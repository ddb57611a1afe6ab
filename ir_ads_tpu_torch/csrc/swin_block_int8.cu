// K10: the w8a8 Swin attention half-block,
// y = x + proj_w8a8(W-MSA(qkv_w8a8(LN1 x))).
//
// Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v4_int8 (launched by
// pallas_window_block under IR_ADS_INT8).  x is the padded, cyclically rolled
// (B, Hp, Wp, C) bf16 map.  LN1 output is zeroed at positions that are
// padding of the original map and rounded to bf16, then quantized per row;
// the s8 qkv product gives (acc * sx) * sqkv + bqkv, rounded to bf16.  Window
// attention is K1's, bf16 with f32 scores and softmax.  Its bf16 output is
// quantized per row, and the s8 proj product gives y = x + ((acc * sa) * sp
// + bp), rounded once.  Weights arrive quantized per output channel (s8,
// f32 scales), in (out, in) layout.  The TPU kernel's bias/mask folds
// (IR_ADS_SWIN_BIASMASK) do not apply to its int8 variant, nor here.
//
// Bound on an H100: per token 8C^2 int8 operations (qkv, proj) and
// 4 * 144 * C bf16 ones (scores, P.V) against 4C bytes moved (x in, y out).
// At the card's rates the bf16 attention takes 1.1x the int8 products' time
// at C = 128 and 0.14x at C = 1024; the bytes bound by a hair at C = 128,
// the operations at the wider stages (chip_smoke.py's count).  Design: three
// launches, the two row kernels in s8 and K1's attention between them:
//   ln_quant_qkv      rows of the map: LN1 in f32 -> bf16 tile -> per-row s8
//                     -> mma.sync s8 product with Wqkv (igemm.cuh) -> qkv
//                     (bf16) to device memory;
//   attention         K1's: on the tensor-core shapes (the wrapper's
//                     tensor_core_design) int8_attn_mma_kernel,
//                     window_mma.cuh's head kernel on the map in place
//                     (MapRows); elsewhere window_attn_kernel, the first
//                     design (window_block.cuh);
//   quant_proj_add    rows: attention output -> per-row s8 -> s8 product
//                     with Wproj -> dequantize, + bias + residual x -> y.
// As in K1, qkv and the attention output make one round trip through device
// memory; fusing them away is later work.
#include "igemm.cuh"
#include "window_block.cuh"
#include "window_mma.cuh"

using namespace port;

namespace {

__host__ __device__ inline size_t rows_smem_int8(int C) {
  const int bm = rows_per_block(C);
  return align128((size_t)bm * (C + 8) * 2) + align128((size_t)bm * (C + 16)) +
         align128((size_t)bm * kLdI * 4) + align128((size_t)kBN * kLdWs) +
         align128((size_t)bm * 4);
}

struct RowSmem {
  bf16* A_s;    // [bm][C + 8] bf16 rows (LN1 output or attention output)
  int8_t* q_s;  // [bm][C + 16] their s8
  int* I_s;     // [bm][kLdI]
  int8_t* W_s;  // [64][kLdWs]
  float* sc;    // [bm] row scales
};

__device__ inline RowSmem row_smem(unsigned char* p, int C) {
  const int bm = rows_per_block(C);
  RowSmem s;
  s.A_s = reinterpret_cast<bf16*>(p);
  p += align128((size_t)bm * (C + 8) * 2);
  s.q_s = reinterpret_cast<int8_t*>(p);
  p += align128((size_t)bm * (C + 16));
  s.I_s = reinterpret_cast<int*>(p);
  p += align128((size_t)bm * kLdI * 4);
  s.W_s = reinterpret_cast<int8_t*>(p);
  p += align128((size_t)kBN * kLdWs);
  s.sc = reinterpret_cast<float*>(p);
  return s;
}

__global__ void __launch_bounds__(kThreads)
ln_quant_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                    const bf16* __restrict__ b, const int8_t* __restrict__ wqkv,
                    const float* __restrict__ sqkv, const bf16* __restrict__ bqkv,
                    bf16* __restrict__ qkv, int T, int Hp, int Wp, int C,
                    int h_real, int w_real, int shift, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowSmem s = row_smem(smem, C);
  const int bm = rows_per_block(C);
  const int row0 = blockIdx.x * bm;
  const int valid = min(bm, T - row0);
  const bool padded = h_real != Hp || w_real != Wp;
  layer_norm_rows(s.A_s, C + 8, x, row0, bm, T, C, g, b, eps, [=](int row) {
    if (!padded) return false;
    const int pix = row % (Hp * Wp);
    const int r = pix / Wp, c = pix % Wp;
    return (r + shift) % Hp >= h_real || (c + shift) % Wp >= w_real;
  });
  __syncthreads();
  quantize_rows(s.q_s, C + 16, s.sc, s.A_s, C + 8, bm, valid, C);
  const int C3 = 3 * C;
  for (int n0 = 0; n0 < C3; n0 += kBN) {
    tile_igemm(s.I_s, kLdI, s.q_s, C + 16, bm, wqkv + (size_t)n0 * C, C, kBN, C, s.W_s);
    for (int idx = threadIdx.x; idx < bm * kBN; idx += kThreads) {
      const int r = idx / kBN, col = idx % kBN;
      if (r < valid)
        qkv[(size_t)(row0 + r) * C3 + n0 + col] = __float2bfloat16(dequant(
            s.I_s[r * kLdI + col], s.sc[r], sqkv[n0 + col],
            __bfloat162float(bqkv[n0 + col])));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
quant_proj_add_kernel(const bf16* __restrict__ att, const bf16* __restrict__ x,
                      const int8_t* __restrict__ wproj,
                      const float* __restrict__ sproj,
                      const bf16* __restrict__ bproj, bf16* __restrict__ y, int T,
                      int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowSmem s = row_smem(smem, C);
  const int bm = rows_per_block(C);
  const int row0 = blockIdx.x * bm;
  const int valid = min(bm, T - row0);
  for (int idx = threadIdx.x; idx < bm * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    s.A_s[r * (C + 8) + c] =
        r < valid ? att[(size_t)(row0 + r) * C + c] : __float2bfloat16(0.0f);
  }
  __syncthreads();
  quantize_rows(s.q_s, C + 16, s.sc, s.A_s, C + 8, bm, valid, C);
  for (int n0 = 0; n0 < C; n0 += kBN) {
    tile_igemm(s.I_s, kLdI, s.q_s, C + 16, bm, wproj + (size_t)n0 * C, C, kBN, C, s.W_s);
    for (int idx = threadIdx.x; idx < bm * kBN; idx += kThreads) {
      const int r = idx / kBN, col = idx % kBN;
      if (r < valid) {
        const size_t o = (size_t)(row0 + r) * C + n0 + col;
        y[o] = __float2bfloat16(__fadd_rn(
            __bfloat162float(x[o]),
            dequant(s.I_s[r * kLdI + col], s.sc[r], sproj[n0 + col],
                    __bfloat162float(bproj[n0 + col]))));
      }
    }
  }
}

// The attention on the tensor cores: K1's (swin_block.cu), window_mma.cuh's
// head kernel on the map in place.
template <int NT, int D>
__global__ void __launch_bounds__(WindowMma<NT, D>::Threads, 1)
int8_attn_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                     const int* __restrict__ region, bf16* __restrict__ att, int B, int Hp,
                     int Wp, int C, int ws, float scale) {
  map_head<NT, D>(qkv, bias, region, att, B, Hp, Wp, C, ws, scale);
}

}  // namespace

extern "C" int swin_window_block_int8(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wproj, const void* sproj,
    const void* bproj, const void* bias, const void* region, void* qkv, void* att,
    void* y, int B, int Hp, int Wp, int C, int heads, int ws, int h_real,
    int w_real, int shift, int tensor_cores, float scale, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * Hp * Wp;
  const int bm = rows_per_block(C);
  const size_t rs = rows_smem_int8(C);
  cudaError_t err = cudaFuncSetAttribute(
      ln_quant_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rs);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(quant_proj_add_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rs);
  if (err != cudaSuccess) return (int)err;
  ln_quant_qkv_kernel<<<(T + bm - 1) / bm, kThreads, rs, st>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (const int8_t*)wqkv,
      (const float*)sqkv, (const bf16*)bqkv, (bf16*)qkv, T, Hp, Wp, C, h_real,
      w_real, shift, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int BN = B * (Hp / ws) * (Wp / ws);
  if (tensor_cores) {
    const int e = launch_mma(ws * ws, C / heads, [&](auto nt, auto dd) {
      constexpr int NT = decltype(nt)::value, D = decltype(dd)::value;
      return launch_heads<NT, D>(int8_attn_mma_kernel<NT, D>, BN, heads, st,
                                 (const bf16*)qkv, (const float*)bias, (const int*)region,
                                 (bf16*)att, B, Hp, Wp, C, ws, scale);
    });
    if (e) return e;
  } else {
    const size_t as = window_attention_smem(ws * ws, C / heads);
    err = cudaFuncSetAttribute(window_attn_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)as);
    if (err != cudaSuccess) return (int)err;
    window_attn_kernel<<<dim3(BN, heads), kThreads, as, st>>>(
        (const bf16*)qkv, (const float*)bias, (const int*)region, (bf16*)att, Hp,
        Wp, C, heads, ws, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  quant_proj_add_kernel<<<(T + bm - 1) / bm, kThreads, rs, st>>>(
      (const bf16*)att, (const bf16*)x, (const int8_t*)wproj, (const float*)sproj,
      (const bf16*)bproj, (bf16*)y, T, C);
  return (int)cudaGetLastError();
}
