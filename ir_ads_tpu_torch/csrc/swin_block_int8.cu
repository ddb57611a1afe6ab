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
// the operations at the wider stages (chip_smoke.py's count).
//
// Design: five launches, each a grid over the whole map, the two s8
// products on igemm.cuh's TMA and wgmma GEMM (a fused row kernel streams
// all of Wqkv and Wproj again for every row tile):
//   k10_ln1_kernel    LN1 of the map's rows (f32 statistics, zero at
//                     padding) to bf16, then per-row s8 (xq, sx): the rows
//                     code of the fused form (layer_norm_rows,
//                     quantize_rows), one warp a row;
//   K10QkvOut         s8 GEMM with Wqkv: qkv = bf16((acc * sx) * sqkv +
//                     bqkv);
//   attention         K1's: on the tensor-core shapes (the wrapper's
//                     tensor_core_design) int8_attn_mma_kernel,
//                     window_mma.cuh's head kernel on the map in place
//                     (MapRows); elsewhere window_attn_kernel, the first
//                     design (window_block.cuh);
//   k10_att_quant_kernel  per-row s8 of the attention output (aq, sa), one
//                     warp a row;
//   K10ProjAdd        s8 GEMM with Wproj: y = bf16(x + ((acc * sa) * sp +
//                     bp)).
// Bits: each epilogue is the fused rows' expression (this file before its
// products moved to igemm.cuh) and the s8 sums are exact in any order, so
// K10 keeps those kernels' bits.  The s8 rows, their scales, qkv and the
// attention output make one round trip through device memory; the wrapper
// allocates them.
#include "gemm_epilogues.cuh"
#include "igemm.cuh"
#include "window_block.cuh"
#include "window_mma.cuh"

using namespace port;

namespace {

constexpr int kLnRows = kWarps;  // rows a block of the row launches: one a warp

__global__ void __launch_bounds__(kThreads)
k10_ln1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
               const bf16* __restrict__ b, int8_t* __restrict__ xq, float* __restrict__ sx,
               int T, int Hp, int Wp, int C, int h_real, int w_real, int shift, float eps) {
  extern __shared__ __align__(16) unsigned char ln_smem[];
  bf16* ln_s = reinterpret_cast<bf16*>(ln_smem);
  const int row0 = blockIdx.x * kLnRows, valid = min(kLnRows, T - row0);
  const bool padded = h_real != Hp || w_real != Wp;
  layer_norm_rows(ln_s, C + 8, x, row0, valid, T, C, g, b, eps, [=](int row) {
    if (!padded) return false;
    const int pix = row % (Hp * Wp);
    const int r = pix / Wp, c = pix % Wp;
    return (r + shift) % Hp >= h_real || (c + shift) % Wp >= w_real;
  });
  __syncthreads();
  quantize_rows(xq + (size_t)row0 * C, C, sx + row0, ln_s, C + 8, valid, C);
}

__global__ void __launch_bounds__(kThreads)
k10_att_quant_kernel(const bf16* __restrict__ att, int8_t* __restrict__ aq,
                     float* __restrict__ sa, int T, int C) {
  const int row0 = blockIdx.x * kLnRows, valid = min(kLnRows, T - row0);
  quantize_rows(aq + (size_t)row0 * C, C, sa + row0, att + (size_t)row0 * C, C, valid, C);
}

// The rows' scale, the row of both epilogues.
struct RowScale {
  float s;
};

// qkv = bf16((acc * sx) * sqkv + bqkv)
struct K10QkvOut {
  static constexpr bool kRowMax = false;
  const float* sx;
  const float* sqkv;
  const bf16* bqkv;
  bf16* qkv;
  int ld;
  __device__ RowScale row(int r) const { return {sx[r]}; }
  __device__ ScaleBias col(int c) const { return scale_bias(sqkv, bqkv, c); }
  __device__ void operator()(RowScale r, ScaleBias c, int i, int j, int a0, int a1) const {
    store_bf16x2(qkv + (size_t)i * ld + j, dequant(a0, r.s, c.s0, c.b0),
                 dequant(a1, r.s, c.s1, c.b1));
  }
};

// y = bf16(x + ((acc * sa) * sproj + bproj)), rounded once
struct K10ProjAdd {
  static constexpr bool kRowMax = false;
  const float* sa;
  const float* sproj;
  const bf16* bproj;
  const bf16* x;
  bf16* y;
  int C;
  __device__ RowScale row(int r) const { return {sa[r]}; }
  __device__ ScaleBias col(int c) const { return scale_bias(sproj, bproj, c); }
  __device__ void operator()(RowScale r, ScaleBias c, int i, int j, int a0, int a1) const {
    const size_t o = (size_t)i * C + j;
    store_bf16x2(y + o, __fadd_rn(__bfloat162float(x[o]), dequant(a0, r.s, c.s0, c.b0)),
                 __fadd_rn(__bfloat162float(x[o + 1]), dequant(a1, r.s, c.s1, c.b1)));
  }
};

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

// x, y (B, Hp, Wp, C) bf16, the padded map rolled by `shift`; ln_g, ln_b,
// bqkv, bproj bf16; wqkv (3C, C) and wproj (C, C) s8 with f32 scales sqkv
// and sproj; bias (heads, N, N) f32, region (nW, N) int32 or null when
// unshifted; the intermediates over the T = B Hp Wp rows: xq, aq (T, C) s8,
// sx, sa (T) f32, qkv (T, 3C) and att (T, C) bf16.  C a multiple of 16.
// tensor_cores = 1 takes the attention's tensor-core design, 0 its first.
extern "C" int swin_window_block_int8(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wproj, const void* sproj,
    const void* bproj, const void* bias, const void* region, void* xq, void* sx, void* qkv,
    void* att, void* aq, void* sa, void* y, int B, int Hp, int Wp, int C, int heads, int ws,
    int h_real, int w_real, int shift, int tensor_cores, float scale, float eps,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * Hp * Wp;
  const int row_blocks = (T + kLnRows - 1) / kLnRows;
  k10_ln1_kernel<<<row_blocks, kThreads, kLnRows * (C + 8) * 2, st>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (int8_t*)xq, (float*)sx, T, Hp,
      Wp, C, h_real, w_real, shift, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int e = igemm(xq, C, wqkv, C, T, 3 * C, C,
                K10QkvOut{(const float*)sx, (const float*)sqkv, (const bf16*)bqkv, (bf16*)qkv,
                          3 * C},
                st);
  if (e) return e;

  const int BN = B * (Hp / ws) * (Wp / ws);
  if (tensor_cores) {
    e = launch_mma(ws * ws, C / heads, [&](auto nt, auto dd) {
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

  k10_att_quant_kernel<<<row_blocks, kThreads, 0, st>>>((const bf16*)att, (int8_t*)aq,
                                                         (float*)sa, T, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return igemm(aq, C, wproj, C, T, C, C,
               K10ProjAdd{(const float*)sa, (const float*)sproj, (const bf16*)bproj,
                          (const bf16*)x, (bf16*)y, C},
               st);
}
