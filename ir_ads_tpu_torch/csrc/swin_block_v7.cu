// K13: the banded whole Swin block on the padded, rolled (B, Hp, Wp, C) map,
//   y   = round(x + proj(W-MSA(qkv(LN1 x))))
//   out = round(y + FFN(LN2 y) + adapter_scale * Adapter(y)),
// the tail on every position, in rolled coordinates.
//
// Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v7 (launched by
// pallas_window_block_v7; twin _block_v7_reference), with its rounding
// points: the attention half is K1's (LN1 in f32, zeroed at positions that
// are padding of the real map; qkv, q * scale, the probabilities and the
// attention output rounded to bf16); its residual y is rounded to bf16 as
// K1's output is; the tail is K2's on y (LN2 in f32, the FFN hidden rounded
// after the tanh GELU, the adapter hidden after the relu, the output summed
// in f32 and rounded once).  So at every real position it is K1 -> un-roll,
// crop -> K2, bit for bit, as the TPU kernel is the composition it replaces.
// Adapter weights may be stacked per stream, (S, Ca, C): image b uses
// stream b / (B / S).  Pad, roll, un-roll and crop stay with the caller.
//
// Bound on an H100: operations at every stage.  Per token of the padded map
// the block does 24C^2 + 4*144*C + 4*C*Ca flops (qkv, proj, FFN, scores and
// P.V, adapter) against 4C bytes of x and out; at C = 128 that is over 800
// flop per byte, past the card's 295 (chip_smoke.py's count).
//
// Design: three launches of one source over the fused row steps of K1's
// and K2's earlier form (window_block.cuh, tail.cuh) and K1's attention:
//   v7_ln_qkv     rows of the map: LN1 (zeroed at padding) -> WMMA product
//                 with Wqkv -> qkv rows (bf16) in device memory;
//   v7_attn       K1's attention, the map read and written in place: on the
//                 tensor-core shapes (the wrapper's tensor_core_design)
//                 v7_attn_mma_kernel, window_mma.cuh's head kernel on
//                 MapRows; elsewhere v7_attn_kernel, the first design (one
//                 block a (window, head));
//   v7_proj_tail  rows of one stream: attention tile -> WMMA product with
//                 Wproj -> y = round(x + proj + b) into a bf16 tile in
//                 shared memory, then K2's steps on that tile (adapter on y,
//                 LN2 of y, the FFN walked 64 hidden columns at a time)
//                 -> out.
// Against K1 + K2, y never makes its round trip through device memory; the
// qkv and attention maps still do (the TPU kernel keeps them in VMEM).  The
// row kernels stay on tile_gemm, whose order of the sums K1's and K2's GEMMs
// (gemm_mma.cuh) keep: K13 is K1 -> un-roll, crop -> K2 bit for bit, which
// chip_smoke.py holds.
#include "tail.cuh"
#include "window_block.cuh"
#include "window_mma.cuh"

using namespace port;

namespace {

__global__ void __launch_bounds__(kThreads)
v7_ln_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 const bf16* __restrict__ b, const bf16* __restrict__ wqkv,
                 const bf16* __restrict__ bqkv, bf16* __restrict__ qkv, int T,
                 int Hp, int Wp, int C, int h_real, int w_real, int shift,
                 float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln_qkv_rows(smem, x, g, b, wqkv, bqkv, qkv, T, Hp, Wp, C, h_real, w_real,
              shift, eps);
}

__global__ void __launch_bounds__(kThreads)
v7_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
               const int* __restrict__ region, bf16* __restrict__ att, int Hp,
               int Wp, int C, int heads, int ws, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  map_window_attention(smem, qkv, bias, region, att, Hp, Wp, C, heads, ws,
                       scale);
}

template <int NT, int D>
__global__ void __launch_bounds__(WindowMma<NT, D>::Threads, 1)
v7_attn_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                   const int* __restrict__ region, bf16* __restrict__ att, int B, int Hp,
                   int Wp, int C, int ws, float scale) {
  map_head<NT, D>(qkv, bias, region, att, B, Hp, Wp, C, ws, scale);
}

size_t proj_tail_smem(int C) {
  const int bm = rows_per_block(C);
  return 2 * align128((size_t)bm * (C + 8) * 2) +
         align128((size_t)bm * (C + 4) * 4) + tail_scratch_bytes(bm);
}

// Grid (row tiles of one stream, S streams): stream s owns rows
// [s * Ts, (s + 1) * Ts) and reads its own adapter weights.
__global__ void __launch_bounds__(kThreads)
v7_proj_tail_kernel(const bf16* __restrict__ att, const bf16* __restrict__ x,
                    const bf16* __restrict__ wproj,
                    const bf16* __restrict__ bproj, const bf16* __restrict__ g2,
                    const bf16* __restrict__ be2, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, const bf16* __restrict__ aw1,
                    const bf16* __restrict__ ab1, const bf16* __restrict__ aw2,
                    const bf16* __restrict__ ab2, bf16* __restrict__ out, int Ts,
                    int C, int H, int Ca, float eps, float adapter_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bm = rows_per_block(C);
  const int lda = C + 8, ldacc = C + 4;
  unsigned char* p = smem;
  bf16* A_s = reinterpret_cast<bf16*>(p);
  p += align128((size_t)bm * lda * 2);
  bf16* Y_s = reinterpret_cast<bf16*>(p);
  p += align128((size_t)bm * lda * 2);
  float* acc_s = reinterpret_cast<float*>(p);
  p += align128((size_t)bm * ldacc * 4);
  const TailScratch t = tail_scratch(p, bm);

  const int s = blockIdx.y;
  aw1 += (size_t)s * Ca * C;
  ab1 += (size_t)s * Ca;
  aw2 += (size_t)s * C * Ca;
  ab2 += (size_t)s * C;
  const int r0 = blockIdx.x * bm;
  const int rows = min(bm, Ts - r0);
  const size_t off = ((size_t)s * Ts + r0) * C;
  att += off;
  x += off;
  out += off;

  // y = round(x + att Wproj^T + bproj), K1's proj_add_rows arithmetic, kept
  // in shared memory; rows past the tile are zeros, as K2's are
  for (int idx = threadIdx.x; idx < bm * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    A_s[r * lda + c] = r < rows ? att[(size_t)r * C + c] : __float2bfloat16(0.0f);
  }
  for (int n0 = 0; n0 < C; n0 += kBN) {
    tile_gemm(t.F_s, kLdF, A_s, lda, bm, wproj + (size_t)n0 * C, C, kBN, C, C,
              t.W_s, false);
    for (int idx = threadIdx.x; idx < bm * kBN; idx += kThreads) {
      const int r = idx / kBN, col = idx % kBN;
      Y_s[r * lda + n0 + col] =
          r < rows ? __float2bfloat16(__bfloat162float(x[(size_t)r * C + n0 + col]) +
                                      t.F_s[r * kLdF + col] +
                                      __bfloat162float(bproj[n0 + col]))
                   : __float2bfloat16(0.0f);
    }
  }

  // K2 (block_tail.cu) on the y tile: adapter, LN2, FFN, residual
  adapter_into(acc_s, ldacc, Y_s, lda, t, bm, C, Ca, aw1, ab1, aw2, ab2, b2,
               adapter_scale);
  layer_norm_rows_of(A_s, lda, [=](int row) { return Y_s + row * lda; }, 0,
                     bm, rows, C, g2, be2, eps, [](int) { return false; });
  ffn_accumulate(acc_s, ldacc, A_s, lda, t, bm, C, H, w1, b1, w2);
  for (int idx = threadIdx.x; idx < rows * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    out[(size_t)r * C + c] =
        __float2bfloat16(__bfloat162float(Y_s[r * lda + c]) + acc_s[r * ldacc + c]);
  }
}

}  // namespace

// x, out (B, Hp, Wp, C) bf16, the padded map rolled by `shift`; qkv
// (B*Hp*Wp, 3C) and att (B*Hp*Wp, C) bf16 scratch; region (nW, N) int32 or
// null when unshifted; adapter weights stacked over S streams (S = 1: not
// stacked), B % S == 0.
extern "C" int swin_block_v7(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* region, const void* ln2_g, const void* ln2_b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* aw1,
    const void* ab1, const void* aw2, const void* ab2, void* qkv, void* att,
    void* out, int B, int Hp, int Wp, int C, int heads, int ws, int h_real,
    int w_real, int shift, int hidden, int Ca, int S, int tensor_cores, float scale,
    float eps, float adapter_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * Hp * Wp;
  const int bm = rows_per_block(C);
  const size_t rs = rows_smem(C);
  cudaFuncSetAttribute(v7_ln_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rs);
  v7_ln_qkv_kernel<<<(T + bm - 1) / bm, kThreads, rs, st>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (const bf16*)wqkv,
      (const bf16*)bqkv, (bf16*)qkv, T, Hp, Wp, C, h_real, w_real, shift, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int BN = B * (Hp / ws) * (Wp / ws);
  if (tensor_cores) {
    const int e = launch_mma(ws * ws, C / heads, [&](auto nt, auto dd) {
      constexpr int NT = decltype(nt)::value, D = decltype(dd)::value;
      return launch_heads<NT, D>(v7_attn_mma_kernel<NT, D>, BN, heads, st,
                                 (const bf16*)qkv, (const float*)bias, (const int*)region,
                                 (bf16*)att, B, Hp, Wp, C, ws, scale);
    });
    if (e) return e;
  } else {
    const size_t as = window_attention_smem(ws * ws, C / heads);
    cudaFuncSetAttribute(v7_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)as);
    v7_attn_kernel<<<dim3(BN, heads), kThreads, as, st>>>(
        (const bf16*)qkv, (const float*)bias, (const int*)region, (bf16*)att, Hp,
        Wp, C, heads, ws, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  const size_t ts = proj_tail_smem(C);
  cudaFuncSetAttribute(v7_proj_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ts);
  const int Ts = T / S;
  v7_proj_tail_kernel<<<dim3((Ts + bm - 1) / bm, S), kThreads, ts, st>>>(
      (const bf16*)att, (const bf16*)x, (const bf16*)wproj, (const bf16*)bproj,
      (const bf16*)ln2_g, (const bf16*)ln2_b, (const bf16*)w1, (const bf16*)b1,
      (const bf16*)w2, (const bf16*)b2, (const bf16*)aw1, (const bf16*)ab1,
      (const bf16*)aw2, (const bf16*)ab2, (bf16*)out, Ts, C, hidden, Ca, eps,
      adapter_scale);
  return (int)cudaGetLastError();
}
