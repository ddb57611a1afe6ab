// K1: the Swin attention half-block, y = x + proj(W-MSA(qkv(LN1 x))).
//
// Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v4 (launched by
// pallas_window_block).  x is the padded, cyclically rolled (B, Hp, Wp, C)
// bf16 map; LN1 output is zeroed at positions that are padding of the
// original map, qkv is rounded to bf16 as it leaves the product, the
// probabilities are rounded to bf16 before P.V, and LN statistics are f32.
//
// Bound on an H100: operations at every stage.  Per token the half-block
// does 8C^2 + 4*144*C flops (qkv, proj, scores, P.V) and must move 4C bytes
// (x in, y out, bf16), about 400 flop per byte at C = 128 and more at the
// wider stages, above the card's 295 (989 Tflop/s over 3.35 TB/s).  The
// count is chip_smoke.py's.  Design: three launches,
// because at C = 1024 neither a window's 144 x 3C qkv nor its LN(x) fits in
// the 227 KB of shared memory of one block:
//   ln_qkv      rows of the map: LN1 in f32 -> bf16 tile in shared memory ->
//               WMMA product with Wqkv -> qkv (bf16) to device memory;
//   window_attn one block per (window, head): scores, bias, region mask,
//               softmax and P.V in shared memory, all WMMA;
//   proj_add    rows: attention output tile -> WMMA product with Wproj ->
//               + bias + residual x -> y.
// The qkv and attention maps make one round trip through device memory (the
// TPU kernel keeps them in VMEM); fusing them away is later work.  The LN1 +
// qkv rows, the window attention and the proj rows are shared with K5, K13
// and K14 (window_block.cuh).
#include "window_block.cuh"

using namespace port;

namespace {

__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
              const bf16* __restrict__ b, const bf16* __restrict__ wqkv,
              const bf16* __restrict__ bqkv, bf16* __restrict__ qkv,
              int T, int Hp, int Wp, int C, int h_real, int w_real, int shift,
              float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln_qkv_rows(smem, x, g, b, wqkv, bqkv, qkv, T, Hp, Wp, C, h_real, w_real,
              shift, eps);
}

__global__ void __launch_bounds__(kThreads)
proj_add_kernel(const bf16* __restrict__ att, const bf16* __restrict__ x,
                const bf16* __restrict__ wproj, const bf16* __restrict__ bproj,
                bf16* __restrict__ y, int T, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  proj_add_rows(smem, att, x, wproj, bproj, y, T, C);
}

}  // namespace

extern "C" int swin_window_block(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* region, void* qkv, void* att, void* y, int B, int Hp, int Wp,
    int C, int heads, int ws, int h_real, int w_real, int shift, float scale,
    float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * Hp * Wp;
  const int bm = rows_per_block(C);
  const size_t rs = rows_smem(C);
  cudaFuncSetAttribute(ln_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rs);
  cudaFuncSetAttribute(proj_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rs);
  ln_qkv_kernel<<<(T + bm - 1) / bm, kThreads, rs, st>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (const bf16*)wqkv,
      (const bf16*)bqkv, (bf16*)qkv, T, Hp, Wp, C, h_real, w_real, shift, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t as = window_attention_smem(ws * ws, C / heads);
  cudaFuncSetAttribute(window_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)as);
  dim3 grid(B * (Hp / ws) * (Wp / ws), heads);
  window_attn_kernel<<<grid, kThreads, as, st>>>(
      (const bf16*)qkv, (const float*)bias, (const int*)region, (bf16*)att, Hp,
      Wp, C, heads, ws, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  proj_add_kernel<<<(T + bm - 1) / bm, kThreads, rs, st>>>(
      (const bf16*)att, (const bf16*)x, (const bf16*)wproj, (const bf16*)bproj,
      (bf16*)y, T, C);
  return (int)cudaGetLastError();
}
