// K14: the Swin attention half-block on the REAL (B, H, W, C) map,
//   y = round(x + proj(W-MSA(qkv(LN1 x)))),
// with the window padding, the cyclic shift and the crop inside the kernel.
//
// Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v5 (launched by
// pallas_window_block_full; twin _block_full_reference), with its rounding
// points: LN1 in f32 on the real tokens, rounded to bf16; zero padding after
// LN1, so a padded position's qkv is the bias row bqkv; qkv rounded to bf16;
// (q * scale), the probabilities and the attention output rounded to bf16;
// proj + bias + residual summed in f32 and rounded once.  It is K1
// (swin_block.cu) on the padded, rolled map, un-rolled and cropped, bit for
// bit: the same LN1 + qkv and proj arithmetic (here the fused row kernels
// on tile_gemm, in K1 GEMMs on gemm_mma.cuh that sum in tile_gemm's order)
// and the same window attention, with the pad, the roll and the crop moved
// into the indices.
//
// Bound on an H100: operations at every stage.  Per real token the
// half-block does 8C^2 flops (qkv, proj) plus 4*144*C (scores and P.V) per
// token of the padded map, and must move 4C bytes (x in, y out, bf16):
// about 400 flop per byte at C = 128 and more at the wider stages, above
// the card's 295 (chip_smoke.py's count).
//
// Design: the TPU kernel holds one image's whole map in VMEM; here, as K5
// (swin_block_v6.cu) does, three launches of one source over the fused row
// steps (window_block.cuh) and K5's attention:
//   v5_ln_qkv     rows of the real map: LN1 -> WMMA product with Wqkv -> qkv
//                 rows (bf16) in device memory, real tokens only;
//   v5_attn       the windows of the rolled padded map: token i of a window
//                 reads the qkv row of the real position it rolls from, or
//                 bqkv where that position is padding, and writes its output
//                 only where it is real.  On the tensor-core shapes (the
//                 wrapper's tensor_core_design) v5_attn_mma_kernel,
//                 window_mma.cuh's head kernel on RealMapTokens; elsewhere
//                 v5_attn_kernel, the first design (one block a (window,
//                 head));
//   v5_proj_add   rows of the real map: attention tile -> WMMA product with
//                 Wproj -> + bias + residual x -> y.
// The padded, rolled map is never written: against K1 and its pad, roll,
// un-roll and crop copies (four map passes of C, and the qkv and attention
// maps of the padding), only the real qkv and attention rows make a round
// trip through device memory.
#include "window_block.cuh"
#include "window_mma.cuh"

using namespace port;

namespace {

// LN1 + qkv of the real tokens: no padding, no roll.
__global__ void __launch_bounds__(kThreads)
v5_ln_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 const bf16* __restrict__ b, const bf16* __restrict__ wqkv,
                 const bf16* __restrict__ bqkv, bf16* __restrict__ qkv, int T,
                 int C, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln_qkv_rows(smem, x, g, b, wqkv, bqkv, qkv, T, 1, 1, C, 1, 1, 0, eps);
}

__global__ void __launch_bounds__(kThreads)
v5_attn_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bqkv,
               const float* __restrict__ bias, const int* __restrict__ region,
               bf16* __restrict__ att, int H, int W, int C, int heads, int ws,
               int shift, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  real_map_window_attention(smem, qkv, bqkv, bias, region, att, H, W, C, heads,
                            ws, shift, scale);
}

template <int NT, int D>
__global__ void __launch_bounds__(WindowMma<NT, D>::Threads, 1)
v5_attn_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bqkv,
                   const float* __restrict__ bias, const int* __restrict__ region,
                   bf16* __restrict__ att, int B, int H, int W, int C, int ws, int shift,
                   float scale) {
  real_map_head<NT, D>(qkv, bqkv, bias, region, att, B, H, W, C, ws, shift, scale);
}

__global__ void __launch_bounds__(kThreads)
v5_proj_add_kernel(const bf16* __restrict__ att, const bf16* __restrict__ x,
                   const bf16* __restrict__ wproj,
                   const bf16* __restrict__ bproj, bf16* __restrict__ y, int T,
                   int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  proj_add_rows(smem, att, x, wproj, bproj, y, T, C);
}

}  // namespace

// x, y (B, H, W, C) bf16 real maps; qkv (B*H*W, 3C) and att (B*H*W, C) bf16
// scratch; region (nW, N) int32 of the padded map, or null when unshifted.
extern "C" int swin_block_full(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* region, void* qkv, void* att, void* y, int B, int H, int W,
    int C, int heads, int ws, int shift, int tensor_cores, float scale, float eps,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * H * W;
  const int bm = rows_per_block(C);
  const size_t rs = rows_smem(C);
  cudaFuncSetAttribute(v5_ln_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rs);
  cudaFuncSetAttribute(v5_proj_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rs);
  v5_ln_qkv_kernel<<<(T + bm - 1) / bm, kThreads, rs, st>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (const bf16*)wqkv,
      (const bf16*)bqkv, (bf16*)qkv, T, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int nW = ((H + ws - 1) / ws) * ((W + ws - 1) / ws);
  if (tensor_cores) {
    const int e = launch_mma(ws * ws, C / heads, [&](auto nt, auto dd) {
      constexpr int NT = decltype(nt)::value, D = decltype(dd)::value;
      return launch_heads<NT, D>(v5_attn_mma_kernel<NT, D>, B * nW, heads, st,
                                 (const bf16*)qkv, (const bf16*)bqkv, (const float*)bias,
                                 (const int*)region, (bf16*)att, B, H, W, C, ws, shift, scale);
    });
    if (e) return e;
  } else {
    const size_t as = window_attention_smem(ws * ws, C / heads);
    cudaFuncSetAttribute(v5_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)as);
    v5_attn_kernel<<<dim3(B * nW, heads), kThreads, as, st>>>(
        (const bf16*)qkv, (const bf16*)bqkv, (const float*)bias,
        (const int*)region, (bf16*)att, H, W, C, heads, ws, shift, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  v5_proj_add_kernel<<<(T + bm - 1) / bm, kThreads, rs, st>>>(
      (const bf16*)att, (const bf16*)x, (const bf16*)wproj, (const bf16*)bproj,
      (bf16*)y, T, C);
  return (int)cudaGetLastError();
}
