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
// bit: the same LN1, the same GEMMs and epilogues on the real rows, and the
// same window attention, with the pad, the roll and the crop moved into the
// attention's indices.
//
// Bound on an H100: operations at every stage.  Per real token the
// half-block does 8C^2 flops (qkv, proj) plus 4*144*C (scores and P.V) per
// token of the padded map, and must move 4C bytes (x in, y out, bf16):
// about 400 flop per byte at C = 128 and more at the wider stages, above
// the card's 295 (chip_smoke.py's count).
//
// Design: the TPU kernel holds one image's whole map in VMEM; here K1's
// four launches, each a grid over the T = B H W rows of the real map:
//   v5_ln1_kernel  LN1 of the real rows to bf16 (layer_norm_rows, one warp
//                  a row; the real map has no padding to zero);
//   FullQkvOut     GEMM with Wqkv on gemm_mma.cuh: qkv = bf16(acc + bqkv);
//   attention      the windows of the rolled padded map: token i of a
//                  window reads the qkv row of the real position it rolls
//                  from, or bqkv where that position is padding, and
//                  writes its output only where it is real.  On the
//                  tensor-core shapes (the wrapper's tensor_core_design)
//                  v5_attn_mma_kernel, window_mma.cuh's head kernel on
//                  RealMapTokens; elsewhere v5_attn_kernel, the first
//                  design (window_block.cuh, one block a (window, head));
//   FullProjAdd    GEMM with Wproj: y = bf16((x + acc) + bproj), x first,
//                  straight to the real map.
// The epilogues are K1's (gemm_epilogues.cuh) under names of their own, and
// gemm_mma.cuh sums each output in the order K1's GEMMs take, so the rows
// keep K1's bits.  Only real rows enter the GEMMs (at stage 3 of 4 images
// 1,200 against K1's 2,304 of the padded map), and against pad, roll, K1,
// un-roll and crop the four copies of the map are gone.  The LN output,
// qkv and the attention output make one round trip through device memory;
// the wrapper allocates them.
#include "gemm_epilogues.cuh"
#include "window_block.cuh"
#include "window_mma.cuh"

using namespace port;

namespace {

constexpr int kLnRows = kWarps;  // rows a block of the LN launch: one a warp

// K14's epilogues, named apart from K1's and K5's (gemm_epilogues.cuh)
struct FullQkvOut : QkvOut {};
struct FullProjAdd : ProjAddOut {};

__global__ void __launch_bounds__(kThreads)
v5_ln1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
              const bf16* __restrict__ b, bf16* __restrict__ xn, int T, int C, float eps) {
  const int row0 = blockIdx.x * kLnRows;
  layer_norm_rows(xn + (size_t)row0 * C, C, x, row0, min(kLnRows, T - row0), T, C, g, b, eps,
                  [](int) { return false; });
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

}  // namespace

// x, y (B, H, W, C) bf16 real maps; the parameters bf16 in torch Linear
// layout, bias (heads, N, N) f32, region (nW, N) int32 of the padded map or
// null when unshifted; the intermediates over the T = B H W real rows: xn
// (T, C), qkv (T, 3C) and att (T, C) bf16.  tensor_cores = 1 takes the
// attention's tensor-core design (C / heads 16 or 32, N <= 144; else
// cudaErrorInvalidValue), 0 its first design.
extern "C" int swin_block_full(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* region, void* xn, void* qkv, void* att, void* y, int B, int H, int W,
    int C, int heads, int ws, int shift, int tensor_cores, float scale, float eps,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * H * W;
  v5_ln1_kernel<<<(T + kLnRows - 1) / kLnRows, kThreads, 0, st>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (bf16*)xn, T, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int e = gemm(gemm_args(xn, C, 0, wqkv, C, 0, T, 3 * C, C), 1,
               FullQkvOut{{(const bf16*)bqkv, (bf16*)qkv, 3 * C}}, st);
  if (e) return e;

  const int nW = ((H + ws - 1) / ws) * ((W + ws - 1) / ws);
  if (tensor_cores) {
    e = launch_mma(ws * ws, C / heads, [&](auto nt, auto dd) {
      constexpr int NT = decltype(nt)::value, D = decltype(dd)::value;
      return launch_heads<NT, D>(v5_attn_mma_kernel<NT, D>, B * nW, heads, st,
                                 (const bf16*)qkv, (const bf16*)bqkv, (const float*)bias,
                                 (const int*)region, (bf16*)att, B, H, W, C, ws, shift, scale);
    });
    if (e) return e;
  } else {
    const size_t as = window_attention_smem(ws * ws, C / heads);
    err = cudaFuncSetAttribute(v5_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)as);
    if (err != cudaSuccess) return (int)err;
    v5_attn_kernel<<<dim3(B * nW, heads), kThreads, as, st>>>(
        (const bf16*)qkv, (const bf16*)bqkv, (const float*)bias, (const int*)region,
        (bf16*)att, H, W, C, heads, ws, shift, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  return gemm(gemm_args(att, C, 0, wproj, C, 0, T, C, C), 1,
              FullProjAdd{{(const bf16*)x, (const bf16*)bproj, (bf16*)y, C}}, st);
}
