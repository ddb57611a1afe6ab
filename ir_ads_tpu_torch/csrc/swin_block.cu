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
// count is chip_smoke.py's.
//
// Design: four launches, each a grid over the whole map (at C = 1024
// neither a window's 144 x 3C qkv nor its LN(x) fits in the 227 KB of
// shared memory of one block, and a fused row kernel would stream all of
// Wqkv and Wproj again for every row tile):
//   swin_ln1_kernel  LN1 of the map's rows to bf16, zero at padding
//                    (layer_norm_rows, one warp a row);
//   SwinQkvOut       GEMM with Wqkv on gemm_mma.cuh: qkv = bf16(acc +
//                    bqkv);
//   attention        on the tensor-core shapes (the wrapper's
//                    tensor_core_design: d 16 or 32, N <= 144, every
//                    Swin-B stage) swin_attn_mma_kernel, window_mma.cuh's
//                    persistent head kernel on the map in place (MapRows,
//                    K15's); elsewhere window_attn_kernel, the first design
//                    (window_block.cuh, one block a (window, head));
//   SwinProjAdd      GEMM with Wproj: y = bf16((x + acc) + bproj).
// The epilogues are the expressions of the earlier fused row kernels, and
// gemm_mma.cuh sums each output in their order, so the products kept those
// kernels' bits; K13 and K14 run the same launches (their epilogues under
// names of their own) and are held bit for bit against compositions with
// K1 (chip_smoke.py).  The attention's row sums run in window_mma.cuh's
// order, not the first design's: an output can sit one bf16 ulp from it.  The LN output, qkv
// and the attention output make one round trip through device memory; the
// wrapper allocates them.
#include "gemm_epilogues.cuh"
#include "window_block.cuh"
#include "window_mma.cuh"

using namespace port;

namespace {

constexpr int kLnRows = kWarps;  // rows a block of the LN launch: one a warp

// K1's epilogues, named apart from K5's on the r5 path (gemm_epilogues.cuh)
struct SwinQkvOut : QkvOut {};
struct SwinProjAdd : ProjAddOut {};

__global__ void __launch_bounds__(kThreads)
swin_ln1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                const bf16* __restrict__ b, bf16* __restrict__ xn, int T, int Hp, int Wp,
                int C, int h_real, int w_real, int shift, float eps) {
  const int row0 = blockIdx.x * kLnRows;
  const bool padded = h_real != Hp || w_real != Wp;
  layer_norm_rows(xn + (size_t)row0 * C, C, x, row0, min(kLnRows, T - row0), T, C, g, b, eps,
                  [=](int row) {
                    if (!padded) return false;
                    const int pix = row % (Hp * Wp);
                    const int r = pix / Wp, c = pix % Wp;
                    return (r + shift) % Hp >= h_real || (c + shift) % Wp >= w_real;
                  });
}

template <int NT, int D>
__global__ void __launch_bounds__(WindowMma<NT, D>::Threads, 1)
swin_attn_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                     const int* __restrict__ region, bf16* __restrict__ att, int B, int Hp,
                     int Wp, int C, int ws, float scale) {
  map_head<NT, D>(qkv, bias, region, att, B, Hp, Wp, C, ws, scale);
}

}  // namespace

// x, y (B, Hp, Wp, C) bf16, the padded map rolled by `shift`; the
// parameters bf16 in torch Linear layout, bias (heads, N, N) f32, region
// (nW, N) int32 or null when unshifted; the intermediates over the T = B Hp
// Wp rows: xn (T, C), qkv (T, 3C) and att (T, C) bf16.  tensor_cores = 1
// takes the attention's tensor-core design (C / heads 16 or 32, N <= 144;
// else cudaErrorInvalidValue), 0 its first design.
extern "C" int swin_window_block(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* region, void* xn, void* qkv, void* att, void* y, int B, int Hp,
    int Wp, int C, int heads, int ws, int h_real, int w_real, int shift,
    int tensor_cores, float scale, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * Hp * Wp;
  swin_ln1_kernel<<<(T + kLnRows - 1) / kLnRows, kThreads, 0, st>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (bf16*)xn, T, Hp, Wp, C, h_real,
      w_real, shift, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int e = gemm(gemm_args(xn, C, 0, wqkv, C, 0, T, 3 * C, C), 1,
               SwinQkvOut{{(const bf16*)bqkv, (bf16*)qkv, 3 * C}}, st);
  if (e) return e;

  const int BN = B * (Hp / ws) * (Wp / ws);
  if (tensor_cores) {
    e = launch_mma(ws * ws, C / heads, [&](auto nt, auto dd) {
      constexpr int NT = decltype(nt)::value, D = decltype(dd)::value;
      return launch_heads<NT, D>(swin_attn_mma_kernel<NT, D>, BN, heads, st,
                                 (const bf16*)qkv, (const float*)bias, (const int*)region,
                                 (bf16*)att, B, Hp, Wp, C, ws, scale);
    });
    if (e) return e;
  } else {
    const size_t as = window_attention_smem(ws * ws, C / heads);
    err = cudaFuncSetAttribute(window_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)as);
    if (err != cudaSuccess) return (int)err;
    window_attn_kernel<<<dim3(BN, heads), kThreads, as, st>>>(
        (const bf16*)qkv, (const float*)bias, (const int*)region, (bf16*)att, Hp, Wp, C,
        heads, ws, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  return gemm(gemm_args(att, C, 0, wproj, C, 0, T, C, C), 1,
              SwinProjAdd{{(const bf16*)x, (const bf16*)bproj, (bf16*)y, C}}, st);
}
