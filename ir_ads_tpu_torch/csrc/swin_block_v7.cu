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
// Design: the TPU kernel keeps the block's rows in VMEM; here K1's four
// launches, then K2's five on the block's y, each a grid over the T = B Hp
// Wp rows of the map:
//   v7_ln1_kernel  LN1 of the map's rows to bf16, zero at padding
//                  (layer_norm_rows, one warp a row);
//   V7QkvOut       GEMM with Wqkv on gemm_mma.cuh: qkv = bf16(acc + bqkv);
//   attention      K1's, the map read and written in place: on the
//                  tensor-core shapes (the wrapper's tensor_core_design)
//                  v7_attn_mma_kernel, window_mma.cuh's head kernel on
//                  MapRows; elsewhere v7_attn_kernel, the first design
//                  (window_block.cuh, one block a (window, head));
//   V7ProjAdd      GEMM with Wproj: y = bf16((x + acc) + bproj), x first;
//   V7AdapterUp    GEMM of y with Wa1 (N = Ca): bf16(relu(acc + ab1));
//   V7AdapterDown  GEMM with Wa2 (K = Ca, rounded up to 16 with zeros):
//                  adapter_scale * (acc + ab2) + b2 in f32, the FFN's init;
//                  both adapter GEMMs batched over the S streams (gridDim.z
//                  = S, rows [s Ts, (s + 1) Ts), each reading its weights);
//   v7_ln2_kernel  LN2 of y to bf16;
//   V7Fc1Out       GEMM with W1: bf16(gelu_tanh(acc + b1));
//   V7Fc2Out       GEMM with W2 over the whole hidden (K = 4C) from the
//                  adapter's f32 output: out = bf16(y + acc).
// The epilogues are K1's and K2's (gemm_epilogues.cuh) under names of
// their own, the GEMM arguments K2's, and gemm_mma.cuh sums each output in
// the order K1's and K2's GEMMs take: K13 keeps the composition's bits,
// which chip_smoke.py holds.  At padding positions y is x + proj(att) +
// bproj on a zero x; the tail runs there too and the caller's crop drops
// it.  Against K1, un-roll, crop and K2, the un-roll and crop copies are
// gone; the intermediates (LN outputs, qkv, the attention output, y, the
// adapter's hidden and f32 output, the FFN hidden: 83 MB at stage 0 of 4
// images) make one round trip through device memory, and the wrapper
// allocates them.
#include "gemm_epilogues.cuh"
#include "window_block.cuh"
#include "window_mma.cuh"

using namespace port;

namespace {

constexpr int kLnRows = kWarps;  // rows a block of the LN launches: one a warp

// K13's epilogues, named apart from K1's, K2's and K5's (gemm_epilogues.cuh)
struct V7QkvOut : QkvOut {};
struct V7ProjAdd : ProjAddOut {};
struct V7AdapterUp : AdapterUp {};
struct V7AdapterDown : AdapterDown {};
struct V7Fc1Out : Fc1Out {};
struct V7Fc2Out : TailOut {};

__global__ void __launch_bounds__(kThreads)
v7_ln1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
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

__global__ void __launch_bounds__(kThreads)
v7_ln2_kernel(const bf16* __restrict__ y, const bf16* __restrict__ g,
              const bf16* __restrict__ b, bf16* __restrict__ yn, int T, int C, float eps) {
  const int row0 = blockIdx.x * kLnRows;
  layer_norm_rows(yn + (size_t)row0 * C, C, y, row0, min(kLnRows, T - row0), T, C, g, b, eps,
                  [](int) { return false; });
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

}  // namespace

// x, out (B, Hp, Wp, C) bf16, the padded map rolled by `shift`; the
// parameters bf16 in torch Linear layout (w1 (hidden, C), w2 (C, hidden)),
// bias (heads, N, N) f32, region (nW, N) int32 or null when unshifted,
// adapter weights stacked over S streams (aw1 (S, Ca, C), ab1 (S, Ca), aw2
// (S, C, Ca), ab2 (S, C); S = 1: not stacked), B % S == 0; the
// intermediates over the T = B Hp Wp rows: xn (T, C) bf16 (LN1's, then
// LN2's output), qkv (T, 3C), att (T, C) and y (T, C) bf16, ah (T, Ca)
// bf16, init (T, C) f32, hid (T, hidden) bf16.  C, hidden and Ca even.
// tensor_cores = 1 takes the attention's tensor-core design (C / heads 16
// or 32, N <= 144; else cudaErrorInvalidValue), 0 its first design.
extern "C" int swin_block_v7(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* region, const void* ln2_g, const void* ln2_b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* aw1,
    const void* ab1, const void* aw2, const void* ab2, void* xn, void* qkv,
    void* att, void* y, void* ah, void* init, void* hid, void* out, int B, int Hp,
    int Wp, int C, int heads, int ws, int h_real, int w_real, int shift, int hidden,
    int Ca, int S, int tensor_cores, float scale, float eps, float adapter_scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * Hp * Wp, Ts = T / S, ln_grid = (T + kLnRows - 1) / kLnRows;
  v7_ln1_kernel<<<ln_grid, kThreads, 0, st>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (bf16*)xn, T, Hp, Wp, C, h_real,
      w_real, shift, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int e = gemm(gemm_args(xn, C, 0, wqkv, C, 0, T, 3 * C, C), 1,
               V7QkvOut{{(const bf16*)bqkv, (bf16*)qkv, 3 * C}}, st);
  if (e) return e;

  const int BN = B * (Hp / ws) * (Wp / ws);
  if (tensor_cores) {
    e = launch_mma(ws * ws, C / heads, [&](auto nt, auto dd) {
      constexpr int NT = decltype(nt)::value, D = decltype(dd)::value;
      return launch_heads<NT, D>(v7_attn_mma_kernel<NT, D>, BN, heads, st,
                                 (const bf16*)qkv, (const float*)bias, (const int*)region,
                                 (bf16*)att, B, Hp, Wp, C, ws, scale);
    });
    if (e) return e;
  } else {
    const size_t as = window_attention_smem(ws * ws, C / heads);
    err = cudaFuncSetAttribute(v7_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)as);
    if (err != cudaSuccess) return (int)err;
    v7_attn_kernel<<<dim3(BN, heads), kThreads, as, st>>>(
        (const bf16*)qkv, (const float*)bias, (const int*)region, (bf16*)att, Hp, Wp, C,
        heads, ws, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  e = gemm(gemm_args(att, C, 0, wproj, C, 0, T, C, C), 1,
           V7ProjAdd{{(const bf16*)x, (const bf16*)bproj, (bf16*)y, C}}, st);
  if (e) return e;

  // K2's five launches on y, the adapter's per stream
  e = gemm(gemm_args(y, C, (long long)Ts * C, aw1, C, (long long)Ca * C, Ts, Ca, C), S,
           V7AdapterUp{{(const bf16*)ab1, (bf16*)ah, Ca, Ts}}, st);
  if (e) return e;
  e = gemm(gemm_args(ah, Ca, (long long)Ts * Ca, aw2, Ca, (long long)C * Ca, Ts, C, Ca), S,
           V7AdapterDown{{(const bf16*)ab2, (const bf16*)b2, (float*)init, C, Ts,
                          adapter_scale}},
           st);
  if (e) return e;
  v7_ln2_kernel<<<ln_grid, kThreads, 0, st>>>((const bf16*)y, (const bf16*)ln2_g,
                                              (const bf16*)ln2_b, (bf16*)xn, T, C, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  e = gemm(gemm_args(xn, C, 0, w1, C, 0, T, hidden, C), 1,
           V7Fc1Out{{(const bf16*)b1, (bf16*)hid, hidden}}, st);
  if (e) return e;
  return gemm(gemm_args(hid, hidden, 0, w2, hidden, 0, T, C, hidden, (const float*)init, C), 1,
              V7Fc2Out{{(const bf16*)y, (bf16*)out, C}}, st);
}
