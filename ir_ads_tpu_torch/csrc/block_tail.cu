// K2: the Swin block tail, out = x + FFN(LN2 x) + 0.5 * Adapter(x).
//
// Replaces ir_ads_tpu/ops/pallas_mlp.py:_tail_kernel (launched by
// fused_block_tail_pallas).  x is (N, C) bf16; FFN is C -> 4C -> C with
// tanh GELU and the hidden rounded to bf16 after GELU; the adapter reads x
// itself (not LN x): C -> C/16 (relu, rounded to bf16) -> C.
//
// Bound on an H100: operations.  Per row it does about 16C^2 flops and must
// move 4C bytes (x in, out, bf16): 4C flop per byte, 512 at C = 128, above
// the card's ~295 flop/byte bf16 ridge (chip_smoke.py's count).
//
// Design: five launches, each a grid over all the rows, the four products
// on gemm_mma.cuh's pipelined GEMM with the step's arithmetic as its
// epilogue (a fused row kernel would stream all of W1, W2 and the adapter
// weights again for every row tile):
//   TailAdapterUp    GEMM of x with Wa1 (N = Ca): bf16(relu(acc + ab1));
//   TailAdapterDown  GEMM with Wa2 (K = Ca, rounded up to 16 with zeros):
//                    adapter_scale * (acc + ab2) + b2 in f32, the FFN's init;
//   tail_ln2_kernel  LN2 of x to bf16 (layer_norm_rows, one warp a row);
//   TailFc1          GEMM with W1: bf16(gelu_tanh(acc + b1));
//   TailOut          GEMM with W2 over the whole hidden (K = 4C) from the
//                    adapter's f32 output: out = bf16(x + acc).
// This is the order of the earlier fused form (the adapter into an f32
// tile, then the FFN adding 64 hidden columns at a time into it): each
// epilogue is its expression and gemm_mma.cuh sums each output in its
// order, so K2 kept that form's bits; K5's tail (swin_block_v6.cu) runs the
// same launches on its f32 residual, and K13's (swin_block_v7.cu) on its
// bf16 y.  The adapter's hidden (N, Ca), its f32 output (N, C), the LN
// output (N, C) and the FFN hidden (N, 4C: 79 MB at stage 0 of 4 images)
// make one round trip through device memory; the wrapper allocates them.
#include "gemm_epilogues.cuh"

using namespace port;

namespace {

constexpr int kLnRows = kWarps;  // rows a block of the LN launch: one a warp

// K2's epilogues, named apart from K5's on the r5 path (gemm_epilogues.cuh)
struct TailAdapterUp : AdapterUp {};
struct TailAdapterDown : AdapterDown {};
struct TailFc1 : Fc1Out {};

__global__ void __launch_bounds__(kThreads)
tail_ln2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                const bf16* __restrict__ b, bf16* __restrict__ xn, int T, int C, float eps) {
  const int row0 = blockIdx.x * kLnRows;
  layer_norm_rows(xn + (size_t)row0 * C, C, x, row0, min(kLnRows, T - row0), T, C, g, b, eps,
                  [](int) { return false; });
}

}  // namespace

// x, out (T, C) bf16; the parameters bf16 in torch Linear layout (w1 (H,
// C), w2 (C, H), aw1 (Ca, C), aw2 (C, Ca)); the intermediates: ah (T, Ca)
// bf16, init (T, C) f32, xn (T, C) bf16, hid (T, H) bf16.  C, H and Ca even.
extern "C" int block_tail(const void* x, const void* ln_g, const void* ln_b,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* aw1, const void* ab1,
                          const void* aw2, const void* ab2, void* ah, void* init,
                          void* xn, void* hid, void* out, int T, int C, int H, int Ca,
                          float eps, float adapter_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = gemm(gemm_args(x, C, 0, aw1, C, 0, T, Ca, C), 1,
               TailAdapterUp{{(const bf16*)ab1, (bf16*)ah, Ca, T}}, st);
  if (e) return e;
  e = gemm(gemm_args(ah, Ca, 0, aw2, Ca, 0, T, C, Ca), 1,
           TailAdapterDown{{(const bf16*)ab2, (const bf16*)b2, (float*)init, C, T,
                            adapter_scale}},
           st);
  if (e) return e;
  tail_ln2_kernel<<<(T + kLnRows - 1) / kLnRows, kThreads, 0, st>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (bf16*)xn, T, C, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  e = gemm(gemm_args(xn, C, 0, w1, C, 0, T, H, C), 1,
           TailFc1{{(const bf16*)b1, (bf16*)hid, H}}, st);
  if (e) return e;
  return gemm(gemm_args(hid, H, 0, w2, H, 0, T, C, H, (const float*)init, C), 1,
              TailOut{(const bf16*)x, (bf16*)out, C}, st);
}
