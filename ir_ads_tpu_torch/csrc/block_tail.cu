// K2: the Swin block tail, out = x + FFN(LN2 x) + 0.5 * Adapter(x).
//
// Replaces ir_ads_tpu/ops/pallas_mlp.py:_tail_kernel (launched by
// fused_block_tail_pallas).  x is (N, C) bf16; FFN is C -> 4C -> C with
// tanh GELU and the hidden rounded to bf16 after GELU; the adapter reads x
// itself (not LN x): C -> C/16 (relu, rounded to bf16) -> C.
//
// Bound on an H100: operations.  Per row it does about 16C^2 flops and must
// move 4C bytes (x in, out, bf16): 4C flop per byte, 512 at C = 128, above
// the card's ~295 flop/byte bf16 ridge (chip_smoke.py's count).  Design: one
// block per tile of bm rows.  The (bm, C) f32 output accumulator and the
// (bm, C) bf16 activation tile live in shared memory; the 4C-wide hidden is
// produced and consumed 64 columns at a time (one WMMA product with a slice
// of W1, GELU, then a WMMA product with the matching slice of W2 that
// accumulates into the output tile), so it never reaches device memory.
// Every weight is streamed once per row tile (from L2 for all but the first
// tiles).  The adapter and FFN steps are shared with K5 (tail.cuh).
#include "tail.cuh"

using namespace port;

namespace {

__global__ void __launch_bounds__(kThreads)
block_tail_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  const bf16* __restrict__ b, const bf16* __restrict__ w1,
                  const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ b2, const bf16* __restrict__ aw1,
                  const bf16* __restrict__ ab1, const bf16* __restrict__ aw2,
                  const bf16* __restrict__ ab2, bf16* __restrict__ out, int T,
                  int C, int H, int Ca, float eps, float adapter_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bm = rows_per_block(C);
  const int lda = C + 8, ldacc = C + 4;
  unsigned char* p = smem;
  bf16* A_s = reinterpret_cast<bf16*>(p);
  p += align128((size_t)bm * lda * 2);
  float* acc_s = reinterpret_cast<float*>(p);
  p += align128((size_t)bm * ldacc * 4);
  const TailScratch t = tail_scratch(p, bm);
  const int row0 = blockIdx.x * bm;

  // adapter branch on x itself: acc = adapter_scale * (relu(x Wa1 + ab1) Wa2 + ab2) + b2
  for (int idx = threadIdx.x; idx < bm * C; idx += kThreads) {
    const int r = idx / C, c = idx % C, row = row0 + r;
    A_s[r * lda + c] = row < T ? x[(size_t)row * C + c] : __float2bfloat16(0.0f);
  }
  adapter_into(acc_s, ldacc, A_s, lda, t, bm, C, Ca, aw1, ab1, aw2, ab2, b2,
               adapter_scale);

  // LN2 -> A_s, then the FFN 64 hidden columns at a time, accumulated
  layer_norm_rows(A_s, lda, x, row0, bm, T, C, g, b, eps,
                  [](int) { return false; });
  ffn_accumulate(acc_s, ldacc, A_s, lda, t, bm, C, H, w1, b1, w2);

  for (int idx = threadIdx.x; idx < bm * C; idx += kThreads) {
    const int r = idx / C, c = idx % C, row = row0 + r;
    if (row < T) {
      const size_t o = (size_t)row * C + c;
      out[o] = __float2bfloat16(__bfloat162float(x[o]) + acc_s[r * ldacc + c]);
    }
  }
}

}  // namespace

extern "C" int block_tail(const void* x, const void* ln_g, const void* ln_b,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* aw1, const void* ab1,
                          const void* aw2, const void* ab2, void* out, int T,
                          int C, int H, int Ca, float eps, float adapter_scale,
                          void* stream) {
  const int bm = rows_per_block(C);
  const size_t smem = align128((size_t)bm * (C + 8) * 2) +
                      align128((size_t)bm * (C + 4) * 4) + tail_scratch_bytes(bm);
  cudaFuncSetAttribute(block_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  block_tail_kernel<<<(T + bm - 1) / bm, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (const bf16*)w1,
      (const bf16*)b1, (const bf16*)w2, (const bf16*)b2, (const bf16*)aw1,
      (const bf16*)ab1, (const bf16*)aw2, (const bf16*)ab2, (bf16*)out, T, C,
      H, Ca, eps, adapter_scale);
  return (int)cudaGetLastError();
}
