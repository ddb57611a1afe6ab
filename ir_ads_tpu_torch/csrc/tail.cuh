// Device code shared by the two kernels that compute the Swin block tail
// on a row tile, K2 (block_tail.cu) and K13 (swin_block_v7.cu):
//   out = y + FFN(LN2 y) + adapter_scale * Adapter(y)
// on a tile of bm rows held in shared memory.  Both steps accumulate into a
// (bm, C) f32 tile acc_s; the FFN's 4C-wide hidden never leaves shared
// memory: it is produced and consumed 64 columns at a time.
#pragma once

#include "common.cuh"

namespace port {

// Scratch of the tail steps besides the caller's tiles: F_s (bm, kLdF) f32,
// H_s (bm, kBN + 8) bf16 and W_s (kBN, kBK) bf16.
struct TailScratch {
  float* F_s;
  bf16* H_s;
  bf16* W_s;
};

inline size_t tail_scratch_bytes(int bm) {
  return align128((size_t)bm * kLdF * 4) + align128((size_t)bm * (kBN + 8) * 2) +
         (size_t)kBN * kBK * 2;
}

__device__ inline TailScratch tail_scratch(unsigned char* p, int bm) {
  TailScratch s;
  s.F_s = reinterpret_cast<float*>(p);
  p += align128((size_t)bm * kLdF * 4);
  s.H_s = reinterpret_cast<bf16*>(p);
  p += align128((size_t)bm * (kBN + 8) * 2);
  s.W_s = reinterpret_cast<bf16*>(p);
  return s;
}

// acc = adapter_scale * (relu(A Wa1^T + ab1) Wa2^T + ab2) + b2, the hidden
// rounded to bf16 after relu.  A_s (bm, C) bf16 is the adapter's input (the
// block's residual stream, not LN of it); Ca <= 64.  b2 is the FFN's output
// bias, folded in here so the FFN steps only accumulate.
__device__ void adapter_into(float* acc_s, int ldacc, const bf16* A_s, int lda,
                             TailScratch t, int bm, int C, int Ca,
                             const bf16* __restrict__ aw1,
                             const bf16* __restrict__ ab1,
                             const bf16* __restrict__ aw2,
                             const bf16* __restrict__ ab2,
                             const bf16* __restrict__ b2, float adapter_scale) {
  const int ldh = kBN + 8;
  tile_gemm(t.F_s, kLdF, A_s, lda, bm, aw1, C, Ca, C, C, t.W_s, false);
  for (int idx = threadIdx.x; idx < bm * kBN; idx += kThreads) {
    const int r = idx / kBN, col = idx % kBN;
    const float v = col < Ca ? fmaxf(t.F_s[r * kLdF + col] + __bfloat162float(ab1[col]), 0.0f) : 0.0f;
    t.H_s[r * ldh + col] = __float2bfloat16(v);
  }
  const int Ka = (Ca + 15) / 16 * 16;
  for (int n0 = 0; n0 < C; n0 += kBN)
    tile_gemm(acc_s + n0, ldacc, t.H_s, ldh, bm, aw2 + (size_t)n0 * Ca, Ca, kBN,
              Ca, Ka, t.W_s, false);
  for (int idx = threadIdx.x; idx < bm * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    float* a = acc_s + r * ldacc + c;
    *a = adapter_scale * (*a + __bfloat162float(ab2[c])) + __bfloat162float(b2[c]);
  }
}

// acc += gelu(A W1^T + b1) W2^T, 64 hidden columns at a time, the hidden
// rounded to bf16 after the tanh GELU.  A_s (bm, C) bf16 holds LN2 of the
// residual stream.
__device__ void ffn_accumulate(float* acc_s, int ldacc, const bf16* A_s,
                               int lda, TailScratch t, int bm, int C, int H,
                               const bf16* __restrict__ w1,
                               const bf16* __restrict__ b1,
                               const bf16* __restrict__ w2) {
  const int ldh = kBN + 8;
  for (int j0 = 0; j0 < H; j0 += kBN) {
    tile_gemm(t.F_s, kLdF, A_s, lda, bm, w1 + (size_t)j0 * C, C, kBN, C, C,
              t.W_s, false);
    for (int idx = threadIdx.x; idx < bm * kBN; idx += kThreads) {
      const int r = idx / kBN, col = idx % kBN;
      t.H_s[r * ldh + col] = __float2bfloat16(
          gelu_tanh(t.F_s[r * kLdF + col] + __bfloat162float(b1[j0 + col])));
    }
    for (int n0 = 0; n0 < C; n0 += kBN)
      tile_gemm(acc_s + n0, ldacc, t.H_s, ldh, bm, w2 + (size_t)n0 * H + j0, H,
                kBN, kBN, kBN, t.W_s, true);
  }
}

}  // namespace port
