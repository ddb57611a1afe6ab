// Shared device helpers for the port's hand-written Hopper kernels: warp
// reductions, bf16 rounding, the tanh GELU and the LayerNorms of rows.  The
// bf16 products of the Swin blocks (K1, K2, K5, K13, K14) and K11's
// adapter run on gemm_mma.cuh's pipelined GEMM, the s8 products of K10 and
// K11 on igemm.cuh, the window attention on window_mma.cuh (its first
// design on window_block.cuh's WMMA tiles).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace port {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;  // every kernel here runs 8 warps per block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// tanh-approximate GELU (flax nn.gelu default), in f32.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// LayerNorm of `rows` bf16 rows of x (row stride C, in device memory) into
// dst (bf16, row stride ld): f32 statistics, gamma/beta in bf16 as the TPU
// kernels take them, output rounded to bf16.  Row r of dst is x's row
// `row0 + r`; rows >= n_rows and rows flagged by zero_row(row) are written
// as zeros.  One warp per row.
template <typename ZeroRow>
__device__ void layer_norm_rows(bf16* dst, int ld, const bf16* __restrict__ x,
                                int row0, int rows, int n_rows, int C,
                                const bf16* __restrict__ gamma,
                                const bf16* __restrict__ beta, float eps,
                                ZeroRow zero_row) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const int row = row0 + r;
    bf16* out = dst + r * ld;
    if (row >= n_rows || zero_row(row)) {
      for (int c = lane; c < C; c += 32) out[c] = __float2bfloat16(0.0f);
      continue;
    }
    const bf16* xr = x + (size_t)row * C;
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) s += __bfloat162float(xr[c]);
    const float mu = warp_sum(s) / C;
    float v = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = __bfloat162float(xr[c]) - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + eps);
    for (int c = lane; c < C; c += 32) {
      const float d = (__bfloat162float(xr[c]) - mu) * rstd;
      out[c] = __float2bfloat16(d * __bfloat162float(gamma[c]) +
                                __bfloat162float(beta[c]));
    }
  }
}

// LayerNorm of `rows` f32 rows (src, row stride lds) into dst (bf16, row
// stride ld), with the arithmetic of layer_norm_rows.  Rows >= n_rows are written as zeros.  One warp per row.
__device__ void layer_norm_tile(bf16* dst, int ld, const float* src, int lds,
                                int rows, int n_rows, int C,
                                const bf16* __restrict__ gamma,
                                const bf16* __restrict__ beta, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    bf16* out = dst + r * ld;
    if (r >= n_rows) {
      for (int c = lane; c < C; c += 32) out[c] = __float2bfloat16(0.0f);
      continue;
    }
    const float* xr = src + r * lds;
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) s += xr[c];
    const float mu = warp_sum(s) / C;
    float v = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = xr[c] - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + eps);
    for (int c = lane; c < C; c += 32) {
      const float d = (xr[c] - mu) * rstd;
      out[c] = __float2bfloat16(d * __bfloat162float(gamma[c]) +
                                __bfloat162float(beta[c]));
    }
  }
}

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) / 128 * 128; }

}  // namespace port
