// Shared device helpers for the port's hand-written Hopper kernels.
//
// tile_gemm is the matrix-product routine of the fused row kernels (K1, K2,
// K11's adapter, K13, K14): a block of 256 threads (8 warps)
// multiplies a bf16 activation tile that already sits in shared memory by a
// slice of a weight matrix streamed from device memory, with WMMA (mma.sync
// 16x16x16, bf16 operands, f32 accumulation), one staging buffer and two
// barriers a 64-deep step.  K5's products run on gemm_mma.cuh's pipelined
// GEMM instead, which sums in tile_gemm's order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace port {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;  // every kernel here runs 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 64;  // output columns per tile_gemm call
constexpr int kBK = 64;  // depth staged per step
constexpr int kLdF = kBN + 4;  // row stride of a (rows, kBN) f32 tile

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

// out_s[bm x 64] (f32, row stride ldo) = (accumulate ? out_s : 0)
//     + A_s[bm x K] (bf16, row stride lda) @ W[0:64, 0:K]^T
//
// W points at row 0 of the 64-row output slice of a row-major (out, in)
// weight (torch Linear layout) with row stride ldw.  Rows >= n_valid and
// columns >= k_valid of W read as zero, so ragged widths (the adapter's
// C/16 hidden) need no padded copy; A_s must hold zeros in those columns.
// K is k_valid rounded up to 16; bm is a multiple of 16, at most 64.
// W_s is a 64 x 64 bf16 staging buffer.  All threads of the block call it.
__device__ void tile_gemm(float* out_s, int ldo, const bf16* A_s, int lda,
                          int bm, const bf16* __restrict__ W, int ldw,
                          int n_valid, int k_valid, int K, bf16* W_s,
                          bool accumulate) {
  const int warp = threadIdx.x / 32;
  const int n_frag = (bm / 16) * (kBN / 16);
  __syncthreads();  // the caller's writes to A_s / out_s are visible
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = warp + i * kWarps;
    if (f < n_frag) {
      float* c = out_s + (f / 4) * 16 * ldo + (f % 4) * 16;
      if (accumulate)
        wmma::load_matrix_sync(acc[i], c, ldo, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc[i], 0.0f);
    }
  }
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // W_s free, A_s/out_s writes of the caller visible
    for (int idx = threadIdx.x; idx < kBN * kBK / 8; idx += kThreads) {
      const int n = idx / (kBK / 8);
      const int kc = (idx % (kBK / 8)) * 8;
      const int k = k0 + kc;
      bf16* dst = W_s + n * kBK + kc;
      if (n < n_valid && k + 8 <= k_valid && (ldw % 8) == 0) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(W + (size_t)n * ldw + k);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (n < n_valid && k + e < k_valid)
                       ? W[(size_t)n * ldw + k + e]
                       : __float2bfloat16(0.0f);
      }
    }
    __syncthreads();
    const int kend = min(kBK, K - k0);
    for (int kk = 0; kk < kend; kk += 16) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int f = warp + i * kWarps;
        if (f < n_frag) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(a, A_s + (f / 4) * 16 * lda + k0 + kk, lda);
          wmma::load_matrix_sync(b, W_s + (f % 4) * 16 * kBK + kk, kBK);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = warp + i * kWarps;
    if (f < n_frag)
      wmma::store_matrix_sync(out_s + (f / 4) * 16 * ldo + (f % 4) * 16,
                              acc[i], ldo, wmma::mem_row_major);
  }
  __syncthreads();
}

// LayerNorm of `rows` bf16 rows into dst (bf16, row stride ld): f32
// statistics, gamma/beta in bf16 as the TPU kernels take them, output
// rounded to bf16.  row_ptr(row) gives row `row0 + r`'s C values, in device
// or shared memory.  Rows >= n_rows and rows flagged by zero_row(row) are
// written as zeros.  One warp per row.
template <typename RowPtr, typename ZeroRow>
__device__ void layer_norm_rows_of(bf16* dst, int ld, RowPtr row_ptr, int row0,
                                   int rows, int n_rows, int C,
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
    const bf16* xr = row_ptr(row);
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

// layer_norm_rows_of on rows of x (bf16, row stride C) in device memory.
template <typename ZeroRow>
__device__ void layer_norm_rows(bf16* dst, int ld, const bf16* __restrict__ x,
                                int row0, int rows, int n_rows, int C,
                                const bf16* __restrict__ gamma,
                                const bf16* __restrict__ beta, float eps,
                                ZeroRow zero_row) {
  layer_norm_rows_of(dst, ld, [=](int row) { return x + (size_t)row * C; },
                     row0, rows, n_rows, C, gamma, beta, eps, zero_row);
}

// LayerNorm of `rows` f32 rows already in shared memory (src, row stride
// lds) into dst (bf16, row stride ld), with the arithmetic of
// layer_norm_rows.  Rows >= n_rows are written as zeros.  One warp per row.
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

// Rows per block for the row-tiled kernels: keeps a (bm, C) bf16 tile plus a
// (bm, C) f32 accumulator well inside shared memory at every Swin-B width.
__host__ __device__ inline int rows_per_block(int C) {
  int bm = 16384 / C;
  if (bm > 64) bm = 64;
  if (bm < 16) bm = 16;
  return bm;
}

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) / 128 * 128; }

}  // namespace port
