// Int8 tensor-core product of the w8a8 kernels, K10 (swin_block_int8.cu)
// and K11 (block_tail_int8.cu).
//
// tile_igemm is the s8 counterpart of common.cuh's tile_gemm: a block of 256
// threads (8 warps) multiplies an s8 activation tile that already sits in
// shared memory by a 64-row slice of an s8 weight streamed from device
// memory, with mma.sync.m16n8k32 (s8 operands, s32 accumulation, exact).
// Each warp owns pieces of 16 rows x 8 columns and keeps their sums in
// registers over the whole depth.  No TMA, no wgmma, one staging buffer:
// the simple form, correct for every shape of the slice.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace port {

constexpr int kIBK = 128;          // depth of the weight staged per step
constexpr int kLdWs = kIBK + 16;   // its row stride: rows 4 banks apart
constexpr int kLdI = kBN + 4;      // row stride of a (rows, kBN) int32 tile

__device__ __forceinline__ uint32_t ld_s32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16 x 32, row-major) . b (32 x 8, column-major), s8 -> s32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out_s[bm x 64] (int32, row stride ldo) = A_s[bm x K] (s8, row stride lda)
//     @ W[0:64, 0:K]^T
//
// W points at row 0 of the 64-row output slice of a row-major (out, in) s8
// weight with row stride ldw; rows >= n_valid read as zero.  bm is a
// multiple of 16, at most 64; K a multiple of 32; lda a multiple of 16 and
// ldw a multiple of 16 (16-byte staging loads).  W_s holds 64 x kLdWs bytes.
// All threads of the block call it.
__device__ void tile_igemm(int* out_s, int ldo, const int8_t* A_s, int lda,
                           int bm, const int8_t* __restrict__ W, int ldw,
                           int n_valid, int K, int8_t* W_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_pieces = (bm / 16) * (kBN / 8);
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kIBK) {
    const int kend = min(kIBK, K - k0);
    __syncthreads();  // W_s free, the caller's writes to A_s and out_s done
    for (int idx = threadIdx.x; idx < kBN * (kIBK / 16); idx += kThreads) {
      const int n = idx / (kIBK / 16), kc = (idx % (kIBK / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < n_valid && kc < kend)
        v = *reinterpret_cast<const uint4*>(W + (size_t)n * ldw + k0 + kc);
      *reinterpret_cast<uint4*>(W_s + n * kLdWs + kc) = v;
    }
    __syncthreads();
    for (int kk = 0; kk < kend; kk += 32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = warp + i * kWarps;
        if (p < n_pieces) {
          const int m0 = (p / (kBN / 8)) * 16, n0 = (p % (kBN / 8)) * 8;
          const int8_t* a = A_s + (m0 + g) * lda + k0 + kk + t * 4;
          const uint32_t af[4] = {ld_s32(a), ld_s32(a + 8 * lda), ld_s32(a + 16),
                                  ld_s32(a + 8 * lda + 16)};
          const int8_t* b = W_s + (n0 + g) * kLdWs + kk + t * 4;
          const uint32_t bf[2] = {ld_s32(b), ld_s32(b + 16)};
          mma_s8(acc[i], af, bf);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = warp + i * kWarps;
    if (p < n_pieces) {
      const int m0 = (p / (kBN / 8)) * 16, n0 = (p % (kBN / 8)) * 8;
      int* o = out_s + (m0 + g) * ldo + n0 + t * 2;
      o[0] = acc[i][0];
      o[1] = acc[i][1];
      o[8 * ldo] = acc[i][2];
      o[8 * ldo + 1] = acc[i][3];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Quantize `rows` f32 or bf16 rows of a shared tile (src, row stride lds,
// C columns) to s8 per row: scale = max(max|v|, 1e-12) / 127, q =
// round-half-even(v / scale) by true division, as the TPU kernels do.
// Writes q to dst (row stride ldq) and the scale to scale_s[r]; rows >=
// n_valid are written as zeros with scale 1.  One warp per row.
template <typename T>
__device__ void quantize_rows(int8_t* dst, int ldq, float* scale_s,
                              const T* src, int lds, int rows, int n_valid,
                              int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    int8_t* q = dst + r * ldq;
    if (r >= n_valid) {
      for (int c = lane; c < C; c += 32) q[c] = 0;
      if (lane == 0) scale_s[r] = 1.0f;
      continue;
    }
    const T* v = src + (size_t)r * lds;
    float m = 0.0f;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, fabsf(to_f32(v[c])));
    const float s = fmaxf(warp_max(m), 1e-12f) / 127.0f;
    for (int c = lane; c < C; c += 32) {
      const int k = __float2int_rn(to_f32(v[c]) / s);
      q[c] = static_cast<int8_t>(max(-127, min(127, k)));
    }
    if (lane == 0) scale_s[r] = s;
  }
}

// (acc * s_row) * s_col + b with each step rounded as the plain version
// rounds it (no fused multiply-add).
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col,
                                         float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col), b);
}

}  // namespace port
