// The s8 GEMM of the w8a8 kernels K10 (swin_block_int8.cu) and K11
// (block_tail_int8.cu), written for Hopper, with the output computed by an
// epilogue:
//   out = epilogue(A W^T)
// A (M x K) s8 row-major in device memory (the quantized rows of a whole
// map), W (N x K) s8 in torch Linear layout (out, in), sums in s32.  Both
// operands are K-major, the only layout wgmma takes for 8-bit types, so
// nothing is transposed.
//
// Exactness: an s8 x s8 product summed in s32 is exact, so any order of k,
// tile or instruction gives the same integers; the epilogues around it
// (dequant, gelu_tanh, quantize_rows below and in common.cuh) are the
// expressions of K10's and K11's earlier fused row kernels, so the two
// keep those kernels' bits.  chip_smoke.py holds the raw s32 output (S32Out)
// equal to torch._int_mm's at every product's (M, N, K).
//
// Design: a block takes a BM x 128 output tile.  One producer warp feeds a
// ring of STAGES 128-deep k-slices (128 bytes a row: A's BM rows and W's
// 128 rows) by TMA, each slice's arrival
// counted by an mbarrier (full) and its release by another (empty); BM / 64
// consumer warpgroups each multiply their 64 rows of the slice by W's 128
// with four wgmma.mma_async m64n128k32 s32.s8.s8, the accumulators (64 s32
// a thread) in registers, one wgmma group in flight while the next slice is
// waited for.  TMA writes each slice in the 128-byte swizzle that the wgmma
// descriptors name; rows past M or N and k past K arrive as zeros, which
// add nothing.  The tensor maps are encoded on the host through
// cudaGetDriverEntryPoint (the build links no -lcuda) and passed as
// __grid_constant__ parameters.  Two tiles, chosen by igemm() from the grid
// they give:
//   IgemmBig    128 x 128, two consumer warpgroups, 3 stages (96 KB): where
//               the output has at least one such tile an SM;
//   IgemmSmall  64 x 128, one consumer warpgroup, 4 stages (96 KB): smaller
//               grids (K11's W2 at Swin-B stage 3: M = 1200, N = 1024, 80
//               big tiles for 132 SMs against 152 small).
// Two blocks an SM: the launch bounds hold a big block's thread to 112
// registers, so one block's epilogue runs beside the other's loads and
// products.  K11's W1 passes are bound by their epilogues (the tanh GELU,
// and a true division a code in the quantize pass), not by the tensor
// cores, and ran faster so than at one block an SM.
//
// Bound on an H100: the bytes at K = 128 (A is read once, each output
// written once), the int8 operations at the wider stages (2 K operations
// per output against 1979 Tops): chip_smoke.py's count per kernel.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing is linked)

#include <cstdint>

#include "gemm_mma.cuh"

namespace port {

constexpr int kIgBK = 128;  // k of a staged slice: 128 s8 values, one swizzle row
constexpr int kIgBN = 128;  // output columns of a tile

// ---- mbarriers, TMA and wgmma (sm_90a) ----------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of a 2D tensor map (coordinates: k, row) into shared memory,
// completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// The wgmma descriptor of a K-major operand in the 128-byte swizzle: 8-row
// groups 1024 bytes apart (SBO), the start address in 16-byte units; a step
// of 32 bytes along k adds 2 to it.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128, s32) += A (64 x 32, s8) . B (128 x 32, s8)^T, both from
// shared memory.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---- the kernel ----------------------------------------------------------

// A block's tile: BM x 128, BM / 64 consumer warpgroups and one producer
// warp, STAGES slices in the ring.
template <int BM, int STAGES>
struct IgemmTile {
  static constexpr int BMv = BM, Stages = STAGES, WG = BM / 64;
  static constexpr int Threads = WG * 128 + 32;
  static constexpr int StageBytes = (BM + kIgBN) * kIgBK;
  // the ring, its 2 x STAGES mbarriers, and 1024 bytes to align the ring
  // to the swizzle's 1024-byte period
  static constexpr int Bytes = STAGES * StageBytes + 2 * STAGES * 8 + 1024;
};
using IgemmBig = IgemmTile<128, 3>;
using IgemmSmall = IgemmTile<64, 4>;

// Epilogues.  Each has
//   Row row(r), Col col(c)   what it reads once for row r and for the
//                            columns c, c + 1 (c even): scales, biases;
// and a store epilogue (kRowMax false)
//   operator()(Row, Col, r, c, a0, a1)
// receiving the s32 outputs (r, c) and (r, c + 1), r < M, c < N (N even).
// A row-max epilogue (kRowMax true, K11's max pass) has
//   float2 value(Row, Col, a0, a1)   the f32 values of the two outputs, and
//   void reduce(r, m)                m = max(0, max |value|) over the
//                                    tile's valid columns of row r (fmaxf:
//                                    a NaN value is passed over).

// The scale and bias of output columns c and c + 1, the Col of the
// dequantizing epilogues.
struct ScaleBias {
  float s0, s1, b0, b1;
};
__device__ __forceinline__ ScaleBias scale_bias(const float* s, const bf16* b, int c) {
  return {s[c], s[c + 1], __bfloat162float(b[c]), __bfloat162float(b[c + 1])};
}

// The raw s32 output, which chip_smoke.py holds against torch._int_mm:
struct S32Out {
  static constexpr bool kRowMax = false;
  struct Row {};
  struct Col {};
  int* out;
  int ld;
  __device__ Row row(int) const { return {}; }
  __device__ Col col(int) const { return {}; }
  __device__ void operator()(Row, Col, int r, int c, int a0, int a1) const {
    *reinterpret_cast<int2*>(out + (size_t)r * ld + c) = make_int2(a0, a1);
  }
};

// The kernel: the epilogue's type comes first so that a profiler's kernel
// name tells the launches of a sequence apart (igemm_kernel<Tail8Fc2, ...>).
template <typename Epi, int BM, int STAGES>
__global__ void __launch_bounds__(IgemmTile<BM, STAGES>::Threads, 2)
igemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
             int M, int N, int K, Epi epi) {
  using T = IgemmTile<BM, STAGES>;
  extern __shared__ __align__(1024) unsigned char igemm_smem[];
  unsigned char* ring = igemm_smem + ((1024 - (smem_u32(igemm_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * T::StageBytes);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kIgBN;
  const int KT = (K + kIgBK - 1) / kIgBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * T::WG);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * T::WG) {  // the producer warp: one lane starts the copies
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);  // round 0 passes at once
        unsigned char* a = ring + s * T::StageBytes;
        mbar_expect_tx(&full[s], T::StageBytes);
        tma_load_2d(a, &tm_a, &full[s], kt * kIgBK, m0);
        tma_load_2d(a + BM * kIgBK, &tm_w, &full[s], kt * kIgBK, n0);
      }
    }
    return;
  }

  const int wg = warp / 4;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  fence_acc(acc);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* a = ring + s * T::StageBytes + wg * 64 * kIgBK;
    const unsigned char* w = ring + s * T::StageBytes + BM * kIgBK;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kIgBK; kk += 32)
      wgmma_s8_n128(acc, sw128_desc(a + kk), sw128_desc(w + kk));
    wgmma_commit();
    wgmma_wait<1>();  // slice kt - 1's products are done: release its stage
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator i of a thread: row 16 (warp % 4) + lane / 4 + 8 ((i / 2) % 2),
  // column 8 (i / 4) + 2 (lane % 4) + i % 2 of the warpgroup's 64 x 128
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4, row1 = row0 + 8;
  const int col0 = n0 + 2 * (lane % 4);
  // the rows' values, read once (at a valid row: rows past M are not used)
  const auto rv0 = epi.row(min(row0, M - 1)), rv1 = epi.row(min(row1, M - 1));
  if constexpr (Epi::kRowMax) {
    float m0v = 0.0f, m1v = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
      if (col < N) {
        const auto cv = epi.col(col);
        const float2 v0 = epi.value(rv0, cv, acc[4 * j], acc[4 * j + 1]);
        const float2 v1 = epi.value(rv1, cv, acc[4 * j + 2], acc[4 * j + 3]);
        m0v = fmaxf(m0v, fmaxf(fabsf(v0.x), fabsf(v0.y)));
        m1v = fmaxf(m1v, fmaxf(fabsf(v1.x), fabsf(v1.y)));
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0v = fmaxf(m0v, __shfl_xor_sync(0xffffffffu, m0v, o));
      m1v = fmaxf(m1v, __shfl_xor_sync(0xffffffffu, m1v, o));
    }
    if (lane % 4 == 0) {
      if (row0 < M) epi.reduce(row0, m0v);
      if (row1 < M) epi.reduce(row1, m1v);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
      if (col < N) {
        const auto cv = epi.col(col);
        if (row0 < M) epi(rv0, cv, row0, col, acc[4 * j], acc[4 * j + 1]);
        if (row1 < M) epi(rv1, cv, row1, col, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// The tensor map of an s8 (rows x K) matrix with row stride ld bytes, in
// boxes of 128 bytes of k by box_rows rows, 128-byte swizzle, zeros past
// its edges.
inline bool s8_tensor_map(CUtensorMap* map, const void* base, int rows, int K, int ld,
                          int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)kIgBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Epi, typename T>
inline int igemm_launch(const int8_t* A, int lda, const int8_t* W, int ldw, int M, int N, int K,
                        const Epi& epi, cudaStream_t st) {
  auto kernel = igemm_kernel<Epi, T::BMv, T::Stages>;
  static unsigned allowed = 0;  // devices on which the kernel may take T::Bytes
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(allowed >> dev & 1u)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::Bytes);
    if (err != cudaSuccess) return (int)err;
    allowed |= 1u << dev;
  }
  CUtensorMap tm_a, tm_w;
  if (!s8_tensor_map(&tm_a, A, M, K, lda, T::BMv) || !s8_tensor_map(&tm_w, W, N, K, ldw, kIgBN))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kIgBN - 1) / kIgBN, (M + T::BMv - 1) / T::BMv);
  kernel<<<grid, T::Threads, T::Bytes, st>>>(tm_a, tm_w, M, N, K, epi);
  return (int)cudaGetLastError();
}

// out = epi(A W^T): A (M x K) and W (N x K) s8 with row strides lda and ldw
// bytes (multiples of 16, 16-byte aligned bases, as TMA asks), N even;
// the tile by the grid it gives (header).
template <typename Epi>
inline int igemm(const void* A, int lda, const void* W, int ldw, int M, int N, int K,
                 const Epi& epi, cudaStream_t st) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 2 || lda % 16 || ldw % 16 ||
      reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(W) % 16)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((M + 127) / 128) * ((N + kIgBN - 1) / kIgBN);
  if (tiles >= device_sms())
    return igemm_launch<Epi, IgemmBig>((const int8_t*)A, lda, (const int8_t*)W, ldw, M, N, K,
                                       epi, st);
  return igemm_launch<Epi, IgemmSmall>((const int8_t*)A, lda, (const int8_t*)W, ldw, M, N, K,
                                       epi, st);
}

// ---- the rows around the products ----------------------------------------

// The s8 code of v at scale s: round-half-even(v / s) by true division,
// clamped to +-127.
__device__ __forceinline__ int8_t quantize_code(float v, float s) {
  const int k = __float2int_rn(v / s);
  return static_cast<int8_t>(max(-127, min(127, k)));
}

// Quantize `rows` bf16 rows (src, row stride lds, C columns; shared or
// device memory) to s8 per row: scale = max(max|v|, 1e-12) / 127, q =
// round-half-even(v / scale) by true division, as the TPU kernels do.
// Writes q to dst (row stride ldq) and the scale to scale_s[r].  One warp
// per row.
__device__ void quantize_rows(int8_t* dst, int ldq, float* scale_s, const bf16* src, int lds,
                              int rows, int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    int8_t* q = dst + (size_t)r * ldq;
    const bf16* v = src + (size_t)r * lds;
    float m = 0.0f;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, fabsf(__bfloat162float(v[c])));
    const float s = fmaxf(warp_max(m), 1e-12f) / 127.0f;
    for (int c = lane; c < C; c += 32) q[c] = quantize_code(__bfloat162float(v[c]), s);
    if (lane == 0) scale_s[r] = s;
  }
}

// (acc * s_row) * s_col + b with each step rounded as the plain version
// rounds it (no fused multiply-add).
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col), b);
}

}  // namespace port
