// A bf16 GEMM for the card with the output computed by an epilogue:
//   out = epilogue(C_init + A W^T)
// A (M x K) bf16 row-major in device memory, W (N x K) bf16 in torch Linear
// layout (out, in), C_init (M x N) f32 or none; batched over gridDim.z
// (batch z offsets A, W and C_init by their batch strides and is handed to
// the epilogue).  K5 (swin_block_v6.cu) runs its six products on it.
//
// Order of the sums: each output is one f32 accumulator in registers,
// starting from C_init (or +0) and taking the 16-deep mma.sync m16n8k16
// steps of k in ascending order, with no split of k and no reordered
// reduction.  tile_gemm (common.cuh) sums in that order too (a WMMA
// 16x16x16 bf16 step is two of the same HMMA instructions), so a product
// moved from tile_gemm to this GEMM keeps its bits wherever the epilogue
// is written as the same expression and compiled with the same flags.
// Past the valid rows of A and W and past K, the operands read as zero;
// k steps past K rounded up to 16 are not taken.
//
// Design: a block takes a BM x BN output tile, its warps (2 x WGN) each a
// (BM / 2) x (BN / WGN) sub-tile of f32 accumulators in registers.  A and W
// tiles of 64-deep k slices arrive by cp.async in a ring of STAGES
// (16-byte pieces; the rows padded to 72 bf16, so ldmatrix meets no bank
// conflict), the next slices in flight while one is multiplied, with one
// block barrier a slice; the operands go from shared memory to registers
// by ldmatrix.  Ragged pieces (rows past M or N, k past K, a row stride
// that is not a multiple of 8) are written by the threads themselves,
// zero-filled.  Two tiles, chosen by gemm() from the grid they give:
//   Big    128 x 128, 8 warps of 64 x 32, 3 stages (108 KB): where the
//          output has at least one such tile an SM;
//   Small  64 x 64, 4 warps of 32 x 32, 4 stages (72 KB): smaller grids
//          (M = 1200 at Swin-B stage 3 and N = 1024: 80 big tiles for 132
//          SMs against 304 small; the adapter's N = C / 16).
// Both run two blocks an SM or more (ptxas: 94 and 56 registers a thread,
// no spills).  Of twelve tile shapes, depths and
// warp layouts tried on K5's products at stages 2 and 3 on an H100, these
// two took the least time.  torch.matmul (cuBLAS on wgmma) computes the
// same products several times faster (chip_smoke.py prints both by
// launch): mma.sync is not the card's fastest path.
//
// Bound on an H100: operations at the Swin-B widths (K = C >= 512: 2 K
// flops per output against 2 bytes of A and W each per k).
#pragma once

#include "mma.cuh"

namespace port {

// One GEMM: operands, strides (elements) and sizes.  vec_a and vec_w say
// that the operand's rows may be read in aligned 16-byte pieces (the
// pointer, row stride and batch stride multiples of 8 elements).
struct GemmArgs {
  const bf16* A;
  const bf16* W;
  const float* init;  // C_init or nullptr
  long long a_z, w_z, c_z;
  int lda, ldw, ldc;
  int M, N, K;
  bool vec_a, vec_w;
};

constexpr int kGemmBK = 64;           // depth of a staged slice
constexpr int kGemmLd = kGemmBK + 8;  // row stride of a staged slice, bf16

// A block's tile: BM x BN, 2 x WGN warps, STAGES slices in the ring.
template <int BM, int BN, int WGN, int STAGES>
struct GemmTile {
  static constexpr int BMv = BM, BNv = BN, Stages = STAGES, Threads = 64 * WGN;
  static constexpr int WM = BM / 2, WN = BN / WGN;  // a warp's sub-tile
  static constexpr int MF = WM / 16, NF = WN / 8;   // its m16 and n8 fragments
  static constexpr int StageElems = (BM + BN) * kGemmLd;
  static constexpr int Bytes = STAGES * StageElems * 2;
};
using GemmBig = GemmTile<128, 128, 4, 3>;
using GemmSmall = GemmTile<64, 64, 2, 4>;

// ROWS x kGemmBK of src (rows row0.., k0..) into a staged slice: 16-byte
// cp.async pieces, zeros past rows_valid and K, the ragged piece by hand.
template <int ROWS, int THREADS>
__device__ __forceinline__ void gemm_stage_rows(bf16* dst, const bf16* __restrict__ src, int ld,
                                                int row0, int rows_valid, int k0, int K,
                                                bool vec) {
  constexpr int CH = kGemmBK / 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, kc = (c % CH) * 8;
    const int row = row0 + r, k = k0 + kc;
    bf16* d = dst + r * kGemmLd + kc;
    const bf16* s = src + (size_t)row * ld + k;
    if (row >= rows_valid || k >= K) {
      *reinterpret_cast<uint4*>(d) = uint4{0u, 0u, 0u, 0u};
    } else if (vec && k + 8 <= K) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = k + e < K ? s[e] : __float2bfloat16(0.0f);
    }
  }
}

// The kernel: the epilogue's type comes first so that a profiler's kernel
// name tells the launches of a sequence apart (gemm_kernel<QkvOut, ...>);
// the tile (GemmTile) follows.
// epi(z, row, col, v0, v1) receives the outputs (row, col) and (row, col +
// 1) of batch z, row < M and col < N (N is even).
template <typename Epi, int BM, int BN, int WGN, int STAGES>
__global__ void __launch_bounds__(64 * WGN)
gemm_kernel(GemmArgs g, Epi epi) {
  using T = GemmTile<BM, BN, WGN, STAGES>;
  constexpr int kStages = STAGES;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  bf16* ring = reinterpret_cast<bf16*>(gemm_smem);
  const int z = blockIdx.z;
  const bf16* A = g.A + z * g.a_z;
  const bf16* W = g.W + z * g.w_z;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int K16 = (g.K + 15) / 16 * 16, KT = (K16 + kGemmBK - 1) / kGemmBK;

  auto load = [&](int kt) {
    bf16* st = ring + (kt % kStages) * T::StageElems;
    gemm_stage_rows<BM, T::Threads>(st, A, g.lda, m0, g.M, kt * kGemmBK, g.K, g.vec_a);
    gemm_stage_rows<BN, T::Threads>(st + BM * kGemmLd, W, g.ldw, n0, g.N, kt * kGemmBK, g.K,
                                    g.vec_w);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane >> 2, t = lane & 3;
  const int wm = (warp / WGN) * T::WM, wn = (warp % WGN) * T::WN;
  float acc[T::MF][T::NF][4];
  const float* init = g.init ? g.init + z * g.c_z : nullptr;
#pragma unroll
  for (int mi = 0; mi < T::MF; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NF; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + 16 * mi + gr + 8 * h, col = n0 + wn + 8 * ni + 2 * t;
        float2 v = make_float2(0.0f, 0.0f);
        if (init && row < g.M && col < g.N)
          v = *reinterpret_cast<const float2*>(init + (size_t)row * g.ldc + col);
        acc[mi][ni][2 * h] = v.x;
        acc[mi][ni][2 * h + 1] = v.y;
      }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed (this thread's part)
    __syncthreads();               // ... everyone's, and slice kt - 1 is spent
    if (kt + kStages - 1 < KT) load(kt + kStages - 1);
    cp_async_commit();
    const bf16* As = ring + (kt % kStages) * T::StageElems;
    const bf16* Ws = As + BM * kGemmLd;
#pragma unroll
    for (int kk = 0; kk < kGemmBK; kk += 16) {
      if (kt * kGemmBK + kk >= K16) break;
      unsigned a[T::MF][4], b[T::NF][2];
#pragma unroll
      for (int mi = 0; mi < T::MF; ++mi)
        ldsm_x4(a[mi], As + (wm + 16 * mi + (lane & 15)) * kGemmLd + kk + (lane >> 4) * 8);
#pragma unroll
      for (int ni = 0; ni < T::NF; ni += 2) {
        unsigned r[4];
        ldsm_x4(r, Ws + (wn + 8 * ni + (lane & 7) + ((lane >> 4) << 3)) * kGemmLd + kk +
                       ((lane >> 3) & 1) * 8);
        b[ni][0] = r[0], b[ni][1] = r[1], b[ni + 1][0] = r[2], b[ni + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < T::MF; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NF; ++ni) mma_k16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < T::MF; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NF; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + 16 * mi + gr + 8 * h, col = n0 + wn + 8 * ni + 2 * t;
        if (row < g.M && col < g.N) epi(z, row, col, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
}

template <typename Epi, typename T>
inline int gemm_launch(const GemmArgs& g, int batches, const Epi& epi, cudaStream_t st) {
  constexpr int BM = T::BMv, BN = T::BNv;
  auto kernel = gemm_kernel<Epi, BM, BN, T::Threads / 64, T::Stages>;
  static unsigned allowed = 0;  // devices on which the kernel may take T::Bytes
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(allowed >> dev & 1u)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::Bytes);
    if (err != cudaSuccess) return (int)err;
    allowed |= 1u << dev;
  }
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, batches);
  kernel<<<grid, T::Threads, T::Bytes, st>>>(g, epi);
  return (int)cudaGetLastError();
}

// The SMs of the current device, asked once a device.
inline int device_sms() {
  static int sms[32] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (!sms[dev]) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// Launches the GEMM with the tile that suits its size (header).  N must be
// even; rows of A, W and C_init are read as the strides say.
template <typename Epi>
inline int gemm(const GemmArgs& g, int batches, const Epi& epi, cudaStream_t st) {
  if (g.N % 2 || g.M <= 0 || g.N <= 0 || g.K <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((g.M + 127) / 128) * ((g.N + 127) / 128) * batches;
  if (tiles >= device_sms()) return gemm_launch<Epi, GemmBig>(g, batches, epi, st);
  return gemm_launch<Epi, GemmSmall>(g, batches, epi, st);
}

}  // namespace port
