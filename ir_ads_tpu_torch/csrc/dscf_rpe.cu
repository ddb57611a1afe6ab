// K3, K6 and K18: the DSCF continuous relative-position bias, the bilinear
// sample of table[bg % G, e] at the displacement between query pixel (r, c)
// and deformable key j, in three layouts and two roundings:
//   K3  dscf_rpe_rows    bias[bg, e, r, j, c]  (BG, hg, h, M, w), levels 0-2;
//   K6  dscf_rpe_packed  bias[bg, e, j, r*w+c] (BG, hg, M, h*w), level 3,
//                        where the einsum attention adds it to its scores;
//   K18 dscf_rpe_jmajor  bias[bg, e, j, r, c]  (BG, hg, M, h, w), the same
//                        memory order as K6's, in the f32 form below
//                        (the pallas2 DSCF, every level).
//
// K3 and K6 replace ir_ads_tpu/ops/pallas_dscf_rpe.py:_rpe_rows_kernel
// (launched by dscf_rpe_bias_rows_pallas) and _rpe_packed_kernel (launched
// by dscf_rpe_bias_packed_pallas).  The TPU kernels write the bilinear form
// as two dense hat-weight products because its matrix unit wants dense
// work, and in bf16 round where a bf16 product would: the hat weights
// max(0, 1 - |(ay*r - s) + by|) (that f32 order), the table and the partial
// product u[s] = sum_t wx[t] T[s, t] go to bf16 before their f32 sums, the
// output once.  rpe_sample (csrc/dscf.cuh, shared with K16) computes the
// same in the 2 x 2-tap form, bit for bit.
//
// K18 replaces _rpe_kernel (launched by dscf_rpe_bias_pallas), which rounds
// differently: its hat weights max(0, 1 - |(ay*r + by) - s|) (another f32
// order), the table and u stay f32 whatever it stores, and the output is
// rounded once.  The sequence of its first CUDA form (ops/
// dscf_rpe_jmajor.py rpe_bias_jmajor_ordered writes it out in torch): four
// taps an axis from floor(x) - 1, a tap off the table or of weight 0
// skipped, u = sum over the x taps of wx * T[s, t] from +0 in tap order,
// acc = sum over the y taps of wy * u from +0 in tap order, each product
// and sum rounded (__fmul_rn, __fadd_rn: no multiply-add contracted), the
// output rounded once.  XLA's and cuBLAS's f32 dots may fuse a multiply-add,
// so the einsum plain version can sit an f32 ulp away before the rounding,
// and an output near a bf16 rounding boundary then lands one bf16 ulp
// apart.
//
// Throughout, the index arithmetic is written with __fmul_rn / __fsub_rn /
// __fadd_rn: nvcc -O3 would contract a*r - s into an FMA, skip the
// product's rounding, and one f32 ulp in a weight can flip its bf16
// rounding.  ay and ax come from the host, rounded once from double as the
// TPU kernels' Python constants are.
//
// Bound on an H100: bytes (the bf16 output: a few dozen flops per 2-byte
// output, table reads hit the cache).  K3 and K6: one thread per output
// element, consecutive threads along the minor output axis (the query
// column c for K3, the flat query pixel for K6), so stores coalesce.
//
// K18 (rpe_jmajor_kernel) writes 184 MB at level 0, where its first form, a
// thread an output that searched 16 taps through guarded loads, found its
// (bg, e, j, r, c) by 64-bit divisions and shared nothing with its
// neighbours, ran at 5 % of the memory rate.  Its sample is separable: with
// x = (a*i + b) rounded, the outer taps floor(x) - 1 and floor(x) + 2 lie
// at an exact distance of 1 or more, which rounds to 1 or more, so their
// weights are exactly 0 and the search comes down to the two middle taps
// of each axis.  A tap off the table, or of weight 0, adds w * T = +-0 (the
// table is finite) to a sum that started at +0 and is never -0, which
// leaves the sum as skipping it does: the kernel reads a clamped index for
// it under weight 0, and computes each output as
//   u(s) = (+0 + wx1 T[s, x1]) + wx2 T[s, x1 + 1],
//   acc  = (+0 + wy1 u(y1)) + wy2 u(y1 + 1),
// bit for bit the search (phase 3 holds it so at levels 0-3).  Design: a
// block of 16 warps per (bg, e) plane (gridDim.y) and band of keys, two
// blocks an SM, the f32 table plane (75.7 KB at 119 x 159) staged once by
// cp.async; a warp takes (key, 32 consecutive columns), so everything that
// depends on the key is uniform across it: the y taps and weights of each
// row, computed once, a lane a row, 32 rows at a time, into the warp's
// shared table; each lane's x taps and weights, once, in registers.  Rows
// go eight at a time, branch-free: where no row of the eight has a first
// tap row new against the last row's two (ay <= 1 at levels 0-1, so most
// groups), that row's u(s) is carried over and only the second tap row's
// computed; elsewhere (a key's first rows; every row at levels 2-3, where
// ay > 1) both.  The eight rows go through shared memory, and each lane
// stores 8 consecutive columns of a row as one 16-byte store (as 8-byte
// stores, or element by element, at a ragged or unaligned edge: level 3's
// planes of 15 x 20 start 8-byte aligned).  No integer division is left in
// the inner loop.
#include "dscf.cuh"

using namespace port;

namespace {

// Rows layout (BG, hg, h, M, w).
__global__ void __launch_bounds__(kThreads)
rpe_rows_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                bf16* __restrict__ out, long long total, int G, int hg, int h,
                int M, int w, int s1, int s2, float ay, float ax) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % w);
  long long t = idx / w;
  const int j = (int)(t % M);
  t /= M;
  const int r = (int)(t % h);
  t /= h;
  const int e = (int)(t % hg);
  const int bg = (int)(t / hg);
  out[idx] = __float2bfloat16(
      rpe_sample(pos, table, bg, e, j, r, c, G, hg, M, s1, s2, ay, ax));
}

// Packed layout (BG, hg, M, h*w): the query plane flat and minor.
__global__ void __launch_bounds__(kThreads)
rpe_packed_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                  bf16* __restrict__ out, long long total, int G, int hg, int h,
                  int M, int w, int s1, int s2, float ay, float ax) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int hw = h * w;
  const int q = (int)(idx % hw);
  long long t = idx / hw;
  const int j = (int)(t % M);
  t /= M;
  const int e = (int)(t % hg);
  const int bg = (int)(t / hg);
  out[idx] = __float2bfloat16(
      rpe_sample(pos, table, bg, e, j, q / w, q % w, G, hg, M, s1, s2, ay, ax));
}

// max(0, 1 - |v - i|) in f32, v = (a*i' + b) rounded: _rpe_kernel's hat
// weight of tap i, unrounded.
__device__ __forceinline__ float hat_f32(float v, int i) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(v, (float)i))));
}

// The two middle y taps of one (key, query row): the table offsets of
// their rows (clamped onto the table) and their weights (0 off the table).
struct __align__(16) YTaps {
  int o1, o2;
  float w1, w2;
};

constexpr int kJWarps = 16;  // two blocks an SM: 32 warps
constexpr int kJThreads = 32 * kJWarps;
constexpr int kJRows = 8;  // rows a warp stages before its 16-byte stores

// The y taps of query row r for the key whose origin row is by.
__device__ __forceinline__ YTaps y_taps(float ay, int r, float by, int s1, int s2) {
  const float yv = __fadd_rn(__fmul_rn(ay, (float)r), by);
  const int y1 = (int)floorf(yv), y2 = y1 + 1;
  YTaps y;
  y.o1 = min(max(y1, 0), s1 - 1) * s2;
  y.o2 = min(max(y2, 0), s1 - 1) * s2;
  y.w1 = (y1 >= 0 && y1 < s1) ? hat_f32(yv, y1) : 0.0f;
  y.w2 = (y2 >= 0 && y2 < s1) ? hat_f32(yv, y2) : 0.0f;
  return y;
}

// j-major layout (BG, hg, M, h, w), _rpe_kernel's form.  Shared memory:
// the table plane (s1 x s2 f32), then each warp's y taps of 32 rows and its
// (kJRows, 32) bf16 staging tile.
__global__ void __launch_bounds__(kJThreads)
rpe_jmajor_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                  bf16* __restrict__ out, int G, int hg, int h, int M, int w, int s1,
                  int s2, float ay, float ax, int keys_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr unsigned kAll = 0xffffffffu, kGroup = (1u << kJRows) - 1;
  float* T = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t t_bytes = align128((size_t)s1 * s2 * 4);
  YTaps* Y = reinterpret_cast<YTaps*>(smem + t_bytes) + warp * 32;
  bf16* St = reinterpret_cast<bf16*>(smem + t_bytes + kJWarps * 32 * sizeof(YTaps)) +
             warp * kJRows * 32;
  const int plane = blockIdx.y, bg = plane / hg, e = plane % hg;
  const float* Tg = table + ((size_t)(bg % G) * hg + e) * s1 * s2;
  for (int i = threadIdx.x; i < s1 * s2; i += kJThreads) cp_async4(T + i, Tg + i);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int j0 = blockIdx.x * keys_per_block, j1 = min(M, j0 + keys_per_block);
  const int chunks = (w + 31) / 32;
  for (int task = warp; task < (j1 - j0) * chunks; task += kJWarps) {
    const int j = j0 + task / chunks, c0 = (task % chunks) * 32;
    const float* p = pos + ((size_t)bg * M + j) * 2;
    const float by = __fmul_rn(__fmul_rn(__fsub_rn(0.5f, __fmul_rn(0.5f, __ldg(p))), 0.5f),
                               (float)(s1 - 1));
    const float bx = __fmul_rn(__fmul_rn(__fsub_rn(0.5f, __fmul_rn(0.5f, __ldg(p + 1))), 0.5f),
                               (float)(s2 - 1));
    const int c = c0 + lane;
    const float xv = __fadd_rn(__fmul_rn(ax, (float)c), bx);
    const int x1 = (int)floorf(xv), x2 = x1 + 1;
    const float wx1 = (x1 >= 0 && x1 < s2) ? hat_f32(xv, x1) : 0.0f;
    const float wx2 = (x2 >= 0 && x2 < s2) ? hat_f32(xv, x2) : 0.0f;
    const int xa = min(max(x1, 0), s2 - 1), xb = min(max(x2, 0), s2 - 1);
    const auto u_of = [&](int o) {
      return __fadd_rn(__fadd_rn(0.0f, __fmul_rn(wx1, T[o + xa])), __fmul_rn(wx2, T[o + xb]));
    };
    const auto sample = [&](const YTaps& y, float u1, float u2) {
      return __float2bfloat16(
          __fadd_rn(__fadd_rn(0.0f, __fmul_rn(y.w1, u1)), __fmul_rn(y.w2, u2)));
    };
    int po1 = -1, po2 = -1;  // the last row's tap rows and their u
    float pu1 = 0.0f, pu2 = 0.0f;
    bf16* o_plane = out + (((size_t)bg * hg + e) * M + j) * h * w;
    for (int rb = 0; rb < h; rb += 32) {
      // the y taps of rows rb.. rb + 31, a lane each, and which rows are
      // "fresh": their first tap row is neither of the last row's
      __syncwarp();  // the last rows are done with Y
      const int r = rb + lane;
      bool fresh = true;
      if (r < h) {
        const YTaps y = y_taps(ay, r, by, s1, s2);
        if (r > 0) {
          const YTaps last = y_taps(ay, r - 1, by, s1, s2);
          fresh = y.o1 != last.o1 && y.o1 != last.o2;
        }
        Y[lane] = y;
      }
      const unsigned flags = __ballot_sync(kAll, fresh);  // set past h
      __syncwarp();
      const int last = min(31, h - 1 - rb);
      for (int g = 0; g <= last; g += kJRows) {
        if (((flags >> g) & kGroup) == 0) {
          // each row's first tap row is the last row's first or second: its
          // u carried over, the second's computed
#pragma unroll
          for (int i = 0; i < kJRows; ++i) {
            const YTaps y = Y[g + i];
            const float u1 = y.o1 == po1 ? pu1 : pu2, u2 = u_of(y.o2);
            St[i * 32 + lane] = sample(y, u1, u2);
            po1 = y.o1, po2 = y.o2, pu1 = u1, pu2 = u2;
          }
        } else {
          // a key's first rows, taps that move by two rows or more (every
          // row where ay > 1), and rows past h (the last repeated, not
          // stored): both u computed
#pragma unroll
          for (int i = 0; i < kJRows; ++i) {
            const YTaps y = Y[min(g + i, last)];
            const float u1 = u_of(y.o1), u2 = u_of(y.o2);
            St[i * 32 + lane] = sample(y, u1, u2);
            po1 = y.o1, po2 = y.o2, pu1 = u1, pu2 = u2;
          }
        }
        __syncwarp();
        const int rr = rb + g + lane / 4, cc = c0 + 8 * (lane % 4);
        if (rr < h && cc < w) {
          const size_t o = (size_t)rr * w + cc;
          const bf16* src = St + (lane / 4) * 32 + 8 * (lane % 4);
          // the widest stores the run's length and alignment allow
          const int n = min(8, w - cc);
          const size_t at = reinterpret_cast<size_t>(o_plane + o);
          if (n == 8 && at % 16 == 0) {
            *reinterpret_cast<uint4*>(o_plane + o) = *reinterpret_cast<const uint4*>(src);
          } else if (n % 4 == 0 && at % 8 == 0) {
            for (int q = 0; q < n; q += 4)
              *reinterpret_cast<uint2*>(o_plane + o + q) =
                  *reinterpret_cast<const uint2*>(src + q);
          } else {
            for (int q = 0; q < n; ++q) o_plane[o + q] = src[q];
          }
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

extern "C" int dscf_rpe_rows(const void* pos, const void* table, void* out,
                             int BG, int G, int hg, int h, int M, int w, int s1,
                             int s2, float ay, float ax, void* stream) {
  const long long total = (long long)BG * hg * h * M * w;
  const long long blocks = (total + kThreads - 1) / kThreads;
  rpe_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      (const float*)pos, (const float*)table, (bf16*)out, total, G, hg, h, M,
      w, s1, s2, ay, ax);
  return (int)cudaGetLastError();
}

extern "C" int dscf_rpe_packed(const void* pos, const void* table, void* out,
                               int BG, int G, int hg, int h, int M, int w,
                               int s1, int s2, float ay, float ax,
                               void* stream) {
  const long long total = (long long)BG * hg * M * h * w;
  const long long blocks = (total + kThreads - 1) / kThreads;
  rpe_packed_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      (const float*)pos, (const float*)table, (bf16*)out, total, G, hg, h, M,
      w, s1, s2, ay, ax);
  return (int)cudaGetLastError();
}

extern "C" int dscf_rpe_jmajor(const void* pos, const void* table, void* out,
                               int BG, int G, int hg, int h, int M, int w,
                               int s1, int s2, float ay, float ax,
                               void* stream) {
  const size_t smem = align128((size_t)s1 * s2 * 4) + (size_t)kJWarps * 32 * sizeof(YTaps) +
                      (size_t)kJWarps * kJRows * 32 * sizeof(bf16);
  const int planes = BG * hg;
  const int blocks = blocks_per_device(rpe_jmajor_kernel, smem, kJThreads);
  const int bands = std::min(M, std::max(1, blocks / planes));
  const int keys = (M + bands - 1) / bands;
  rpe_jmajor_kernel<<<dim3((M + keys - 1) / keys, planes), kJThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      (const float*)pos, (const float*)table, (bf16*)out, G, hg, h, M, w, s1, s2, ay, ax,
      keys);
  return (int)cudaGetLastError();
}
