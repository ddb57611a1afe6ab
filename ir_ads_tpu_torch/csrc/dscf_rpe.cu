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
// rounded once.  rpe_sample_f32 below is that form, two taps an axis
// searched among four as in rpe_sample.  Its sums of two products are
// written with __fmul_rn / __fadd_rn; XLA's and cuBLAS's f32 dots may fuse
// a multiply-add, so the plain version (the twin's f32 einsums, rounded
// once) can sit an f32 ulp away before the rounding, and an output near a
// bf16 rounding boundary then lands one bf16 ulp apart.
//
// Throughout, the index arithmetic is written with __fmul_rn / __fsub_rn /
// __fadd_rn: nvcc -O3 would contract a*r - s into an FMA, skip the
// product's rounding, and one f32 ulp in a weight can flip its bf16
// rounding.  ay and ax come from the host, rounded once from double as the
// TPU kernels' Python constants are.
//
// Bound on an H100: bytes (the bf16 output: a few dozen flops per 2-byte
// output, table reads hit the cache).  Design: one thread per output
// element, consecutive threads along the minor output axis (the query
// column c for K3, the flat query pixel for K6 and K18), so stores
// coalesce.
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

// max(0, 1 - |(a*i + b) - s|) in f32: _rpe_kernel's hat weight, unrounded.
__device__ __forceinline__ float rpe_hat_f32(float a, int i, int s, float b) {
  const float d = __fsub_rn(__fadd_rn(__fmul_rn(a, (float)i), b), (float)s);
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d)));
}

// One output of _rpe_kernel's bias before its rounding: the same sample as
// rpe_sample with f32 hat weights, the f32 table and an f32 u.
__device__ __forceinline__ float rpe_sample_f32(const float* __restrict__ pos,
                                                const float* __restrict__ table,
                                                int bg, int e, int j, int r, int c,
                                                int G, int hg, int M, int s1,
                                                int s2, float ay, float ax) {
  const float* p = pos + ((size_t)bg * M + j) * 2;
  const float by = __fmul_rn(__fmul_rn(__fsub_rn(0.5f, __fmul_rn(0.5f, p[0])), 0.5f),
                             (float)(s1 - 1));
  const float bx = __fmul_rn(__fmul_rn(__fsub_rn(0.5f, __fmul_rn(0.5f, p[1])), 0.5f),
                             (float)(s2 - 1));
  const int y0 = (int)floorf(__fadd_rn(__fmul_rn(ay, (float)r), by)) - 1;
  const int x0 = (int)floorf(__fadd_rn(__fmul_rn(ax, (float)c), bx)) - 1;
  float wx[4];
#pragma unroll
  for (int dx = 0; dx < 4; ++dx) {
    const int t = x0 + dx;
    wx[dx] = (t < 0 || t >= s2) ? 0.0f : rpe_hat_f32(ax, c, t, bx);
  }
  const float* T = table + ((size_t)(bg % G) * hg + e) * s1 * s2;
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    const int s = y0 + dy;
    if (s < 0 || s >= s1) continue;
    const float wy = rpe_hat_f32(ay, r, s, by);
    if (wy == 0.0f) continue;
    float u = 0.0f;
#pragma unroll
    for (int dx = 0; dx < 4; ++dx)
      if (wx[dx] != 0.0f) u = __fadd_rn(u, __fmul_rn(wx[dx], __ldg(T + s * s2 + x0 + dx)));
    acc = __fadd_rn(acc, __fmul_rn(wy, u));
  }
  return acc;
}

// j-major layout (BG, hg, M, h, w), _rpe_kernel's form.
__global__ void __launch_bounds__(kThreads)
rpe_jmajor_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                  bf16* __restrict__ out, long long total, int G, int hg, int h,
                  int M, int w, int s1, int s2, float ay, float ax) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % w);
  long long t = idx / w;
  const int r = (int)(t % h);
  t /= h;
  const int j = (int)(t % M);
  t /= M;
  const int e = (int)(t % hg);
  const int bg = (int)(t / hg);
  out[idx] = __float2bfloat16(
      rpe_sample_f32(pos, table, bg, e, j, r, c, G, hg, M, s1, s2, ay, ax));
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
  const long long total = (long long)BG * hg * M * h * w;
  const long long blocks = (total + kThreads - 1) / kThreads;
  rpe_jmajor_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      (const float*)pos, (const float*)table, (bf16*)out, total, G, hg, h, M,
      w, s1, s2, ay, ax);
  return (int)cudaGetLastError();
}
