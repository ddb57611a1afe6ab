// K3 and K6: the DSCF continuous relative-position bias, the bilinear
// sample of table[bg % G, e] at the displacement between query pixel (r, c)
// and deformable key j, in two layouts:
//   K3 dscf_rpe_rows    bias[bg, e, r, j, c]  (BG, hg, h, M, w), levels 0-2;
//   K6 dscf_rpe_packed  bias[bg, e, j, r*w+c] (BG, hg, M, h*w), level 3,
//                       where the einsum attention adds it to its scores.
//
// Replace ir_ads_tpu/ops/pallas_dscf_rpe.py:_rpe_rows_kernel (launched by
// dscf_rpe_bias_rows_pallas) and _rpe_packed_kernel (launched by
// dscf_rpe_bias_packed_pallas).  The TPU kernels write the bilinear form as
// two dense hat-weight products because its matrix unit wants dense work;
// a hat weight has only two non-zero taps per axis, so here each output is a
// 2 x 2-tap bilinear form over the table, read through L1/L2.  The hat
// weights are evaluated as max(0, 1 - |i - s|) exactly as the f32 twin does,
// in f32; only the stored result is rounded to bf16.
//
// Bound on an H100: bytes (the bf16 output: about 16 flop per 2-byte output,
// table reads hit the cache).  Design: one thread per output element,
// consecutive threads along the minor output axis (the query column c for
// K3, the flat query pixel for K6), so stores coalesce; both layouts share
// one sampling routine.
#include "common.cuh"

using namespace port;

namespace {

// One output of the bias: the bilinear sample of table[bg % G, e] at the
// displacement between query pixel (r, c) and key j, in f32.
__device__ __forceinline__ float rpe_sample(const float* __restrict__ pos,
                                            const float* __restrict__ table,
                                            int bg, int e, int j, int r, int c,
                                            int G, int hg, int h, int M, int w,
                                            int s1, int s2) {
  const float ay = (s1 - 1.0f) / (2.0f * (h - 1.0f));
  const float ax = (s2 - 1.0f) / (2.0f * (w - 1.0f));
  const float* p = pos + ((size_t)bg * M + j) * 2;
  const float by = (0.5f - 0.5f * p[0]) * 0.5f * (s1 - 1.0f);
  const float bx = (0.5f - 0.5f * p[1]) * 0.5f * (s2 - 1.0f);
  const float iy = ay * r + by;
  const float ix = ax * c + bx;
  const int y0 = (int)floorf(iy), x0 = (int)floorf(ix);
  const float* T = table + ((size_t)(bg % G) * hg + e) * s1 * s2;
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int s = y0 + dy;
    if (s < 0 || s >= s1) continue;
    const float wy = fmaxf(0.0f, 1.0f - fabsf(iy - (float)s));
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int u = x0 + dx;
      if (u < 0 || u >= s2) continue;
      const float wx = fmaxf(0.0f, 1.0f - fabsf(ix - (float)u));
      acc += wy * wx * T[s * s2 + u];
    }
  }
  return acc;
}

// Rows layout (BG, hg, h, M, w).
__global__ void __launch_bounds__(kThreads)
rpe_rows_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                bf16* __restrict__ out, long long total, int G, int hg, int h,
                int M, int w, int s1, int s2) {
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
      rpe_sample(pos, table, bg, e, j, r, c, G, hg, h, M, w, s1, s2));
}

// Packed layout (BG, hg, M, h*w): the query plane flat and minor.
__global__ void __launch_bounds__(kThreads)
rpe_packed_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                  bf16* __restrict__ out, long long total, int G, int hg, int h,
                  int M, int w, int s1, int s2) {
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
      rpe_sample(pos, table, bg, e, j, q / w, q % w, G, hg, h, M, w, s1, s2));
}

}  // namespace

extern "C" int dscf_rpe_rows(const void* pos, const void* table, void* out,
                             int BG, int G, int hg, int h, int M, int w, int s1,
                             int s2, void* stream) {
  const long long total = (long long)BG * hg * h * M * w;
  const long long blocks = (total + kThreads - 1) / kThreads;
  rpe_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      (const float*)pos, (const float*)table, (bf16*)out, total, G, hg, h, M,
      w, s1, s2);
  return (int)cudaGetLastError();
}

extern "C" int dscf_rpe_packed(const void* pos, const void* table, void* out,
                               int BG, int G, int hg, int h, int M, int w,
                               int s1, int s2, void* stream) {
  const long long total = (long long)BG * hg * M * h * w;
  const long long blocks = (total + kThreads - 1) / kThreads;
  rpe_packed_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      (const float*)pos, (const float*)table, (bf16*)out, total, G, hg, h, M,
      w, s1, s2);
  return (int)cudaGetLastError();
}
