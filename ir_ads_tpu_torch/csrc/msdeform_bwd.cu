// K9's backward: the gradients of multi-scale deformable attention sampling
// (csrc/msdeform.cu) with respect to the value stack, the sampling
// locations and the attention weights.  With the forward
//
//   out[b, q, h*D + c] = sum over (level l, point p, corner k) of
//       value[b, idx_k, h, c] * m_k * cw_k * a,   a = attn[b, q, h, l, p]
//
// (cw_k the bilinear corner weights of the pixel coordinate g = loc * size -
// 0.5, f = g - floor(g); m_k = 1 for a corner inside its level, else 0, its
// index clamped) and g_out = d loss / d out, per (b, q, h) and sample s:
//
//   dvalue[b, idx_k, h, c] += m_k * cw_k * a * g_out[c]          (scatter)
//   t_k                     = <value[b, idx_k, h, :], g_out>      (gather)
//   dattn[s]                = sum_k m_k * cw_k * t_k
//   dloc[s].x               = a * w_l * sum_k m_k * dcw_k/dfx * t_k
//   dloc[s].y               = a * h_l * sum_k m_k * dcw_k/dfy * t_k
//
// which is the vjp of the JAX package's ms_deform_attn_xla (the _bwd of
// ir_ads_tpu/ops/pallas_msdeform.py, line 240): floor() has no gradient,
// and m_k multiplies the value term of dloc too, so a clamped neighbour of
// an out-of-bounds corner never reaches the location gradient (JAX's zeros
// padding reads no value there).
//
// Design: K9's lane layout.  A half-warp per (batch, query, head), two
// heads a warp, two channels a lane (one 4-byte bf16x2 or 8-byte float2
// load per lane reads a corner's row of D = 32).  Lane t first works out
// sample t's four clamped corner offsets, masked corner weights and the
// factors of its location gradient exactly as the forward does (corner
// arithmetic unfused, as in ops/msdeform.corner_tables).  The half-warp
// then takes the samples in order: a sample's offsets and weights come by
// shuffle, its four rows are loaded, each lane adds m_k * cw_k * a * g_out
// of its two channels into an f32 dvalue buffer with atomicAdd, and the
// four dot products t_k are summed over the half-warp by butterfly
// shuffles; lane s keeps sample s's four.  After the 16 samples each lane
// writes its sample's dattn and dloc.  The caller zeroes the f32 buffer
// and rounds it once to the value dtype.
//
// The order of the atomicAdds changes from run to run, so dvalue differs
// between runs in its last f32 bits (and, after the one rounding, may
// differ by a bf16 ulp); dloc and dattn are the same from run to run.
//
// Bound on an H100: bytes (value, locations, weights, g_out read once,
// dvalue, dloc and dattn written once: about 89 MB a layer at the DINO-R50
// encoder's training shape, batch 4 at 512x512, in bf16).  The kernel moves more:
// L*P*4 gathered rows and as many scattered f32 row pairs per (query,
// head), each scattered element an L2 atomic.
#include "common.cuh"

using namespace port;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kHalf = 16;                 // lanes of a half-warp: one (query, head)
constexpr int kPairs = kThreads / kHalf;  // (query, head) pairs of a block

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

template <typename T>
struct Pair;
template <>
struct Pair<bf16> {
  using Raw = unsigned;
  static __device__ __forceinline__ Raw load(const bf16* p) {
    return __ldg(reinterpret_cast<const unsigned*>(p));
  }
  static __device__ __forceinline__ float lo(Raw r) { return __uint_as_float(r << 16); }
  static __device__ __forceinline__ float hi(Raw r) { return __uint_as_float(r & 0xffff0000u); }
};
template <>
struct Pair<float> {
  using Raw = float2;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ float lo(Raw r) { return r.x; }
  static __device__ __forceinline__ float hi(Raw r) { return r.y; }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
msdeform_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const T* __restrict__ attn, const T* __restrict__ gout,
                    float* __restrict__ dvalue, float* __restrict__ dloc,
                    T* __restrict__ dattn, Levels lv, long long total, int S, int Lq,
                    int H, int D, int L, int P) {
  const int t = threadIdx.x % kHalf;
  const long long pair = (long long)blockIdx.x * kPairs + threadIdx.x / kHalf;
  // a half-warp past the end repeats the last pair, adds and stores nothing:
  // it still takes part in its warp's shuffles
  const bool live = pair < total;
  const long long wid = live ? pair : total - 1;  // (b, q, h) flat
  const int h = (int)(wid % H);
  const int b = (int)(wid / H / Lq);
  const int LP = L * P;
  const float* loc_w = loc + wid * LP * 2;
  const T* att_w = attn + wid * LP;
  // lanes past D / 2 repeat the last channel pair with a zero cotangent
  const bool chan = t < D / 2;
  const int c = 2 * min(t, D / 2 - 1);
  const bool adds = live && chan;
  const float g0 = adds ? to_f32(gout[wid * D + c]) : 0.0f;
  const float g1 = adds ? to_f32(gout[wid * D + c + 1]) : 0.0f;
  const size_t base = ((size_t)b * S * H + h) * D + c;
  const T* v_bh = value + base;
  float* dv_bh = dvalue + base;
  const int row = H * D;

  for (int s0 = 0; s0 < LP; s0 += kHalf) {
    // lane t: sample s0 + t's corners (past the last sample: offset 0,
    // weight 0) and the factors of its location gradient
    int off[4] = {0, 0, 0, 0};
    float wgt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float cw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bool valid[4] = {false, false, false, false};
    float fx = 0.0f, fy = 0.0f, a = 0.0f, sx = 0.0f, sy = 0.0f;
    const int s = s0 + t;
    if (s < LP) {
      const int l = s / P;
      int hh = lv.h[0], ww = lv.w[0], start = 0;
#pragma unroll
      for (int i = 1; i < kMaxLevels; ++i)
        if (i == l) hh = lv.h[i], ww = lv.w[i], start = lv.start[i];
      const float2 xy = *reinterpret_cast<const float2*>(loc_w + 2 * s);
      const float gx = __fsub_rn(__fmul_rn(xy.x, (float)ww), 0.5f);
      const float gy = __fsub_rn(__fmul_rn(xy.y, (float)hh), 0.5f);
      const float x0f = floorf(gx), y0f = floorf(gy);
      fx = gx - x0f;
      fy = gy - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      a = to_f32(att_w[s]);
      sx = a * (float)ww;
      sy = a * (float)hh;
      cw[0] = (1.0f - fx) * (1.0f - fy);
      cw[1] = fx * (1.0f - fy);
      cw[2] = (1.0f - fx) * fy;
      cw[3] = fx * fy;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
        valid[k] = xi >= 0 && xi < ww && yi >= 0 && yi < hh;
        const int xc = min(max(xi, 0), ww - 1), yc = min(max(yi, 0), hh - 1);
        off[k] = (start + yc * ww + xc) * row;
        wgt[k] = __fmul_rn(valid[k] ? cw[k] : 0.0f, a);
      }
    }
    float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // sample t's t_k, once reduced
    const int n = min(kHalf, LP - s0);
    for (int j = 0; j < n; ++j) {
      typename Pair<T>::Raw r[4];
      int o[4];
      float w[4], part[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[k] = __shfl_sync(0xffffffffu, off[k], j, kHalf);
        w[k] = __shfl_sync(0xffffffffu, wgt[k], j, kHalf);
        r[k] = Pair<T>::load(v_bh + o[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        part[k] = __fmaf_rn(Pair<T>::hi(r[k]), g1, Pair<T>::lo(r[k]) * g0);
        if (adds && w[k] != 0.0f) {
          atomicAdd(dv_bh + o[k], w[k] * g0);
          atomicAdd(dv_bh + o[k] + 1, w[k] * g1);
        }
      }
#pragma unroll
      for (int m = kHalf / 2; m > 0; m >>= 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          part[k] += __shfl_xor_sync(0xffffffffu, part[k], m, kHalf);
      }
      if (t == j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) dot[k] = part[k];
      }
    }
    if (live && s < LP) {
      float d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = valid[k] ? dot[k] : 0.0f;
      const float da = cw[0] * d[0] + cw[1] * d[1] + cw[2] * d[2] + cw[3] * d[3];
      // d cw_k / d fx: -(1 - fy), (1 - fy), -fy, fy; d cw_k / d fy: -(1 - fx),
      // -fx, (1 - fx), fx
      const float tx = (1.0f - fy) * (d[1] - d[0]) + fy * (d[3] - d[2]);
      const float ty = (1.0f - fx) * (d[2] - d[0]) + fx * (d[3] - d[1]);
      *reinterpret_cast<float2*>(dloc + (wid * LP + s) * 2) = make_float2(tx * sx, ty * sy);
      store(dattn + wid * LP + s, da);
    }
  }
}

}  // namespace

// value (B, S, H, D), loc (B, Lq, H, L, P, 2) f32, attn (B, Lq, H, L, P),
// gout (B, Lq, H*D); dvalue (B, S, H, D) f32, zeroed by the caller; dloc
// like loc; dattn like attn.  value, attn, gout and dattn bf16 (is_bf16) or
// f32.  shapes is a host array of L (h, w) pairs.  D even and <= 32, L <= 8,
// S*H*D < 2^31.
extern "C" int msdeform_attn_bwd(const void* value, const void* loc, const void* attn,
                                 const void* gout, void* dvalue, void* dloc, void* dattn,
                                 const int* shapes, int B, int S, int Lq, int H, int D,
                                 int L, int P, int is_bf16, void* stream) {
  if (D > 32 || D % 2 || L > kMaxLevels || (long long)S * H * D >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * Lq * H;
  const unsigned blocks = (unsigned)((total + kPairs - 1) / kPairs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    msdeform_bwd_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        (const bf16*)value, (const float*)loc, (const bf16*)attn, (const bf16*)gout,
        (float*)dvalue, (float*)dloc, (bf16*)dattn, lv, total, S, Lq, H, D, L, P);
  else
    msdeform_bwd_kernel<float><<<blocks, kThreads, 0, st>>>(
        (const float*)value, (const float*)loc, (const float*)attn, (const float*)gout,
        (float*)dvalue, (float*)dloc, (float*)dattn, lv, total, S, Lq, H, D, L, P);
  return (int)cudaGetLastError();
}
