// K9: multi-scale deformable attention sampling, the op every DINO encoder
// and decoder layer runs:
//
//   out[b, q, h*D + c] = sum over (level l, point p, corner k) of
//       value[b, start_l + y_k * w_l + x_k, h, c] * corner_weight_k * attn[b, q, h, l, p]
//
// with F.grid_sample(align_corners=False, padding_mode="zeros") semantics:
// the pixel coordinate of a location in [0, 1] is loc * size - 0.5, and a
// corner outside its level has weight 0 (its index is clamped, never read).
//
// Replaces ir_ads_tpu/ops/pallas_msdeform.py:_gather_kernel (launched by
// _pallas_forward, entry ms_deform_attn_pallas).  The TPU version builds
// (B, Lq, L*P*4, heads) index and weight tables in XLA and stages the whole
// value stack in VMEM, because its compiler can gather no other way.  None of
// that carries over: here the corner arithmetic is inside the kernel and the
// tables never exist in device memory.  Rounding points are the TPU
// kernel's: locations and attention weights in f32, corner weight x
// attention weight one f32 product, the gathered value cast to f32, the sum
// over all L*P*4 slots in f32, one rounding to the value type on store.
//
// Bound on an H100: bytes (each value row, location, weight and output once:
// about 47 MB at the DINO encoder shape, where the arithmetic is 0.7 GFLOP of
// f32).  The gathered traffic is larger than the compulsory bytes, L*P*4 rows
// of D values per (query, head), but the 10 MB value stack stays in the 50 MB
// L2.  Design: one warp per (batch, query, head) with the lanes on the D
// channels, so a corner is one coalesced read of D values (64 bytes for bf16
// at D = 32).  Lane s first works out sample s's four corner indices and
// weights; the warp then walks the samples, taking each corner's index and
// weight from that lane by shuffle.  A block of 8 warps covers the 8 heads
// of one query at DINO's width, so its location reads and its store are
// contiguous.  The f32 sum stays in one register per lane.
#include "common.cuh"

using namespace port;

namespace {

constexpr int kMaxLevels = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
msdeform_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const T* __restrict__ attn, T* __restrict__ out, Levels lv,
                long long total, int S, int Lq, int H, int D, int L, int P) {
  const int lane = threadIdx.x % 32;
  const long long wid = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (wid >= total) return;  // (b, q, h) flat; the whole warp leaves together
  const int h = (int)(wid % H);
  const int b = (int)(wid / H / Lq);
  const int LP = L * P;
  const float* loc_w = loc + wid * LP * 2;
  const T* att_w = attn + wid * LP;
  const T* v_bh = value + ((size_t)b * S * H + h) * D + lane;
  const size_t row = (size_t)H * D;

  float acc = 0.0f;
  for (int s0 = 0; s0 < LP; s0 += 32) {
    // lane s: the four corners of sample s0 + s
    int idx[4] = {0, 0, 0, 0};
    float wgt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int s = s0 + lane;
    if (s < LP) {
      const int l = s / P;
      const int hh = lv.h[l], ww = lv.w[l];
      // no fused multiply-add here: the plain version rounds the product
      // first, and floor() must see the same coordinate
      const float gx = __fsub_rn(__fmul_rn(loc_w[2 * s], (float)ww), 0.5f);
      const float gy = __fsub_rn(__fmul_rn(loc_w[2 * s + 1], (float)hh), 0.5f);
      const float x0f = floorf(gx), y0f = floorf(gy);
      const float fx = gx - x0f, fy = gy - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      const float a = to_f32(att_w[s]);
      const float cw[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                           (1.0f - fx) * fy, fx * fy};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int xi = x0 + (k & 1), yi = y0 + (k >> 1);
        const bool valid = xi >= 0 && xi < ww && yi >= 0 && yi < hh;
        const int xc = min(max(xi, 0), ww - 1), yc = min(max(yi, 0), hh - 1);
        idx[k] = lv.start[l] + yc * ww + xc;
        wgt[k] = __fmul_rn(valid ? cw[k] : 0.0f, a);
      }
    }
    // the warp: every sample's corners, one row of D values each
    const int n = min(32, LP - s0);
    for (int j = 0; j < n; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = __shfl_sync(0xffffffffu, idx[k], j);
        const float w = __shfl_sync(0xffffffffu, wgt[k], j);
        if (w != 0.0f && lane < D) acc += to_f32(v_bh[(size_t)i * row]) * w;
      }
    }
  }
  if (lane < D) store(out + wid * D + lane, acc);
}

}  // namespace

// value (B, S, H, D), loc (B, Lq, H, L, P, 2) f32, attn (B, Lq, H, L, P),
// out (B, Lq, H*D); value, attn and out bf16 (is_bf16) or f32.  shapes is a
// host array of L (h, w) pairs.  D <= 32, L <= 8.
extern "C" int msdeform_attn(const void* value, const void* loc,
                             const void* attn, void* out, const int* shapes,
                             int B, int S, int Lq, int H, int D, int L, int P,
                             int is_bf16, void* stream) {
  if (D > 32 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
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
  const unsigned blocks = (unsigned)((total + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    msdeform_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        (const bf16*)value, (const float*)loc, (const bf16*)attn, (bf16*)out,
        lv, total, S, Lq, H, D, L, P);
  else
    msdeform_kernel<float><<<blocks, kThreads, 0, st>>>(
        (const float*)value, (const float*)loc, (const float*)attn,
        (float*)out, lv, total, S, Lq, H, D, L, P);
  return (int)cudaGetLastError();
}
