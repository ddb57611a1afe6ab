// K9: multi-scale deformable attention sampling, the op every DINO encoder
// and decoder layer runs:
//
//   out[b, q, h*D + c] = sum over (level l, point p, corner k) of
//       value[b, start_l + y_k * w_l + x_k, h, c] * corner_weight_k * attn[b, q, h, l, p]
//
// with F.grid_sample(align_corners=False, padding_mode="zeros") semantics:
// the pixel coordinate of a location in [0, 1] is loc * size - 0.5, and a
// corner outside its level has weight 0 on its clamped index.
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
// Order of the sums: each channel is one f32 chain of fused multiply-adds
// from +0, sample-major (level, point), then corner, every corner added,
// those of weight 0 too (a corner outside its level adds its clamped row
// times 0, as the Pallas kernel and the plain version do, so a non-finite
// value there gives NaN as on the TPU).  Adding v * 0 to a sum that started
// at +0 leaves its bits as they were for finite v, so on finite inputs the
// output is the first design's (which skipped zero weights) bit for bit
// (tests/test_torch_msdeform_order.py holds the premise on the CPU).
//
// Bound on an H100: bytes (each value row, location, weight and output once:
// about 47 MB at the DINO encoder shape, 0.014 ms; the arithmetic is 0.7
// GFLOP of f32).  The gathered traffic is larger, L*P*4 rows of D values per
// (query, head), about 0.66 GB at that shape, but the 10 MB value stack stays
// in the 50 MB L2, so the kernel is bound by how many gathers it keeps in
// flight.  The first design (one warp a (query, head), the lanes on the
// channels) kept about one: a load, then a branch on the weight, then the
// FMA that waits on it, 64 times in series.
//
// Design: a half-warp per (batch, query, head), two heads a warp, two
// channels a lane, so one 4-byte (bf16x2) or 8-byte (float2) load per lane
// reads a corner's whole row of D = 32 values for each of the warp's two
// heads.  A block's 8 warps cover 16 (query, head) pairs, the 8 heads of two
// queries at DINO's width, so its location reads, weight reads and stores
// are contiguous.  Lane t of a half-warp first works out sample t's four
// clamped corner offsets and weights (L*P = 16 at DINO's width; more in
// chunks of 16), reading its location as one float2.  The half-warp then
// takes the samples in order: the offsets and weights of a sample's four
// corners come by shuffle, its four loads are issued, then its FMAs run.
// No branch depends on a weight, so nothing holds the next sample's loads
// back but the registers.  On an H100, issuing the loads of two or four
// samples before their FMAs took 1.10x and 1.29x the time (more registers,
// fewer warps resident; eight and sixteen spilled), and blocks that walk a
// contiguous run of queries for the L1's sake 1.17x.  The gathers run at
// about 6 TB/s of rows (0.66 GB at the encoder shape), near what L2
// delivers: the time is the gathered traffic's, not the bytes bound's.
#include "common.cuh"

using namespace port;

namespace {

constexpr int kMaxLevels = 8;
constexpr int kHalf = 16;   // lanes of a half-warp, which takes one (query, head)
constexpr int kPairs = kThreads / kHalf;  // (query, head) pairs of a block

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// Two adjacent channels of a value row: loaded as one word, widened to f32
// exactly, stored with one rounding each.
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
  static __device__ __forceinline__ void store(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};
template <>
struct Pair<float> {
  using Raw = float2;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ float lo(Raw r) { return r.x; }
  static __device__ __forceinline__ float hi(Raw r) { return r.y; }
  static __device__ __forceinline__ void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
msdeform_pairs_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                      const T* __restrict__ attn, T* __restrict__ out, Levels lv,
                      long long total, int S, int Lq, int H, int D, int L, int P) {
  const int t = threadIdx.x % kHalf;
  const long long pair = (long long)blockIdx.x * kPairs + threadIdx.x / kHalf;
  // a half-warp past the end repeats the last pair and stores nothing: it
  // still takes part in its warp's shuffles
  const bool live = pair < total;
  const long long wid = live ? pair : total - 1;  // (b, q, h) flat
  const int h = (int)(wid % H);
  const int b = (int)(wid / H / Lq);
  const int LP = L * P;
  const float* loc_w = loc + wid * LP * 2;
  const T* att_w = attn + wid * LP;
  // lanes past D / 2 repeat the last channel pair and store nothing
  const int c = 2 * min(t, D / 2 - 1);
  const T* v_bh = value + ((size_t)b * S * H + h) * D + c;
  const int row = H * D;  // elements from one value row to the next

  float acc0 = 0.0f, acc1 = 0.0f;
  for (int s0 = 0; s0 < LP; s0 += kHalf) {
    // lane t: the four corners of sample s0 + t, as element offsets from
    // v_bh (past the last sample: offset 0, weight 0, never added)
    int off[4] = {0, 0, 0, 0};
    float wgt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int s = s0 + t;
    if (s < LP) {
      const int l = s / P;
      // the level's shape and start by selection: indexing the parameter
      // struct with l would copy it to local memory
      int hh = lv.h[0], ww = lv.w[0], start = 0;
#pragma unroll
      for (int i = 1; i < kMaxLevels; ++i)
        if (i == l) hh = lv.h[i], ww = lv.w[i], start = lv.start[i];
      const float2 xy = *reinterpret_cast<const float2*>(loc_w + 2 * s);
      // no fused multiply-add here: the plain version rounds the product
      // first, and floor() must see the same coordinate
      const float gx = __fsub_rn(__fmul_rn(xy.x, (float)ww), 0.5f);
      const float gy = __fsub_rn(__fmul_rn(xy.y, (float)hh), 0.5f);
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
        off[k] = (start + yc * ww + xc) * row;
        wgt[k] = __fmul_rn(valid ? cw[k] : 0.0f, a);
      }
    }
    // the half-warp, sample by sample: its four corners' loads, then their
    // FMAs in the chain's order; n is the same for both halves of the warp
    const int n = min(kHalf, LP - s0);
    for (int j = 0; j < n; ++j) {
      typename Pair<T>::Raw r[4];
      float w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int o = __shfl_sync(0xffffffffu, off[k], j, kHalf);
        w[k] = __shfl_sync(0xffffffffu, wgt[k], j, kHalf);
        r[k] = Pair<T>::load(v_bh + o);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc0 = __fmaf_rn(Pair<T>::lo(r[k]), w[k], acc0);
        acc1 = __fmaf_rn(Pair<T>::hi(r[k]), w[k], acc1);
      }
    }
  }
  if (live && t < D / 2) Pair<T>::store(out + wid * D + c, acc0, acc1);
}

}  // namespace

// value (B, S, H, D), loc (B, Lq, H, L, P, 2) f32, attn (B, Lq, H, L, P),
// out (B, Lq, H*D); value, attn and out bf16 (is_bf16) or f32.  shapes is a
// host array of L (h, w) pairs.  D even and <= 32, L <= 8, S*H*D < 2^31.
extern "C" int msdeform_attn(const void* value, const void* loc,
                             const void* attn, void* out, const int* shapes,
                             int B, int S, int Lq, int H, int D, int L, int P,
                             int is_bf16, void* stream) {
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
    msdeform_pairs_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        (const bf16*)value, (const float*)loc, (const bf16*)attn, (bf16*)out,
        lv, total, S, Lq, H, D, L, P);
  else
    msdeform_pairs_kernel<float><<<blocks, kThreads, 0, st>>>(
        (const float*)value, (const float*)loc, (const float*)attn,
        (float*)out, lv, total, S, Lq, H, D, L, P);
  return (int)cudaGetLastError();
}
