// K19: the flat-input patch embedding, patchify + projection + LayerNorm in
// one pass: flat rows (B, H, W*3) bf16 -> (B, H/4, W/4, 128) bf16.
//
// Replaces ir_ads_tpu/ops/pallas_patch.py:_patch_kernel (launched by
// pallas_patch_embed; twin _xla_twin), which PatchEmbed runs on flat input
// under IR_ADS_PATCH_EMBED=pallas.  The patch of output pixel (py, px) is
// the 4 x 12 values x[b, 4*py + r, 12*px + q] (r the patch row, q = 3 *
// x_in_patch + channel): row k = 12*r + q of the (48, 128) weight, the conv
// kernel reshaped as (E, p, p, c) and transposed.  The TPU kernel does this
// relayout in VMEM; here it is the index arithmetic of the loads.
// Rounding points, the Pallas kernel's: the product summed in f32 and
// rounded to bf16, plus the bias rounded to bf16 and rounded again, the
// LayerNorm mean and variance in f32, times the LayerNorm scale and plus its
// bias, both rounded to bf16 by the wrapper (pallas_patch_embed's vec, where
// the twin keeps them f32), in f32, one rounding at the end.  Products of
// two bf16 values are exact in f32, so the order of the f32 sums is all
// that may part the kernel from its plain version: an output near a bf16
// rounding boundary can land one ulp apart.  The LayerNorm's arithmetic is
// written with _rn intrinsics so that nvcc contracts nothing into an FMA.
//
// Bound on an H100: bytes.  Per output pixel it reads 48 bf16 inputs and
// writes 128 bf16 outputs and does 2 * 48 * 128 flops, 35 flops per byte,
// far under the card's 295.  The count is chip_smoke.py's.  Design: one
// block of 256 threads per band of up to 64 output pixels of one output
// row.  The block
// stages the 48 x 128 weight (f32) and its band's 4 input rows (coalesced
// loads, f32) in shared memory; each warp takes one output pixel at a time,
// each lane 4 of the 128 channels (lane + 32 j): 48 f32 multiply-adds a
// channel on CUDA cores, the LayerNorm's sums by warp shuffles, and one
// coalesced bf16 store of the pixel's 128 channels.
#include "common.cuh"

using namespace port;

namespace {

constexpr int kP = 4;                // patch size
constexpr int kC = 3;                // input channels
constexpr int kRow = kP * kC;        // values of one patch row: 12
constexpr int kK = kP * kRow;        // values of one patch: 48
constexpr int kE = 128;              // embedding width (Swin-B)
constexpr int kPerLane = kE / 32;    // channels of one lane
constexpr int kPix = 64;             // output pixels of a block's band

__global__ void __launch_bounds__(kThreads)
patch_embed_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias, const bf16* __restrict__ g,
                   const bf16* __restrict__ be, bf16* __restrict__ out, int H,
                   int W, float eps) {
  __shared__ float w_s[kK * kE];
  __shared__ float x_s[kP * kPix * kRow];
  const int Wp = W / kP, Hp = H / kP;
  const int bands = (Wp + kPix - 1) / kPix;
  const int px0 = (blockIdx.x % bands) * kPix;
  const int orow = blockIdx.x / bands;  // b * Hp + py
  const int b = orow / Hp, py = orow % Hp;
  const int npix = min(kPix, Wp - px0);
  const int span = npix * kRow;  // values of one input row in the band

  for (int i = threadIdx.x; i < kK * kE; i += kThreads) w_s[i] = __bfloat162float(w[i]);
  const size_t wc = (size_t)W * kC;
  for (int i = threadIdx.x; i < kP * span; i += kThreads) {
    const int r = i / span, o = i % span;
    x_s[r * kPix * kRow + o] = __bfloat162float(
        x[((size_t)b * H + (size_t)py * kP + r) * wc + (size_t)px0 * kRow + o]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float bv[kPerLane], gv[kPerLane], bev[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    bv[j] = __bfloat162float(bias[lane + 32 * j]);
    gv[j] = __bfloat162float(g[lane + 32 * j]);
    bev[j] = __bfloat162float(be[lane + 32 * j]);
  }
  for (int pix = warp; pix < npix; pix += kWarps) {
    float acc[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int r = 0; r < kP; ++r) {
      const float* xr = x_s + r * kPix * kRow + pix * kRow;
#pragma unroll
      for (int q = 0; q < kRow; ++q) {
        const float xv = xr[q];  // one address for the warp: a broadcast
        const float* wr = w_s + (r * kRow + q) * kE + lane;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) acc[j] = fmaf(xv, wr[32 * j], acc[j]);
      }
    }
    float y[kPerLane], s = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      y[j] = round_bf16(__fadd_rn(round_bf16(acc[j]), bv[j]));
      s = __fadd_rn(s, y[j]);
    }
    const float mu = __fmul_rn(warp_sum(s), 1.0f / kE);
    float v = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      y[j] = __fsub_rn(y[j], mu);
      v = __fadd_rn(v, __fmul_rn(y[j], y[j]));
    }
    const float var = __fmul_rn(warp_sum(v), 1.0f / kE);
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    bf16* o = out + ((size_t)orow * Wp + px0 + pix) * kE + lane;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      o[32 * j] = __float2bfloat16(
          __fadd_rn(__fmul_rn(__fmul_rn(y[j], rstd), gv[j]), bev[j]));
  }
}

}  // namespace

// x (B, H, W*3) bf16 flat rows, H and W multiples of 4; w (48, 128) bf16;
// bias, g, be (128) bf16; out (B, H/4, W/4, 128) bf16.
extern "C" int patch_embed(const void* x, const void* w, const void* bias,
                           const void* g, const void* be, void* out, int B,
                           int H, int W, float eps, void* stream) {
  const int bands = (W / kP + kPix - 1) / kPix;
  patch_embed_kernel<<<B * (H / kP) * bands, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)bias, (const bf16*)g,
      (const bf16*)be, (bf16*)out, H, W, eps);
  return (int)cudaGetLastError();
}
