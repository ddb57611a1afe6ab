// K19: the flat-input patch embedding, patchify + projection + LayerNorm in
// one pass: flat rows (B, H, W*3) bf16 -> (B, H/4, W/4, 128) bf16.
//
// Replaces ir_ads_tpu/ops/pallas_patch.py:_patch_kernel (launched by
// pallas_patch_embed; twin _xla_twin), which PatchEmbed runs on flat input
// under IR_ADS_PATCH_EMBED=pallas.  The patch of output pixel (py, px) is
// the 4 x 12 values x[b, 4*py + r, 12*px + q] (r the patch row, q = 3 *
// x_in_patch + channel): row k = 12*r + q of the (48, 128) weight, the conv
// kernel reshaped as (E, p, p, c) and transposed.  The TPU kernel does this
// relayout in VMEM; here it is the map of the staging copies.
// Rounding points, the Pallas kernel's: the product summed in f32 and
// rounded to bf16, plus the bias rounded to bf16 and rounded again, the
// LayerNorm mean and variance in f32, times the LayerNorm scale and plus its
// bias, both rounded to bf16 as the kernel stages them (pallas_patch_embed's
// vec, where the twin keeps them f32), in f32, one rounding at the end.  Products of
// two bf16 values are exact in f32, so the order of the f32 sums (the
// product's, on the tensor cores, and the LayerNorm's, by lane then by quad)
// is all that may part the kernel from its plain version: an output near a
// bf16 rounding boundary can land one ulp apart.  The LayerNorm's
// arithmetic is written with _rn intrinsics so that nvcc contracts nothing
// into an FMA.
//
// Bound on an H100: bytes.  Per output pixel it reads 48 bf16 inputs and
// writes 128 bf16 outputs and does 2 * 48 * 128 flops, 35 flops per byte,
// far under the card's 295; 27 MB at (4, 480, 1920), 0.008 ms.  The first
// design ran the product on CUDA cores from shared memory (five shared
// loads for every four FMAs of a lane) and staged the whole weight as f32
// in each of its 1,440 blocks.
//
// Design: persistent blocks (as many as are resident, two an SM) of 8
// warps.  A block stages the weight once, transposed to (128, 48) bf16,
// then walks bands of 128 output pixels (flat (b, py, px) order, so a band
// may span output rows), with the next band's input copied by cp.async
// while the current one is multiplied.  The staging map: output pixel i of
// the band takes slots [56 i, 56 i + 48) of the band's buffer, slot 12 r +
// q holding x[b, 4 py + r, 12 px + q], copied in 8-byte pieces (a pixel's
// piece of one input row is 24 bytes at 8-byte alignment); the rows are
// padded to 56 so that ldmatrix meets no bank conflict.  Each warp takes 16
// pixels x 128 channels: mma.sync m16n8k16 bf16 -> f32, K = 48 in three
// steps, N = 128 as 16 n8 tiles, A and B by ldmatrix.  In the accumulator
// layout a pixel's 128 channels lie on one lane quad, so the bias, the
// roundings and the LayerNorm run in registers, its two sums each a
// lane's 32 values in order and then two quad shuffles.  The rows go out
// through a warp's own shared tile as whole 256-byte pixel rows, 16 bytes a
// lane.
#include "mma.cuh"

using namespace port;

namespace {

constexpr int kP = 4;                // patch size
constexpr int kC = 3;                // input channels
constexpr int kRow = kP * kC;        // values of one patch row: 12
constexpr int kK = kP * kRow;        // values of one patch: 48
constexpr int kE = 128;              // embedding width (Swin-B)
constexpr int kLd = kK + 8;          // staged row of a pixel or a weight column, bf16
constexpr int kBand = 16 * kWarps;   // output pixels of a band: 16 a warp
constexpr int kOutLd = kE + 8;       // a warp's output tile row, bf16
constexpr int kPieces = kRow / 4;    // 8-byte pieces of a pixel's input row: 3

struct Smem {
  bf16 w[kE * kLd];               // the weight, (n, k)
  bf16 x[2][kBand * kLd];         // two bands' patches
  bf16 o[kWarps][16 * kOutLd];    // each warp's output rows
  float bias[kE], g[kE], be[kE];  // the vectors, bf16 values as f32
};

// The band's input, by cp.async: copy e of the band's kP * kBand * kPieces
// is piece j of input row r of pixel i, consecutive copies walking one
// input row.  Pixels past n_pix are not copied.
__device__ __forceinline__ void stage_band(bf16* xs, const bf16* __restrict__ x, long long band,
                                           long long n_pix, int H, int W, int Hp, int Wp) {
  const size_t wc = (size_t)W * kC;
  for (int e = threadIdx.x; e < kP * kBand * kPieces; e += kThreads) {
    const int r = e / (kBand * kPieces), rem = e % (kBand * kPieces);
    const int i = rem / kPieces, j = rem % kPieces;
    const long long p = band * kBand + i;
    if (p >= n_pix) continue;
    const int px = (int)(p % Wp);
    const long long q = p / Wp;
    const int py = (int)(q % Hp), b = (int)(q / Hp);
    cp_async8(xs + i * kLd + r * kRow + 4 * j,
              x + ((size_t)b * H + (size_t)py * kP + r) * wc + (size_t)px * kRow + 4 * j);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
patch_embed_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias, const float* __restrict__ g,
                       const float* __restrict__ be, bf16* __restrict__ out, int B, int H,
                       int W, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int Hp = H / kP, Wp = W / kP;
  const long long n_pix = (long long)B * Hp * Wp;
  const long long n_bands = (n_pix + kBand - 1) / kBand;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  long long band = blockIdx.x;
  stage_band(sm.x[0], x, band, n_pix, H, W, Hp, Wp);
  cp_async_commit();
  for (int i = threadIdx.x; i < kK * kE; i += kThreads)
    sm.w[(i % kE) * kLd + i / kE] = w[i];
  for (int i = threadIdx.x; i < kE; i += kThreads) {
    sm.bias[i] = __bfloat162float(bias[i]);
    sm.g[i] = round_bf16(g[i]);
    sm.be[i] = round_bf16(be[i]);
  }

  const int gr = lane / 4, qc = lane % 4;  // accumulator row and column pair
  bf16* os = sm.o[warp];
  for (int it = 0; band < n_bands; band += gridDim.x, ++it) {
    // the next band's copies go out before this one is waited for
    if (band + gridDim.x < n_bands)
      stage_band(sm.x[(it + 1) & 1], x, band + gridDim.x, n_pix, H, W, Hp, Wp);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* xs = sm.x[it & 1] + warp * 16 * kLd;

    float acc[kE / 8][4];
#pragma unroll
    for (int n = 0; n < kE / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks) {
      unsigned a[4];
      ldsm_x4(a, xs + (lane & 15) * kLd + 16 * ks + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < kE / 8; n += 2) {
        unsigned r[4];
        ldsm_x4(r, sm.w + (8 * n + (lane & 7) + ((lane >> 4) << 3)) * kLd + 16 * ks +
                       ((lane >> 3) & 1) * 8);
        mma_k16(acc[n], a, r[0], r[1]);
        mma_k16(acc[n + 1], a, r[2], r[3]);
      }
    }

    // rows gr (h = 0) and gr + 8 (h = 1): y = bf16(bf16(acc) + bias), the
    // LayerNorm's sums by lane in channel order, then over the quad
    float s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kE / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bv = sm.bias[8 * n + 2 * qc + (e & 1)];
        acc[n][e] = round_bf16(__fadd_rn(round_bf16(acc[n][e]), bv));
        s[e >> 1] = __fadd_rn(s[e >> 1], acc[n][e]);
      }
    float mu[2], v[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
      mu[h] = __fmul_rn(s[h], 1.0f / kE);
    }
#pragma unroll
    for (int n = 0; n < kE / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] = __fsub_rn(acc[n][e], mu[e >> 1]);
        v[e >> 1] = __fadd_rn(v[e >> 1], __fmul_rn(acc[n][e], acc[n][e]));
      }
    float rstd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
      v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
      rstd[h] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fmul_rn(v[h], 1.0f / kE), eps)));
    }
#pragma unroll
    for (int n = 0; n < kE / 8; ++n) {
      const int col = 8 * n + 2 * qc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float o2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o2[e] = __fadd_rn(__fmul_rn(__fmul_rn(acc[n][2 * h + e], rstd[h]), sm.g[col + e]),
                            sm.be[col + e]);
        *reinterpret_cast<unsigned*>(os + (gr + 8 * h) * kOutLd + col) = bf16x2_rn(o2[0], o2[1]);
      }
    }
    __syncwarp();
    // the warp's 16 pixel rows, 16 bytes a lane
    const long long pix0 = band * kBand + warp * 16;
#pragma unroll
    for (int m = 0; m < 16 * kE / 8 / 32; ++m) {
      const int e = lane + 32 * m, row = e / (kE / 8), chunk = e % (kE / 8);
      if (pix0 + row < n_pix)
        *reinterpret_cast<uint4*>(out + (pix0 + row) * kE + 8 * chunk) =
            *reinterpret_cast<const uint4*>(os + row * kOutLd + 8 * chunk);
    }
    __syncwarp();
    __syncthreads();  // the band's buffer is spent: the next copies may land there
  }
  cp_async_wait<0>();
}

}  // namespace

// x (B, H, W*3) bf16 flat rows, H and W multiples of 4; w (48, 128) bf16;
// bias (128) bf16; g, be (128) f32, the LayerNorm's as the module holds
// them; out (B, H/4, W/4, 128) bf16.
extern "C" int patch_embed(const void* x, const void* w, const void* bias,
                           const void* g, const void* be, void* out, int B,
                           int H, int W, float eps, void* stream) {
  const long long n_pix = (long long)B * (H / kP) * (W / kP);
  if (n_pix == 0) return (int)cudaSuccess;
  const long long n_bands = (n_pix + kBand - 1) / kBand;
  const size_t smem = sizeof(Smem);
  const int resident = blocks_per_device(patch_embed_mma_kernel, smem, kThreads);
  const int grid = (int)std::min<long long>(n_bands, resident);
  patch_embed_mma_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)bias, (const float*)g, (const float*)be,
      (bf16*)out, B, H, W, eps);
  return (int)cudaGetLastError();
}
