// K16: the fused DSCF attention: the rpe bias sampled inside the score loop
// and K4's attention in its unpacked form, in one kernel.  Every query
// pixel (r, c) and head e of group bg attends over the M deformable keys:
//   out = softmax_j(bf16(q * scale) . k_j + bf16(sample(table, r, c, j))) . V
// with the unnormalised weights rounded to bf16, P.V summed in f32 and
// divided by the softmax denominator after it, rounded once.
//
// Replaces ir_ads_tpu/ops/pallas_dscf.py:_dscf_fused_kernel (launched by
// pallas_dscf_attention_fused, the reference DAttentionMM's pallas4).  The
// TPU kernel builds the bias of a band of query rows in a VMEM scratch
// (hg x rows x M x w f32, up to 24 MB) with K3's hat-weight products and
// rounding points, then runs the unpacked rows attention on it.  Nothing of
// that size fits 227 KB of shared memory, and nothing needs to: each score's
// bias is sampled where the score is (csrc/dscf.cuh's rpe_key, rpe_row and
// rpe_pixel, which composes rpe_col, rpe_u, rpe_two_tap and rpe_search, the
// parts K3 calls: bf16 hat weights in the order (ay*r - s) + by, the bf16
// table, a bf16 u, the bias rounded to bf16 and widened), and the attention
// is K4's unpacked form.  Both are the device
// code K3 and K4 run, with every operation written out, so K16 is bit-equal
// to K3 followed by K4 with packed=0, and no bias reaches device memory.
// The reference's band (rows dividing h with rows * w a multiple of 8) is a
// VMEM tiling with no counterpart here; the wrapper keeps its domain.
//
// Bound on an H100: operations on the CUDA cores (no bias to read: q, k, v
// and the output are a few MB, while each score costs the 2 x 2-tap sample,
// about 60 f32 operations, beside its share of the two dots).
//
// M <= 1024 (dscf_attend_mma<false>, K4's unpacked form on the tensor
// cores): persistent blocks, a warpgroup each, one (bg, head) plane a
// block, walking its tiles of 16 consecutive query pixels.  A block stages,
// once for its plane, K and V as bf16 rows, each key's origin (by, bx) on
// the table, and the (bg % G, e) table rounded to bf16 (37.8 KB at Swin-B's
// 119 x 159), which is only ever read rounded, with a row and a column of
// zeros past its last, which the two-tap sample reads at the table's edge;
// then, once a tile, the y taps and their hat weights of every (image row,
// key) the tile touches (one row at w % 16 == 0, up to two at level 2's w =
// 40).  Each lane samples the bias of its scores once, where they sit in
// the MMA's C layout (pixels g and g + 8 of the tile, keys 8n + 2t and 8n
// + 2t + 1), from those parts: only the x taps and the table reads are its
// own.
// Past 1024 keys: one block per (bg, head) and 256 query pixels, one
// thread per query pixel (dscf_attend<false>, as K4 there), the sample
// computed whole in each of its two passes.
#include "dscf.cuh"

using namespace port;

namespace {

constexpr int HC = kDscfHeadChannels;
constexpr int kMaxTiles = 32;  // n-tiles a warp at most: M <= 1024 on the tensor cores

__global__ void __launch_bounds__(kThreads)
dscf_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ pos,
                  const float* __restrict__ table, bf16* __restrict__ out, int G,
                  int hg, int h, int w, int M, int Mp, int s1, int s2, float scale,
                  float ay, float ax) {
  extern __shared__ __align__(16) float kv_s[];
  float* K_s = kv_s;
  float* V_s = kv_s + M * HC;
  const int bg = blockIdx.y / hg, e = blockIdx.y % hg;
  const int HW = h * w, GC = hg * HC;
  stage_head_kv(k + (size_t)bg * Mp * GC + e * HC, v + (size_t)bg * Mp * GC + e * HC, M,
                GC, K_s, V_s);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int r = p / w, c = p % w;
  float qs[HC], acc[HC];
  scaled_query(q + ((size_t)bg * HW + p) * GC + e * HC, scale, qs);
  dscf_attend<false>(qs, K_s, V_s, M, [&](int j) {
    return round_bf16(rpe_sample(pos, table, bg, e, j, r, c, G, hg, M, s1, s2, ay, ax));
  }, acc);
  bf16* op = out + ((size_t)bg * HW + p) * GC + e * HC;
#pragma unroll
  for (int d = 0; d < HC; ++d) op[d] = __float2bfloat16(acc[d]);
}

// The image rows a tile of 16 query pixels at p0 touches.
__host__ __device__ __forceinline__ int tile_span(int p0, int HW, int w) {
  const int end = p0 + kTileRows < HW ? p0 + kTileRows : HW;
  return (end - 1) / w - p0 / w + 1;
}

// Shared memory: K and V rows (padded to the warps' keys), (by, bx) of each
// key, then ``span`` image rows' y parts of each key (rpe_pair's y1, and
// the middle two bf16 hat weights as one word), then the bf16 table with a
// row and a column of zeros past its last, (S1 + 1) x (S2 + 1).  At Swin-B's
// shapes three blocks fit on an SM.
template <int NT>
size_t fused_smem(int M, int span, int s1, int s2) {
  constexpr int kRows = kMmaWarps * 8 * NT;
  return (size_t)kRows * 2 * sizeof(uint4) +
         (size_t)M * (2 * sizeof(float) + span * sizeof(uint2)) +
         (size_t)(s1 + 1) * (s2 + 1) * sizeof(bf16);
}

template <int NT>
__global__ void __launch_bounds__(kMmaThreads, 2)
dscf_fused_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ pos,
                      const float* __restrict__ table, bf16* __restrict__ out, int G,
                      int hg, int h, int w, int M, int Mp, int s1, int s2, float scale,
                      float ay, float ax, int span) {
  constexpr int kRows = kMmaWarps * 8 * NT;  // keys padded to the warps' n-tiles
  constexpr int kTableLoads = 8;             // table loads in flight a thread
  extern __shared__ __align__(16) uint4 fused_s[];
  __shared__ PackedRed red;
  uint4* K_s = fused_s;
  uint4* V_s = K_s + kRows;
  float* by_s = reinterpret_cast<float*>(V_s + kRows);
  float* bx_s = by_s + M;
  uint2* y_s = reinterpret_cast<uint2*>(bx_s + M);  // span x M
  bf16* T_s = reinterpret_cast<bf16*>(y_s + span * M);
  const int plane = blockIdx.y, bg = plane / hg, e = plane % hg;
  const int HW = h * w, GC = hg * HC, S2P = s2 + 1, STP = (s1 + 1) * S2P;
  const int tiles = (HW + kTileRows - 1) / kTileRows;
  const float* T = table + ((size_t)(bg % G) * hg + e) * s1 * s2;
  for (int i0 = threadIdx.x; i0 < STP; i0 += kTableLoads * kMmaThreads) {
    float t[kTableLoads];
#pragma unroll
    for (int u = 0; u < kTableLoads; ++u) {
      const int i = i0 + u * kMmaThreads, s = i / S2P, c = i % S2P;
      t[u] = i < STP && (unsigned)s < (unsigned)s1 && (unsigned)c < (unsigned)s2
                 ? __ldg(T + s * s2 + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kTableLoads; ++u) {
      const int i = i0 + u * kMmaThreads;
      if (i < STP) T_s[i] = __float2bfloat16(t[u]);
    }
  }
  stage_kv_rows(k + (size_t)bg * Mp * GC + e * HC, v + (size_t)bg * Mp * GC + e * HC, M, GC,
                kRows, K_s, V_s);
  for (int j = threadIdx.x; j < M; j += kMmaThreads) {
    const RpeKey key = rpe_key(pos + ((size_t)bg * M + j) * 2, s1, s2);
    by_s[j] = key.by;
    bx_s[j] = key.bx;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int key0 = warp * 8 * NT;
  const auto tab = [&](int s, int t) { return __bfloat162float(T_s[s * S2P + t]); };
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = tile * kTileRows, rows = min(kTileRows, HW - p0), r0 = p0 / w;
    // the y parts of the tile's image rows (the last tile's were read
    // before its store_tile barrier)
    const int n_rows = tile_span(p0, HW, w);
    for (int idx = threadIdx.x; idx < n_rows * M; idx += kMmaThreads) {
      const int slot = idx / M, j = idx % M;
      const RpeRow y = rpe_row(ay, r0 + slot, by_s[j], s1);
      y_s[slot * M + j] = make_uint2((unsigned)rpe_pair(y, s1),
                                         pack_bf16x2(y.wy[1], y.wy[2]));
    }
    __syncthreads();
    // the lane's two query pixels: tile rows g and g + 8
    const int pa = p0 + min(g, rows - 1), pb = p0 + min(g + 8, rows - 1);
    const int ra = pa / w, rb = pb / w;
    const uint2* ya = y_s + (ra - r0) * M;
    const uint2* yb = y_s + (rb - r0) * M;
    const float aca = __fmul_rn(ax, (float)(pa % w)), acb = __fmul_rn(ax, (float)(pb % w));
    const unsigned qa0 = scaled_query_pair(q + ((size_t)bg * HW + pa) * GC + e * HC, t, scale);
    const unsigned qa1 = scaled_query_pair(q + ((size_t)bg * HW + pb) * GC + e * HC, t, scale);
    float o[4];
    dscf_attend_mma<false, NT>(qa0, qa1, K_s + key0, V_s + key0, [&](int nt, float* b) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = key0 + 8 * (nt + i) + 2 * t + jj;
          if (j < M) {
            const float bx = bx_s[j];
            const auto sample = [&](const uint2* yr, int r, float ac) {
              const uint2 yp = yr[j];
              return round_bf16_alu(rpe_pixel(
                  (int)yp.x, bf16_lo(yp.y), bf16_hi(yp.y),
                  [&] { return rpe_row(ay, r, by_s[j], s1); }, tab, ac, bx, s2));
            };
            b[4 * i + jj] = sample(ya, ra, aca);
            b[4 * i + 2 + jj] = sample(yb, rb, acb);
          } else {  // a padded key
            b[4 * i + jj] = b[4 * i + 2 + jj] = -INFINITY;
          }
        }
      }
    }, red, o);
    store_tile<false>(o, red, out + ((size_t)bg * HW + p0) * GC + e * HC, GC, rows);
  }
}

}  // namespace

extern "C" int dscf_fused_attention(const void* q, const void* k, const void* v,
                                    const void* pos, const void* table, void* out,
                                    int BG, int G, int hg, int h, int w, int M, int Mp,
                                    int s1, int s2, float scale, float ay, float ax,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M > 32 * kMaxTiles) {  // too many keys for the tensor-core design
    const size_t smem = (size_t)2 * M * HC * sizeof(float);
    cudaFuncSetAttribute(dscf_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    dim3 grid((h * w + kThreads - 1) / kThreads, BG * hg);
    dscf_fused_kernel<<<grid, kThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)pos,
        (const float*)table, (bf16*)out, G, hg, h, w, M, Mp, s1, s2, scale, ay, ax);
    return (int)cudaGetLastError();
  }
  const int HW = h * w, tiles = (HW + kTileRows - 1) / kTileRows;
  int span = 1;
  for (int p0 = 0; p0 < HW; p0 += kTileRows) span = std::max(span, tile_span(p0, HW, w));
  return WarpTiles<4, 8, 12, 16, 20, 24, 28, kMaxTiles>::with((M + 31) / 32, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    auto kernel = dscf_fused_mma_kernel<NT>;
    const size_t smem = fused_smem<NT>(M, span, s1, s2);
    if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
    const dim3 grid = plane_grid(kernel, smem, BG * hg, tiles);
    kernel<<<grid, kMmaThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)pos,
        (const float*)table, (bf16*)out, G, hg, h, w, M, Mp, s1, s2, scale, ay, ax, span);
    return (int)cudaGetLastError();
  });
}
