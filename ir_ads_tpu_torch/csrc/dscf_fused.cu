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
//
// A head has 8 channels (every Swin-B DSCF level) or 12 (every Swin-L
// level): the kernels are templates of the width (HC), as K4's are, and
// only these two are instantiated, since no path runs K16 at the MiT's 4,
// 5 or 10 (a legacy model takes level 3's DSCF entry, the einsum under
// dscf_pallas4); at 12 only the tile counts FusedTiles names.  At 12 channels K and V are staged as two planes of
// 8-channel rows, the channels past the head zero, and the query's A
// fragments of the second plane come from channels 8-11 (csrc/dscf.cuh's
// load_head_row and scaled_query_channels, 8-byte and 4-byte words): the
// sampling in the score loop is the same for every width, and the score
// is two m16n8k8 products into one accumulator, P.V one m16n8k16 a plane,
// K4's steps at 12 channels, so K16 stays bit-equal to K3 then K4.  The
// second plane adds 20 KB of K and V rows at 600 keys (94 KB a block at
// Swin-L's level 2, two blocks an SM); where the shared memory a launch
// needs passes what a block may take, the launch is refused
// (cudaErrorInvalidValue) and the wrapper raises.
#include "dscf.cuh"

using namespace port;

namespace {

constexpr int kMaxTiles = 32;  // n-tiles a warp at most: M <= 1024 on the tensor cores

// The n-tile counts the tensor-core kernel is built for, by head width: at
// 8 channels K4's counts, so that K16 stays bit-equal to K3 then K4 at
// every M up to 1024; at 12 the count of Swin-L's M = 600 at 480x640 (20)
// and the smallest (4, M <= 128), each a kernel that nvcc takes about 14 s
// for, the largest counts the longest; past the last count the thread form
// runs.  Where K4 at 12 takes another count (M 129..512, 641..1024) K16
// has its rounding points and another order of the f32 sums.
template <int HC>
struct FusedTiles {
  using Counts = WarpTiles<4, 8, 12, 16, 20, 24, 28, kMaxTiles>;
  static constexpr int kMax = kMaxTiles;
};
template <>
struct FusedTiles<12> {
  using Counts = WarpTiles<4, 20>;
  static constexpr int kMax = 20;
};

template <int HC>
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
  stage_head_kv<HC>(k + (size_t)bg * Mp * GC + e * HC, v + (size_t)bg * Mp * GC + e * HC,
                    M, GC, K_s, V_s);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int r = p / w, c = p % w;
  float qs[HC], acc[HC];
  scaled_query<HC>(q + ((size_t)bg * HW + p) * GC + e * HC, scale, qs);
  dscf_attend<false, HC>(qs, K_s, V_s, M, [&](int j) {
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

// Shared memory: K and V rows (padded to the warps' keys, a plane of them
// per 8 channels of the head), (by, bx) of each key, then ``span`` image
// rows' y parts of each key (rpe_pair's y1, and the middle two bf16 hat
// weights as one word), then the bf16 table with a row and a column of
// zeros past its last, (S1 + 1) x (S2 + 1).  At Swin-B's shapes three
// blocks fit on an SM, at Swin-L's two.
template <int NT, int HC>
size_t fused_smem(int M, int span, int s1, int s2) {
  constexpr int kRows = kMmaWarps * 8 * NT;
  return (size_t)kRows * 2 * kHeadPlanes<HC> * sizeof(uint4) +
         (size_t)M * (2 * sizeof(float) + span * sizeof(uint2)) +
         (size_t)(s1 + 1) * (s2 + 1) * sizeof(bf16);
}

template <int NT, int HC>
__global__ void __launch_bounds__(kMmaThreads, 2)
dscf_fused_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ pos,
                      const float* __restrict__ table, bf16* __restrict__ out, int G,
                      int hg, int h, int w, int M, int Mp, int s1, int s2, float scale,
                      float ay, float ax, int span) {
  constexpr int P = kHeadPlanes<HC>;
  constexpr int kRows = kMmaWarps * 8 * NT;  // keys padded to the warps' n-tiles
  constexpr int kTableLoads = 8;             // table loads in flight a thread
  extern __shared__ __align__(16) uint4 fused_s[];
  __shared__ PackedRedT<HC> red;
  uint4* K_s = fused_s;  // P planes of kRows rows each, then V's
  uint4* V_s = K_s + P * kRows;
  float* by_s = reinterpret_cast<float*>(V_s + P * kRows);
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
  stage_kv_rows<HC>(k + (size_t)bg * Mp * GC + e * HC, v + (size_t)bg * Mp * GC + e * HC, M,
                    GC, kRows, K_s, V_s);
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
    const bf16* q0 = q + ((size_t)bg * HW + pa) * GC + e * HC;
    const bf16* q1 = q + ((size_t)bg * HW + pb) * GC + e * HC;
    // channels 2t, 2t + 1 of the first plane and 8 + 2t, 9 + 2t of the
    // second, zero past the head
    const unsigned qa0 = scaled_query_channels<HC>(q0, 2 * t, scale);
    const unsigned qa1 = scaled_query_channels<HC>(q1, 2 * t, scale);
    const unsigned qa2 = P > 1 ? scaled_query_channels<HC>(q0, 8 + 2 * t, scale) : 0u;
    const unsigned qa3 = P > 1 ? scaled_query_channels<HC>(q1, 8 + 2 * t, scale) : 0u;
    float o[4 * P];
    dscf_attend_mma<false, NT, HC>(qa0, qa1, K_s + key0, V_s + key0, [&](int nt, float* b) {
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
    }, red, o, qa2, qa3);
    store_tile<false, HC>(o, red, out + ((size_t)bg * HW + p0) * GC + e * HC, GC, rows);
  }
}

template <int HC>
int launch(const void* q, const void* k, const void* v, const void* pos, const void* table,
           void* out, int BG, int G, int hg, int h, int w, int M, int Mp, int s1, int s2,
           float scale, float ay, float ax, cudaStream_t st) {
  if (M > 32 * FusedTiles<HC>::kMax) {  // too many keys for the tensor-core kernels built
    const size_t smem = (size_t)2 * M * HC * sizeof(float);
    if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(dscf_fused_kernel<HC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    dim3 grid((h * w + kThreads - 1) / kThreads, BG * hg);
    dscf_fused_kernel<HC><<<grid, kThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)pos,
        (const float*)table, (bf16*)out, G, hg, h, w, M, Mp, s1, s2, scale, ay, ax);
    return (int)cudaGetLastError();
  }
  const int HW = h * w, tiles = (HW + kTileRows - 1) / kTileRows;
  int span = 1;
  for (int p0 = 0; p0 < HW; p0 += kTileRows) span = std::max(span, tile_span(p0, HW, w));
  return FusedTiles<HC>::Counts::with((M + 31) / 32, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    auto kernel = dscf_fused_mma_kernel<NT, HC>;
    const size_t smem = fused_smem<NT, HC>(M, span, s1, s2);
    if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
    const dim3 grid = plane_grid(kernel, smem, BG * hg, tiles);
    kernel<<<grid, kMmaThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)pos,
        (const float*)table, (bf16*)out, G, hg, h, w, M, Mp, s1, s2, scale, ay, ax, span);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// hc: channels per head, 8 or 12.
extern "C" int dscf_fused_attention(const void* q, const void* k, const void* v,
                                    const void* pos, const void* table, void* out,
                                    int BG, int G, int hg, int h, int w, int M, int Mp,
                                    int s1, int s2, float scale, float ay, float ax, int hc,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (hc) {
    case 8:
      return launch<8>(q, k, v, pos, table, out, BG, G, hg, h, w, M, Mp, s1, s2, scale, ay,
                       ax, st);
    case 12:
      return launch<12>(q, k, v, pos, table, out, BG, G, hg, h, w, M, Mp, s1, s2, scale, ay,
                        ax, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
