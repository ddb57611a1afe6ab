// K17: DSCF deformable attention over a packed bias.  Every query pixel p
// and head e of group bg attends over the Mp keys of its group:
//   out = softmax_j(bf16(q * scale) . k_j + bias[bg, p, e*Mp + j]) . V,
// softmax in f32, the normalised probabilities rounded to bf16 before P.V
// (jax.nn.softmax, then the cast), P.V summed in f32, rounded once.
//
// Replaces ir_ads_tpu/ops/pallas_dscf.py:_dscf_kernel (launched by
// pallas_dscf_attention, the reference DAttentionMM's pallas and pallas2).
// Layouts as the TPU kernel's: q (BG, HW, GC), k and v (BG, Mp, GC) with Mp
// a multiple of 128, bias (BG, HW, hg*Mp) bf16, head e in channels
// [e*HC, (e+1)*HC) and bias lanes [e*Mp, (e+1)*Mp).  The caller pads the
// keys with zeros and their bias columns with -1e9.  This kernel visits all
// Mp keys, as the TPU kernel does, so it computes the function for any
// bias; a padded key adds exactly 0 to the softmax sum and to P.V
// (exp(-1e9 - max) is 0 in f32).
//
// Bound on an H100: as K4's packed form (csrc/dscf_rows.cu), whose device
// code it runs (dscf_attend_mma<true, HC>, csrc/dscf.cuh): bytes (the bias,
// 2 bytes a score); the exp, the true division and the rounding of each
// score set the pace.  Design: one block, a warpgroup, per (bg, head) and
// 64 query pixels, K and V staged once as bf16 rows; four tiles of 16
// query pixels, the keys split over the four warps; each lane reads its
// scores' bias pairs (4 bytes) straight from the query's contiguous row, a
// warp load 8 rows x 16 bytes, the other half of each sector taken by the
// next n-tile's load.  Past 1024 keys: one thread a query pixel
// (dscf_attend<true, HC>), K and V staged as f32 (2 Mp HC 4 bytes: at 12
// channels up to Mp = 2304 in the 227 KB a block may take; past it the
// launch is refused with cudaErrorInvalidValue and the wrapper raises).
//
// A head has 8 channels (every Swin-B DSCF level), 12 (every Swin-L level)
// or, at the MiT's four stages, 8, 8, 10, 8 (CMNeXt-B1..B5) and 4, 4, 5, 4
// (CMNeXt-B0): the kernels are templates of the width, K4's design word
// for word where the device code is shared.  At 10 and 12 channels K and V
// are staged as two planes of 8-channel rows, the channels past the head
// zero in shared memory and in the query fragments: the score is two
// m16n8k8 products into one f32 accumulator and P.V one m16n8k16 product a
// plane, so the rounding points stay the plain version's.  A head's row
// starts on a 16-byte boundary only at 8 channels (12: 8 bytes, 4 and 10:
// 4, 5: 2), and each width reads its query and key rows in words of that
// size (scaled_query_channels, load_head_row); the store writes each
// channel alone (at gc = 10 and 20 the next head's channels follow).  The
// second plane doubles K and V in shared memory (40 KB at Mp = 640) and
// adds four registers of B fragments and four of P.V sums a lane, so a
// two-plane kernel asks for three resident blocks an SM where one plane
// asks for four (kMinBlocks).
#include "dscf.cuh"

using namespace port;

namespace {

constexpr int kBlockQueries = 64;  // query pixels a block takes: four tiles
constexpr int kKeyLanes = 128;     // Mp is a multiple of the TPU's lane width
constexpr int kMaxTiles = 32;      // n-tiles a warp at most: Mp <= 1024

// Past kMaxTiles: one thread a query pixel (dscf_attend<true, HC>), K and V
// as f32 in shared memory.
template <int HC>
__global__ void __launch_bounds__(kThreads)
dscf_attention_thread_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ bias,
                             bf16* __restrict__ out, int hg, int HW, int Mp, float scale) {
  extern __shared__ __align__(16) float kvf_s[];
  float* K_s = kvf_s;
  float* V_s = kvf_s + Mp * HC;
  const int bg = blockIdx.y / hg, e = blockIdx.y % hg, GC = hg * HC;
  stage_head_kv<HC>(k + (size_t)bg * Mp * GC + e * HC, v + (size_t)bg * Mp * GC + e * HC,
                    Mp, GC, K_s, V_s);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  float qs[HC], acc[HC];
  scaled_query<HC>(q + ((size_t)bg * HW + p) * GC + e * HC, scale, qs);
  const bf16* bp = bias + ((size_t)bg * HW + p) * hg * Mp + (size_t)e * Mp;
  dscf_attend<true, HC>(qs, K_s, V_s, Mp, [&](int j) { return __bfloat162float(bp[j]); },
                        acc);
  bf16* op = out + ((size_t)bg * HW + p) * GC + e * HC;
#pragma unroll
  for (int d = 0; d < HC; ++d) op[d] = __float2bfloat16(acc[d]);
}

// Resident blocks an SM the mma kernel asks for: four up to 640 keys with
// one plane, three with two (more registers a lane), two past 640 keys.
template <int NT, int HC>
constexpr int kMinBlocks = NT > 20 ? 2 : kHeadPlanes<HC> > 1 ? 3 : 4;

// K and V rows (bf16, key order; rows past Mp zero) of 4 warps x 8 NT keys,
// one plane of them per 8 channels of the head.
template <int NT, int HC>
__global__ void __launch_bounds__(kMmaThreads, kMinBlocks<NT, HC>)
dscf_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ bias,
                      bf16* __restrict__ out, int hg, int HW, int Mp, float scale) {
  constexpr int P = kHeadPlanes<HC>;
  constexpr int kRows = kMmaWarps * 8 * NT;
  extern __shared__ __align__(16) uint4 kv_s[];
  __shared__ PackedRedT<HC> red;
  uint4* K_s = kv_s;  // P planes of kRows rows each, then V's
  uint4* V_s = kv_s + P * kRows;
  const int bg = blockIdx.y / hg, e = blockIdx.y % hg, GC = hg * HC;
  stage_kv_rows<HC>(k + (size_t)bg * Mp * GC + e * HC, v + (size_t)bg * Mp * GC + e * HC, Mp,
                    GC, kRows, K_s, V_s);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int key0 = warp * 8 * NT;
  const int p_begin = blockIdx.x * kBlockQueries, n = min(kBlockQueries, HW - p_begin);
  for (int p0 = p_begin; p0 < p_begin + n; p0 += kTileRows) {
    const int rows = min(kTileRows, p_begin + n - p0);
    const size_t r0 = (size_t)bg * HW + p0 + min(g, rows - 1);
    const size_t r1 = (size_t)bg * HW + p0 + min(g + 8, rows - 1);
    const bf16* q0 = q + r0 * GC + e * HC;
    const bf16* q1 = q + r1 * GC + e * HC;
    // channels 2t, 2t + 1 of the first plane and 8 + 2t, 9 + 2t of the
    // second, zero past the head
    const unsigned qa0 = scaled_query_channels<HC>(q0, 2 * t, scale);
    const unsigned qa1 = scaled_query_channels<HC>(q1, 2 * t, scale);
    const unsigned qa2 = P > 1 ? scaled_query_channels<HC>(q0, 8 + 2 * t, scale) : 0u;
    const unsigned qa3 = P > 1 ? scaled_query_channels<HC>(q1, 8 + 2 * t, scale) : 0u;
    const bf16* b0 = bias + (r0 * hg + e) * Mp + key0 + 2 * t;
    const bf16* b1 = bias + (r1 * hg + e) * Mp + key0 + 2 * t;
    float o[4 * P];
    dscf_attend_mma<true, NT, HC>(qa0, qa1, K_s + key0, V_s + key0, [&](int nt, float* b) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key0 + 8 * (nt + i) + 2 * t;  // past Mp: -inf
        const unsigned w0 = key < Mp ? __ldg(reinterpret_cast<const unsigned*>(b0 + 8 * (nt + i)))
                                     : 0xff80ff80u;
        const unsigned w1 = key < Mp ? __ldg(reinterpret_cast<const unsigned*>(b1 + 8 * (nt + i)))
                                     : 0xff80ff80u;
        b[4 * i] = bf16_lo(w0);
        b[4 * i + 1] = bf16_hi(w0);
        b[4 * i + 2] = bf16_lo(w1);
        b[4 * i + 3] = bf16_hi(w1);
      }
    }, red, o, qa2, qa3);
    store_tile<true, HC>(o, red, out + ((size_t)bg * HW + p0) * GC + e * HC, GC, rows);
  }
}

template <int HC>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int BG,
           int hg, int HW, int Mp, float scale, cudaStream_t st) {
  if (Mp > 32 * kMaxTiles) {
    const size_t smem = (size_t)2 * Mp * HC * sizeof(float);
    if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(dscf_attention_thread_kernel<HC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    dim3 grid((HW + kThreads - 1) / kThreads, BG * hg);
    dscf_attention_thread_kernel<HC><<<grid, kThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias, (bf16*)out, hg,
        HW, Mp, scale);
    return (int)cudaGetLastError();
  }
  return WarpTiles<4, 8, 12, 16, 20, 24, 28, kMaxTiles>::with(Mp / 32, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    auto kernel = dscf_attention_kernel<NT, HC>;
    const size_t smem = (size_t)2 * kHeadPlanes<HC> * kMmaWarps * 8 * NT * sizeof(uint4);
    blocks_per_device(kernel, smem, kMmaThreads);  // allows its dynamic shared memory
    dim3 grid((HW + kBlockQueries - 1) / kBlockQueries, BG * hg);
    kernel<<<grid, kMmaThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias, (bf16*)out, hg,
        HW, Mp, scale);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// hc: channels per head, 4, 5, 8, 10 or 12.
extern "C" int dscf_attention(const void* q, const void* k, const void* v, const void* bias,
                              void* out, int BG, int hg, int HW, int Mp, float scale, int hc,
                              void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (Mp % kKeyLanes) return (int)cudaErrorInvalidValue;
  switch (hc) {
    case 4: return launch<4>(q, k, v, bias, out, BG, hg, HW, Mp, scale, st);
    case 5: return launch<5>(q, k, v, bias, out, BG, hg, HW, Mp, scale, st);
    case 8: return launch<8>(q, k, v, bias, out, BG, hg, HW, Mp, scale, st);
    case 10: return launch<10>(q, k, v, bias, out, BG, hg, HW, Mp, scale, st);
    case 12: return launch<12>(q, k, v, bias, out, BG, hg, HW, Mp, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
