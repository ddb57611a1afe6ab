// K4: DSCF deformable attention in the rows layout.  Every query pixel and
// head attends over the M deformable keys of its (batch, group):
//   out = softmax_j(bf16(q * scale) . k_j + bias[j]) . V,
// with the K3 bias (BG, hg, h, M, w) added in f32.
//
// Replaces the two rows kernels of ir_ads_tpu/ops/pallas_dscf.py (launched
// by pallas_dscf_attention_rows), which round differently in bf16 and are
// chosen per level by the reference's DAttentionMM (IR_ADS_DSCF_PACKED,
// default "1,1,1,0"):
//   packed=1  _dscf_rows_kernel_packed: the probabilities normalised,
//             exp(s - max) / den, rounded to bf16, then P.V (levels 0-2);
//   packed=0  _dscf_rows_kernel: the unnormalised exp(s - max) rounded to
//             bf16, P.V summed in f32, divided by den, rounded once
//             (level 3).
// Padded keys (M <= j < Mp) are masked with -1e9 on the TPU; here they are
// simply not visited, which gives the same result (exp(-1e9 - max) is 0 in
// f32).
//
// Bound on an H100: bytes (the (BG, hg, h, M, w) bf16 bias is the only
// large input, 2 bytes a score).  What sets the pace is the work a score
// takes beside its two dots: exp, the bf16 rounding and, in the packed
// form, a true division.
//
// M <= 1024, both forms (dscf_attend_mma, csrc/dscf.cuh): the score dot
// and P.V on the tensor cores (mma.sync), a warpgroup for 16 query pixels,
// the keys split over its four warps, every f32 score held in registers
// until the final max and den; the form sets the A operand of P.V (the
// normalised p or the unnormalised e) and whether the sum is divided by den
// after it.  Persistent blocks, one (bg, head) each, stage its K and V once
// and walk its tiles of 16 consecutive query pixels.  A tile's bias is an M
// x 16 box of the (bg, head)'s (h, M, w) slab, the keys at a stride of w:
// it comes into shared memory by 16-byte cp.async copies of 8 pixels (32
// contiguous bytes a key row; 8-byte copies where w % 8 != 0, as at level
// 3's w = 20), double-buffered so that the next tile's box is in flight
// during this one, and ldmatrix.trans reads it transposed into the score
// layout, the row halves swizzled against bank conflicts.  K16 runs the
// unpacked form's device code on a bias it samples itself and must stay
// bit-equal to K3 followed by this kernel.
//
// Past 1024 keys, both forms (dscf_attend, whose unpacked form K16 also
// runs there): one block per (bg, head) and 256 query pixels, K and V
// staged as f32; one thread per query pixel walks the keys for the max and
// den, then for P.V, reading the bias along the query column, so every
// pass coalesces.
//
// A head has 8 channels (every Swin-B level), 12 (every Swin-L level), or
// at the MiT's stages 8, 8, 10, 8 (CMNeXt-B1..B5) and 4, 4, 5, 4
// (CMNeXt-B0): the kernels are templates of the width (hc).  At 10 and 12,
// K and V are staged as two planes of 8-channel rows, the second's
// channels past the head zero in shared memory (never in device memory):
// the score is two m16n8k8 products into one f32 accumulator and P.V one
// m16n8k16 product a plane, so the rounding points stay the plain
// version's.  At 4 and 5 the one plane's channels past the head are zero.
// A head's row starts on a 16-byte boundary only at 8 channels; at 12 on an
// 8-byte one, at 4 and 10 on a 4-byte one and at 5 on a 2-byte one, and
// each width reads its rows in words of that size (load_head_row,
// scaled_query_channels).  The store writes each channel of the head alone:
// at gc = 10 and 20 the channels past a head are the next head's.
#include "dscf.cuh"

using namespace port;

namespace {

constexpr int kMaxTiles = 32;  // n-tiles a warp at most: M <= 1024 on the tensor cores

template <bool Packed, int HC>
__global__ void __launch_bounds__(kThreads)
dscf_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ bias,
                 bf16* __restrict__ out, int hg, int h, int w, int M, int Mp,
                 float scale) {
  extern __shared__ __align__(16) float kv_s[];
  float* K_s = kv_s;
  float* V_s = kv_s + M * HC;
  const int bg = blockIdx.y / hg, e = blockIdx.y % hg;
  const int HW = h * w, GC = hg * HC;
  stage_head_kv<HC>(k + (size_t)bg * Mp * GC + e * HC, v + (size_t)bg * Mp * GC + e * HC, M,
                    GC, K_s, V_s);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int r = p / w, c = p % w;
  float qs[HC], acc[HC];
  scaled_query<HC>(q + ((size_t)bg * HW + p) * GC + e * HC, scale, qs);
  const bf16* bp = bias + (((size_t)bg * hg + e) * h + r) * M * w + c;
  dscf_attend<Packed, HC>(qs, K_s, V_s, M,
                      [&](int j) { return __bfloat162float(bp[(size_t)j * w]); }, acc);
  bf16* op = out + ((size_t)bg * HW + p) * GC + e * HC;
#pragma unroll
  for (int d = 0; d < HC; ++d) op[d] = __float2bfloat16(acc[d]);
}

// A tile's bias box: key rows of the 16 query pixels' bf16 (32 bytes), the
// two 16-byte halves swapped in rows 4-7 of every 8, so that ldmatrix's
// eight row reads of one half meet no bank twice.
__device__ __forceinline__ int box_at(int j, int t) {
  return j * kTileRows + 8 * ((t >> 3) ^ ((j >> 2) & 1)) + (t & 7);
}

// The box of the tile at query pixel p0 of one (bg, head)'s slab (h, M, w):
// bias of pixel min(p0 + t, HW - 1) and key j.  w % 8 == 0 (Swin-B's levels
// 0-2): 16-byte cp.async copies of 8 pixels, which then lie in one image
// row; w % 4 == 0: 8-byte copies; else 16-bit loads and stores.  All
// threads of the block call it.
__device__ __forceinline__ void stage_box(const bf16* __restrict__ slab, bf16* box, int p0,
                                          int HW, int w, int M) {
  auto src = [&](int j, int p) { return slab + ((size_t)(p / w) * M + j) * w + p % w; };
  if (w % 8 == 0) {
    for (int idx = threadIdx.x; idx < M * 2; idx += kMmaThreads) {
      const int j = idx >> 1, t = 8 * (idx & 1);
      cp_async16(box + box_at(j, t), src(j, min(p0 + t, HW - 8)));
    }
  } else if (w % 4 == 0) {
    for (int idx = threadIdx.x; idx < M * 4; idx += kMmaThreads) {
      const int j = idx >> 2, t = 4 * (idx & 3);
      cp_async8(box + box_at(j, t), src(j, min(p0 + t, HW - 4)));
    }
  } else {
    for (int idx = threadIdx.x; idx < M * kTileRows; idx += kMmaThreads) {
      const int j = idx / kTileRows, t = idx % kTileRows;
      box[box_at(j, t)] = *src(j, min(p0 + t, HW - 1));
    }
  }
}

template <bool Packed, int NT, int HC>
__global__ void __launch_bounds__(kMmaThreads, NT <= 20 ? 3 : 2)
dscf_rows_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ bias,
                     bf16* __restrict__ out, int hg, int h, int w, int M, int Mp,
                     float scale) {
  constexpr int P = kHeadPlanes<HC>;
  constexpr int kRows = kMmaWarps * 8 * NT;  // keys padded to the warps' n-tiles
  constexpr int kBoxElems = kRows * kTileRows;
  extern __shared__ __align__(16) uint4 kvb_s[];
  __shared__ PackedRedT<HC> red;
  uint4* K_s = kvb_s;  // P planes of kRows rows each, then V's
  uint4* V_s = kvb_s + P * kRows;
  bf16* boxes = reinterpret_cast<bf16*>(V_s + P * kRows);
  const int bgh = blockIdx.y, bg = bgh / hg, e = bgh % hg;
  const int HW = h * w, GC = hg * HC;
  const int tiles = (HW + kTileRows - 1) / kTileRows;
  const bf16* slab = bias + (size_t)bgh * h * M * w;
  int tile = blockIdx.x;
  stage_box(slab, boxes, tile * kTileRows, HW, w, M);
  cp_async_commit();
  stage_kv_rows<HC>(k + (size_t)bg * Mp * GC + e * HC, v + (size_t)bg * Mp * GC + e * HC, M,
                    GC, kRows, K_s, V_s);
  for (int idx = threadIdx.x; idx < (kRows - M) * kTileRows; idx += kMmaThreads) {
    const int j = M + idx / kTileRows, t = idx % kTileRows;  // padded keys: bias -inf
    boxes[box_at(j, t)] = boxes[kBoxElems + box_at(j, t)] = __float2bfloat16(-INFINITY);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int key0 = warp * 8 * NT;
  for (int n = 0; tile < tiles; ++n, tile += gridDim.x) {
    cp_async_wait_all();  // this tile's box has landed (this thread's copies)
    __syncthreads();      // ... every thread's, K and V too; the other box is free
    if (tile + gridDim.x < tiles) {  // the next tile's box, in flight during this one
      stage_box(slab, boxes + ((n + 1) & 1) * kBoxElems, (tile + gridDim.x) * kTileRows, HW,
                w, M);
      cp_async_commit();
    }
    const bf16* box = boxes + (n & 1) * kBoxElems;
    const int p0 = tile * kTileRows, rows = min(kTileRows, HW - p0);
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
    float o[4 * P];
    dscf_attend_mma<Packed, NT, HC>(qa0, qa1, K_s + key0, V_s + key0, [&](int nt, float* b) {
      // matrix m of the ldmatrix: n-tile nt + m / 2, query half m % 2
      const int m = lane >> 3, j = key0 + 8 * (nt + (m >> 1)) + (lane & 7);
      unsigned r[4];
      ldsm_x4_t(r, box + j * kTileRows + 8 * ((m & 1) ^ ((j >> 2) & 1)));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b[2 * i] = bf16_lo(r[i]);
        b[2 * i + 1] = bf16_hi(r[i]);
      }
    }, red, o, qa2, qa3);
    store_tile<Packed, HC>(o, red, out + ((size_t)bg * HW + p0) * GC + e * HC, GC, rows);
  }
}

template <bool Packed, int HC>
int launch_thread(const void* q, const void* k, const void* v, const void* bias, void* out,
                  int BG, int hg, int h, int w, int M, int Mp, float scale,
                  cudaStream_t stream) {
  const size_t smem = (size_t)2 * M * HC * sizeof(float);
  cudaFuncSetAttribute(dscf_rows_kernel<Packed, HC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((h * w + kThreads - 1) / kThreads, BG * hg);
  dscf_rows_kernel<Packed, HC><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias,
      (bf16*)out, hg, h, w, M, Mp, scale);
  return (int)cudaGetLastError();
}

template <bool Packed, int HC>
int launch_mma(const void* q, const void* k, const void* v, const void* bias, void* out,
               int BG, int hg, int h, int w, int M, int Mp, float scale, cudaStream_t stream) {
  return WarpTiles<4, 8, 12, 16, 20, 24, 28, kMaxTiles>::with((M + 31) / 32, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    auto kernel = dscf_rows_mma_kernel<Packed, NT, HC>;
    const size_t smem = (size_t)kMmaWarps * 8 * NT *
                        (2 * kHeadPlanes<HC> * sizeof(uint4) + 2 * kTileRows * sizeof(bf16));
    const dim3 grid = plane_grid(kernel, smem, BG * hg, (h * w + kTileRows - 1) / kTileRows);
    kernel<<<grid, kMmaThreads, smem, stream>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                                (const bf16*)bias, (bf16*)out, hg, h, w, M, Mp,
                                                scale);
    return (int)cudaGetLastError();
  });
}

template <int HC>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int BG,
           int hg, int h, int w, int M, int Mp, float scale, int packed, cudaStream_t s) {
  if (M > 32 * kMaxTiles)  // too many keys for the tensor-core design
    return packed ? launch_thread<true, HC>(q, k, v, bias, out, BG, hg, h, w, M, Mp, scale, s)
                  : launch_thread<false, HC>(q, k, v, bias, out, BG, hg, h, w, M, Mp, scale, s);
  return packed ? launch_mma<true, HC>(q, k, v, bias, out, BG, hg, h, w, M, Mp, scale, s)
                : launch_mma<false, HC>(q, k, v, bias, out, BG, hg, h, w, M, Mp, scale, s);
}

}  // namespace

// hc: channels per head, 4, 5, 8, 10 or 12.
extern "C" int dscf_rows_attention(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int BG, int hg,
                                   int h, int w, int M, int Mp, float scale,
                                   int packed, int hc, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (hc) {
    case 4: return launch<4>(q, k, v, bias, out, BG, hg, h, w, M, Mp, scale, packed, s);
    case 5: return launch<5>(q, k, v, bias, out, BG, hg, h, w, M, Mp, scale, packed, s);
    case 8: return launch<8>(q, k, v, bias, out, BG, hg, h, w, M, Mp, scale, packed, s);
    case 10: return launch<10>(q, k, v, bias, out, BG, hg, h, w, M, Mp, scale, packed, s);
    case 12: return launch<12>(q, k, v, bias, out, BG, hg, h, w, M, Mp, scale, packed, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
