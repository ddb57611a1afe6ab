// K8: the backward of DSCF deformable attention in the rows layout.  For
// every query pixel and head it recomputes the softmax over the M keys of
// its (batch, group) and turns the output cotangent dO into
//   dq    (BG, h*w, GC)      bf16,
//   dk    (BG, Mp, GC)       f32, summed over every query pixel,
//   dv    (BG, Mp, GC)       f32, summed over every query pixel,
//   dbias (BG, hg, h, M, w)  f32, in the forward's rows layout.
//
// Replaces ir_ads_tpu/ops/pallas_dscf.py:_dscf_rows_bwd_kernel (launched by
// pallas_dscf_rows_bwd).  Rounding points are that kernel's: scores are
// (k.q) * scale + bias in f32 (q is NOT rounded after scaling, unlike the
// forward), f32 softmax P = e / den (a true division); pc = bf16(P) feeds
// dV += pc * dO; dP = v.dO; dS = P * (dP - sum_j dP_j P_j) in f32; dbias =
// dS; bf16(dS * scale) feeds dq += dSc * k and dK += dSc * q.  Keys M <= j <
// Mp (masked with -1e9 on the TPU, probability exactly 0) add nothing;
// their dk and dv rows stay at the zeros the caller wrote.
//
// Bound on an H100: bytes, by the f32 dbias store (4 bytes per score) and
// the bf16 bias read (2 bytes), against ~80 flop per score.
//
// Design: the four products on the tensor cores, key-major as the TPU
// kernel's sT.  A block of 4 warps takes a tile of 64 query pixels of one
// (bg, head) plane; the warps split the plane's keys by 16-key m-tiles
// (warp w takes m-tiles w, w + 4, ...), with the head's K and V staged in
// shared memory as bf16 rows of 8 channels.  Per (m-tile, 8-pixel n-tile):
//   S^T  = K q^T   and  dP^T = V dO^T: mma.sync m16n8k8, each score an f32
//        sum of 8 exact products, scaled and biased in f32;
//   dV  += pc^T dO and  dK  += dSc^T q: the C fragments of two n-tiles,
//        rounded to bf16, are the A operand of mma.sync m16n8k16 over 16
//        pixels, dO and q by ldmatrix.trans; summed in registers over the
//        tile's 64 pixels, then added once a tile to the block's dK, dV in
//        shared memory, where each key row has one owner warp;
//   dq  += dSc K: the same bf16 dSc, transposed in registers (movmatrix),
//        by K through ldmatrix.trans; summed over the warp's keys in
//        registers, then over the 4 warps in warp order through shared
//        memory, and rounded once.
// Two passes over the keys: the first gives each pixel's max, den = sum_j
// exp(s_j - max) and sum_j exp(s_j - max) dP_j, online score by score (one
// exp a score), merged across the 8 lanes that share a pixel column by
// shuffles and across the warps in warp order; the second recomputes S and
// dP and takes the gradients.  dbias leaves as float2 stores of a pixel
// pair, 8 key rows of 32 contiguous bytes a warp instruction; the bias is
// read as bf16 pairs in the same layout, the next m-tile's while this one
// is computed.  Blocks are persistent: each takes a contiguous range of the
// (plane, tile) units, so the card is evenly loaded whatever the plane
// count, and adds its dK, dV sums to dk, dv with f32 atomics when its plane
// changes and at its end.  The order of those adds changes from run to run,
// so dk and dv differ between runs in their last f32 bits; dq and dbias do
// not.  Needs w % 8 == 0 (an n-tile is 8 pixels of one image row).
//
// A head has 8 channels (Swin-B) or 12 (Swin-L), the template parameter
// HC.  At 12, K, V, q and dO are staged in shared memory as two planes of
// 8-channel rows, the second's channels 12-15 zero (never in device
// memory): S^T and dP^T are two m16n8k8 products into one f32 accumulator,
// and dV, dK and dq one m16n8k16 product a plane of 8 output channels,
// whose columns past the head are dropped.  At 8 channels (one plane) no
// second-plane load or product is compiled.
#include <cfloat>

#include "dscf.cuh"

using namespace port;

namespace {

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kTile = 64;        // query pixels a tile
constexpr int kNT = kTile / 8;   // 8-pixel n-tiles a tile
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kNegInfPair = 0xff80ff80u;  // two bf16 -inf

__device__ __forceinline__ unsigned transpose8x8(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// A pixel column's softmax statistics over some keys: max, den = sum
// exp(s - max), acc = sum exp(s - max) dP.
struct Stats {
  float mx = -FLT_MAX, den = 0.0f, acc = 0.0f;
  // one more key, with one exp: against the larger of the two maxima.
  // Branch-free (selects), so that the compiler can interleave a lane's 16
  // independent columns
  __device__ __forceinline__ void add(float s, float dp) {
    const float hi = fmaxf(mx, s), ex = expf(__fsub_rn(fminf(mx, s), hi));
    const bool up = s > mx;
    den = __fmaf_rn(den, up ? ex : 1.0f, up ? 1.0f : ex);  // den * ex + 1, or den + ex
    const float rescaled = __fmaf_rn(acc, ex, dp), added = __fmaf_rn(ex, dp, acc);
    acc = up ? rescaled : added;
    mx = hi;
  }
  __device__ __forceinline__ void merge(float m2, float d2, float a2) {
    const float hi = fmaxf(mx, m2);
    const float f1 = expf(__fsub_rn(mx, hi)), f2 = expf(__fsub_rn(m2, hi));
    den = __fmaf_rn(den, f1, __fmul_rn(d2, f2));
    acc = __fmaf_rn(acc, f1, __fmul_rn(a2, f2));
    mx = hi;
  }
};

template <int HC>
struct Smem {  // the block's shared memory past K, V and dK | dV
  uint4 q[kHeadPlanes<HC>][kTile], dout[kHeadPlanes<HC>][kTile];
  float mx[kBwdWarps][kTile], den[kBwdWarps][kTile], acc[kBwdWarps][kTile];
  float4 stats[kTile];  // per pixel: max, den, RN(1 / den), sum_j dP_j P_j
  float dq[kBwdWarps][kTile][HC];
};

template <int HC>
size_t smem_bytes(int M) {
  const int Mk = (M + 15) / 16 * 16;
  return (size_t)Mk * (2 * kHeadPlanes<HC> * sizeof(uint4) + 2 * HC * sizeof(float)) +
         sizeof(Smem<HC>);
}

// The bias pairs of one key m-tile (rows j0 + g and j0 + g + 8, pixels 2t,
// 2t + 1 of each n-tile): -inf past M, 0 on n-tiles past the plane's pixels.
__device__ __forceinline__ void load_bias(unsigned (&b)[kNT][2], const bf16* __restrict__ bp,
                                          const int (&off)[kNT], int live, int j0, int g, int M,
                                          int w) {
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + g + 8 * r;
      b[n][r] = n >= live ? 0u
                : j >= M  ? kNegInfPair
                          : __ldg(reinterpret_cast<const unsigned*>(bp + off[n] + j * w));
    }
}

template <int HC>
__global__ void __launch_bounds__(kBwdThreads, HC == 8 ? 3 : 2)
dscf_rows_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ bias,
                     const bf16* __restrict__ dout, bf16* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dbias, int BG, int hg, int h, int w, int M,
                     int Mp, float scale) {
  constexpr int P = kHeadPlanes<HC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Mt = (M + 15) / 16, Mk = 16 * Mt;
  uint4* K_s = reinterpret_cast<uint4*>(smem);  // P planes of Mk rows each, then V's
  uint4* V_s = K_s + P * Mk;
  float* dKV_s = reinterpret_cast<float*>(V_s + P * Mk);  // (Mk, 2 HC): dK row j | dV row j
  Smem<HC>& sm = *reinterpret_cast<Smem<HC>*>(dKV_s + Mk * 2 * HC);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int HW = h * w, GC = hg * HC, T = (HW + kTile - 1) / kTile;
  const long long units = (long long)BG * hg * T;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;

  for (int idx = tid; idx < Mk * 2 * HC; idx += kBwdThreads) dKV_s[idx] = 0.0f;
  // adds the block's dK, dV of plane pl to dk, dv and zeroes them
  auto flush = [&](int pl) {
    __syncthreads();
    const int bg = pl / hg, e = pl % hg;
    float* dkb = dk + (size_t)bg * Mp * GC + e * HC;
    float* dvb = dv + (size_t)bg * Mp * GC + e * HC;
    for (int idx = tid; idx < M * 2 * HC; idx += kBwdThreads) {
      const int j = idx / (2 * HC), d = idx % (2 * HC);
      atomicAdd(d < HC ? dkb + (size_t)j * GC + d : dvb + (size_t)j * GC + d - HC, dKV_s[idx]);
      dKV_s[idx] = 0.0f;
    }
  };

  int plane = -1;
  for (long long u = u0; u < u1; ++u) {
    const int pl = (int)(u / T), p0 = (int)(u % T) * kTile;
    const int bg = pl / hg, e = pl % hg;
    if (pl != plane) {
      if (plane >= 0) flush(plane);
      plane = pl;
      const size_t kv = (size_t)bg * Mp * GC + e * HC;
      stage_kv_rows<HC>(k + kv, v + kv, M, GC, Mk, K_s, V_s);
    }
    {  // this tile's q and dO rows, zero past the plane's pixels
      const int p = p0 + tid % kTile;
      const bf16* src = (tid < kTile ? q : dout) + ((size_t)bg * HW + p) * GC + e * HC;
      load_head_row<HC>(src, p < HW, (tid < kTile ? sm.q[0] : sm.dout[0]) + tid % kTile,
                        kTile);
    }
    // n-tile n is pixels p0 + 8n .. + 7, in one image row; off[n]: its
    // pixel pair's offset in the plane's (h, M, w) bias at key 0
    const int live = min(kNT, (HW - p0) / 8);
    int off[kNT];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int p = min(p0 + 8 * n, HW - 8);
      off[n] = (p / w) * M * w + p % w + 2 * t;
    }
    const size_t plane_off = (size_t)pl * h * M * w;
    const bf16* bp = bias + plane_off;
    float* dbp = dbias + plane_off;
    __syncthreads();

    // the B operands of S^T and dP^T: q and dO rows of each n-tile
    unsigned qb[P][kNT], ob[P][kNT];
#pragma unroll
    for (int cp = 0; cp < P; ++cp)
#pragma unroll
      for (int n = 0; n < kNT; n += 4) {
        unsigned r[4];
        ldsm_x4(r, sm.q[cp] + 8 * n + lane);
        qb[cp][n] = r[0], qb[cp][n + 1] = r[1], qb[cp][n + 2] = r[2], qb[cp][n + 3] = r[3];
        ldsm_x4(r, sm.dout[cp] + 8 * n + lane);
        ob[cp][n] = r[0], ob[cp][n + 1] = r[1], ob[cp][n + 2] = r[2], ob[cp][n + 3] = r[3];
      }
    // S^T and dP^T of one n-tile from the planes' A fragments (kv[cp]: K
    // rows, then V rows, of the m-tile), one accumulator each
    auto scores = [&](const unsigned (&kv)[P][4], int n, float (&c)[4], float (&d)[4]) {
#pragma unroll
      for (int cp = 0; cp < P; ++cp) {
        mma_k8(c, kv[cp][0], kv[cp][1], qb[cp][n]);
        mma_k8(d, kv[cp][2], kv[cp][3], ob[cp][n]);
      }
    };

    // pass 1: per pixel column (n, 2t + x) over this lane's keys
    Stats col[kNT][2];
    unsigned bnext[kNT][2];
    if (warp < Mt) load_bias(bnext, bp, off, live, 16 * warp, g, M, w);
    for (int mt = warp; mt < Mt; mt += kBwdWarps) {
      const int j0 = 16 * mt;
      unsigned bcur[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) bcur[n][0] = bnext[n][0], bcur[n][1] = bnext[n][1];
      if (mt + kBwdWarps < Mt) load_bias(bnext, bp, off, live, j0 + 16 * kBwdWarps, g, M, w);
      unsigned kv[P][4];
#pragma unroll
      for (int cp = 0; cp < P; ++cp)
        ldsm_x4(kv[cp], (lane < 16 ? K_s : V_s) + cp * Mk + j0 + (lane & 15));
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        scores(kv, n, c, d);
        const float b[4] = {bf16_lo(bcur[n][0]), bf16_hi(bcur[n][0]), bf16_lo(bcur[n][1]),
                            bf16_hi(bcur[n][1])};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          col[n][i & 1].add(__fadd_rn(__fmul_rn(c[i], scale), b[i]), d[i]);
      }
    }
    // across the 8 lanes of a column, then the warps through shared memory
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        Stats& st = col[n][x];
#pragma unroll
        for (int o = 4; o <= 16; o <<= 1)
          st.merge(__shfl_xor_sync(kAll, st.mx, o), __shfl_xor_sync(kAll, st.den, o),
                   __shfl_xor_sync(kAll, st.acc, o));
        if (g == 0) {
          const int p = 8 * n + 2 * t + x;
          sm.mx[warp][p] = st.mx, sm.den[warp][p] = st.den, sm.acc[warp][p] = st.acc;
        }
      }
    __syncthreads();
    if (tid < kTile) {
      Stats st;
      st.mx = sm.mx[0][tid], st.den = sm.den[0][tid], st.acc = sm.acc[0][tid];
      for (int wp = 1; wp < kBwdWarps; ++wp)
        st.merge(sm.mx[wp][tid], sm.den[wp][tid], sm.acc[wp][tid]);
      sm.stats[tid] = make_float4(st.mx, st.den, __frcp_rn(st.den), __fdiv_rn(st.acc, st.den));
    }
    __syncthreads();

    // pass 2: the gradients
    float dqa[kNT / 2][P][4] = {};
    if (warp < Mt) load_bias(bnext, bp, off, live, 16 * warp, g, M, w);
    for (int mt = warp; mt < Mt; mt += kBwdWarps) {
      const int j0 = 16 * mt;
      unsigned bcur[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) bcur[n][0] = bnext[n][0], bcur[n][1] = bnext[n][1];
      if (mt + kBwdWarps < Mt) load_bias(bnext, bp, off, live, j0 + 16 * kBwdWarps, g, M, w);
      unsigned kv[P][4], kt[P][2];
#pragma unroll
      for (int cp = 0; cp < P; ++cp) {
        ldsm_x4(kv[cp], (lane < 16 ? K_s : V_s) + cp * Mk + j0 + (lane & 15));
        ldsm_x2_t(kt[cp], K_s + cp * Mk + j0 + (lane & 15));
      }
      const bool key0 = j0 + g < M, key1 = j0 + g + 8 < M;
      float dka[P][4] = {}, dva[P][4] = {};
#pragma unroll
      for (int m2 = 0; m2 < kNT / 2; ++m2) {
        // A fragments over 16 pixels: [0], [2] key row g, [1], [3] g + 8
        unsigned pca[4], dsa[4];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int n = 2 * m2 + x;
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          scores(kv, n, c, d);
          const float b[4] = {bf16_lo(bcur[n][0]), bf16_hi(bcur[n][0]), bf16_lo(bcur[n][1]),
                              bf16_hi(bcur[n][1])};
          const float4 st[2] = {sm.stats[8 * n + 2 * t], sm.stats[8 * n + 2 * t + 1]};
          float p[4], ds[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4& s4 = st[i & 1];
            const float s = __fadd_rn(__fmul_rn(c[i], scale), b[i]);
            const float ex = expf(__fsub_rn(s, s4.x));
            p[i] = quotient(ex, s4.y, s4.z);
            ds[i] = __fmul_rn(p[i], __fsub_rn(d[i], s4.w));
          }
          if (n < live) {
            float* at = dbp + off[n] + j0 * w + g * w;
            if (key0) *reinterpret_cast<float2*>(at) = make_float2(ds[0], ds[1]);
            if (key1) *reinterpret_cast<float2*>(at + 8 * w) = make_float2(ds[2], ds[3]);
          }
          pca[2 * x] = bf16x2_rn(p[0], p[1]);
          pca[2 * x + 1] = bf16x2_rn(p[2], p[3]);
          dsa[2 * x] = bf16x2_rn(__fmul_rn(ds[0], scale), __fmul_rn(ds[1], scale));
          dsa[2 * x + 1] = bf16x2_rn(__fmul_rn(ds[2], scale), __fmul_rn(ds[3], scale));
        }
        // dSc as pixels x keys: each 8 x 8 block transposed in registers
        const unsigned a[4] = {transpose8x8(dsa[0]), transpose8x8(dsa[2]), transpose8x8(dsa[1]),
                               transpose8x8(dsa[3])};
#pragma unroll
        for (int cp = 0; cp < P; ++cp) {
          unsigned ot[2], qt[2];
          ldsm_x2_t(ot, sm.dout[cp] + 16 * m2 + (lane & 15));
          ldsm_x2_t(qt, sm.q[cp] + 16 * m2 + (lane & 15));
          mma_k16(dva[cp], pca, ot[0], ot[1]);
          mma_k16(dka[cp], dsa, qt[0], qt[1]);
          mma_k16(dqa[m2][cp], a, kt[cp][0], kt[cp][1]);
        }
      }
      // rows j0 + g and j0 + g + 8 are this warp's alone; a plane's
      // channels past the head (12-15) are dropped
#pragma unroll
      for (int cp = 0; cp < P; ++cp) {
        const int ch = 8 * cp + 2 * t;
        if (ch >= HC) continue;
        float* r0 = dKV_s + (j0 + g) * 2 * HC + ch;
        float* r1 = r0 + 8 * 2 * HC;
        r0[0] += dka[cp][0], r0[1] += dka[cp][1], r1[0] += dka[cp][2], r1[1] += dka[cp][3];
        r0[HC] += dva[cp][0], r0[HC + 1] += dva[cp][1], r1[HC] += dva[cp][2],
            r1[HC + 1] += dva[cp][3];
      }
    }

    // dq: the warps' parts in warp order, rounded once
#pragma unroll
    for (int m2 = 0; m2 < kNT / 2; ++m2)
#pragma unroll
      for (int cp = 0; cp < P; ++cp) {
        const int ch = 8 * cp + 2 * t;
        if (ch >= HC) continue;
        float* r0 = sm.dq[warp][16 * m2 + g] + ch;
        float* r1 = sm.dq[warp][16 * m2 + g + 8] + ch;
        r0[0] = dqa[m2][cp][0], r0[1] = dqa[m2][cp][1], r1[0] = dqa[m2][cp][2],
        r1[1] = dqa[m2][cp][3];
      }
    __syncthreads();
    // four channels of one pixel a thread: px = idx / (HC / 4)
    for (int idx = tid; idx < kTile * (HC / 4); idx += kBwdThreads) {
      const int px = idx / (HC / 4), c0 = 4 * (idx % (HC / 4));
      float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int wp = 0; wp < kBwdWarps; ++wp)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[i] = __fadd_rn(sum[i], sm.dq[wp][px][c0 + i]);
      if (p0 + px < HW) {
        const uint2 packed = {bf16x2_rn(sum[0], sum[1]), bf16x2_rn(sum[2], sum[3])};
        *reinterpret_cast<uint2*>(dq + ((size_t)bg * HW + p0 + px) * GC + e * HC + c0) = packed;
      }
    }
  }
  if (plane >= 0) flush(plane);
}

template <int HC>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* dout,
           void* dq, void* dk, void* dv, void* dbias, int BG, int hg, int h, int w, int M,
           int Mp, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HC>(M);
  if (w % 8 || smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const int blocks = blocks_per_device(dscf_rows_bwd_kernel<HC>, smem, kBwdThreads);
  const long long units = (long long)BG * hg * ((h * w + kTile - 1) / kTile);
  const int grid = (int)std::min<long long>(units, blocks);
  dscf_rows_bwd_kernel<HC><<<grid, kBwdThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias,
      (const bf16*)dout, (bf16*)dq, (float*)dk, (float*)dv, (float*)dbias, BG, hg, h,
      w, M, Mp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// hc: channels per head, 8 or 12.
extern "C" int dscf_rows_bwd(const void* q, const void* k, const void* v,
                             const void* bias, const void* dout, void* dq,
                             void* dk, void* dv, void* dbias, int BG, int hg,
                             int h, int w, int M, int Mp, float scale, int hc,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (hc == 8)
    return launch<8>(q, k, v, bias, dout, dq, dk, dv, dbias, BG, hg, h, w, M, Mp, scale, s);
  if (hc == 12)
    return launch<12>(q, k, v, bias, dout, dq, dk, dv, dbias, BG, hg, h, w, M, Mp, scale, s);
  return (int)cudaErrorInvalidValue;
}
