// K7: the backward of Swin window attention.  For every window and head it
// recomputes the softmax from the saved qkv and turns the cotangent of the
// attention output into
//   dqkv  (BN, N, 3C) bf16   gradients of q | k | v,
//   ow    (BN, N, C)  bf16   the recomputed attention output (optional; the
//                            out-projection's weight gradient needs it),
//   dbias (heads, N, N) f32  gradient of the rel-pos bias, summed over all
//                            windows (optional).
//
// Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_bwd_kernel (launched by
// pallas_window_attention_bwd).  Rounding points are that kernel's: scores
// are dot(q, k) * scale in f32 (q is NOT rounded after scaling, unlike the
// forward), + f32 bias, -1e9 where shift-region ids differ, f32 softmax P =
// e / sum e (a true division); pc = bf16(P) feeds ow = pc.V and dV =
// pc^T.dO; dP = dO.V^T in f32; dS = P * (dP - rowsum(dP * P)) in f32; dbias
// += dS before the scale; bf16(dS * scale) feeds dQ = dSc.K and dK =
// dSc^T.Q; each output is rounded once.  The sums run in another order than
// the TPU kernel's, so K7 is held to bars, not to bits.  want_ow = 0 and
// want_dbias = 0 (null outputs) skip the output and its arithmetic.
//
// Bound on an H100: bytes at the Swin-B shapes (d = 32): 14 C bytes per
// token in and out against 12 N d = 55 kflop per token and head, about 99
// flop per byte at N = 144, under the card's 295.
//
// Two designs; the wrapper (ops/window_attn_bwd.py) chooses by shape alone:
// d = C / heads = 32 and N = 144 (every Swin-B stage) take the tensor
// cores, any other shape the first design.
//
// The tensor cores (window_attn_bwd_mma_kernel), window_mma.cuh's design
// for the forward (K12) carried to the backward, with K8's key-major pass
// (dscf_rows_bwd.cu) for the two products that need a transpose.  Blocks
// are persistent, each on one head (blockIdx.y) walking that head's windows
// (blockIdx.x, + gridDim.x, ...): the head's f32 bias is staged in shared
// memory once a block (row stride N + 4 floats), and q, k, v, dO and the
// region ids of a window arrive by 16-byte cp.async pieces, the next
// window's while this one is computed (two buffers; one when dbias is
// asked for, whose f32 sum takes the room).  N = 144 is nine 16-row
// strips: the block has nine warps, one a strip, as window_mma.cuh's
// forward.  A window takes two passes with a barrier between:
//   rows  warp w owns query rows 16w .. 16w + 15.  S = q.k^T (mma.sync
//         m16n8k16, k by ldmatrix) stays in the accumulator registers (72
//         f32 a lane); scale, bias and mask are added there, the row max
//         and sum e go across the quad by shuffles; P = e / sum by
//         __fdiv_rn's two corrections (mma.cuh quotient) in place.  dP =
//         dO.V^T is taken 16 keys at a time, twice: for rowsum(dP * P)
//         (across the quad by shuffles), then for dS = P (dP - rowsum),
//         whose bf16(dS * scale) is at once the A operand of dQ += dSc.K
//         over those 16 keys (K by ldmatrix.trans); pc = bf16(P) is the A
//         operand of ow = pc.V.  A 16 x 144 dP strip held beside P would
//         pass the 168 registers a lane that nine warps leave (three to a
//         sub-partition's 16 K registers): taking dP twice spills less and
//         ran faster on the card.  dbias: each warp adds its rows'
//         dS to the block's f32 sum in shared memory (its own rows: no
//         conflict).  Each row's max, sum, RN(1 / sum) and rowsum(dP * P)
//         go to shared memory.
//   keys  warp w owns key rows 16w .. 16w + 15 and walks the queries 16 at
//         a time: S^T = k.q^T and dP^T = V.dO^T again (the products of the
//         rows pass, the operands swapped), then P and dS from the rows'
//         statistics; their C fragments are the A operands of dV += pc^T.dO
//         and dK += dSc^T.q over those 16 queries (dO and q by
//         ldmatrix.trans), summed in registers over the window's queries.
// No score, P or dS touches device memory; the only shared-memory traffic
// past the operands is the bias read and, with dbias, its sum.  dbias
// leaves once a block: one f32 atomicAdd per element into the zeroed
// output.  The order of those adds changes from run to run, so dbias (and
// only dbias) differs between runs in its last f32 bits; every other output
// is the same from run to run.  Shared memory at N = 144, d = 32: 177 KB
// (bias 83 KB, two window buffers of 46 KB, the row statistics), 214 KB
// with dbias (its 83 KB sum, one buffer): one block of nine warps an SM,
// 168 registers a thread (the most nine warps allow), 96 bytes spilled
// (ptxas).  The f32 bias alone is more than a third of the SM's shared
// memory, so two blocks an SM would each stage it, with no room left for
// two windows' operands.
//
// The first design (window_attn_bwd_kernel): one block of 256 threads per
// (window, head); q, k, v, dO of the head (bf16), the f32 P tile and the
// f32 dP tile stay in shared memory (221 KB at N = 144, d = 32; bf16 copies
// of P and of dS * scale reuse the tile that is free at that moment), and
// the six products are WMMA (mma.sync 16x16x16, f32 accumulation); dbias is
// summed with one f32 atomic add per element and window.
#include "mma.cuh"

using namespace port;

namespace {

// ---- the tensor cores

// The layout of the block's shared memory for MT 16-row strips (N = 16 MT)
// at d = 32: the head's bias (N rows of LDB f32), with Dbias its f32 sum
// (the same layout), Bufs window buffers of q, k, v, dO (N rows of LDQ
// bf16 each) and the region ids (N), and the rows' statistics (float4: max,
// sum, RN(1 / sum), rowsum(dP * P)).
template <int MT, bool Dbias>
struct BwdMma {
  static constexpr int N = 16 * MT, NT = 2 * MT, D = 32, Threads = 32 * MT;
  static constexpr int LDQ = D + 8, LDB = N + 4, Bufs = Dbias ? 1 : 2;
  static constexpr int BiasBytes = N * LDB * 4;
  static constexpr int BufBytes = 4 * N * LDQ * 2 + N * 4;
  static constexpr int Bytes = BiasBytes * (Dbias ? 2 : 1) + Bufs * BufBytes + N * 16;
};

constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(kAll, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(kAll, v, 2));
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kAll, v, 1));
  return fmaxf(v, __shfl_xor_sync(kAll, v, 2));
}

// Two f32 outputs of rows r and r + 8 of a 16 x 32 C tile, rounded, to
// dst (row stride ld) at the fragment's columns.
__device__ __forceinline__ void store_tile(bf16* dst, size_t ld, const float (&o)[4][4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    *reinterpret_cast<unsigned*>(dst + g * ld + 8 * c + 2 * t) = bf16x2_rn(o[c][0], o[c][1]);
    *reinterpret_cast<unsigned*>(dst + (g + 8) * ld + 8 * c + 2 * t) =
        bf16x2_rn(o[c][2], o[c][3]);
  }
}

// The rows pass of warp `warp` (header): dQ (and ow) of query rows row0 ..
// row0 + 15, the rows' statistics, dS into Db.
template <int MT, bool Dbias>
__device__ __forceinline__ void bwd_rows(const bf16* Qs, const bf16* Ks, const bf16* Vs,
                                         const bf16* Os, const int* Rs, const float* Bs,
                                         float* Db, float4* stats, float scale, bf16* dq,
                                         bf16* ow, int C3, int C) {
  using L = BwdMma<MT, Dbias>;
  constexpr int NT = L::NT, LDQ = L::LDQ, LDB = L::LDB;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3, row0 = 16 * (threadIdx.x / 32);

  // dO's A fragments (16 x 32), kept for the two dP passes
  unsigned oa[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    ldsm_x4(oa[ks], Os + (row0 + (lane & 15)) * LDQ + 16 * ks + (lane >> 4) * 8);
  // dP = dO.V^T for the n-tiles n, n + 1 (16 keys)
  auto dp_pair = [&](int n, float (&d)[2][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      unsigned vb[4];
      ldsm_x4(vb, Vs + (8 * (n + i) + (lane & 7)) * LDQ + (lane >> 3) * 8);
      d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) mma_k16(d[i], oa[ks], vb[2 * ks], vb[2 * ks + 1]);
    }
  };

  // S = q.k^T: 8-key n-tiles, two 16-deep steps of d
  float s[NT][4];
  {
    unsigned qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4(qa[ks], Qs + (row0 + (lane & 15)) * LDQ + 16 * ks + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      unsigned kb[4];
      ldsm_x4(kb, Ks + (8 * n + (lane & 7)) * LDQ + (lane >> 3) * 8);
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) mma_k16(s[n], qa[ks], kb[2 * ks], kb[2 * ks + 1]);
    }
  }

  // s * scale + bias, -1e9 where the region ids differ; the row maxima
  const float* b0 = Bs + (row0 + g) * LDB + 2 * t;
  const float* b1 = b0 + 8 * LDB;
  const int rg0 = Rs ? Rs[row0 + g] : 0, rg1 = Rs ? Rs[row0 + g + 8] : 0;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 x0 = *reinterpret_cast<const float2*>(b0 + 8 * n);
    const float2 x1 = *reinterpret_cast<const float2*>(b1 + 8 * n);
    float(&c)[4] = s[n];
    c[0] = __fadd_rn(__fmul_rn(c[0], scale), x0.x);
    c[1] = __fadd_rn(__fmul_rn(c[1], scale), x0.y);
    c[2] = __fadd_rn(__fmul_rn(c[2], scale), x1.x);
    c[3] = __fadd_rn(__fmul_rn(c[3], scale), x1.y);
    if (Rs) {
      const int2 kr = *reinterpret_cast<const int2*>(Rs + 8 * n + 2 * t);
      if (kr.x != rg0) c[0] = __fadd_rn(c[0], -1e9f);
      if (kr.y != rg0) c[1] = __fadd_rn(c[1], -1e9f);
      if (kr.x != rg1) c[2] = __fadd_rn(c[2], -1e9f);
      if (kr.y != rg1) c[3] = __fadd_rn(c[3], -1e9f);
    }
    m0 = fmaxf(m0, fmaxf(c[0], c[1]));
    m1 = fmaxf(m1, fmaxf(c[2], c[3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  // e = exp(s - max), its row sums; P = e / sum
  float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s[n][0] = expf(__fsub_rn(s[n][0], m0));
    s[n][1] = expf(__fsub_rn(s[n][1], m0));
    s[n][2] = expf(__fsub_rn(s[n][2], m1));
    s[n][3] = expf(__fsub_rn(s[n][3], m1));
    d0 = __fadd_rn(d0, __fadd_rn(s[n][0], s[n][1]));
    d1 = __fadd_rn(d1, __fadd_rn(s[n][2], s[n][3]));
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  const float y0 = __frcp_rn(d0), y1 = __frcp_rn(d1);
  // P, and rowsum(dP * P) in n-tile order (dP a 16-key pair at a time)
  float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
    float d[2][4];
    dp_pair(n, d);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float(&p)[4] = s[n + i];
      p[0] = quotient(p[0], d0, y0);
      p[1] = quotient(p[1], d0, y0);
      p[2] = quotient(p[2], d1, y1);
      p[3] = quotient(p[3], d1, y1);
      r0 = __fmaf_rn(d[i][1], p[1], __fmaf_rn(d[i][0], p[0], r0));
      r1 = __fmaf_rn(d[i][3], p[3], __fmaf_rn(d[i][2], p[2], r1));
    }
  }
  r0 = quad_sum(r0);
  r1 = quad_sum(r1);
  if (t == 0) {
    stats[row0 + g] = make_float4(m0, d0, y0, r0);
    stats[row0 + g + 8] = make_float4(m1, d1, y1, r1);
  }

  float o[4][4];
  // ow = pc.V: the C fragments of two n-tiles, rounded, are the A fragment
  // of a 16-key step; V by ldmatrix.trans
  if (ow) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      const float* u = s[2 * kk];
      const float* v = s[2 * kk + 1];
      const unsigned fa[4] = {bf16x2_rn(u[0], u[1]), bf16x2_rn(u[2], u[3]),
                              bf16x2_rn(v[0], v[1]), bf16x2_rn(v[2], v[3])};
#pragma unroll
      for (int cp = 0; cp < 2; ++cp) {
        unsigned b[4];
        ldsm_x4_t(b, Vs + (16 * kk + (lane & 15)) * LDQ + 16 * cp + (lane >> 4) * 8);
        mma_k16(o[2 * cp], fa, b[0], b[1]);
        mma_k16(o[2 * cp + 1], fa, b[2], b[3]);
      }
    }
    store_tile(ow + (size_t)row0 * C, C, o);
  }
  // dQ = bf16(dS * scale).K, 16 keys a step: dP again, dS = P (dP -
  // rowsum), dbias += dS
#pragma unroll
  for (int c = 0; c < 4; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < MT; ++kk) {
    float d[2][4];
    dp_pair(2 * kk, d);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float(&p)[4] = s[2 * kk + i];
      d[i][0] = __fmul_rn(p[0], __fsub_rn(d[i][0], r0));
      d[i][1] = __fmul_rn(p[1], __fsub_rn(d[i][1], r0));
      d[i][2] = __fmul_rn(p[2], __fsub_rn(d[i][2], r1));
      d[i][3] = __fmul_rn(p[3], __fsub_rn(d[i][3], r1));
      if constexpr (Dbias) {
        const int col = 8 * (2 * kk + i) + 2 * t;
        float2* a0 = reinterpret_cast<float2*>(Db + (row0 + g) * LDB + col);
        float2* a1 = reinterpret_cast<float2*>(Db + (row0 + g + 8) * LDB + col);
        const float2 v0 = *a0, v1 = *a1;
        *a0 = make_float2(__fadd_rn(v0.x, d[i][0]), __fadd_rn(v0.y, d[i][1]));
        *a1 = make_float2(__fadd_rn(v1.x, d[i][2]), __fadd_rn(v1.y, d[i][3]));
      }
    }
    const unsigned fa[4] = {
        bf16x2_rn(__fmul_rn(d[0][0], scale), __fmul_rn(d[0][1], scale)),
        bf16x2_rn(__fmul_rn(d[0][2], scale), __fmul_rn(d[0][3], scale)),
        bf16x2_rn(__fmul_rn(d[1][0], scale), __fmul_rn(d[1][1], scale)),
        bf16x2_rn(__fmul_rn(d[1][2], scale), __fmul_rn(d[1][3], scale))};
#pragma unroll
    for (int cp = 0; cp < 2; ++cp) {
      unsigned b[4];
      ldsm_x4_t(b, Ks + (16 * kk + (lane & 15)) * LDQ + 16 * cp + (lane >> 4) * 8);
      mma_k16(o[2 * cp], fa, b[0], b[1]);
      mma_k16(o[2 * cp + 1], fa, b[2], b[3]);
    }
  }
  store_tile(dq + (size_t)row0 * C3, C3, o);
}

// The keys pass of warp `warp` (header): dK and dV of key rows j0 .. j0 +
// 15 over the window's queries, 16 a step.
template <int MT, bool Dbias>
__device__ __forceinline__ void bwd_keys(const bf16* Qs, const bf16* Ks, const bf16* Vs,
                                         const bf16* Os, const int* Rs, const float* Bs,
                                         const float4* stats, float scale, bf16* dk, bf16* dv,
                                         int C3) {
  using L = BwdMma<MT, Dbias>;
  constexpr int LDQ = L::LDQ, LDB = L::LDB;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3, j0 = 16 * (threadIdx.x / 32);
  unsigned ka[2][4], va[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    ldsm_x4(ka[ks], Ks + (j0 + (lane & 15)) * LDQ + 16 * ks + (lane >> 4) * 8);
    ldsm_x4(va[ks], Vs + (j0 + (lane & 15)) * LDQ + 16 * ks + (lane >> 4) * 8);
  }
  const int rk[2] = {Rs ? Rs[j0 + g] : 0, Rs ? Rs[j0 + g + 8] : 0};
  float dka[4][4] = {}, dva[4][4] = {};
#pragma unroll 1
  for (int qc = 0; qc < MT; ++qc) {
    unsigned pa[4], sa[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // queries 16 qc + 8 i .. + 7
      unsigned qb[4], ob[4];
      ldsm_x4(qb, Qs + (16 * qc + 8 * i + (lane & 7)) * LDQ + (lane >> 3) * 8);
      ldsm_x4(ob, Os + (16 * qc + 8 * i + (lane & 7)) * LDQ + (lane >> 3) * 8);
      float st[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dpt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        mma_k16(st, ka[ks], qb[2 * ks], qb[2 * ks + 1]);
        mma_k16(dpt, va[ks], ob[2 * ks], ob[2 * ks + 1]);
      }
      // C fragment: rows keys j0 + g (+ 8), columns queries q0, q0 + 1
      const int q0 = 16 * qc + 8 * i + 2 * t;
      float p[4], ds[4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float4 sq = stats[q0 + x];
        const int rq = Rs ? Rs[q0 + x] : 0;
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int e = 2 * y + x;
          float sc = __fadd_rn(__fmul_rn(st[e], scale), Bs[(q0 + x) * LDB + j0 + g + 8 * y]);
          if (Rs && rq != rk[y]) sc = __fadd_rn(sc, -1e9f);
          p[e] = quotient(expf(__fsub_rn(sc, sq.x)), sq.y, sq.z);
          ds[e] = __fmul_rn(p[e], __fsub_rn(dpt[e], sq.w));
        }
      }
      pa[2 * i] = bf16x2_rn(p[0], p[1]);
      pa[2 * i + 1] = bf16x2_rn(p[2], p[3]);
      sa[2 * i] = bf16x2_rn(__fmul_rn(ds[0], scale), __fmul_rn(ds[1], scale));
      sa[2 * i + 1] = bf16x2_rn(__fmul_rn(ds[2], scale), __fmul_rn(ds[3], scale));
    }
#pragma unroll
    for (int cp = 0; cp < 2; ++cp) {
      unsigned ob[4], qb[4];
      ldsm_x4_t(ob, Os + (16 * qc + (lane & 15)) * LDQ + 16 * cp + (lane >> 4) * 8);
      ldsm_x4_t(qb, Qs + (16 * qc + (lane & 15)) * LDQ + 16 * cp + (lane >> 4) * 8);
      mma_k16(dva[2 * cp], pa, ob[0], ob[1]);
      mma_k16(dva[2 * cp + 1], pa, ob[2], ob[3]);
      mma_k16(dka[2 * cp], sa, qb[0], qb[1]);
      mma_k16(dka[2 * cp + 1], sa, qb[2], qb[3]);
    }
  }
  store_tile(dk + (size_t)j0 * C3, C3, dka);
  store_tile(dv + (size_t)j0 * C3, C3, dva);
}

// One persistent block: head blockIdx.y, windows blockIdx.x, + gridDim.x,
// ... of BN.  region (nW, N) int32 or null; window w uses row w % nW.
template <int MT, bool Dbias>
__global__ void __launch_bounds__(BwdMma<MT, Dbias>::Threads, 1)
window_attn_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                           const float* __restrict__ bias, const int* __restrict__ region,
                           bf16* __restrict__ dqkv, bf16* __restrict__ ow,
                           float* __restrict__ dbias, int BN, int nW, int C, float scale) {
  using L = BwdMma<MT, Dbias>;
  constexpr int N = L::N, LDQ = L::LDQ, LDB = L::LDB, D = L::D;
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  float* Bs = reinterpret_cast<float*>(smem_bwd);
  float* Db = Dbias ? Bs + N * LDB : nullptr;
  unsigned char* bufs = smem_bwd + L::BiasBytes * (Dbias ? 2 : 1);
  float4* stats = reinterpret_cast<float4*>(bufs + L::Bufs * L::BufBytes);
  const int h = blockIdx.y, C3 = 3 * C, step = gridDim.x;

  const float* bh = bias + (size_t)h * N * N;
  for (int idx = threadIdx.x; idx < N * N / 4; idx += L::Threads) {
    const int i = idx / (N / 4), j = 4 * (idx % (N / 4));
    cp_async16(Bs + i * LDB + j, bh + i * N + j);
  }
  if constexpr (Dbias)
    for (int idx = threadIdx.x; idx < N * LDB; idx += L::Threads) Db[idx] = 0.0f;
  // q, k, v, dO (d bf16 of the head, four 16-byte pieces a row) and the
  // region ids of window `win` into buffer `buf`
  auto load = [&](unsigned char* buf, int win) {
    bf16* dst = reinterpret_cast<bf16*>(buf);
    for (int idx = threadIdx.x; idx < 4 * N * (D / 8); idx += L::Threads) {
      const int which = idx / (N * (D / 8)), row = (idx / (D / 8)) % N, ch = idx % (D / 8);
      const size_t tok = (size_t)win * N + row;
      const bf16* src = which < 3 ? qkv + tok * C3 + which * C : dout + tok * C;
      cp_async16(dst + (which * N + row) * LDQ + 8 * ch, src + h * D + 8 * ch);
    }
    if (region) {
      int* rs = reinterpret_cast<int*>(buf + 4 * N * LDQ * 2);
      const int* src = region + (size_t)(win % nW) * N;
      for (int i = threadIdx.x; i < N; i += L::Threads) cp_async4(rs + i, src + i);
    }
  };

  int it = 0;
  load(bufs, blockIdx.x);
  cp_async_commit();
  for (int win = blockIdx.x; win < BN; win += step, ++it) {
    unsigned char* buf = bufs + (it % L::Bufs) * L::BufBytes;
    if constexpr (L::Bufs == 2) {
      if (win + step < BN) load(bufs + ((it + 1) % 2) * L::BufBytes, win + step);
      cp_async_commit();
      cp_async_wait<1>();  // this window's copies (and the bias) have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qs = reinterpret_cast<const bf16*>(buf);
    const bf16* Ks = Qs + N * LDQ;
    const bf16* Vs = Ks + N * LDQ;
    const bf16* Os = Vs + N * LDQ;
    const int* Rs = region ? reinterpret_cast<const int*>(Os + N * LDQ) : nullptr;
    bf16* dq_w = dqkv + (size_t)win * N * C3 + h * D;
    bwd_rows<MT, Dbias>(Qs, Ks, Vs, Os, Rs, Bs, Db, stats, scale, dq_w,
                        ow ? ow + (size_t)win * N * C + h * D : nullptr, C3, C);
    __syncthreads();  // the rows' statistics are in
    bwd_keys<MT, Dbias>(Qs, Ks, Vs, Os, Rs, Bs, stats, scale, dq_w + C, dq_w + 2 * C, C3);
    __syncthreads();  // the buffer and the statistics are free
    if constexpr (L::Bufs == 1) {
      if (win + step < BN) load(bufs, win + step);
      cp_async_commit();
    }
  }
  if constexpr (Dbias) {
    float* db = dbias + (size_t)h * N * N;
    for (int idx = threadIdx.x; idx < N * N; idx += L::Threads)
      atomicAdd(db + idx, Db[(idx / N) * LDB + idx % N]);
  }
}

// ---- the first design

constexpr int kLdScratch = 20;  // per-warp 16 x 16 f32 staging tile

struct BwdSmem {
  size_t qkvd, tile, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int N, int d) {
  BwdSmem s;
  s.qkvd = align128((size_t)4 * N * (d + 8) * 2);
  s.tile = align128((size_t)N * (N + 4) * 4);
  s.total = s.qkvd + 2 * s.tile + (size_t)kWarps * 16 * kLdScratch * 4;
  return s;
}

// Round a warp's 16 x 16 f32 fragment to bf16 into dst (row stride ld).
__device__ __forceinline__ void store_frag_bf16(
    const wmma::fragment<wmma::accumulator, 16, 16, 16, float>& acc,
    float* scratch, bf16* dst, size_t ld) {
  const int lane = threadIdx.x % 32;
  wmma::store_matrix_sync(scratch, acc, kLdScratch, wmma::mem_row_major);
  __syncwarp();
  for (int idx = lane; idx < 256; idx += 32) {
    const int r = idx / 16, c = idx % 16;
    dst[(size_t)r * ld + c] = __float2bfloat16(scratch[r * kLdScratch + c]);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
window_attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                       const float* __restrict__ bias,
                       const int* __restrict__ region, bf16* __restrict__ dqkv,
                       bf16* __restrict__ ow, float* __restrict__ dbias, int nW,
                       int N, int C, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = C / heads, C3 = 3 * C;
  const int ldq = d + 8, lds = N + 4, ldp = 2 * lds;  // ldp: bf16 rows over f32 rows
  const BwdSmem sz = bwd_smem(N, d);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + N * ldq;
  bf16* v_s = k_s + N * ldq;
  bf16* do_s = v_s + N * ldq;
  float* P_s = reinterpret_cast<float*>(smem + sz.qkvd);        // P, f32
  float* D_s = reinterpret_cast<float*>(smem + sz.qkvd + sz.tile);  // dP, then dS
  bf16* Pb_s = reinterpret_cast<bf16*>(D_s);   // bf16(P), until dP is formed
  bf16* Sb_s = reinterpret_cast<bf16*>(P_s);   // bf16(dS * scale), once P is spent
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(smem + sz.qkvd + 2 * sz.tile) +
                   warp * 16 * kLdScratch;

  const int bn = blockIdx.x, h = blockIdx.y;
  const bf16* qkv_w = qkv + (size_t)bn * N * C3 + h * d;
  const bf16* do_w = dout + (size_t)bn * N * C + h * d;
  const int dv8 = d / 8;
  for (int idx = threadIdx.x; idx < N * dv8; idx += kThreads) {
    const int i = idx / dv8, e = (idx % dv8) * 8;
    const bf16* src = qkv_w + (size_t)i * C3 + e;
    *reinterpret_cast<uint4*>(q_s + i * ldq + e) = *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(k_s + i * ldq + e) = *reinterpret_cast<const uint4*>(src + C);
    *reinterpret_cast<uint4*>(v_s + i * ldq + e) = *reinterpret_cast<const uint4*>(src + 2 * C);
    *reinterpret_cast<uint4*>(do_s + i * ldq + e) =
        *reinterpret_cast<const uint4*>(do_w + (size_t)i * C + e);
  }
  __syncthreads();

  const int nt = N / 16, dt = d / 16;
  // rows x rows product of two (N, d) operands: out[i, j] = a[i, :] . b[j, :]
  auto outer = [&](const bf16* a_s, const bf16* b_s, float* out_s) {
    for (int f = warp; f < nt * nt; f += kWarps) {
      const int mi = f / nt, ni = f % nt;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < d; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, a_s + mi * 16 * ldq + kk, ldq);
        wmma::load_matrix_sync(b, b_s + ni * 16 * ldq + kk, ldq);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(out_s + mi * 16 * lds + ni * 16, acc, lds,
                              wmma::mem_row_major);
    }
  };
  // (N, N) bf16 matrix m_s (row stride ldp) times an (N, d) operand, to
  // device memory at dst (row stride ld_dst): transposed = false gives
  // m . b, transposed = true gives m^T . b.
  auto inner = [&](const bf16* m_s, bool transposed, const bf16* b_s, bf16* dst,
                   size_t ld_dst) {
    for (int f = warp; f < nt * dt; f += kWarps) {
      const int mi = f / dt, ni = f % dt;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < N; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, b_s + kk * ldq + ni * 16, ldq);
        if (transposed) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::load_matrix_sync(a, m_s + kk * ldp + mi * 16, ldp);
          wmma::mma_sync(acc, a, b, acc);
        } else {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, m_s + mi * 16 * ldp + kk, ldp);
          wmma::mma_sync(acc, a, b, acc);
        }
      }
      store_frag_bf16(acc, scratch, dst + (size_t)mi * 16 * ld_dst + ni * 16, ld_dst);
    }
  };

  // P = softmax(q.k * scale + bias + mask) in f32; pc = bf16(P)
  outer(q_s, k_s, P_s);
  __syncthreads();
  const float* bh = bias + (size_t)h * N * N;
  const int* reg = region ? region + (size_t)(bn % nW) * N : nullptr;
  for (int i = warp; i < N; i += kWarps) {
    float* srow = P_s + i * lds;
    const int ri = reg ? reg[i] : 0;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      float s = srow[j] * scale + bh[i * N + j];
      if (reg && reg[j] != ri) s += -1e9f;
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) {
      const float p = srow[j] / sum;
      srow[j] = p;
      Pb_s[i * ldp + j] = __float2bfloat16(p);
    }
  }
  __syncthreads();

  bf16* dq_w = dqkv + (size_t)bn * N * C3 + h * d;
  if (ow) inner(Pb_s, false, v_s, ow + (size_t)bn * N * C + h * d, C);  // pc . V
  inner(Pb_s, true, do_s, dq_w + 2 * C, C3);                            // dV = pc^T . dO
  __syncthreads();

  // dS = P * (dP - rowsum(dP * P)), in place over dP
  outer(do_s, v_s, D_s);
  __syncthreads();
  float* db = dbias ? dbias + (size_t)h * N * N : nullptr;
  for (int i = warp; i < N; i += kWarps) {
    const float* prow = P_s + i * lds;
    float* drow = D_s + i * lds;
    float rs = 0.0f;
    for (int j = lane; j < N; j += 32) rs += drow[j] * prow[j];
    rs = warp_sum(rs);
    for (int j = lane; j < N; j += 32) {
      const float ds = prow[j] * (drow[j] - rs);
      drow[j] = ds;
      if (db) atomicAdd(db + i * N + j, ds);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * N; idx += kThreads) {
    const int i = idx / N, j = idx % N;
    Sb_s[i * ldp + j] = __float2bfloat16(D_s[i * lds + j] * scale);
  }
  __syncthreads();
  inner(Sb_s, false, k_s, dq_w, C3);      // dQ = dSc . K
  inner(Sb_s, true, q_s, dq_w + C, C3);   // dK = dSc^T . Q
}

}  // namespace

// qkv (BN, N, 3C) bf16, dout (BN, N, C) bf16, bias (heads, N, N) f32,
// region (nW, N) int32 or null (no mask); dqkv (BN, N, 3C) bf16, ow (BN, N,
// C) bf16 or null, dbias (heads, N, N) f32 zeroed, or null.  BN is a
// multiple of nW.  tensor_cores = 1 takes the tensor-core design (N = 144,
// C / heads = 32; else cudaErrorInvalidValue), 0 the first design.
extern "C" int window_attn_bwd(const void* qkv, const void* dout, const void* bias,
                               const void* region, void* dqkv, void* ow,
                               void* dbias, int BN, int nW, int N, int C,
                               int heads, int tensor_cores, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (N != 144 || C != 32 * heads) return (int)cudaErrorInvalidValue;
    auto launch = [&](auto kernel, int bytes, int threads) {
      const int blocks = blocks_per_device(kernel, bytes, threads);
      const dim3 grid(std::min(BN, std::max(1, blocks / heads)), heads);
      kernel<<<grid, threads, bytes, st>>>(
          (const bf16*)qkv, (const bf16*)dout, (const float*)bias, (const int*)region,
          (bf16*)dqkv, (bf16*)ow, (float*)dbias, BN, nW, C, scale);
      return (int)cudaGetLastError();
    };
    using WithDbias = BwdMma<9, true>;
    using Plain = BwdMma<9, false>;
    return dbias ? launch(window_attn_bwd_mma_kernel<9, true>, WithDbias::Bytes,
                          WithDbias::Threads)
                 : launch(window_attn_bwd_mma_kernel<9, false>, Plain::Bytes, Plain::Threads);
  }
  const size_t smem = bwd_smem(N, C / heads).total;
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BN, heads);
  window_attn_bwd_kernel<<<grid, kThreads, smem, st>>>(
      (const bf16*)qkv, (const bf16*)dout, (const float*)bias, (const int*)region,
      (bf16*)dqkv, (bf16*)ow, (float*)dbias, nW, N, C, heads, scale);
  return (int)cudaGetLastError();
}
