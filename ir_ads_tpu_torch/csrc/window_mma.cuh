// Window attention on the tensor cores, one persistent block a head: K20
// (window_attention_v1.cu, q, k, v apart), K12 and K15
// (window_attention_qkv.cu, unsplit qkv rows of windows and of the map),
// and the attention launches of the Swin block kernels: K1, K10 and K13 on
// the padded, rolled map (MapRows, K15's policy), K5 and K14 on the real
// map (RealMapTokens).  They differ in two things only:
//   * where a window's tokens are: a Tokens policy gives the q, k and v
//     rows of token i of window `win` for the block's head, its output row
//     (d contiguous bf16 each, 16-byte aligned), and whether that output is
//     stored (keep: false only for RealMapTokens' padding);
//   * the form (Exact):
//       true   K20, the Pallas v1 kernel: qs = f32(q) * scale unrounded,
//              carried as three bf16 parts, p = e / sum as __fdiv_rn;
//       false  the others, the Pallas v2 / v3 / v4-v7 kernels and
//              window_block.cuh's window_attention: qs = bf16(q * scale),
//              one bf16 operand, p = e * (1 / sum), the reciprocal rounded
//              once.
// Scores are f32 in the mma.sync order, the f32 bias is added, -1e9 where
// the region ids of a pair differ; the softmax is f32 (exp(s - max), the sum
// in the C fragments' order, then across the quad), p is rounded to bf16 and
// its C fragments are the A operand of P.V, summed in f32 and rounded once.
//
// One warp takes a 16-row m-tile (9 warps at N = 144); a lane holds its two
// rows' scores in registers (N / 2 f32: 72 at N = 144); the bias (staged
// once a block) and the region mask are added in the C layout, row max and
// sum go across the quad by shuffles.  No score touches shared or device
// memory.  Blocks are persistent, each on one head (blockIdx.y) walking
// that head's windows: the head's bias goes into shared memory once a block
// (row stride N + 8 floats, so the float2 reads of a quad row meet no bank
// conflict), and q, k, v and the region ids of the next window arrive by
// cp.async, 16-byte pieces of each token's d-wide slice, while this one is
// computed (two buffers, rows of d + 8 bf16 for conflict-free ldmatrix):
// 158 KB at N = 144, d = 32.  N is padded to whole 16-row tiles: padded q,
// k and v rows are zero, padded bias columns -inf (their probabilities
// exactly 0, as the Pallas kernels' -1e9 keys), padded rows are not stored.
// The output leaves through the warp's q rows in shared memory as 16-byte
// stores.  The mma.sync helpers are csrc/mma.cuh's.
#pragma once

#include "dscf.cuh"

namespace port {

// x as hi + mid + lo, three bf16 values (as f32): exact where |x| >= 2^-110.
__device__ __forceinline__ void split3(float x, float& hi, float& mid, float& lo) {
  hi = round_bf16(x);
  const float r = __fsub_rn(x, hi);  // exact: the bits of x under hi's
  mid = round_bf16(r);
  lo = round_bf16(__fsub_rn(r, mid));
}

// The layout of the kernel's shared memory, for NT 8-key n-tiles (N <= 8 NT
// = Np) and head dimension D: the head's bias (Np rows of LDB f32), then two
// buffers of q, k, v (Np rows of LDQ bf16 each) and the region ids (Np).
template <int NT, int D>
struct WindowMma {
  static constexpr int Np = 8 * NT, Threads = 16 * NT, LDQ = D + 8, LDB = Np + 8;
  static constexpr int BiasBytes = Np * LDB * 4;
  static constexpr int BufBytes = 3 * Np * LDQ * 2 + Np * 4;
  static constexpr int Bytes = BiasBytes + 2 * BufBytes;
};

// Queues the copies of window `win`'s q, k, v and region ids into buffer
// `buf`: 16-byte pieces, rows [0, N).
template <int NT, int D, typename Tokens>
__device__ __forceinline__ void load_window(const Tokens& tok, const int* __restrict__ region,
                                            unsigned char* buf, int win, int N, int nW) {
  using L = WindowMma<NT, D>;
  constexpr int CH = D / 8;  // 16-byte pieces a row
#pragma unroll
  for (int which = 0; which < 3; ++which) {
    bf16* dst = reinterpret_cast<bf16*>(buf) + which * L::Np * L::LDQ;
    for (int i = threadIdx.x; i < N * CH; i += L::Threads) {
      const int row = i / CH, ch = i % CH;
      cp_async16(dst + row * L::LDQ + ch * 8, tok.in(which, win, row) + ch * 8);
    }
  }
  if (region) {
    int* rs = reinterpret_cast<int*>(buf + 3 * L::Np * L::LDQ * 2);
    const int* src = region + (size_t)(win % nW) * N;
    for (int i = threadIdx.x; i < N; i += L::Threads) cp_async4(rs + i, src + i);
  }
}

// One warp's part of a window: rows row0 .. row0 + 15 against every key,
// rounded and stored at tok.out(win, row).
template <int NT, int D, bool Exact, typename Tokens>
__device__ __forceinline__ void attend_rows(bf16* Qs, const bf16* Ks, const bf16* Vs,
                                            const int* Rs, const float* Bs, bool masked,
                                            float scale, int row0, int N, const Tokens& tok,
                                            int win) {
  using L = WindowMma<NT, D>;
  constexpr int LDQ = L::LDQ, LDB = L::LDB, KS = D / 16, CH = D / 8;
  constexpr int Parts = Exact ? 3 : 1;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;

  // the A fragments of q * scale: three bf16 parts (Exact), or bf16(q * scale)
  unsigned qa[Parts][KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    unsigned raw[4];
    ldsm_x4(raw, Qs + (row0 + (lane & 15)) * LDQ + 16 * ks + (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (Exact) {
        float h0, m0, l0, h1, m1, l1;
        split3(__fmul_rn(bf16_lo(raw[i]), scale), h0, m0, l0);
        split3(__fmul_rn(bf16_hi(raw[i]), scale), h1, m1, l1);
        qa[0][ks][i] = pack_bf16x2(h0, h1);
        qa[1][ks][i] = pack_bf16x2(m0, m1);
        qa[2][ks][i] = pack_bf16x2(l0, l1);
      } else {
        qa[0][ks][i] = bf16x2_rn(__fmul_rn(bf16_lo(raw[i]), scale),
                                 __fmul_rn(bf16_hi(raw[i]), scale));
      }
    }
  }

  // scores: the parts by k^T, a 16-deep step of d at a time
  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
    unsigned kb[2][2 * KS];
    const bf16* Kn = Ks + 8 * n * LDQ;
    if constexpr (D == 32) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(kb[i], Kn + (8 * i + (lane & 7)) * LDQ + (lane >> 3) * 8);
    } else {
      unsigned r4[4];
      ldsm_x4(r4, Kn + (8 * (lane >> 4) + (lane & 7)) * LDQ + ((lane >> 3) & 1) * 8);
      kb[0][0] = r4[0], kb[0][1] = r4[1], kb[1][0] = r4[2], kb[1][1] = r4[3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float(&c)[4] = s[n + i];
      c[0] = c[1] = c[2] = c[3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int part = 0; part < Parts; ++part)
          mma_k16(c, qa[part][ks], kb[i][2 * ks], kb[i][2 * ks + 1]);
    }
  }

  // + bias, -1e9 where the region ids differ; the row maxima
  const float* b0 = Bs + (row0 + g) * LDB + 2 * t;
  const float* b1 = b0 + 8 * LDB;
  const int* kr_at = Rs + 2 * t;
  const int rg0 = masked ? Rs[row0 + g] : 0, rg1 = masked ? Rs[row0 + g + 8] : 0;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 x0 = *reinterpret_cast<const float2*>(b0 + 8 * n);
    const float2 x1 = *reinterpret_cast<const float2*>(b1 + 8 * n);
    float(&c)[4] = s[n];
    c[0] = __fadd_rn(c[0], x0.x);
    c[1] = __fadd_rn(c[1], x0.y);
    c[2] = __fadd_rn(c[2], x1.x);
    c[3] = __fadd_rn(c[3], x1.y);
    if (masked) {
      const int2 kr = *reinterpret_cast<const int2*>(kr_at + 8 * n);
      if (kr.x != rg0) c[0] = __fsub_rn(c[0], 1e9f);
      if (kr.y != rg0) c[1] = __fsub_rn(c[1], 1e9f);
      if (kr.x != rg1) c[2] = __fsub_rn(c[2], 1e9f);
      if (kr.y != rg1) c[3] = __fsub_rn(c[3], 1e9f);
    }
    m0 = fmaxf(m0, fmaxf(c[0], c[1]));
    m1 = fmaxf(m1, fmaxf(c[2], c[3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(kAll, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(kAll, m1, off));
  }
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
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    d0 = __fadd_rn(d0, __shfl_xor_sync(kAll, d0, off));
    d1 = __fadd_rn(d1, __shfl_xor_sync(kAll, d1, off));
  }

  // P.V: p in bf16 as the A operand, v by ldmatrix.trans
  float o[D / 8][4];
  const float den[2] = {d0, d1}, rcp[2] = {__frcp_rn(d0), __frcp_rn(d1)};
  auto pv = [&](auto prob) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const float* a = s[2 * kk];
      const float* b = s[2 * kk + 1];
      const unsigned pa[4] = {bf16x2_rn(prob(a[0], 0), prob(a[1], 0)),
                              bf16x2_rn(prob(a[2], 1), prob(a[3], 1)),
                              bf16x2_rn(prob(b[0], 0), prob(b[1], 0)),
                              bf16x2_rn(prob(b[2], 1), prob(b[3], 1))};
#pragma unroll
      for (int cp = 0; cp < D / 16; ++cp) {
        unsigned vb[4];
        ldsm_x4_t(vb, Vs + (16 * kk + (lane & 15)) * LDQ + 16 * cp + (lane >> 4) * 8);
        mma_k16(o[2 * cp], pa, vb[0], vb[1]);
        mma_k16(o[2 * cp + 1], pa, vb[2], vb[3]);
      }
    }
  };
  if constexpr (Exact) {
    // __fdiv_rn's quotient: div_rn_by with the row's reciprocal taken once,
    // and where a lane meets a quotient under 2^-64, the warp again with
    // __fdiv_rn itself
    bool tiny = false;
    pv([&](float e, int i) {
      tiny |= tiny_quotient(e);
      return div_rn_by(e, den[i], rcp[i]);
    });
    if (__any_sync(kAll, tiny)) pv([&](float e, int i) { return __fdiv_rn(e, den[i]); });
  } else {
    pv([&](float e, int i) { return __fmul_rn(e, rcp[i]); });
  }

  // out, rounded once, through this warp's q rows as 16-byte stores
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    *reinterpret_cast<unsigned*>(Qs + (row0 + g) * LDQ + 8 * c + 2 * t) =
        bf16x2_rn(o[c][0], o[c][1]);
    *reinterpret_cast<unsigned*>(Qs + (row0 + g + 8) * LDQ + 8 * c + 2 * t) =
        bf16x2_rn(o[c][2], o[c][3]);
  }
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int row = row0 + idx / CH, ch = idx % CH;
    if (row < N && tok.keep(win, row))
      *reinterpret_cast<uint4*>(tok.out(win, row) + ch * 8) =
          *reinterpret_cast<const uint4*>(Qs + row * LDQ + ch * 8);
  }
}

// The block's part of head blockIdx.y: windows blockIdx.x, blockIdx.x +
// gridDim.x, ... of BN.  bias (heads, N, N) f32, region (nW, N) int32 or
// null; window w uses region row w % nW.  All threads call it.
template <int NT, int D, bool Exact, typename Tokens>
__device__ __forceinline__ void window_mma_head(const Tokens& tok, const float* __restrict__ bias,
                                                const int* __restrict__ region, int BN, int N,
                                                int nW, float scale) {
  using L = WindowMma<NT, D>;
  constexpr int Np = L::Np, LDQ = L::LDQ, LDB = L::LDB;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  float* Bs = reinterpret_cast<float*>(smem_mma);
  unsigned char* bufs = smem_mma + L::BiasBytes;
  const int h = blockIdx.y, row0 = 16 * (threadIdx.x / 32);

  // once a block: zero the padded rows of q, k, v in both buffers; the
  // head's bias, 0 in the padded rows and -inf in the padded columns
  for (int idx = threadIdx.x; idx < 2 * 3 * (Np - N) * LDQ; idx += L::Threads) {
    const int per = 3 * (Np - N) * LDQ, b = idx / per, rem = idx - b * per;
    const int which = rem / ((Np - N) * LDQ), r = rem % ((Np - N) * LDQ);
    reinterpret_cast<bf16*>(bufs + b * L::BufBytes)[(which * Np + N) * LDQ + r] =
        __float2bfloat16(0.0f);
  }
  const float* bh = bias + (size_t)h * N * N;
  for (int idx = threadIdx.x; idx < Np * Np; idx += L::Threads) {
    const int i = idx / Np, j = idx % Np;
    if (j >= N)
      Bs[i * LDB + j] = -INFINITY;
    else if (i >= N)
      Bs[i * LDB + j] = 0.0f;
    else if (N % 4)
      cp_async4(Bs + i * LDB + j, bh + i * N + j);
    else if (j % 4 == 0)
      cp_async16(Bs + i * LDB + j, bh + i * N + j);
  }
  const int per_head = gridDim.x;
  if ((int)blockIdx.x < BN) load_window<NT, D>(tok, region, bufs, blockIdx.x, N, nW);
  cp_async_commit();

  int it = 0;
  for (int win = blockIdx.x; win < BN; win += per_head, ++it) {
    unsigned char* buf = bufs + (it & 1) * L::BufBytes;
    if (win + per_head < BN)  // the next window, into the other buffer
      load_window<NT, D>(tok, region, bufs + ((it + 1) & 1) * L::BufBytes, win + per_head, N,
                         nW);
    cp_async_commit();
    cp_async_wait<1>();  // this window's copies (and the bias) have landed
    __syncthreads();
    bf16* Qs = reinterpret_cast<bf16*>(buf);
    const bf16* Ks = Qs + Np * LDQ;
    const bf16* Vs = Ks + Np * LDQ;
    const int* Rs = reinterpret_cast<const int*>(Vs + Np * LDQ);
    attend_rows<NT, D, Exact>(Qs, Ks, Vs, Rs, Bs, region != nullptr, scale, row0, N, tok,
                              win);
    __syncthreads();  // this buffer is refilled at the next step
  }
}

// The grid of a window_mma_head kernel: as many blocks as are resident,
// spread evenly over the heads, at most one a window.
template <typename Kernel>
inline dim3 head_grid(Kernel kernel, size_t smem, int threads, int BN, int heads) {
  const int blocks = blocks_per_device(kernel, smem, threads);
  return dim3(std::min(BN, std::max(1, blocks / heads)), heads);
}

// The n-tile counts instantiated: N <= 16, 32, 64, 96 and 144 (12 x 12).
using WindowTiles = WarpTiles<2, 4, 8, 12, 18>;

// Calls launch(nt, dd) with the n-tile count and head dimension of a call
// (std::integral_constant each): d 16 or 32, N <= 144; else
// cudaErrorInvalidValue.
template <typename Launch>
int launch_mma(int N, int d, Launch launch) {
  auto with_d = [&](auto dd) {
    return WindowTiles::with((N + 7) / 8, [&](auto nt) { return launch(nt, dd); });
  };
  if (d == 32) return with_d(std::integral_constant<int, 32>{});
  if (d == 16) return with_d(std::integral_constant<int, 16>{});
  return (int)cudaErrorInvalidValue;
}

// Launches a kernel<NT, D> that runs window_mma_head over BN windows and
// `heads` heads, its grid from head_grid.
template <int NT, int D, typename Kernel, typename... Args>
inline int launch_heads(Kernel kernel, int BN, int heads, cudaStream_t st, Args... args) {
  using L = WindowMma<NT, D>;
  kernel<<<head_grid(kernel, L::Bytes, L::Threads, BN, heads), L::Threads, L::Bytes, st>>>(
      args...);
  return (int)cudaGetLastError();
}

// ---- Token policies: in(which, win, i) gives the q (0), k (1) or v (2)
// slice of token i of window win for the block's head, out(win, i) its
// output slice, keep(win, i) whether that output is stored.

// Token rows of qkv (3C wide) and of the output (C wide), head h's slices;
// rows(win, i) is the row of token i of window win.  Every output is kept.
template <int D, typename Rows>
struct QkvTokens {
  const bf16* qkv;
  bf16* o;
  int C, h;
  Rows rows;
  __device__ const bf16* in(int which, int win, int i) const {
    return qkv + rows(win, i) * (3 * C) + which * C + h * D;
  }
  __device__ bf16* out(int win, int i) const { return o + rows(win, i) * C + h * D; }
  __device__ bool keep(int, int) const { return true; }
};

// Windowed rows (BN, N, 3C) -> (BN, N, C): K12.
struct WindowRows {
  int N;
  __device__ size_t operator()(int win, int i) const { return (size_t)win * N + i; }
};

// The padded, rolled map (B, Hp, Wp, 3C) -> (B, Hp, Wp, C), in place: window
// win = b * nW + wy * nww + wx, token i at map row (b * Hp + wy * ws + i /
// ws) * Wp + wx * ws + i % ws.  K15, and the attention of K1, K10 and K13.
struct MapRows {
  int Hp, Wp, ws, nww, nW;
  __device__ size_t operator()(int win, int i) const {
    const int img = win / nW, w = win % nW;
    const int r = (w / nww) * ws + i / ws, c = (w % nww) * ws + i % ws;
    return ((size_t)img * Hp + r) * Wp + c;
  }
};

// The REAL map (B, H, W, 3C) -> (B, H, W, C) in the windows of its padded
// (Hp, Wp) map rolled by `shift`: token i of window win = b * nW + wy * nww
// + wx holds position ((wy * ws + i / ws + shift) % Hp, (wx * ws + i % ws +
// shift) % Wp) of the padded map.  Where that position is real, its q, k and
// v are the qkv row there and its output is stored there; where it is
// padding, they are the slices of the bias row bqkv (the qkv of a zero LN
// output, bit for bit) and its output is dropped.  Pad, roll and crop are
// index arithmetic: the attention of K5 and K14.  chip_smoke.py holds it
// through K14, bit for bit against pad, roll, K1 (whose attention is this
// head kernel on MapRows), un-roll and crop at the four Swin-B stages.
template <int D>
struct RealMapTokens {
  const bf16* qkv;
  const bf16* bqkv;
  bf16* o;
  int C, h, H, W, Hp, Wp, ws, nww, nW, shift;
  // the real map's row of token i of window win, or -1 where it is padding
  __device__ long long real(int win, int i) const {
    const int img = win / nW, w = win % nW;
    const int r = ((w / nww) * ws + i / ws + shift) % Hp;
    const int c = ((w % nww) * ws + i % ws + shift) % Wp;
    return (r < H && c < W) ? ((long long)img * H + r) * W + c : -1;
  }
  __device__ const bf16* in(int which, int win, int i) const {
    const long long t = real(win, i);
    return (t < 0 ? bqkv : qkv + t * (3 * C)) + which * C + h * D;
  }
  __device__ bf16* out(int win, int i) const { return o + real(win, i) * C + h * D; }
  __device__ bool keep(int win, int i) const { return real(win, i) >= 0; }
};

// Head blockIdx.y of the padded, rolled (B, Hp, Wp) map's qkv rows, in
// place (MapRows), in the rounded form.  bias (heads, N, N) f32, region
// (nW, N) int32 or null.
template <int NT, int D>
__device__ __forceinline__ void map_head(const bf16* __restrict__ qkv,
                                         const float* __restrict__ bias,
                                         const int* __restrict__ region, bf16* __restrict__ out,
                                         int B, int Hp, int Wp, int C, int ws, float scale) {
  const int nww = Wp / ws, nW = (Hp / ws) * nww;
  const QkvTokens<D, MapRows> tok{qkv, out, C, (int)blockIdx.y,
                                  MapRows{Hp, Wp, ws, nww, nW}};
  window_mma_head<NT, D, false>(tok, bias, region, B * nW, ws * ws, nW, scale);
}

// Head blockIdx.y of the real (B, H, W) map's qkv rows in the windows of
// its padded map rolled by `shift` (RealMapTokens), in the rounded form.
// region (nW, N) int32 of the padded map, or null.
template <int NT, int D>
__device__ __forceinline__ void real_map_head(const bf16* __restrict__ qkv,
                                              const bf16* __restrict__ bqkv,
                                              const float* __restrict__ bias,
                                              const int* __restrict__ region,
                                              bf16* __restrict__ out, int B, int H, int W, int C,
                                              int ws, int shift, float scale) {
  const int Hp = (H + ws - 1) / ws * ws, Wp = (W + ws - 1) / ws * ws;
  const int nww = Wp / ws, nW = (Hp / ws) * nww;
  const RealMapTokens<D> tok{qkv, bqkv, out, C, (int)blockIdx.y, H, W, Hp, Wp, ws, nww, nW,
                             shift};
  window_mma_head<NT, D, false>(tok, bias, region, B * nW, ws * ws, nW, scale);
}

}  // namespace port
