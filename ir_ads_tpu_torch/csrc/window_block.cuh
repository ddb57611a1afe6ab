// Device code shared by the Swin block kernels: the window attention with
// the rel-pos bias and the shift-region mask.
//   window_attention  one (window, head): scores, rel-pos bias, region mask,
//                     softmax and P.V in shared memory, all WMMA.  Where the
//                     window's tokens come from and where its output goes is
//                     the caller's:
//     map_window_attention       reads and writes a padded, rolled map in
//                                place (window_attn_kernel: K1, K10; K13,
//                                K15);
//     real_map_window_attention  folds pad, roll and crop into the indices
//                                of the real map (K5, K14).
//   This is the FIRST DESIGN of every attention launch, taken by shape
//   alone: on the tensor-core shapes (window_attention_qkv.py's
//   tensor_core_design, d 16 or 32 and N <= 144: every Swin-B stage) K1,
//   K5, K10 and K12-K15 run window_mma.cuh's persistent head kernel, and
//   no Swin-B shape reaches window_attention (K12 runs it on windowed rows
//   as its own first design).  The Swin blocks' row products run on
//   gemm_mma.cuh with the epilogues of gemm_epilogues.cuh.
#pragma once

#include "common.cuh"

namespace port {

inline size_t window_attention_smem(int N, int d) {
  return align128((size_t)3 * N * (d + 8) * 2) + align128((size_t)N * (N + 4) * 4) +
         (size_t)N * (N + 8) * 2;
}

// Attention of head h over one window of N = ws*ws tokens, d channels a
// head.  load(i) gives token i's 3C-wide qkv row (q | k | v); store(i) gives
// its C-wide output row, or nullptr to drop it.  region_win is the window's
// (N) shift-region ids or nullptr.  q is scaled and rounded to bf16 on
// load (the wrapper passes the scale already rounded to bf16,
// ops/layers.q_scale, as JAX casts the Python scalar to q's dtype before the
// product), scores and softmax are f32, the probabilities are rounded to bf16
// before P.V, the output rounded once.  smem holds window_attention_smem.
template <typename Load, typename Store>
__device__ void window_attention(unsigned char* smem, Load load, Store store,
                                 const float* __restrict__ bias,
                                 const int* __restrict__ region_win, int C,
                                 int heads, int ws, int h, float scale) {
  const int N = ws * ws, d = C / heads;
  const int ldq = d + 8, lds = N + 4, ldp = N + 8, ldo = d + 4;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + N * ldq;
  bf16* v_s = k_s + N * ldq;
  float* S_s = reinterpret_cast<float*>(smem + align128((size_t)3 * N * ldq * 2));
  bf16* P_s = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(S_s) + align128((size_t)N * lds * 4));
  float* O_s = S_s;  // P.V output reuses the score buffer

  for (int idx = threadIdx.x; idx < N * d; idx += kThreads) {
    const int i = idx / d, e = idx % d;
    const bf16* src = load(i) + h * d + e;
    q_s[i * ldq + e] = __float2bfloat16(__bfloat162float(src[0]) * scale);
    k_s[i * ldq + e] = src[C];
    v_s[i * ldq + e] = src[2 * C];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nt = N / 16;
  for (int f = warp; f < nt * nt; f += kWarps) {
    const int mi = f / nt, ni = f % nt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < d; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bq;
      wmma::load_matrix_sync(a, q_s + mi * 16 * ldq + kk, ldq);
      wmma::load_matrix_sync(bq, k_s + ni * 16 * ldq + kk, ldq);
      wmma::mma_sync(acc, a, bq, acc);
    }
    wmma::store_matrix_sync(S_s + mi * 16 * lds + ni * 16, acc, lds,
                            wmma::mem_row_major);
  }
  __syncthreads();

  const float* bh = bias + (size_t)h * N * N;
  const int* reg = region_win;
  for (int i = warp; i < N; i += kWarps) {
    float* srow = S_s + i * lds;
    const int ri = reg ? reg[i] : 0;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      float s = srow[j] + bh[i * N + j];
      if (reg && reg[j] != ri) s -= 1e9f;
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
    const float inv = 1.0f / warp_sum(sum);
    for (int j = lane; j < N; j += 32)
      P_s[i * ldp + j] = __float2bfloat16(srow[j] * inv);
  }
  __syncthreads();

  const int dt = d / 16;
  for (int f = warp; f < nt * dt; f += kWarps) {
    const int mi = f / dt, ni = f % dt;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < N; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
      wmma::load_matrix_sync(a, P_s + mi * 16 * ldp + kk, ldp);
      wmma::load_matrix_sync(bv, v_s + kk * ldq + ni * 16, ldq);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(O_s + mi * 16 * ldo + ni * 16, acc, ldo,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * d; idx += kThreads) {
    const int i = idx / d, e = idx % d;
    bf16* dst = store(i);
    if (dst) dst[h * d + e] = __float2bfloat16(O_s[i * ldo + e]);
  }
}

// The block's (window of one image, head) of the padded, rolled (B, Hp, Wp)
// map, read and written in place, for a grid of (B * nW, heads): token i of
// window (b, wy, wx) is map row (b * Hp + wy * ws + i / ws) * Wp + wx * ws +
// i % ws.  The window partition and reverse are this index arithmetic.
__device__ void map_window_attention(unsigned char* smem,
                                     const bf16* __restrict__ qkv,
                                     const float* __restrict__ bias,
                                     const int* __restrict__ region,
                                     bf16* __restrict__ att, int Hp, int Wp,
                                     int C, int heads, int ws, float scale) {
  const int N = ws * ws;
  const int nww = Wp / ws, nW = (Hp / ws) * nww;
  const int img = blockIdx.x / nW, win = blockIdx.x % nW;
  const int wr = win / nww, wc = win % nww;
  auto token = [&](int i) -> size_t {
    const int r = wr * ws + i / ws, c = wc * ws + i % ws;
    return ((size_t)img * Hp + r) * Wp + c;
  };
  window_attention(
      smem, [&](int i) { return qkv + token(i) * (3 * C); },
      [&](int i) { return att + token(i) * C; }, bias,
      region ? region + (size_t)win * N : nullptr, C, heads, ws, blockIdx.y,
      scale);
}

// The block's (window of the rolled padded map of one image, head), for a
// grid of (B * nW, heads), over the REAL (B, H, W) map: token i of a window
// reads the qkv row of the real position it rolls from, or the bias row
// bqkv where that position is padding, and writes its output only where it
// is real.  Pad, roll and crop are index arithmetic on loads and stores.
__device__ void real_map_window_attention(unsigned char* smem,
                                          const bf16* __restrict__ qkv,
                                          const bf16* __restrict__ bqkv,
                                          const float* __restrict__ bias,
                                          const int* __restrict__ region,
                                          bf16* __restrict__ att, int H, int W,
                                          int C, int heads, int ws, int shift,
                                          float scale) {
  const int N = ws * ws;
  const int Hp = (H + ws - 1) / ws * ws, Wp = (W + ws - 1) / ws * ws;
  const int nww = Wp / ws, nW = (Hp / ws) * nww;
  const int img = blockIdx.x / nW, win = blockIdx.x % nW;
  const int wr = win / nww, wc = win % nww;
  // token i of the rolled window holds position (r, c) of the padded map;
  // returns its row of the real map, or -1 where it is padding
  auto real = [&](int i) -> long long {
    const int r = (wr * ws + i / ws + shift) % Hp;
    const int c = (wc * ws + i % ws + shift) % Wp;
    return (r < H && c < W) ? ((long long)img * H + r) * W + c : -1;
  };
  window_attention(
      smem,
      [&](int i) {
        const long long t = real(i);
        return t < 0 ? bqkv : qkv + t * (3 * C);
      },
      [&](int i) -> bf16* {
        const long long t = real(i);
        return t < 0 ? nullptr : att + t * C;
      },
      bias, region ? region + (size_t)win * N : nullptr, C, heads, ws,
      blockIdx.y, scale);
}

// One block per (window of one image, head) of the padded, rolled map: the
// first design of the attention launch of K1 and of its int8 variant K10,
// outside the tensor-core shapes.  Defined in every source that includes
// this header; only those two launch it.
__global__ void __launch_bounds__(kThreads)
window_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                   const int* __restrict__ region, bf16* __restrict__ att,
                   int Hp, int Wp, int C, int heads, int ws, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  map_window_attention(smem, qkv, bias, region, att, Hp, Wp, C, heads, ws,
                       scale);
}

}  // namespace port
