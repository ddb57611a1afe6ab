// K1: the Swin attention half-block, y = x + proj(W-MSA(qkv(LN1 x))).
//
// Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v4 (launched by
// pallas_window_block).  x is the padded, cyclically rolled (B, Hp, Wp, C)
// bf16 map; LN1 output is zeroed at positions that are padding of the
// original map, qkv is rounded to bf16 as it leaves the product, the
// probabilities are rounded to bf16 before P.V, and LN statistics are f32.
//
// Bound on an H100: operations at every stage.  Per token the half-block
// does 8C^2 + 4*144*C flops (qkv, proj, scores, P.V) and must move 4C bytes
// (x in, y out, bf16), about 400 flop per byte at C = 128 and more at the
// wider stages, above the card's 295 (989 Tflop/s over 3.35 TB/s).  The
// count is chip_smoke.py's.  Design: three launches,
// because at C = 1024 neither a window's 144 x 3C qkv nor its LN(x) fits in
// the 227 KB of shared memory of one block:
//   ln_qkv      rows of the map: LN1 in f32 -> bf16 tile in shared memory ->
//               WMMA product with Wqkv -> qkv (bf16) to device memory;
//   window_attn one block per (window, head): scores, bias, region mask,
//               softmax and P.V in shared memory, all WMMA;
//   proj_add    rows: attention output tile -> WMMA product with Wproj ->
//               + bias + residual x -> y.
// The qkv and attention maps make one round trip through device memory (the
// TPU kernel keeps them in VMEM); fusing them away is later work.
#include "common.cuh"

using namespace port;

namespace {

constexpr int kLdF = kBN + 4;  // f32 tile row stride

__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
              const bf16* __restrict__ b, const bf16* __restrict__ wqkv,
              const bf16* __restrict__ bqkv, bf16* __restrict__ qkv,
              int T, int Hp, int Wp, int C, int h_real, int w_real, int shift,
              float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bm = rows_per_block(C);
  const int lda = C + 8;
  bf16* A_s = reinterpret_cast<bf16*>(smem);
  float* F_s = reinterpret_cast<float*>(smem + align128((size_t)bm * lda * 2));
  bf16* W_s = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(F_s) + align128((size_t)bm * kLdF * 4));
  const int row0 = blockIdx.x * bm;
  const bool padded = h_real != Hp || w_real != Wp;
  layer_norm_rows(A_s, lda, x, row0, bm, T, C, g, b, eps, [=](int row) {
    if (!padded) return false;
    const int pix = row % (Hp * Wp);
    const int r = pix / Wp, c = pix % Wp;
    return (r + shift) % Hp >= h_real || (c + shift) % Wp >= w_real;
  });
  const int C3 = 3 * C;
  for (int n0 = 0; n0 < C3; n0 += kBN) {
    tile_gemm(F_s, kLdF, A_s, lda, bm, wqkv + (size_t)n0 * C, C, kBN, C, C,
              W_s, false);
    for (int idx = threadIdx.x; idx < bm * kBN; idx += kThreads) {
      const int r = idx / kBN, col = idx % kBN, row = row0 + r;
      if (row < T)
        qkv[(size_t)row * C3 + n0 + col] = __float2bfloat16(
            F_s[r * kLdF + col] + __bfloat162float(bqkv[n0 + col]));
    }
  }
}

// One block per (window of one image, head).  N = ws*ws tokens, d channels.
__global__ void __launch_bounds__(kThreads)
window_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                   const int* __restrict__ region, bf16* __restrict__ att,
                   int Hp, int Wp, int C, int heads, int ws, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = ws * ws, d = C / heads;
  const int nww = Wp / ws, nW = (Hp / ws) * nww;
  const int img = blockIdx.x / nW, win = blockIdx.x % nW, h = blockIdx.y;
  const int ldq = d + 8, lds = N + 4, ldp = N + 8, ldo = d + 4;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + N * ldq;
  bf16* v_s = k_s + N * ldq;
  float* S_s = reinterpret_cast<float*>(smem + align128((size_t)3 * N * ldq * 2));
  bf16* P_s = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(S_s) + align128((size_t)N * lds * 4));
  float* O_s = S_s;  // P.V output reuses the score buffer
  const int wr = win / nww, wc = win % nww;
  const int C3 = 3 * C;

  auto token = [&](int i) -> size_t {
    const int r = wr * ws + i / ws, c = wc * ws + i % ws;
    return ((size_t)img * Hp + r) * Wp + c;
  };
  for (int idx = threadIdx.x; idx < N * d; idx += kThreads) {
    const int i = idx / d, e = idx % d;
    const bf16* src = qkv + token(i) * C3 + h * d + e;
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
  const int* reg = region ? region + (size_t)win * N : nullptr;
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
    att[token(i) * C + h * d + e] = __float2bfloat16(O_s[i * ldo + e]);
  }
}

__global__ void __launch_bounds__(kThreads)
proj_add_kernel(const bf16* __restrict__ att, const bf16* __restrict__ x,
                const bf16* __restrict__ wproj, const bf16* __restrict__ bproj,
                bf16* __restrict__ y, int T, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bm = rows_per_block(C);
  const int lda = C + 8;
  bf16* A_s = reinterpret_cast<bf16*>(smem);
  float* F_s = reinterpret_cast<float*>(smem + align128((size_t)bm * lda * 2));
  bf16* W_s = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(F_s) + align128((size_t)bm * kLdF * 4));
  const int row0 = blockIdx.x * bm;
  for (int idx = threadIdx.x; idx < bm * C; idx += kThreads) {
    const int r = idx / C, c = idx % C, row = row0 + r;
    A_s[r * lda + c] = row < T ? att[(size_t)row * C + c] : __float2bfloat16(0.0f);
  }
  for (int n0 = 0; n0 < C; n0 += kBN) {
    tile_gemm(F_s, kLdF, A_s, lda, bm, wproj + (size_t)n0 * C, C, kBN, C, C,
              W_s, false);
    for (int idx = threadIdx.x; idx < bm * kBN; idx += kThreads) {
      const int r = idx / kBN, col = idx % kBN, row = row0 + r;
      if (row < T) {
        const size_t o = (size_t)row * C + n0 + col;
        y[o] = __float2bfloat16(__bfloat162float(x[o]) + F_s[r * kLdF + col] +
                                __bfloat162float(bproj[n0 + col]));
      }
    }
  }
}

size_t rows_smem(int C) {
  const int bm = rows_per_block(C);
  return align128((size_t)bm * (C + 8) * 2) + align128((size_t)bm * kLdF * 4) +
         (size_t)kBN * kBK * 2;
}

}  // namespace

extern "C" int swin_window_block(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* region, void* qkv, void* att, void* y, int B, int Hp, int Wp,
    int C, int heads, int ws, int h_real, int w_real, int shift, float scale,
    float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * Hp * Wp;
  const int bm = rows_per_block(C);
  const size_t rs = rows_smem(C);
  cudaFuncSetAttribute(ln_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rs);
  cudaFuncSetAttribute(proj_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rs);
  ln_qkv_kernel<<<(T + bm - 1) / bm, kThreads, rs, st>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (const bf16*)wqkv,
      (const bf16*)bqkv, (bf16*)qkv, T, Hp, Wp, C, h_real, w_real, shift, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int N = ws * ws, d = C / heads;
  const size_t as = align128((size_t)3 * N * (d + 8) * 2) +
                    align128((size_t)N * (N + 4) * 4) + (size_t)N * (N + 8) * 2;
  cudaFuncSetAttribute(window_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)as);
  dim3 grid(B * (Hp / ws) * (Wp / ws), heads);
  window_attn_kernel<<<grid, kThreads, as, st>>>(
      (const bf16*)qkv, (const float*)bias, (const int*)region, (bf16*)att, Hp,
      Wp, C, heads, ws, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  proj_add_kernel<<<(T + bm - 1) / bm, kThreads, rs, st>>>(
      (const bf16*)att, (const bf16*)x, (const bf16*)wproj, (const bf16*)bproj,
      (bf16*)y, T, C);
  return (int)cudaGetLastError();
}
