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
// forward), + f32 bias, -1e9 where shift-region ids differ, f32 softmax P;
// pc = bf16(P) feeds ow = pc.V and dV = pc^T.dO; dP = dO.V^T in f32;
// dS = P * (dP - rowsum(dP * P)) in f32; dbias += dS before the scale;
// bf16(dS * scale) feeds dQ = dSc.K and dK = dSc^T.Q; each output is
// rounded once.
//
// The TPU kernel walks chunks of windows in grid order, packs 128/d heads
// block-diagonally to fill its matrix unit and carries dbias in a revisited
// output block.  None of that exists here: blocks run in any order, so
//   * one block per (window, head), as K1's attention launch; q, k, v, dO of
//     the head (bf16), the f32 P tile and the f32 dP tile stay in shared
//     memory (211 KB at N = 144, d = 32; bf16 copies of P and of dS * scale
//     reuse the tile that is free at that moment), and the six products are
//     WMMA (mma.sync 16x16x16, f32 accumulation);
//   * dbias is summed with f32 atomic adds into a zeroed buffer.  The order
//     of those adds changes from run to run, so dbias (and only dbias)
//     differs between runs in its last f32 bits; every other output is the
//     same from run to run.
// want_ow = 0 and want_dbias = 0 skip the output and its arithmetic.
//
// Bound on an H100: bytes at the Swin-B shapes (d = 32): 14 C bytes per
// token in and out against 12 N d = 55 kflop per token and head, about 99
// flop per byte at N = 144, under the card's 295.  With one 211 KB block per
// SM the kernel is far from that bound; making it fast is later work.
#include "common.cuh"

using namespace port;

namespace {

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

extern "C" int window_attn_bwd(const void* qkv, const void* dout, const void* bias,
                               const void* region, void* dqkv, void* ow,
                               void* dbias, int BN, int nW, int N, int C,
                               int heads, float scale, void* stream) {
  const size_t smem = bwd_smem(N, C / heads).total;
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BN, heads);
  window_attn_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)qkv, (const bf16*)dout, (const float*)bias, (const int*)region,
      (bf16*)dqkv, (bf16*)ow, (float*)dbias, nW, N, C, heads, scale);
  return (int)cudaGetLastError();
}
