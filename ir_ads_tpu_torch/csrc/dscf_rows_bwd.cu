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
// forward), f32 softmax P; pc = bf16(P) feeds dV += pc * dO; dP = v.dO;
// dS = P * (dP - sum_j dP_j P_j) in f32; dbias = dS; bf16(dS * scale) feeds
// dq += dSc * k and dK += dSc * q.  Keys M <= j < Mp (masked with -1e9 on
// the TPU, probability exactly 0) are not visited; their dk and dv rows
// stay at the zeros the caller wrote.
//
// The TPU kernel packs (row, head) slots block-diagonally for its matrix
// unit and carries dk, dv in a revisited output block over the row tiles.
// Here, as in K4: one block per (bg, head) and 256 query pixels, the head's
// K and V (M x 8 each) staged in shared memory as f32, one thread per query
// pixel, 8-wide dot products on the CUDA cores (8-channel heads give the
// tensor cores nothing to hold).  Two passes over the keys:
//   1. online max, sum and sum_j e_j dP_j (rescaled as the max moves);
//   2. P_j, dS_j -> the dbias store, dq in registers, and the (dK_j, dV_j)
//      contributions, summed over the warp's 32 pixels with a halving
//      butterfly (16 shuffles for 16 values) and added to per-block sums in
//      shared memory.
// The block's sums then go to dk, dv with f32 atomic adds.  The order of
// those adds (shared and global) changes from run to run, so dk and dv
// differ between runs in their last f32 bits; dq and dbias do not.
//
// Bound on an H100: bytes, by the f32 dbias store (4 bytes per score) and
// the bf16 bias read (2 bytes), against ~70 flop per score.  Consecutive
// threads run along w, so the bias reads and the dbias stores coalesce.
#include "common.cuh"

using namespace port;

namespace {

constexpr int HC = 8;  // channels per DSCF head at every level of Swin-B

// Sum each of 16 per-lane values over the warp; lane l ends with the total
// of value l >> 1 in vals[0].
template <int HALF>
__device__ __forceinline__ void halve(float (&vals)[16], int lane) {
  // lanes with bit 2*HALF set keep the upper HALF values, the others the
  // lower; each adds its partner's copy of what it keeps
  const bool upper = lane & (2 * HALF);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? vals[i] : vals[i + HALF];
    const float keep = upper ? vals[i + HALF] : vals[i];
    vals[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

__device__ __forceinline__ void warp_sum16(float (&vals)[16]) {
  const int lane = threadIdx.x % 32;
  halve<8>(vals, lane);
  halve<4>(vals, lane);
  halve<2>(vals, lane);
  halve<1>(vals, lane);
  vals[0] += __shfl_xor_sync(0xffffffffu, vals[0], 1);
}

__global__ void __launch_bounds__(kThreads)
dscf_rows_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ bias,
                     const bf16* __restrict__ dout, bf16* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dbias, int hg, int h, int w, int M,
                     int Mp, float scale) {
  extern __shared__ __align__(16) float kv_s[];
  float* K_s = kv_s;
  float* V_s = K_s + M * HC;
  float* dKV_s = V_s + M * HC;  // (M, 16): dK row j | dV row j
  const int bg = blockIdx.y / hg, e = blockIdx.y % hg;
  const int HW = h * w, GC = hg * HC;
  const bf16* kb = k + (size_t)bg * Mp * GC + e * HC;
  const bf16* vb = v + (size_t)bg * Mp * GC + e * HC;
  for (int idx = threadIdx.x; idx < M * HC; idx += kThreads) {
    const int j = idx / HC, d = idx % HC;
    K_s[idx] = __bfloat162float(kb[(size_t)j * GC + d]);
    V_s[idx] = __bfloat162float(vb[(size_t)j * GC + d]);
  }
  for (int idx = threadIdx.x; idx < M * 2 * HC; idx += kThreads) dKV_s[idx] = 0.0f;
  __syncthreads();

  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < HW;  // dead threads still take part in the shuffles
  const int pc_ = live ? p : HW - 1;
  const int r = pc_ / w, c = pc_ % w;
  float qs[HC], go[HC];
  const size_t qo = ((size_t)bg * HW + pc_) * GC + e * HC;
#pragma unroll
  for (int d = 0; d < HC; ++d) {
    qs[d] = live ? __bfloat162float(q[qo + d]) : 0.0f;
    go[d] = live ? __bfloat162float(dout[qo + d]) : 0.0f;
  }
  const size_t bo = (((size_t)bg * hg + e) * h + r) * M * w + c;
  const bf16* bp = bias + bo;

  auto score = [&](int j) {
    const float* kj = K_s + j * HC;
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < HC; ++d) s += qs[d] * kj[d];
    return s * scale + __bfloat162float(bp[(size_t)j * w]);
  };
  auto dprob = [&](int j) {
    const float* vj = V_s + j * HC;
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < HC; ++d) s += go[d] * vj[d];
    return s;
  };

  float mx = -INFINITY, l = 0.0f, acc = 0.0f;  // acc = sum_j e_j dP_j
  for (int j = 0; j < M; ++j) {
    const float s = score(j), dp = dprob(j);
    if (s > mx) {
      const float f = expf(mx - s);
      l = l * f + 1.0f;
      acc = acc * f + dp;
      mx = s;
    } else {
      const float ej = expf(s - mx);
      l += ej;
      acc += ej * dp;
    }
  }
  const float rs = acc / l;

  float dqa[HC];
#pragma unroll
  for (int d = 0; d < HC; ++d) dqa[d] = 0.0f;
  float* dbp = dbias + bo;
  const int lane = threadIdx.x % 32;
  for (int j = 0; j < M; ++j) {
    const float pj = expf(score(j) - mx) / l;
    const float ds = pj * (dprob(j) - rs);
    if (live) dbp[(size_t)j * w] = ds;
    const float dsc = round_bf16(ds * scale);
    const float pcj = round_bf16(pj);
    const float* kj = K_s + j * HC;
    float vals[16];
#pragma unroll
    for (int d = 0; d < HC; ++d) {
      dqa[d] += dsc * kj[d];
      vals[d] = dsc * qs[d];       // dK_j
      vals[HC + d] = pcj * go[d];  // dV_j
    }
    warp_sum16(vals);
    if ((lane & 1) == 0) atomicAdd(dKV_s + j * 2 * HC + (lane >> 1), vals[0]);
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < HC; ++d) dq[qo + d] = __float2bfloat16(dqa[d]);
  }
  __syncthreads();
  float* dkb = dk + (size_t)bg * Mp * GC + e * HC;
  float* dvb = dv + (size_t)bg * Mp * GC + e * HC;
  for (int idx = threadIdx.x; idx < M * 2 * HC; idx += kThreads) {
    const int j = idx / (2 * HC), d = idx % (2 * HC);
    float* dst = d < HC ? dkb + (size_t)j * GC + d : dvb + (size_t)j * GC + d - HC;
    atomicAdd(dst, dKV_s[idx]);
  }
}

}  // namespace

extern "C" int dscf_rows_bwd(const void* q, const void* k, const void* v,
                             const void* bias, const void* dout, void* dq,
                             void* dk, void* dv, void* dbias, int BG, int hg,
                             int h, int w, int M, int Mp, float scale,
                             void* stream) {
  const size_t smem = (size_t)4 * M * HC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dscf_rows_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((h * w + kThreads - 1) / kThreads, BG * hg);
  dscf_rows_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias,
      (const bf16*)dout, (bf16*)dq, (float*)dk, (float*)dv, (float*)dbias, hg, h,
      w, M, Mp, scale);
  return (int)cudaGetLastError();
}
