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
// [e*8, (e+1)*8) and bias lanes [e*Mp, (e+1)*Mp).  The caller pads the keys
// with zeros and their bias columns with -1e9.  This kernel visits all Mp
// keys, as the TPU kernel does, so it computes the function for any bias; a
// padded key adds exactly 0 to the softmax sum and to P.V (exp(-1e9 - max)
// is 0 in f32), so skipping the padding, given its count, would be exact
// too.  The TPU kernel tiles the queries for VMEM; here a block of 256
// queries plays that part.
//
// Bound on an H100: bytes (the bf16 bias, 2 bytes per score, against ~35
// flop per score on the CUDA cores).  Design: K4's (csrc/dscf_rows.cu) on
// this layout: one block per (bg, head) and 256 query pixels, the head's K
// and V (Mp x 8, 40 KB as f32 at Mp = 640) staged in shared memory, one
// thread per query pixel running dscf_attend<true> (csrc/dscf.cuh): an
// online max/sum pass, then the P.V pass.  A thread reads its own bias row
// (Mp contiguous bf16) twice; the rows of a warp lie hg*Mp*2 bytes apart,
// so each load touches 32 sectors and the next 15 loads of a thread hit
// them in L1.  8-channel heads stay on the CUDA cores, as in K4.
#include "dscf.cuh"

using namespace port;

namespace {

constexpr int HC = kDscfHeadChannels;

__global__ void __launch_bounds__(kThreads)
dscf_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ bias,
                      bf16* __restrict__ out, int hg, int HW, int Mp, float scale) {
  extern __shared__ __align__(16) float kv_s[];
  float* K_s = kv_s;
  float* V_s = kv_s + Mp * HC;
  const int bg = blockIdx.y / hg, e = blockIdx.y % hg;
  const int GC = hg * HC;
  stage_head_kv(k + (size_t)bg * Mp * GC + e * HC, v + (size_t)bg * Mp * GC + e * HC, Mp,
                GC, K_s, V_s);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  float qs[HC], acc[HC];
  scaled_query(q + ((size_t)bg * HW + p) * GC + e * HC, scale, qs);
  const bf16* bp = bias + ((size_t)bg * HW + p) * hg * Mp + (size_t)e * Mp;
  dscf_attend<true>(qs, K_s, V_s, Mp, [&](int j) { return __bfloat162float(bp[j]); }, acc);
  bf16* op = out + ((size_t)bg * HW + p) * GC + e * HC;
#pragma unroll
  for (int d = 0; d < HC; ++d) op[d] = __float2bfloat16(acc[d]);
}

}  // namespace

extern "C" int dscf_attention(const void* q, const void* k, const void* v, const void* bias,
                              void* out, int BG, int hg, int HW, int Mp, float scale,
                              void* stream) {
  const size_t smem = (size_t)2 * Mp * HC * sizeof(float);
  cudaFuncSetAttribute(dscf_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((HW + kThreads - 1) / kThreads, BG * hg);
  dscf_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias, (bf16*)out, hg,
      HW, Mp, scale);
  return (int)cudaGetLastError();
}
