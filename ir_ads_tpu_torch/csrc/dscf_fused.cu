// K16: the fused DSCF attention: the rpe bias sampled inside the score loop
// and K4's attention in its unpacked form, in one kernel.  Every query
// pixel (r, c) and head e of group bg attends over the M deformable keys:
//   out = softmax_j(bf16(q * scale) . k_j + bf16(sample(table, r, c, j))) . V
// with the unnormalised weights rounded to bf16, P.V summed in f32 and
// divided by the softmax denominator after it, rounded once.
//
// Replaces ir_ads_tpu/ops/pallas_dscf.py:_dscf_fused_kernel (launched by
// pallas_dscf_attention_fused, the reference DAttentionMM's pallas4).  The
// TPU kernel builds the bias of a band of query rows in a VMEM scratch
// (hg x rows x M x w f32, up to 24 MB) with K3's hat-weight products and
// rounding points, then runs the unpacked rows attention on it.  Nothing of
// that size fits 227 KB of shared memory, and nothing needs to: each score's
// bias is rpe_sample (csrc/dscf.cuh, K3's sampling: bf16 hat weights in the
// order (ay*r - s) + by, the bf16 table, a bf16 u, the bias rounded to bf16
// and widened), computed where the score is, and the attention is
// dscf_attend<false> (K4's unpacked form).  Both are the device code K3 and
// K4 run, with every operation written out, so K16 is bit-equal to K3
// followed by K4 with packed=0, and no bias reaches device memory.  The
// reference's band (rows dividing h with rows * w a multiple of 8) is a
// VMEM tiling with no counterpart here; the wrapper keeps its domain.
//
// Bound on an H100: operations on the CUDA cores (no bias to read: q, k, v
// and the output are a few MB, while each score costs the 2 x 2-tap sample,
// about 60 f32 operations, and the 8-wide dot, in each of two passes).
// Design: K4's, one block per (bg, head) and 256 query pixels, the head's K
// and V staged in shared memory as f32, one thread per query pixel running
// the online max/sum pass and the P.V pass; the table (S1 x S2 f32 per
// head, 76 KB at Swin-B's 119 x 159) is read through the read-only cache,
// where the pixels of a block, close on the plane, share its lines.
#include "dscf.cuh"

using namespace port;

namespace {

constexpr int HC = kDscfHeadChannels;

__global__ void __launch_bounds__(kThreads)
dscf_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ pos,
                  const float* __restrict__ table, bf16* __restrict__ out, int G,
                  int hg, int h, int w, int M, int Mp, int s1, int s2, float scale,
                  float ay, float ax) {
  extern __shared__ __align__(16) float kv_s[];
  float* K_s = kv_s;
  float* V_s = kv_s + M * HC;
  const int bg = blockIdx.y / hg, e = blockIdx.y % hg;
  const int HW = h * w, GC = hg * HC;
  stage_head_kv(k + (size_t)bg * Mp * GC + e * HC, v + (size_t)bg * Mp * GC + e * HC, M,
                GC, K_s, V_s);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int r = p / w, c = p % w;
  float qs[HC], acc[HC];
  scaled_query(q + ((size_t)bg * HW + p) * GC + e * HC, scale, qs);
  dscf_attend<false>(qs, K_s, V_s, M, [&](int j) {
    return round_bf16(rpe_sample(pos, table, bg, e, j, r, c, G, hg, M, s1, s2, ay, ax));
  }, acc);
  bf16* op = out + ((size_t)bg * HW + p) * GC + e * HC;
#pragma unroll
  for (int d = 0; d < HC; ++d) op[d] = __float2bfloat16(acc[d]);
}

}  // namespace

extern "C" int dscf_fused_attention(const void* q, const void* k, const void* v,
                                    const void* pos, const void* table, void* out,
                                    int BG, int G, int hg, int h, int w, int M, int Mp,
                                    int s1, int s2, float scale, float ay, float ax,
                                    void* stream) {
  const size_t smem = (size_t)2 * M * HC * sizeof(float);
  cudaFuncSetAttribute(dscf_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((h * w + kThreads - 1) / kThreads, BG * hg);
  dscf_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)pos,
      (const float*)table, (bf16*)out, G, hg, h, w, M, Mp, s1, s2, scale, ay, ax);
  return (int)cudaGetLastError();
}
