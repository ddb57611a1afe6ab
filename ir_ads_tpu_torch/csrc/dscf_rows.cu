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
// Both are dscf_attend<Packed> in csrc/dscf.cuh, which K16 and K17 share.
// Padded keys (M <= j < Mp) are masked with -1e9 on the TPU; here they are
// simply not visited, which gives the same result (exp(-1e9 - max) is 0 in
// f32).
//
// Bound on an H100: bytes (the (BG, hg, h, M, w) bf16 bias is the only large
// input: 2 bytes per score against ~35 flop per score).  Design: one block
// per (bg, head) and 256 query pixels; the head's K and V (M x 8 each)
// are staged in shared memory as f32 and read as warp-wide broadcasts; one
// thread per query pixel runs an online max/sum pass and then the P.V pass,
// reading the bias along the query column, so both passes coalesce.  The
// products are 8-wide dot products on the CUDA cores: with 8 channels per
// head they are too thin for the tensor cores to pay.
#include "dscf.cuh"

using namespace port;

namespace {

constexpr int HC = kDscfHeadChannels;

template <bool Packed>
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
  stage_head_kv(k + (size_t)bg * Mp * GC + e * HC, v + (size_t)bg * Mp * GC + e * HC, M,
                GC, K_s, V_s);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int r = p / w, c = p % w;
  float qs[HC], acc[HC];
  scaled_query(q + ((size_t)bg * HW + p) * GC + e * HC, scale, qs);
  const bf16* bp = bias + (((size_t)bg * hg + e) * h + r) * M * w + c;
  dscf_attend<Packed>(qs, K_s, V_s, M,
                      [&](int j) { return __bfloat162float(bp[(size_t)j * w]); }, acc);
  bf16* op = out + ((size_t)bg * HW + p) * GC + e * HC;
#pragma unroll
  for (int d = 0; d < HC; ++d) op[d] = __float2bfloat16(acc[d]);
}

template <bool Packed>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out,
           int BG, int hg, int h, int w, int M, int Mp, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)2 * M * HC * sizeof(float);
  cudaFuncSetAttribute(dscf_rows_kernel<Packed>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((h * w + kThreads - 1) / kThreads, BG * hg);
  dscf_rows_kernel<Packed><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias,
      (bf16*)out, hg, h, w, M, Mp, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dscf_rows_attention(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int BG, int hg,
                                   int h, int w, int M, int Mp, float scale,
                                   int packed, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return packed ? launch<true>(q, k, v, bias, out, BG, hg, h, w, M, Mp, scale, s)
                : launch<false>(q, k, v, bias, out, BG, hg, h, w, M, Mp, scale, s);
}
