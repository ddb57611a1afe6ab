// K4: DSCF deformable attention in the rows layout.  Every query pixel and
// head attends over the M deformable keys of its (batch, group):
//   out = softmax_j(q.k_j * scale + bias[j]) . V,
// the probabilities normalised and rounded to bf16 before P.V, as the twin
// (pallas_dscf.dscf_rows_reference) does.  Padded keys (M <= j < Mp) are
// masked with -1e9 on the TPU; here they are simply not visited, which gives
// the same probabilities (exp(-1e9 - max) is 0 in f32).
//
// Replaces ir_ads_tpu/ops/pallas_dscf.py:_dscf_rows_kernel_packed and
// _dscf_rows_kernel (launched by pallas_dscf_attention_rows): one function,
// two TPU layouts of it.
//
// Bound on an H100: bytes (the (BG, hg, h, M, w) bf16 bias is the only large
// input: 2 bytes per score against ~35 flop per score).  Design: one block
// per (bg, head) and 256 query pixels; the head's K and V (M x 8 each)
// are staged in shared memory as f32 and read as warp-wide broadcasts; one
// thread per query pixel runs an online max/sum pass and then the P.V pass,
// reading the bias along the query column, so both passes coalesce.  The
// products are 8-wide dot products on the CUDA cores: with 8 channels per
// head they are too thin for the tensor cores to pay.
#include "common.cuh"

using namespace port;

namespace {

constexpr int HC = 8;  // channels per DSCF head at every level of Swin-B

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
  const bf16* kb = k + (size_t)bg * Mp * GC + e * HC;
  const bf16* vb = v + (size_t)bg * Mp * GC + e * HC;
  for (int idx = threadIdx.x; idx < M * HC; idx += kThreads) {
    const int j = idx / HC, d = idx % HC;
    K_s[idx] = __bfloat162float(kb[(size_t)j * GC + d]);
    V_s[idx] = __bfloat162float(vb[(size_t)j * GC + d]);
  }
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int r = p / w, c = p % w;
  float qs[HC];
  const bf16* qp = q + ((size_t)bg * HW + p) * GC + e * HC;
#pragma unroll
  for (int d = 0; d < HC; ++d)
    qs[d] = round_bf16(__bfloat162float(qp[d]) * scale);
  const bf16* bp = bias + (((size_t)bg * hg + e) * h + r) * M * w + c;

  auto score = [&](int j) {
    const float* kj = K_s + j * HC;
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < HC; ++d) s += qs[d] * kj[d];
    return s + __bfloat162float(bp[(size_t)j * w]);
  };
  float mx = -INFINITY, l = 0.0f;
  for (int j = 0; j < M; ++j) {
    const float s = score(j);
    if (s > mx) {
      l = l * expf(mx - s) + 1.0f;
      mx = s;
    } else {
      l += expf(s - mx);
    }
  }
  const float inv = 1.0f / l;
  float acc[HC];
#pragma unroll
  for (int d = 0; d < HC; ++d) acc[d] = 0.0f;
  for (int j = 0; j < M; ++j) {
    const float pj = round_bf16(expf(score(j) - mx) * inv);
    const float* vj = V_s + j * HC;
#pragma unroll
    for (int d = 0; d < HC; ++d) acc[d] += pj * vj[d];
  }
  bf16* op = out + ((size_t)bg * HW + p) * GC + e * HC;
#pragma unroll
  for (int d = 0; d < HC; ++d) op[d] = __float2bfloat16(acc[d]);
}

}  // namespace

extern "C" int dscf_rows_attention(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int BG, int hg,
                                   int h, int w, int M, int Mp, float scale,
                                   void* stream) {
  const size_t smem = (size_t)2 * M * HC * sizeof(float);
  cudaFuncSetAttribute(dscf_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((h * w + kThreads - 1) / kThreads, BG * hg);
  dscf_rows_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias,
      (bf16*)out, hg, h, w, M, Mp, scale);
  return (int)cudaGetLastError();
}
