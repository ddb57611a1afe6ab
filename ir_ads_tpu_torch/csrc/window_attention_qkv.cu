// K12: W-MSA / SW-MSA on windowed, unsplit qkv, (B*nW, N, 3C) -> (B*nW, N, C),
// and K15: the same on the qkv map, (B, Hp, Wp, 3C) -> (B, Hp, Wp, C).
//
// K12 replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v2 (launched by
// pallas_window_attention_qkv; twin _qkv_reference), K15 _attn_kernel_v3
// (launched by pallas_window_attention_map; twin _map_reference, which is
// window_partition -> _qkv_reference -> window_reverse).  Heads stay in the
// channel dimension: token i's row is q | k | v, head h at channels
// [h*d, (h+1)*d) of each third, and the output row keeps the same head
// order, ready for the output projection.  The f32 (heads, N, N) rel-pos
// bias is added to the f32 scores, and -1e9 where the shift-region ids of a
// pair differ; the (nW, N) region ids are tiled over the images (window w
// of the batch uses row w % nW).  q * scale is rounded to bf16, the softmax
// is f32, the probabilities are rounded to bf16 and P.V is summed in f32
// and rounded once: window_block.cuh's window_attention, which K1, K5 and
// K10 run on their own layouts.  K15 reads and writes the map in place:
// token i of window (b, wy, wx) is map row (b*Hp + wy*ws + i/ws)*Wp +
// wx*ws + i%ws (map_window_attention, K1's attention launch), so the TPU
// kernel's VMEM partition and reverse are index arithmetic here.  K15's
// output is K12's on the partitioned map, reversed, bit for bit.
//
// Bound on an H100: bytes.  Per window it reads 3C x N and writes C x N
// bf16 values and does 4 N^2 C flops (scores and P.V), 72 flops per byte
// at N = 144, under the card's 295 (989 Tflop/s over 3.35 TB/s).  The count
// is chip_smoke.py's.  Design: one block of 256 threads per (window, head)
// stages its head's q, k and v slices in shared memory, computes scores,
// softmax and P.V there with WMMA, and writes its head's slice of the
// output: the N x N scores never reach device memory.  The loads are 2-byte
// reads strided by 3C; vectorised or TMA loads are later work.
#include "window_block.cuh"

using namespace port;

namespace {

__global__ void __launch_bounds__(kThreads)
window_attention_qkv_kernel(const bf16* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const int* __restrict__ region,
                            bf16* __restrict__ out, int C, int heads, int ws,
                            int nW, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = ws * ws;
  const size_t row0 = (size_t)blockIdx.x * N;
  window_attention(
      smem, [&](int i) { return qkv + (row0 + i) * (3 * C); },
      [&](int i) { return out + (row0 + i) * C; }, bias,
      region ? region + (size_t)(blockIdx.x % nW) * N : nullptr, C, heads, ws,
      blockIdx.y, scale);
}

__global__ void __launch_bounds__(kThreads)
window_attention_map_kernel(const bf16* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const int* __restrict__ region,
                            bf16* __restrict__ out, int Hp, int Wp, int C,
                            int heads, int ws, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  map_window_attention(smem, qkv, bias, region, out, Hp, Wp, C, heads, ws,
                       scale);
}

}  // namespace

// qkv (BN, ws*ws, 3C) bf16, bias (heads, N, N) f32, region (nW, N) int32 or
// null (no mask), out (BN, N, C) bf16.  BN is a multiple of nW.
extern "C" int window_attention_qkv(const void* qkv, const void* bias,
                                    const void* region, void* out, int BN,
                                    int C, int heads, int ws, int nW,
                                    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t as = window_attention_smem(ws * ws, C / heads);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)as);
  if (err != cudaSuccess) return (int)err;
  window_attention_qkv_kernel<<<dim3(BN, heads), kThreads, as, st>>>(
      (const bf16*)qkv, (const float*)bias, (const int*)region, (bf16*)out, C,
      heads, ws, nW, scale);
  return (int)cudaGetLastError();
}

// qkv (B, Hp, Wp, 3C) bf16, bias (heads, N, N) f32, region (nW, N) int32 or
// null (no mask), out (B, Hp, Wp, C) bf16.  Hp and Wp are multiples of ws.
extern "C" int window_attention_map(const void* qkv, const void* bias,
                                    const void* region, void* out, int B,
                                    int Hp, int Wp, int C, int heads, int ws,
                                    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t as = window_attention_smem(ws * ws, C / heads);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)as);
  if (err != cudaSuccess) return (int)err;
  window_attention_map_kernel<<<dim3(B * (Hp / ws) * (Wp / ws), heads),
                                kThreads, as, st>>>(
      (const bf16*)qkv, (const float*)bias, (const int*)region, (bf16*)out, Hp,
      Wp, C, heads, ws, scale);
  return (int)cudaGetLastError();
}
