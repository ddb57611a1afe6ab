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
// and rounded once: the rounding points of window_block.cuh's
// window_attention.  K15 reads and writes the map in place: token i of
// window (b, wy, wx) is map row (b*Hp + wy*ws + i/ws)*Wp + wx*ws + i%ws
// (window_mma.cuh's MapRows, on which the attention launches of K1, K10 and
// K13 run too), so the TPU kernel's VMEM partition and reverse are index
// arithmetic here.  K15's
// output is K12's on the partitioned map, reversed, bit for bit.
//
// Bound on an H100: bytes.  Per window it reads 3C x N and writes C x N
// bf16 values and does 4 N^2 C flops (scores and P.V), 72 flops per byte
// at N = 144, under the card's 295 (989 Tflop/s over 3.35 TB/s).  The count
// is chip_smoke.py's.
//
// Two designs; the wrappers (ops/window_attention_qkv.py,
// ops/window_attention_map.py) choose by shape alone: d = C / heads of 16
// or 32 and N <= 144 (every Swin-B stage: d = 32, N = 144) take the tensor
// cores, anything else the first design.
//
// The tensor cores (window_qkv_mma_kernel, window_map_mma_kernel):
// window_mma.cuh's design in its rounded form, K20's redesign moved to
// this layout.  One persistent block a head walks the head's windows; the
// head's f32 bias is staged in shared memory once a block; token i's q, k
// and v slices (d bf16 each, 64 bytes at d = 32) arrive as 16-byte
// cp.async pieces of its 3C-wide row, double-buffered; scores, softmax
// and P.V stay in registers, mma.sync m16n8k16 with bf16(q * scale) as
// one operand.  K12 and K15 instantiate the same device code on two
// Tokens policies (window_mma.cuh's WindowRows and MapRows), so K15 stays
// K12 on the partitioned map, reversed, bit for bit.
// The softmax sum runs in another order than window_block.cuh's (the C
// fragments' order, then across the quad, against a lane-strided sum and
// a warp butterfly), so an output can sit one bf16 ulp from the first
// design's.
//
// The first design (window_attention_qkv_kernel, window_attention_map_kernel):
// one block of 256 threads per (window, head) stages its head's q, k and v
// slices in shared memory by 2-byte loads strided by 3C, computes scores,
// softmax and P.V there with WMMA (window_block.cuh's window_attention, the
// N x N scores in shared memory: one block of 8 warps an SM), and writes
// its head's slice of the output.
#include "window_block.cuh"
#include "window_mma.cuh"

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

template <int NT, int D>
__global__ void __launch_bounds__(WindowMma<NT, D>::Threads, 1)
window_qkv_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                      const int* __restrict__ region, bf16* __restrict__ out, int BN, int C,
                      int N, int nW, float scale) {
  const QkvTokens<D, WindowRows> tok{qkv, out, C, (int)blockIdx.y, WindowRows{N}};
  window_mma_head<NT, D, false>(tok, bias, region, BN, N, nW, scale);
}

template <int NT, int D>
__global__ void __launch_bounds__(WindowMma<NT, D>::Threads, 1)
window_map_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                      const int* __restrict__ region, bf16* __restrict__ out, int B, int Hp,
                      int Wp, int C, int ws, float scale) {
  map_head<NT, D>(qkv, bias, region, out, B, Hp, Wp, C, ws, scale);
}

}  // namespace

// qkv (BN, ws*ws, 3C) bf16, bias (heads, N, N) f32, region (nW, N) int32 or
// null (no mask), out (BN, N, C) bf16.  BN is a multiple of nW.
// tensor_cores = 1 takes the tensor-core design (C / heads 16 or 32, N <=
// 144; else cudaErrorInvalidValue), 0 the first design.
extern "C" int window_attention_qkv(const void* qkv, const void* bias,
                                    const void* region, void* out, int BN,
                                    int C, int heads, int ws, int nW,
                                    int tensor_cores, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = ws * ws;
  if (tensor_cores) {
    if (N > 144) return (int)cudaErrorInvalidValue;
    return launch_mma(N, C / heads, [&](auto nt, auto dd) {
      constexpr int NT = decltype(nt)::value, D = decltype(dd)::value;
      using L = WindowMma<NT, D>;
      auto kernel = window_qkv_mma_kernel<NT, D>;
      kernel<<<head_grid(kernel, L::Bytes, L::Threads, BN, heads), L::Threads, L::Bytes, st>>>(
          (const bf16*)qkv, (const float*)bias, (const int*)region, (bf16*)out, BN, C, N, nW,
          scale);
      return (int)cudaGetLastError();
    });
  }
  const size_t as = window_attention_smem(N, C / heads);
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
// tensor_cores as window_attention_qkv's.
extern "C" int window_attention_map(const void* qkv, const void* bias,
                                    const void* region, void* out, int B,
                                    int Hp, int Wp, int C, int heads, int ws,
                                    int tensor_cores, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = ws * ws, BN = B * (Hp / ws) * (Wp / ws);
  if (tensor_cores) {
    if (N > 144) return (int)cudaErrorInvalidValue;
    return launch_mma(N, C / heads, [&](auto nt, auto dd) {
      constexpr int NT = decltype(nt)::value, D = decltype(dd)::value;
      using L = WindowMma<NT, D>;
      auto kernel = window_map_mma_kernel<NT, D>;
      kernel<<<head_grid(kernel, L::Bytes, L::Threads, BN, heads), L::Threads, L::Bytes, st>>>(
          (const bf16*)qkv, (const float*)bias, (const int*)region, (bf16*)out, B, Hp, Wp, C,
          ws, scale);
      return (int)cudaGetLastError();
    });
  }
  const size_t as = window_attention_smem(N, C / heads);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)as);
  if (err != cudaSuccess) return (int)err;
  window_attention_map_kernel<<<dim3(BN, heads), kThreads, as, st>>>(
      (const bf16*)qkv, (const float*)bias, (const int*)region, (bf16*)out, Hp,
      Wp, C, heads, ws, scale);
  return (int)cudaGetLastError();
}
