// K5: the whole Swin block on the real (B, H, W, C) map,
//   y   = x + proj(W-MSA(qkv(LN1 x)))           (f32, never rounded)
//   out = y + FFN(LN2 y) + adapter_scale * Adapter(round(y)).
//
// Replaces ir_ads_tpu/ops/pallas_swin.py:_attn_kernel_v6 (launched by
// pallas_window_block_v6), with its rounding points: LN1 in f32 on the real
// tokens; qkv projected from the real tokens only and rounded to bf16, the
// bias row standing in at padded positions; pad, cyclic roll and crop
// inside the kernel; (q * scale), the probabilities and the attention
// output rounded to bf16; the attention-half residual y kept in f32: LN2
// reads it in f32, the adapter reads it rounded to bf16, the FFN hidden is
// rounded after the tanh GELU, and the output is y + ffn + adapter summed in
// f32 and rounded once.  Adapter weights may be stacked per stream, (S, Ca,
// C): sample b uses stream b / (B / S).
//
// Bound on an H100: operations at stages 2 and 3.  Per token the block does
// 24C^2 + 4*144*C + 4*C*Ca flops (qkv, proj, FFN, scores and P.V on the
// padded map, adapter) against 4C bytes of x and out plus 24C^2 bytes of
// bf16 weights for the whole call; at C = 512 over 4 x 1200 tokens and at
// C = 1024 over 4 x 300 tokens the operations take 6x and 3x longer than
// the bytes at the card's peak rates (chip_smoke.py's count: 32 us against
// 5 us and 10 us).
//
// Design: the TPU kernel holds one image's whole padded qkv map in VMEM; at
// stage 2 that map is 21 MB for 4 images, far past a block's 227 KB of
// shared memory.  So three launches of one source, sharing K1's and K2's
// device code (window_block.cuh, tail.cuh):
//   v6_ln_qkv   rows of the REAL map: LN1 -> WMMA product with Wqkv -> qkv
//               rows (bf16) in device memory, real tokens only;
//   v6_attn     one block per (window of the rolled padded map, head); token
//               i of a window reads the qkv row of the real position it
//               rolls from, or the bias row where that position is padding,
//               and writes its output only where it is real: pad, roll and
//               crop are index arithmetic on loads and stores;
//   proj_tail   rows of the real map: attention tile -> WMMA product with
//               Wproj -> y = x + (proj + b) in an f32 tile, then the tail on
//               that tile (adapter on round(y), LN2(y), the FFN walked 64
//               hidden columns at a time, as K2) -> out.
// qkv and the attention output make one round trip through device memory;
// y never does.
#include "tail.cuh"
#include "window_block.cuh"

using namespace port;

namespace {

// LN1 + qkv of the real tokens: no padding, no roll.
__global__ void __launch_bounds__(kThreads)
v6_ln_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 const bf16* __restrict__ b, const bf16* __restrict__ wqkv,
                 const bf16* __restrict__ bqkv, bf16* __restrict__ qkv, int T,
                 int C, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln_qkv_rows(smem, x, g, b, wqkv, bqkv, qkv, T, 1, 1, C, 1, 1, 0, eps);
}

__global__ void __launch_bounds__(kThreads)
v6_attn_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bqkv,
               const float* __restrict__ bias, const int* __restrict__ region,
               bf16* __restrict__ att, int H, int W, int C, int heads, int ws,
               int shift, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  real_map_window_attention(smem, qkv, bqkv, bias, region, att, H, W, C, heads,
                            ws, shift, scale);
}

size_t proj_tail_smem(int C) {
  const int bm = rows_per_block(C);
  return align128((size_t)bm * (C + 8) * 2) +
         2 * align128((size_t)bm * (C + 4) * 4) + tail_scratch_bytes(bm);
}

// Grid (row tiles of one stream, S streams): stream s owns rows
// [s * Ts, (s + 1) * Ts) and reads its own adapter weights.
__global__ void __launch_bounds__(kThreads)
proj_tail_kernel(const bf16* __restrict__ att, const bf16* __restrict__ x,
                 const bf16* __restrict__ wproj, const bf16* __restrict__ bproj,
                 const bf16* __restrict__ g2, const bf16* __restrict__ be2,
                 const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                 const bf16* __restrict__ w2, const bf16* __restrict__ b2,
                 const bf16* __restrict__ aw1, const bf16* __restrict__ ab1,
                 const bf16* __restrict__ aw2, const bf16* __restrict__ ab2,
                 bf16* __restrict__ out, int Ts, int C, int H, int Ca,
                 float eps, float adapter_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bm = rows_per_block(C);
  const int lda = C + 8, ldf = C + 4;
  unsigned char* p = smem;
  bf16* A_s = reinterpret_cast<bf16*>(p);
  p += align128((size_t)bm * lda * 2);
  float* y_s = reinterpret_cast<float*>(p);
  p += align128((size_t)bm * ldf * 4);
  float* acc_s = reinterpret_cast<float*>(p);
  p += align128((size_t)bm * ldf * 4);
  const TailScratch t = tail_scratch(p, bm);

  const int s = blockIdx.y;
  aw1 += (size_t)s * Ca * C;
  ab1 += (size_t)s * Ca;
  aw2 += (size_t)s * C * Ca;
  ab2 += (size_t)s * C;
  const int r0 = blockIdx.x * bm;
  const int rows = min(bm, Ts - r0);
  const size_t off = ((size_t)s * Ts + r0) * C;
  att += off;
  x += off;
  out += off;

  for (int idx = threadIdx.x; idx < bm * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    A_s[r * lda + c] = r < rows ? att[(size_t)r * C + c] : __float2bfloat16(0.0f);
  }
  for (int n0 = 0; n0 < C; n0 += kBN)
    tile_gemm(y_s + n0, ldf, A_s, lda, bm, wproj + (size_t)n0 * C, C, kBN, C,
              C, t.W_s, false);
  // y = x + (proj + b) in f32; the adapter's input is y rounded to bf16
  for (int idx = threadIdx.x; idx < bm * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    float* y = y_s + r * ldf + c;
    *y = r < rows ? __bfloat162float(x[(size_t)r * C + c]) +
                        (*y + __bfloat162float(bproj[c]))
                  : 0.0f;
    A_s[r * lda + c] = __float2bfloat16(*y);
  }
  adapter_into(acc_s, ldf, A_s, lda, t, bm, C, Ca, aw1, ab1, aw2, ab2, b2,
               adapter_scale);
  layer_norm_tile(A_s, lda, y_s, ldf, bm, rows, C, g2, be2, eps);
  ffn_accumulate(acc_s, ldf, A_s, lda, t, bm, C, H, w1, b1, w2);
  for (int idx = threadIdx.x; idx < rows * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    out[(size_t)r * C + c] =
        __float2bfloat16(y_s[r * ldf + c] + acc_s[r * ldf + c]);
  }
}

}  // namespace

extern "C" int swin_block_v6(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* region, const void* ln2_g, const void* ln2_b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* aw1,
    const void* ab1, const void* aw2, const void* ab2, void* qkv, void* att,
    void* out, int B, int H, int W, int C, int heads, int ws, int shift,
    int hidden, int Ca, int S, float scale, float eps, float adapter_scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * H * W;
  const int bm = rows_per_block(C);
  const size_t rs = rows_smem(C);
  cudaFuncSetAttribute(v6_ln_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rs);
  v6_ln_qkv_kernel<<<(T + bm - 1) / bm, kThreads, rs, st>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (const bf16*)wqkv,
      (const bf16*)bqkv, (bf16*)qkv, T, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t as = window_attention_smem(ws * ws, C / heads);
  cudaFuncSetAttribute(v6_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)as);
  const int nW = ((H + ws - 1) / ws) * ((W + ws - 1) / ws);
  v6_attn_kernel<<<dim3(B * nW, heads), kThreads, as, st>>>(
      (const bf16*)qkv, (const bf16*)bqkv, (const float*)bias,
      (const int*)region, (bf16*)att, H, W, C, heads, ws, shift, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t ts = proj_tail_smem(C);
  cudaFuncSetAttribute(proj_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ts);
  const int Ts = T / S;
  proj_tail_kernel<<<dim3((Ts + bm - 1) / bm, S), kThreads, ts, st>>>(
      (const bf16*)att, (const bf16*)x, (const bf16*)wproj, (const bf16*)bproj,
      (const bf16*)ln2_g, (const bf16*)ln2_b, (const bf16*)w1, (const bf16*)b1,
      (const bf16*)w2, (const bf16*)b2, (const bf16*)aw1, (const bf16*)ab1,
      (const bf16*)aw2, (const bf16*)ab2, (bf16*)out, Ts, C, hidden, Ca, eps,
      adapter_scale);
  return (int)cudaGetLastError();
}
