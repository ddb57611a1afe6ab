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
// Design: the TPU kernel holds one image's whole padded qkv map in VMEM and
// the block's rows in one pass; here a fixed sequence of nine launches,
// whose six products run on gemm_mma.cuh's pipelined GEMM with the
// step's arithmetic as its epilogue, each a grid over the whole map (a
// fused tail would stream all of W1 and W2 again for every row tile):
//   v6_ln1_kernel  LN1 of the real rows to bf16 (layer_norm_rows)
//   QkvOut         GEMM with Wqkv: qkv = bf16(acc + bqkv)
//   attention      the windows of the rolled padded map: token i of a
//                  window reads the qkv row of the real position it rolls
//                  from, or the bias row where that position is padding,
//                  and writes its output only where it is real: pad, roll
//                  and crop are index arithmetic.  On the tensor-core
//                  shapes (the wrapper's tensor_core_design: d 16 or 32, N
//                  <= 144, every Swin-B stage) v6_attn_mma_kernel,
//                  window_mma.cuh's persistent head kernel on its
//                  RealMapTokens policy; elsewhere v6_attn_kernel, the
//                  first design (window_block.cuh's
//                  real_map_window_attention, one block a (window, head))
//   ProjOut        GEMM with Wproj: y = x + (acc + bproj) in f32, and
//                  bf16(y), the adapter's input
//   AdapterUp      GEMM with Wa1 (N = Ca): bf16(relu(acc + ab1))
//   AdapterDown    GEMM with Wa2 (K = Ca, rounded up to 16 with zeros):
//                  adapter_scale * (acc + ab2) + b2 in f32, the FFN's init
//   v6_ln2_kernel  LN2 of the f32 y to bf16 (layer_norm_tile)
//   Fc1Out         GEMM with W1: bf16(gelu_tanh(acc + b1))
//   Fc2Out         GEMM with W2 over the whole hidden (K = 4C) from the
//                  adapter's f32 output: out = bf16(y + acc).
// Stacked adapters are the adapter GEMMs' batch (gridDim.z = S, rows of
// stream s reading its own weights).  Every epilogue is the expression the
// earlier fused form (v6_ln_qkv_kernel and proj_tail_kernel on WMMA row
// tiles) wrote, and every product sums in that form's order (gemm_mma.cuh),
// so K5's output is that form's bit for bit.  The intermediates (LN outputs, qkv,
// attention output, y in f32 and bf16, the adapter's hidden and output,
// the FFN hidden: about 50 MB at stage 2 of 4 images) make one round trip
// through device memory; the wrapper allocates them.  Registers (ptxas):
// the LN launches 32, no shared memory; the attention window_mma.cuh's
// (158 KB of shared memory at N = 144, d = 32); the GEMMs gemm_mma.cuh's.
// The epilogues but ProjOut are gemm_epilogues.cuh's, shared with K1 and
// K2.
#include "gemm_epilogues.cuh"
#include "window_block.cuh"
#include "window_mma.cuh"

using namespace port;

namespace {

constexpr int kLnRows = kWarps;  // rows a block of the LN launches: one a warp

__global__ void __launch_bounds__(kThreads)
v6_ln1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
              const bf16* __restrict__ b, bf16* __restrict__ xn, int T, int C, float eps) {
  const int row0 = blockIdx.x * kLnRows;
  layer_norm_rows(xn + (size_t)row0 * C, C, x, row0, min(kLnRows, T - row0), T, C, g, b, eps,
                  [](int) { return false; });
}

__global__ void __launch_bounds__(kThreads)
v6_ln2_kernel(const float* __restrict__ y, const bf16* __restrict__ g,
              const bf16* __restrict__ b, bf16* __restrict__ yn, int T, int C, float eps) {
  const int row0 = blockIdx.x * kLnRows, rows = min(kLnRows, T - row0);
  layer_norm_tile(yn + (size_t)row0 * C, C, y + (size_t)row0 * C, C, rows, rows, C, g, b, eps);
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

template <int NT, int D>
__global__ void __launch_bounds__(WindowMma<NT, D>::Threads, 1)
v6_attn_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bqkv,
                   const float* __restrict__ bias, const int* __restrict__ region,
                   bf16* __restrict__ att, int B, int H, int W, int C, int ws, int shift,
                   float scale) {
  real_map_head<NT, D>(qkv, bqkv, bias, region, att, B, H, W, C, ws, shift, scale);
}

// The attention launch: qkv (B H W, 3C) and att (B H W, C) of the real map.
int attn_launch(const void* qkv, const void* bqkv, const void* bias, const void* region,
                void* att, int B, int H, int W, int C, int heads, int ws, int shift,
                int tensor_cores, float scale, cudaStream_t st) {
  const int nW = ((H + ws - 1) / ws) * ((W + ws - 1) / ws);
  if (tensor_cores)
    return launch_mma(ws * ws, C / heads, [&](auto nt, auto dd) {
      constexpr int NT = decltype(nt)::value, D = decltype(dd)::value;
      return launch_heads<NT, D>(v6_attn_mma_kernel<NT, D>, B * nW, heads, st,
                                 (const bf16*)qkv, (const bf16*)bqkv, (const float*)bias,
                                 (const int*)region, (bf16*)att, B, H, W, C, ws, shift, scale);
    });
  const size_t as = window_attention_smem(ws * ws, C / heads);
  const cudaError_t err =
      cudaFuncSetAttribute(v6_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)as);
  if (err != cudaSuccess) return (int)err;
  v6_attn_kernel<<<dim3(B * nW, heads), kThreads, as, st>>>(
      (const bf16*)qkv, (const bf16*)bqkv, (const float*)bias, (const int*)region, (bf16*)att,
      H, W, C, heads, ws, shift, scale);
  return (int)cudaGetLastError();
}

// K5's own epilogue: y = x + (acc + bproj) in f32, and bf16(y), the
// adapter's input (the other epilogues are gemm_epilogues.cuh's).
struct ProjOut {
  const bf16* x;
  const bf16* bias;
  float* y;
  bf16* yb;
  int C;
  __device__ void operator()(int, int r, int c, float v0, float v1) const {
    const size_t i = (size_t)r * C + c;
    const float y0 = __bfloat162float(x[i]) + (v0 + __bfloat162float(bias[c]));
    const float y1 = __bfloat162float(x[i + 1]) + (v1 + __bfloat162float(bias[c + 1]));
    *reinterpret_cast<float2*>(y + i) = make_float2(y0, y1);
    store_bf16x2(yb + i, y0, y1);
  }
};

}  // namespace

// x (B, H, W, C) bf16 and the block's parameters (bf16, torch Linear
// layout; bias (heads, N, N) f32; region (nW, N) int32 or null; aw1 (S, Ca,
// C), ab1 (S, Ca), aw2 (S, C, Ca), ab2 (S, C)); the intermediates, each
// over the T = B H W real rows: xn (T, C) bf16 (LN1's, then LN2's output),
// qkv (T, 3C) bf16, att (T, C) bf16, y (T, C) f32, yb (T, C) bf16, ah (T,
// Ca) bf16, tail_init (T, C) f32, hid (T, hidden) bf16; out (B, H, W, C).
extern "C" int swin_block_v6(
    const void* x, const void* ln_g, const void* ln_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* region, const void* ln2_g, const void* ln2_b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* aw1,
    const void* ab1, const void* aw2, const void* ab2, void* xn, void* qkv,
    void* att, void* y, void* yb, void* ah, void* tail_init, void* hid,
    void* out, int B, int H, int W, int C, int heads, int ws, int shift,
    int hidden, int Ca, int S, int tensor_cores, float scale, float eps,
    float adapter_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * H * W, Ts = T / S, ln_grid = (T + kLnRows - 1) / kLnRows;
  v6_ln1_kernel<<<ln_grid, kThreads, 0, st>>>((const bf16*)x, (const bf16*)ln_g,
                                              (const bf16*)ln_b, (bf16*)xn, T, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int e = gemm(gemm_args(xn, C, 0, wqkv, C, 0, T, 3 * C, C), 1,
               QkvOut{(const bf16*)bqkv, (bf16*)qkv, 3 * C}, st);
  if (e) return e;

  e = attn_launch(qkv, bqkv, bias, region, att, B, H, W, C, heads, ws, shift, tensor_cores,
                  scale, st);
  if (e) return e;

  e = gemm(gemm_args(att, C, 0, wproj, C, 0, T, C, C), 1,
           ProjOut{(const bf16*)x, (const bf16*)bproj, (float*)y, (bf16*)yb, C}, st);
  if (e) return e;
  e = gemm(gemm_args(yb, C, (long long)Ts * C, aw1, C, (long long)Ca * C, Ts, Ca, C), S,
           AdapterUp{(const bf16*)ab1, (bf16*)ah, Ca, Ts}, st);
  if (e) return e;
  e = gemm(gemm_args(ah, Ca, (long long)Ts * Ca, aw2, Ca, (long long)C * Ca, Ts, C, Ca), S,
           AdapterDown{(const bf16*)ab2, (const bf16*)b2, (float*)tail_init, C, Ts,
                       adapter_scale},
           st);
  if (e) return e;
  v6_ln2_kernel<<<ln_grid, kThreads, 0, st>>>((const float*)y, (const bf16*)ln2_g,
                                              (const bf16*)ln2_b, (bf16*)xn, T, C, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  e = gemm(gemm_args(xn, C, 0, w1, C, 0, T, hidden, C), 1,
           Fc1Out{(const bf16*)b1, (bf16*)hid, hidden}, st);
  if (e) return e;
  return gemm(gemm_args(hid, hidden, 0, w2, hidden, 0, T, C, hidden, (const float*)tail_init, C),
              1, Fc2Out{(const float*)y, (bf16*)out, C}, st);
}
