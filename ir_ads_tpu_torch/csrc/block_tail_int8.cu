// K11: the w8a8 Swin block tail, out = x + FFN_w8a8(LN2 x) + 0.5 * Adapter(x).
//
// Replaces ir_ads_tpu/ops/pallas_mlp.py:_tail_kernel_int8 (launched by
// fused_block_tail_pallas under IR_ADS_INT8).  x is (N, C) bf16.  LN2 output
// is rounded to bf16, then quantized per row; the s8 product C -> 4C gives
// (acc * sx) * s1 + b1, and the tanh GELU of it stays f32 (NOT rounded to
// bf16, unlike K2); the whole 4C-wide f32 hidden row is quantized per row,
// and the s8 product 4C -> C gives (acc * sh) * s2 + b2.  The adapter reads x
// itself in bf16: C -> C/16 (relu, rounded to bf16) -> C.  Weights arrive
// quantized per output channel (s8, f32 scales), in (out, in) layout.
//
// Bound on an H100: per row 16C^2 int8 operations (plus C^2/4 bf16 ones in
// the adapter) against 4C bytes moved (x in, out, bf16): 4C operations per
// byte, 512 at C = 128, below the int8 ridge (1979 Tops / 3.35 TB/s = 591),
// so the bytes bound at C = 128 and the operations at the wider stages
// (chip_smoke.py's count).
//
// Design: six launches, each a grid over all the rows, the s8 products on
// igemm.cuh's TMA and wgmma GEMM over the whole map (a fused row kernel
// streams all of W1 and W2 again for every row tile), the adapter's bf16
// products on gemm_mma.cuh:
//   tail8_ln2_kernel  LN2 of x to bf16, then per-row s8 (xq, sx): the rows
//                     code of the fused form (layer_norm_rows,
//                     quantize_rows), one warp a row; zeroes the row-max
//                     buffer;
//   Tail8AdapterUp    GEMM of x with Wa1 (N = Ca): bf16(relu(acc + ab1));
//   Tail8AdapterDown  GEMM with Wa2 (K = Ca, a ragged 16-deep step of
//                     zeros at Ca = 8): a = acc + ab2 in f32;
//   Tail8Fc1Max       s8 GEMM with W1, max pass: the row max of |hidden|,
//                     hidden = gelu_tanh((acc * sx) * s1 + b1), by atomicMax
//                     on the int bits of the non-negative floats (exact and
//                     order free);
//   Tail8Fc1Quant     s8 GEMM with W1 again, quantize pass: the same hidden
//                     (one helper, tail_hidden) -> hq = rn(h / sh) in s8,
//                     sh = max(rowmax, 1e-12) / 127;
//   Tail8Fc2          s8 GEMM with W2 over the whole hidden (K = 4C):
//                     out = bf16((x + (acc * sh) * s2 + b2) + 0.5 a).
// Why W1 twice: the second quantization needs the max of the whole 4C-wide
// f32 hidden row before any of its columns is rounded.  Storing that row
// moves 8 x 4C bytes a row (315 MB at Swin-B stage 0, about 94 us at 3.35
// TB/s); computing it again costs 8C^2 int8 operations a row (10 G at
// stage 0, about 5 us at 1979 Tops).  The s8 hidden (4C bytes a row) makes
// one round trip; keeping it on chip between W1 and W2 is later work.
//
// Bits: each epilogue is the fused form's expression (block_tail_int8.cu
// before its products moved to igemm.cuh), the s8 sums are exact in any
// order, the row max is exact in any order, and gemm_mma.cuh sums the
// adapter in the fused form's order (as K2's adapter), so the output is the
// fused form's bit for bit.  The wrapper allocates the intermediates.
#include "gemm_epilogues.cuh"
#include "igemm.cuh"

using namespace port;

namespace {

constexpr int kLnRows = kWarps;  // rows a block of the LN launch: one a warp

// The f32 hidden of one output of W1: both W1 passes (and the check entry
// below) take it from here, so they compute it with the same instructions.
__device__ __forceinline__ float tail_hidden(int acc, float sx, float s1, float b1) {
  return gelu_tanh(dequant(acc, sx, s1, b1));
}

__global__ void __launch_bounds__(kThreads)
tail8_ln2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                 const bf16* __restrict__ b, int8_t* __restrict__ xq, float* __restrict__ sx,
                 float* __restrict__ rowmax, int T, int C, float eps) {
  extern __shared__ __align__(16) unsigned char ln_smem[];
  bf16* ln_s = reinterpret_cast<bf16*>(ln_smem);
  const int row0 = blockIdx.x * kLnRows, valid = min(kLnRows, T - row0);
  layer_norm_rows(ln_s, C + 8, x, row0, valid, T, C, g, b, eps, [](int) { return false; });
  __syncthreads();
  quantize_rows(xq + (size_t)row0 * C, C, sx + row0, ln_s, C + 8, valid, C);
  if (threadIdx.x < valid) rowmax[row0 + threadIdx.x] = 0.0f;
}

// a = acc + ab2 in f32: the fused form's adapter output.
struct Tail8AdapterDown {
  const bf16* ab2;
  float* a;
  int C;
  __device__ void operator()(int, int r, int c, float v0, float v1) const {
    *reinterpret_cast<float2*>(a + (size_t)r * C + c) =
        make_float2(__fadd_rn(v0, __bfloat162float(ab2[c])),
                    __fadd_rn(v1, __bfloat162float(ab2[c + 1])));
  }
};
struct Tail8AdapterUp : AdapterUp {};

// The W1 epilogues' row: the scale of xq's row.
struct Fc1Row {
  float sx;
};

struct Tail8Fc1Max {
  static constexpr bool kRowMax = true;
  const float* sx;
  const float* s1;
  const bf16* b1;
  float* rowmax;
  __device__ Fc1Row row(int r) const { return {sx[r]}; }
  __device__ ScaleBias col(int c) const { return scale_bias(s1, b1, c); }
  __device__ float2 value(Fc1Row r, ScaleBias c, int a0, int a1) const {
    return make_float2(tail_hidden(a0, r.sx, c.s0, c.b0), tail_hidden(a1, r.sx, c.s1, c.b1));
  }
  // m >= 0: the int bits order as the floats
  __device__ void reduce(int r, float m) const {
    atomicMax(reinterpret_cast<int*>(rowmax + r), __float_as_int(m));
  }
};

struct Tail8Fc1Quant {
  static constexpr bool kRowMax = false;
  struct Row {
    float sx, s;  // xq's scale, the hidden's
  };
  const float* sx;
  const float* s1;
  const bf16* b1;
  const float* rowmax;
  int8_t* hq;
  float* sh;
  int H;
  __device__ Row row(int r) const { return {sx[r], fmaxf(rowmax[r], 1e-12f) / 127.0f}; }
  __device__ ScaleBias col(int c) const { return scale_bias(s1, b1, c); }
  __device__ void operator()(Row r, ScaleBias c, int i, int j, int a0, int a1) const {
    char2 q;
    q.x = quantize_code(tail_hidden(a0, r.sx, c.s0, c.b0), r.s);
    q.y = quantize_code(tail_hidden(a1, r.sx, c.s1, c.b1), r.s);
    *reinterpret_cast<char2*>(hq + (size_t)i * H + j) = q;
    if (j == 0) sh[i] = r.s;
  }
};

struct Tail8Fc2 {
  static constexpr bool kRowMax = false;
  struct Row {
    float sh;
  };
  const bf16* x;
  const float* sh;
  const float* s2;
  const bf16* b2;
  const float* a;
  bf16* out;
  int C;
  float adapter_scale;
  __device__ Row row(int r) const { return {sh[r]}; }
  __device__ ScaleBias col(int c) const { return scale_bias(s2, b2, c); }
  __device__ void operator()(Row r, ScaleBias c, int i, int j, int a0, int a1) const {
    const size_t o = (size_t)i * C + j;
    const float2 av = *reinterpret_cast<const float2*>(a + o);  // the wrapper's buffer
    store_bf16x2(out + o,
                 __fadd_rn(__fadd_rn(__bfloat162float(x[o]), dequant(a0, r.sh, c.s0, c.b0)),
                           __fmul_rn(adapter_scale, av.x)),
                 __fadd_rn(__fadd_rn(__bfloat162float(x[o + 1]), dequant(a1, r.sh, c.s1, c.b1)),
                           __fmul_rn(adapter_scale, av.y)));
  }
};

// The f32 hidden itself (the check entry's).
struct Tail8Fc1Hidden {
  static constexpr bool kRowMax = false;
  const float* sx;
  const float* s1;
  const bf16* b1;
  float* h;
  int H;
  __device__ Fc1Row row(int r) const { return {sx[r]}; }
  __device__ ScaleBias col(int c) const { return scale_bias(s1, b1, c); }
  __device__ void operator()(Fc1Row r, ScaleBias c, int i, int j, int a0, int a1) const {
    *reinterpret_cast<float2*>(h + (size_t)i * H + j) =
        make_float2(tail_hidden(a0, r.sx, c.s0, c.b0), tail_hidden(a1, r.sx, c.s1, c.b1));
  }
};

int ln2_launch(const void* x, const void* ln_g, const void* ln_b, void* xq, void* sx,
               void* rowmax, int T, int C, float eps, cudaStream_t st) {
  tail8_ln2_kernel<<<(T + kLnRows - 1) / kLnRows, kThreads, kLnRows * (C + 8) * 2, st>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (int8_t*)xq, (float*)sx,
      (float*)rowmax, T, C, eps);
  return (int)cudaGetLastError();
}

int fc1_launches(const void* w1, const void* s1, const void* b1, const void* xq,
                 const void* sx, void* rowmax, void* hq, void* sh, int T, int C, int H,
                 cudaStream_t st) {
  int e = igemm(xq, C, w1, C, T, H, C,
                Tail8Fc1Max{(const float*)sx, (const float*)s1, (const bf16*)b1,
                            (float*)rowmax},
                st);
  if (e) return e;
  return igemm(xq, C, w1, C, T, H, C,
               Tail8Fc1Quant{(const float*)sx, (const float*)s1, (const bf16*)b1,
                             (const float*)rowmax, (int8_t*)hq, (float*)sh, H},
               st);
}

}  // namespace

// x, out (T, C) bf16; ln_g, ln_b, b1 (H), b2 (C), the adapter's weights and
// biases bf16 in torch Linear layout; w1 (H, C) and w2 (C, H) s8 with f32
// scales s1 (H) and s2 (C); the intermediates: xq (T, C) s8, sx, rowmax,
// sh (T) f32, ah (T, Ca) bf16, a (T, C) f32, hq (T, H) s8.  C and H
// multiples of 16, Ca even.
extern "C" int block_tail_int8(const void* x, const void* ln_g, const void* ln_b,
                               const void* w1, const void* s1, const void* b1,
                               const void* w2, const void* s2, const void* b2,
                               const void* aw1, const void* ab1, const void* aw2,
                               const void* ab2, void* xq, void* sx, void* rowmax, void* ah,
                               void* a, void* hq, void* sh, void* out, int T, int C, int H,
                               int Ca, float eps, float adapter_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = ln2_launch(x, ln_g, ln_b, xq, sx, rowmax, T, C, eps, st);
  if (e) return e;
  e = gemm(gemm_args(x, C, 0, aw1, C, 0, T, Ca, C), 1,
           Tail8AdapterUp{{(const bf16*)ab1, (bf16*)ah, Ca, T}}, st);
  if (e) return e;
  e = gemm(gemm_args(ah, Ca, 0, aw2, Ca, 0, T, C, Ca), 1,
           Tail8AdapterDown{(const bf16*)ab2, (float*)a, C}, st);
  if (e) return e;
  e = fc1_launches(w1, s1, b1, xq, sx, rowmax, hq, sh, T, C, H, st);
  if (e) return e;
  return igemm(hq, H, w2, H, T, C, H,
               Tail8Fc2{(const bf16*)x, (const float*)sh, (const float*)s2, (const bf16*)b2,
                        (const float*)a, (bf16*)out, C, adapter_scale},
               st);
}

// The check of the two W1 passes on the card (chip_smoke.py): LN2, the max
// and quantize passes as block_tail_int8 runs them, and the f32 hidden of
// the same helper written out (hid, (T, H) f32), from which the row max and
// the codes are computed again.
extern "C" int block_tail_int8_hidden(const void* x, const void* ln_g, const void* ln_b,
                                      const void* w1, const void* s1, const void* b1,
                                      void* xq, void* sx, void* rowmax, void* hq, void* sh,
                                      void* hid, int T, int C, int H, float eps,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = ln2_launch(x, ln_g, ln_b, xq, sx, rowmax, T, C, eps, st);
  if (e) return e;
  e = fc1_launches(w1, s1, b1, xq, sx, rowmax, hq, sh, T, C, H, st);
  if (e) return e;
  return igemm(xq, C, w1, C, T, H, C,
               Tail8Fc1Hidden{(const float*)sx, (const float*)s1, (const bf16*)b1,
                              (float*)hid, H},
               st);
}

// The s8 GEMM's raw s32 output, out (M, N) = a (M, K) . w (N, K)^T, the
// rows of a and w ld bytes apart (chip_smoke.py holds it against
// torch._int_mm; with K < ld the last k are dropped, its planted fault).
extern "C" int igemm_s32(const void* a, const void* w, void* out, int M, int N, int K, int ld,
                         void* stream) {
  return igemm(a, ld, w, ld, M, N, K, S32Out{(int*)out, N},
               static_cast<cudaStream_t>(stream));
}
