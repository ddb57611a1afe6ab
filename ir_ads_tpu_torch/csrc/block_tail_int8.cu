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
// (chip_smoke.py's count).  Design: one block per tile of
// bm = min(64, 32768 / 4C) rows.  K2 walks the hidden 64 columns at a time;
// this kernel cannot, since the second quantization needs the max of the
// complete f32 hidden row before any of its columns is rounded.  Of the three
// ways out (keep the f32 hidden of a row tile in shared memory, compute the
// first product twice, or pass the hidden through device memory) it keeps
// the hidden in shared memory: 128 KB at every stage (64 rows at C = 128
// down to 8 at C = 1024, where the tensor-core tile of 16 rows is half
// zeros), which costs neither the first product again (1.5x the operations)
// nor 32C bytes a row of device-memory traffic (8x the bound's).  Steps:
//   LN2 -> bf16 tile -> per-row s8 (xq);
//   s8 product with W1, 64 hidden columns at a time -> GELU -> f32 hidden;
//   per-row max over the 4C columns -> s8 hidden (hq);
//   s8 product with W2 over the full depth 4C -> ffn tile (f32);
//   bf16 adapter (common.cuh's tile_gemm) -> out = (x + ffn) + 0.5 a.
// The shared memory of the f32 hidden is reused by the last two steps.
#include "igemm.cuh"

using namespace port;

namespace {

// Rows of a tile (valid rows; the product tiles round them up to 16).
__host__ __device__ inline int tail_rows(int H) {
  int bm = 32768 / H;  // the f32 hidden of a tile fills 128 KB
  if (bm > 64) bm = 64;
  if (bm < 1) bm = 1;
  return bm;
}

__host__ __device__ inline int mma_rows(int bm) { return (bm + 15) / 16 * 16; }

struct Smem {
  float* hid;  // [bm][H] f32 hidden; later the ffn tile, x tile and adapter
  int8_t* hq;  // [mp][H + 16]
  int8_t* xq;  // [mp][C + 16]
  int* I_s;    // [mp][kLdI]
  int8_t* W_s; // [64][kLdWs]
  float* sx;   // [mp]
  float* sh;   // [mp]
  // carved from hid once hq is built
  float* ffn;  // [bm][C + 4]
  bf16* A_s;   // [mp][C + 8]
  float* F_s;  // [mp][kLdF]
  bf16* H_s;   // [mp][kBN + 8]
  bf16* Wb_s;  // [kBN][kBK]
  size_t bytes;
};

__host__ __device__ inline Smem carve(unsigned char* base, int C, int H) {
  const int bm = tail_rows(H), mp = mma_rows(bm);
  Smem s;
  size_t off = 0;
  auto take = [&](size_t n) {
    unsigned char* p = base + off;
    off += align128(n);
    return p;
  };
  s.hid = reinterpret_cast<float*>(take((size_t)bm * H * 4));
  s.hq = reinterpret_cast<int8_t*>(take((size_t)mp * (H + 16)));
  s.xq = reinterpret_cast<int8_t*>(take((size_t)mp * (C + 16)));
  s.I_s = reinterpret_cast<int*>(take((size_t)mp * kLdI * 4));
  s.W_s = reinterpret_cast<int8_t*>(take((size_t)kBN * kLdWs));
  s.sx = reinterpret_cast<float*>(take((size_t)mp * 4));
  s.sh = reinterpret_cast<float*>(take((size_t)mp * 4));
  s.bytes = off;
  unsigned char* p = reinterpret_cast<unsigned char*>(s.hid);
  s.ffn = reinterpret_cast<float*>(p);
  p += align128((size_t)bm * (C + 4) * 4);
  s.A_s = reinterpret_cast<bf16*>(p);
  p += align128((size_t)mp * (C + 8) * 2);
  s.F_s = reinterpret_cast<float*>(p);
  p += align128((size_t)mp * kLdF * 4);
  s.H_s = reinterpret_cast<bf16*>(p);
  p += align128((size_t)mp * (kBN + 8) * 2);
  s.Wb_s = reinterpret_cast<bf16*>(p);
  return s;
}

// Bytes of the tile's second life (ffn, x tile, adapter scratch), which
// must fit in the hidden's bm * H * 4.
inline size_t reuse_bytes(int C, int H) {
  const int bm = tail_rows(H), mp = mma_rows(bm);
  return align128((size_t)bm * (C + 4) * 4) + align128((size_t)mp * (C + 8) * 2) +
         align128((size_t)mp * kLdF * 4) + align128((size_t)mp * (kBN + 8) * 2) +
         (size_t)kBN * kBK * 2;
}

__global__ void __launch_bounds__(kThreads)
block_tail_int8_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                       const bf16* __restrict__ b, const int8_t* __restrict__ w1,
                       const float* __restrict__ s1, const bf16* __restrict__ b1,
                       const int8_t* __restrict__ w2, const float* __restrict__ s2,
                       const bf16* __restrict__ b2, const bf16* __restrict__ aw1,
                       const bf16* __restrict__ ab1, const bf16* __restrict__ aw2,
                       const bf16* __restrict__ ab2, bf16* __restrict__ out,
                       int T, int C, int H, int Ca, float eps,
                       float adapter_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem, C, H);
  const int bm = tail_rows(H), mp = mma_rows(bm);
  const int row0 = blockIdx.x * bm;
  const int valid = min(bm, T - row0);
  const int ldx = C + 16, ldh = H + 16;

  // LN2 rounded to bf16 (staged in the hidden's space), then s8 per row
  bf16* ln_s = reinterpret_cast<bf16*>(s.hid);
  layer_norm_rows(ln_s, C + 8, x, row0, mp, row0 + valid, C, g, b, eps,
                  [](int) { return false; });
  __syncthreads();
  quantize_rows(s.xq, ldx, s.sx, ln_s, C + 8, mp, valid, C);

  // hidden = gelu((xq W1^T) * sx * s1 + b1) in f32, 64 columns at a time
  for (int j0 = 0; j0 < H; j0 += kBN) {
    tile_igemm(s.I_s, kLdI, s.xq, ldx, mp, w1 + (size_t)j0 * C, C, kBN, C, s.W_s);
    for (int idx = threadIdx.x; idx < bm * kBN; idx += kThreads) {
      const int r = idx / kBN, col = idx % kBN;
      s.hid[(size_t)r * H + j0 + col] = gelu_tanh(dequant(
          s.I_s[r * kLdI + col], s.sx[r], s1[j0 + col], __bfloat162float(b1[j0 + col])));
    }
  }
  __syncthreads();
  quantize_rows(s.hq, ldh, s.sh, s.hid, H, mp, bm, H);

  // ffn = (hq W2^T) * sh * s2 + b2, over the full depth H
  for (int n0 = 0; n0 < C; n0 += kBN) {
    tile_igemm(s.I_s, kLdI, s.hq, ldh, mp, w2 + (size_t)n0 * H, H, kBN, H, s.W_s);
    for (int idx = threadIdx.x; idx < bm * kBN; idx += kThreads) {
      const int r = idx / kBN, col = idx % kBN;
      s.ffn[r * (C + 4) + n0 + col] = dequant(
          s.I_s[r * kLdI + col], s.sh[r], s2[n0 + col], __bfloat162float(b2[n0 + col]));
    }
  }

  // adapter on x itself, in bf16: a = relu(x Wa1^T + ab1) Wa2^T + ab2
  const int lda = C + 8, ldhh = kBN + 8;
  for (int idx = threadIdx.x; idx < mp * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    s.A_s[r * lda + c] = r < valid ? x[(size_t)(row0 + r) * C + c] : __float2bfloat16(0.0f);
  }
  tile_gemm(s.F_s, kLdF, s.A_s, lda, mp, aw1, C, Ca, C, C, s.Wb_s, false);
  for (int idx = threadIdx.x; idx < mp * kBN; idx += kThreads) {
    const int r = idx / kBN, col = idx % kBN;
    const float v = col < Ca ? fmaxf(s.F_s[r * kLdF + col] + __bfloat162float(ab1[col]), 0.0f)
                             : 0.0f;
    s.H_s[r * ldhh + col] = __float2bfloat16(v);
  }
  const int Ka = (Ca + 15) / 16 * 16;
  for (int n0 = 0; n0 < C; n0 += kBN) {
    tile_gemm(s.F_s, kLdF, s.H_s, ldhh, mp, aw2 + (size_t)n0 * Ca, Ca, kBN, Ca, Ka,
              s.Wb_s, false);
    for (int idx = threadIdx.x; idx < bm * kBN; idx += kThreads) {
      const int r = idx / kBN, col = idx % kBN;
      if (r < valid) {
        const size_t o = (size_t)(row0 + r) * C + n0 + col;
        const float a = __fadd_rn(s.F_s[r * kLdF + col], __bfloat162float(ab2[n0 + col]));
        out[o] = __float2bfloat16(
            __fadd_rn(__fadd_rn(__bfloat162float(x[o]), s.ffn[r * (C + 4) + n0 + col]),
                      __fmul_rn(adapter_scale, a)));
      }
    }
  }
}

}  // namespace

extern "C" int block_tail_int8(const void* x, const void* ln_g, const void* ln_b,
                               const void* w1, const void* s1, const void* b1,
                               const void* w2, const void* s2, const void* b2,
                               const void* aw1, const void* ab1, const void* aw2,
                               const void* ab2, void* out, int T, int C, int H,
                               int Ca, float eps, float adapter_scale,
                               void* stream) {
  const int bm = tail_rows(H);
  const size_t smem = carve(nullptr, C, H).bytes;
  if (reuse_bytes(C, H) > (size_t)bm * H * 4 ||
      (size_t)mma_rows(bm) * (C + 8) * 2 > (size_t)bm * H * 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_tail_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_tail_int8_kernel<<<(T + bm - 1) / bm, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)x, (const bf16*)ln_g, (const bf16*)ln_b, (const int8_t*)w1,
      (const float*)s1, (const bf16*)b1, (const int8_t*)w2, (const float*)s2,
      (const bf16*)b2, (const bf16*)aw1, (const bf16*)ab1, (const bf16*)aw2,
      (const bf16*)ab2, (bf16*)out, T, C, H, Ca, eps, adapter_scale);
  return (int)cudaGetLastError();
}
