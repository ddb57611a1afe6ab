// The epilogues of the Swin block GEMMs on gemm_mma.cuh, shared by K1
// (swin_block.cu), K2 (block_tail.cu), K5 (swin_block_v6.cu), K13
// (swin_block_v7.cu) and K14 (swin_block_full.cu), and the helper that
// fills a GemmArgs.  Each epilogue is the expression of the fused row
// kernels whose products it took over, written in the same order, so that
// with gemm_mma.cuh's order of the sums every kernel that runs it computes
// the same bits: K13 and K14 are held bit for bit against compositions
// with K1 and K2.
//
// A source that runs one of these epilogues beside another kernel's on the
// same path derives a struct of its own name from it (struct SwinQkvOut :
// QkvOut {}): the GEMM's kernel name carries the epilogue's type, and a
// profiler then tells the two kernels' launches apart.
#pragma once

#include <cstdint>

#include "gemm_mma.cuh"

namespace port {

__device__ __forceinline__ void store_bf16x2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __nv_bfloat162(__float2bfloat16(v0),
                                                         __float2bfloat16(v1));
}

// qkv = bf16(acc + bqkv): K1, K5, K13, K14.
struct QkvOut {
  const bf16* bias;
  bf16* qkv;
  int ld;
  __device__ void operator()(int, int r, int c, float v0, float v1) const {
    store_bf16x2(qkv + (size_t)r * ld + c, v0 + __bfloat162float(bias[c]),
                 v1 + __bfloat162float(bias[c + 1]));
  }
};

// y = bf16((x + acc) + bproj), x first: K1, K13, K14.  K5's ProjOut adds
// x + (acc + bproj), another order.
struct ProjAddOut {
  const bf16* x;
  const bf16* bias;
  bf16* y;
  int C;
  __device__ void operator()(int, int r, int c, float v0, float v1) const {
    const size_t i = (size_t)r * C + c;
    store_bf16x2(y + i, (__bfloat162float(x[i]) + v0) + __bfloat162float(bias[c]),
                 (__bfloat162float(x[i + 1]) + v1) + __bfloat162float(bias[c + 1]));
  }
};

// hidden = bf16(relu(acc + ab1)), the adapter's hidden; batch z is stream
// z, with its own rows (Ts a stream) and bias.
struct AdapterUp {
  const bf16* ab1;
  bf16* hidden;
  int Ca, Ts;
  __device__ void operator()(int z, int r, int c, float v0, float v1) const {
    const bf16* b = ab1 + (size_t)z * Ca;
    store_bf16x2(hidden + ((size_t)z * Ts + r) * Ca + c,
                 fmaxf(v0 + __bfloat162float(b[c]), 0.0f),
                 fmaxf(v1 + __bfloat162float(b[c + 1]), 0.0f));
  }
};

// adapter_scale * (acc + ab2) + b2 in f32: the adapter's output, the FFN's
// output bias b2 folded in; the W2 GEMM's init.
struct AdapterDown {
  const bf16* ab2;
  const bf16* b2;
  float* out;
  int C, Ts;
  float adapter_scale;
  __device__ void operator()(int z, int r, int c, float v0, float v1) const {
    const bf16* b = ab2 + (size_t)z * C;
    const float o0 = adapter_scale * (v0 + __bfloat162float(b[c])) + __bfloat162float(b2[c]);
    const float o1 =
        adapter_scale * (v1 + __bfloat162float(b[c + 1])) + __bfloat162float(b2[c + 1]);
    *reinterpret_cast<float2*>(out + ((size_t)z * Ts + r) * C + c) = make_float2(o0, o1);
  }
};

// hidden = bf16(gelu_tanh(acc + b1)): the FFN's hidden.
struct Fc1Out {
  const bf16* b1;
  bf16* hidden;
  int H;
  __device__ void operator()(int, int r, int c, float v0, float v1) const {
    store_bf16x2(hidden + (size_t)r * H + c, gelu_tanh(v0 + __bfloat162float(b1[c])),
                 gelu_tanh(v1 + __bfloat162float(b1[c + 1])));
  }
};

// out = bf16(y + acc), y the f32 residual: K5's last store.
struct Fc2Out {
  const float* y;
  bf16* out;
  int C;
  __device__ void operator()(int, int r, int c, float v0, float v1) const {
    const size_t i = (size_t)r * C + c;
    const float2 yy = *reinterpret_cast<const float2*>(y + i);
    store_bf16x2(out + i, yy.x + v0, yy.y + v1);
  }
};

// out = bf16(x + acc), x the bf16 residual: K2's and K13's last store.
struct TailOut {
  const bf16* x;
  bf16* out;
  int C;
  __device__ void operator()(int, int r, int c, float v0, float v1) const {
    const size_t i = (size_t)r * C + c;
    store_bf16x2(out + i, __bfloat162float(x[i]) + v0, __bfloat162float(x[i + 1]) + v1);
  }
};

// Whether p and the strides allow 16-byte pieces.
inline bool vec16(const void* p, long long ld, long long z) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0 && z % 8 == 0;
}

inline GemmArgs gemm_args(const void* A, int lda, long long a_z, const void* W, int ldw,
                          long long w_z, int M, int N, int K, const float* init = nullptr,
                          int ldc = 0, long long c_z = 0) {
  return GemmArgs{(const bf16*)A, (const bf16*)W, init, a_z, w_z, c_z, lda, ldw, ldc,
                  M, N, K, vec16(A, lda, a_z), vec16(W, ldw, w_z)};
}

}  // namespace port
