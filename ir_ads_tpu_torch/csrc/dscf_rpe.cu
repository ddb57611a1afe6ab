// K3, K6 and K18: the DSCF continuous relative-position bias, the bilinear
// sample of table[bg % G, e] at the displacement between query pixel (r, c)
// and deformable key j, in two layouts and two roundings:
//   K3  dscf_rpe_rows    bias[bg, e, r, j, c]  (BG, hg, h, M, w), levels 0-2
//                        under r5 (and 3 under r4, r4i8, r2, v5, map);
//   K6  dscf_rpe_packed  bias[bg, e, j, r*w+c] (BG, hg, M, h*w), level 3,
//                        where the einsum attention adds it to its scores;
//   K18 dscf_rpe_jmajor  bias[bg, e, j, r, c]  (BG, hg, M, h, w), the same
//                        memory order as K6's, in the f32 form below
//                        (the pallas2 DSCF, every level).
//
// K3 and K6 replace ir_ads_tpu/ops/pallas_dscf_rpe.py:_rpe_rows_kernel
// (launched by dscf_rpe_bias_rows_pallas) and _rpe_packed_kernel (launched
// by dscf_rpe_bias_packed_pallas).  The TPU kernels write the bilinear form
// as two dense hat-weight products because its matrix unit wants dense
// work, and in bf16 round where a bf16 product would: the hat weights
// max(0, 1 - |(ay*r - s) + by|) (that f32 order), the table and the partial
// product u[s] = sum_t wx[t] T[s, t] go to bf16 before their f32 sums, the
// output once.  csrc/dscf.cuh's rpe_* parts (shared with K16) compute the
// same in the 2 x 2-tap form, bit for bit, and search the four taps of an
// axis where the weights' f32 order leaves an outer tap a weight.
//
// K18 replaces _rpe_kernel (launched by dscf_rpe_bias_pallas), which rounds
// differently: its hat weights max(0, 1 - |(ay*r + by) - s|) (another f32
// order), the table and u stay f32 whatever it stores, and the output is
// rounded once.  The sequence of its first CUDA form (ops/
// dscf_rpe_jmajor.py rpe_bias_jmajor_ordered writes it out in torch): four
// taps an axis from floor(x) - 1, a tap off the table or of weight 0
// skipped, u = sum over the x taps of wx * T[s, t] from +0 in tap order,
// acc = sum over the y taps of wy * u from +0 in tap order, each product
// and sum rounded (__fmul_rn, __fadd_rn: no multiply-add contracted), the
// output rounded once.  XLA's and cuBLAS's f32 dots may fuse a multiply-add,
// so the einsum plain version can sit an f32 ulp away before the rounding,
// and an output near a bf16 rounding boundary then lands one bf16 ulp
// apart.  Its sample is separable: with x = (a*i + b) rounded, the outer
// taps floor(x) - 1 and floor(x) + 2 lie at an exact distance of 1 or more,
// which rounds to 1 or more, so their weights are exactly 0 and the search
// comes down to the two middle taps of each axis.  A tap off the table, or
// of weight 0, adds w * T = +-0 (the table is finite) to a sum that started
// at +0 and is never -0, which leaves the sum as skipping it does: the
// kernel reads a clamped index for it under weight 0, and computes each
// output as
//   u(s) = (+0 + wx1 T[s, x1]) + wx2 T[s, x1 + 1],
//   acc  = (+0 + wy1 u(y1)) + wy2 u(y1 + 1),
// bit for bit the search (phase 3 holds it so at levels 0-3).
//
// Throughout, the index arithmetic is written with __fmul_rn / __fsub_rn /
// __fadd_rn: nvcc -O3 would contract a*r - s into an FMA, skip the
// product's rounding, and one f32 ulp in a weight can flip its bf16
// rounding.  ay and ax come from the host, rounded once from double as the
// TPU kernels' Python constants are.
//
// Bound on an H100: bytes (the bf16 output: 184 MB for K3 at level 0, a few
// dozen operations per 2-byte output, the table read from L2).  The first
// forms of all three, a thread an output that found its (bg, e, j, r, c) by
// 64-bit divisions, recomputed the key's origin, its row's weights and its
// column's taps, read the table through guarded loads and shared nothing
// with its neighbours, ran at 4-5 % of the memory rate (K3 1.179 ms at
// level 0, 21x its bound; K6 0.161 ms at level 3, 22x; K18 1.167).
//
// Design (rpe_plane_kernel, one template for the three: the Form gives the
// rounding, the layout the address of a row).  The sample is separable:
// the y part depends on (key, query row), the x part on (key, column), and
// u(s) on (key, column, table row s), not on the query row.  A block of 16
// warps per (bg, e) plane (gridDim.y) and band of keys, two blocks an SM:
//  - stages the table plane once: K18 f32 by cp.async (75.7 KB at 119 x
//    159); K3 and K6 the same, then rounded to bf16 in place, each word the
//    pair (T[s, t], T[s, t + 1]), with a zero row and a zero column past the
//    last (76.3 KB), so that u(s) is one shared-memory read and the two-tap
//    sample's reads need no bounds check;
//  - computes the y taps of every (key, query row) of its band once
//    (rpe_row and rpe_pair for K3 and K6: 8 bytes, the first tap row's
//    offset and the two bf16 weights), in chunks of keys where the band's
//    do not fit beside the table (K18's 16-byte records);
//  - gives each warp runs of 32 (key, column) pairs of the band, key-major,
//    a lane a pair: its x taps (rpe_col) once, in registers, its key's y
//    taps from shared memory; the run walks the query rows eight at a time.
//    Where no lane's row of the eight has a first tap row new against its
//    last row's two (ay <= 1 at levels 0-1, so most groups), the row's
//    u(y1) is carried over from the last row and u(y1 + 1) computed only
//    where the tap row moved; elsewhere (a key's first rows; every row at
//    levels 2-3, where ay > 1) both.  The eight outputs go to registers
//    first, then through shared memory, and each lane stores 8 consecutive
//    pairs of a row as one 16-byte store, 4 lanes a run's row of 64 bytes (as
//    8-byte stores, or element by element, at a ragged or unaligned edge; in
//    the j-major layout a run of 8 splits where the key changes).  The rows
//    layout's run of a row is contiguous; the j-major layout's is where w >=
//    32.  Below that (K6 at level 3, w = 20) a run's row is pieces of 40
//    bytes, and each lane stores its own outputs: its key's row of w pairs
//    is one contiguous store of the lanes that hold it (faster there on an
//    H100, where the staged form is faster for the rows layout and at w >=
//    32).
// No integer division is left in the inner loop.  K3 and K6 take the
// four-tap search (rpe_search) where rpe_pair or rpe_col says the middle taps
// do not suffice: for a whole query row, or for one lane's column on every
// row; it runs after the eight rows, for those outputs alone, and overwrites
// them.
//
// Domain: the staged table, one key's y taps and the staging tiles must fit
// a block's shared memory: (S1 + 1) * S2 * 4 bytes for K3 and K6, S1 * S2 * 4
// for K18, plus 16 KB and the records, at most 232448 bytes (the model's
// table is 119 x 159).  The wrappers raise past it.
//
// What holds them back now (inferred from times and phase clocks: no
// instruction profile runs here): instructions.  At levels 2-3 every output
// computes two u (a read, two unpacks, a product, a multiply-add and the
// rounding each) and the sample, about 30 instructions; at level 0 the rows
// layout's stores, 64 bytes a row 192 KB apart, do not overlap the
// arithmetic as the j-major layout's contiguous planes do (K3 is slower
// than K18 there on the same bytes: chip_smoke.py phase 3).
#include "dscf.cuh"

using namespace port;

namespace {

// The two middle y taps of one (key, query row): the byte offsets of their
// rows in the staged table and their weights.
struct __align__(16) YTaps {
  int o1, o2;
  float w1, w2;
};

constexpr int kJWarps = 16;  // two blocks an SM: 32 warps
constexpr int kJThreads = 32 * kJWarps;
constexpr int kJRows = 8;  // rows a warp stages before its 16-byte stores

// The f32 table plane (s1 x s2) into shared memory by cp.async; every
// thread of the block calls it, and waits for its own copies.
__device__ __forceinline__ void stage_f32(float* T, const float* __restrict__ Tg, int s1, int s2) {
  for (int i = threadIdx.x; i < s1 * s2; i += kJThreads) cp_async4(T + i, Tg + i);
  cp_async_commit();
  cp_async_wait_all();
}

// max(0, 1 - |v - i|) in f32, v = (a*i' + b) rounded: _rpe_kernel's hat
// weight of tap i, unrounded.
__device__ __forceinline__ float hat_f32(float v, int i) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(v, (float)i))));
}

// K18's form, _rpe_kernel's: f32 hat weights max(0, 1 - |(ay*r + by) - s|),
// the f32 table plane (s1 x s2), u and the sum in f32; off the table a tap
// reads a clamped index under weight 0.
struct F32Form {
  using Cell = float;
  static constexpr bool kSearch = false;  // the two middle taps always suffice

  __host__ __device__ static size_t table_bytes(int s1, int s2) {
    return (size_t)s1 * s2 * sizeof(float);
  }

  __device__ static void stage(float* T, const float* __restrict__ Tg, int s1, int s2) {
    stage_f32(T, Tg, s1, s2);
  }

  // the y taps of query row r for the key whose origin row is by, kept as
  // they are
  using Rec = YTaps;
  __device__ static Rec record(float ay, int r, float by, int s1, int s2) {
    const float yv = __fadd_rn(__fmul_rn(ay, (float)r), by);
    const int y1 = (int)floorf(yv), y2 = y1 + 1;
    YTaps y;
    y.o1 = min(max(y1, 0), s1 - 1) * s2 * 4;
    y.o2 = min(max(y2, 0), s1 - 1) * s2 * 4;
    y.w1 = (y1 >= 0 && y1 < s1) ? hat_f32(yv, y1) : 0.0f;
    y.w2 = (y2 >= 0 && y2 < s1) ? hat_f32(yv, y2) : 0.0f;
    return y;
  }
  __device__ static YTaps taps(const Rec& y, int) { return y; }
  __device__ static bool searched(const Rec&) { return false; }

  struct Col {
    const char *pa, *pb;  // the two x taps' columns of table row 0
    float w1, w2;
  };
  __device__ static Col col(const float* T, float ax, int c, float bx, int s2) {
    const float xv = __fadd_rn(__fmul_rn(ax, (float)c), bx);
    const int x1 = (int)floorf(xv), x2 = x1 + 1;
    return {reinterpret_cast<const char*>(T + min(max(x1, 0), s2 - 1)),
            reinterpret_cast<const char*>(T + min(max(x2, 0), s2 - 1)),
            (x1 >= 0 && x1 < s2) ? hat_f32(xv, x1) : 0.0f,
            (x2 >= 0 && x2 < s2) ? hat_f32(xv, x2) : 0.0f};
  }
  __device__ static bool two_taps(const Col&) { return true; }

  __device__ static float u(int o, const Col& x) {
    const float ta = *reinterpret_cast<const float*>(x.pa + o);
    const float tb = *reinterpret_cast<const float*>(x.pb + o);
    return __fadd_rn(__fadd_rn(0.0f, __fmul_rn(x.w1, ta)), __fmul_rn(x.w2, tb));
  }
  __device__ static float sample(const YTaps& y, float u1, float u2) {
    return __fadd_rn(__fadd_rn(0.0f, __fmul_rn(y.w1, u1)), __fmul_rn(y.w2, u2));
  }
  __device__ static float search(const float*, float, int, float, int, int, const Col&, float) {
    return 0.0f;  // never asked: kSearch is false
  }
};

// K3's and K6's form, the Pallas rows and packed kernels' bf16 rounding
// points, through dscf.cuh's rpe_* parts: the table plane as bf16 pairs,
// word (s, t) = (T[s, t], T[s, t + 1]) for s <= s1, t < s2, zero past the
// last row and column.
struct Bf16Form {
  using Cell = unsigned;
  static constexpr bool kSearch = true;

  __host__ __device__ static size_t table_bytes(int s1, int s2) {
    return (size_t)(s1 + 1) * s2 * sizeof(unsigned);
  }

  // The f32 plane by cp.async, then each warp turns its rows into pairs in
  // place, 160 columns at a time, each read before it is overwritten: a word
  // is written after the reads of its row's columns up to the next block of
  // 160, and no other warp reads that row.  The caller's barrier ends it.
  __device__ static void stage(unsigned* T, const float* __restrict__ Tg, int s1, int s2) {
    constexpr unsigned kAll = 0xffffffffu;
    constexpr int kCols = 5;
    float* F = reinterpret_cast<float*>(T);
    stage_f32(F, Tg, s1, s2);
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int s = warp; s <= s1; s += kJWarps) {
      for (int t0 = 0; t0 < s2; t0 += 32 * kCols) {
        float a[kCols + 1];
#pragma unroll
        for (int k = 0; k <= kCols; ++k) {
          const int t = t0 + 32 * k + lane;
          a[k] = s < s1 && t < s2 ? F[s * s2 + t] : 0.0f;
        }
        __syncwarp();  // the row's columns to t0 + 160 are read
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const float next = __shfl_down_sync(kAll, a[k], 1);
          const float wrap = __shfl_sync(kAll, a[k + 1], 0);
          const int t = t0 + 32 * k + lane;
          if (t < s2) T[s * s2 + t] = bf16x2_rn(a[k], lane == 31 ? wrap : next);
        }
      }
    }
  }

  // rpe_row and rpe_pair of query row r, in 8 bytes: the first tap row's
  // byte offset (the second's is s2 words on) and the two bf16 weights.
  // Where the four taps must be searched, offsets of table row 0, whose u
  // the row then computes and carries like any other, weights of all ones
  // (a NaN, never a weight) to flag it: the search replaces its output.
  struct __align__(8) Rec {
    int o1;
    unsigned w;
  };
  static constexpr unsigned kSearched = 0xffffffffu;
  __device__ static Rec record(float ay, int r, float by, int s1, int s2) {
    const RpeRow y = rpe_row(ay, r, by, s1);
    const int y1 = rpe_pair(y, s1);
    if (y1 == kNoPair) return {0, kSearched};
    return {y1 * s2 * 4, pack_bf16x2(y.wy[1], y.wy[2])};
  }
  __device__ static YTaps taps(const Rec& y, int s2x4) {
    return {y.o1, y.o1 + s2x4, bf16_lo(y.w), bf16_hi(y.w)};
  }
  __device__ static bool searched(const Rec& y) { return y.w == kSearched; }

  struct Col {
    RpeCol x;
    const char* p;  // the pair word of x1 (clamped onto the table) in table row 0
    float ac;       // ax * c rounded, for the search
  };
  __device__ static Col col(const unsigned* T, float ax, int c, float bx, int s2) {
    const float ac = __fmul_rn(ax, (float)c);
    const RpeCol x = rpe_col(ac, bx, s2);
    return {x, reinterpret_cast<const char*>(T + min(max(x.x1, 0), s2 - 1)), ac};
  }
  __device__ static bool two_taps(const Col& c) { return c.x.pair; }

  __device__ static float u(int o, const Col& c) {
    const unsigned p = *reinterpret_cast<const unsigned*>(c.p + o);
    return rpe_u(c.x, bf16_lo(p), bf16_hi(p));
  }
  __device__ static float sample(const YTaps& y, float u1, float u2) {
    return rpe_two_tap(y.w1, u1, y.w2, u2);
  }
  __device__ static float search(const unsigned* T, float ay, int r, float by, int s1, int s2,
                                 const Col& c, float bx) {
    return rpe_search(
        rpe_row(ay, r, by, s1), [&](int s, int t) { return bf16_lo(T[s * s2 + t]); }, c.ac,
        bx, c.x.x1, s2);
  }
};

// A block keeps the y taps of every (key, query row) of a chunk of its
// band's keys, h rounded up to kJRows rows a key; a block of two an SM has
// kPlaneSmem bytes of shared memory, and the chunk takes what the table
// and the staging tiles leave.
constexpr int kPlaneSmem = 115712;  // (228 KB an SM - 1 KB a block) / 2

template <typename Form>
size_t fixed_smem(int s1, int s2) {
  return align128(Form::table_bytes(s1, s2)) + (size_t)kJWarps * kJRows * 32 * sizeof(bf16);
}

// n bf16 from shared src to dst with the widest stores its length and
// alignment allow.
__device__ __forceinline__ void store_run(bf16* dst, const bf16* src, int n) {
  const size_t at = reinterpret_cast<size_t>(dst);
  if (n == 8 && at % 16 == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if (n % 4 == 0 && at % 8 == 0) {
    for (int q = 0; q < n; q += 4)
      *reinterpret_cast<uint2*>(dst + q) = *reinterpret_cast<const uint2*>(src + q);
  } else {
    for (int q = 0; q < n; ++q) dst[q] = src[q];
  }
}

// Rows layout (K3): bias[plane, r, j, c], a row's (key, column) pairs
// contiguous; else the j-major layout (K6, K18): bias[plane, j, r, c].
// kDirect (the j-major layout's rows shorter than a run, w < 32): each lane
// stores its own outputs from registers, where a run's 8 rows would split
// into a piece of a row of each key.
template <typename Form, bool kRows, bool kDirect>
__global__ void __launch_bounds__(kJThreads, 2)
rpe_plane_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                 bf16* __restrict__ out, int G, int hg, int h, int M, int w, int s1, int s2,
                 float ay, float ax, int keys_per_block, int chunk_keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr unsigned kAll = 0xffffffffu;
  using Cell = typename Form::Cell;
  using Rec = typename Form::Rec;
  Cell* T = reinterpret_cast<Cell*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h8 = (h + kJRows - 1) / kJRows * kJRows, s2x4 = s2 * 4;
  const size_t t_bytes = align128(Form::table_bytes(s1, s2));
  Rec* Yb = reinterpret_cast<Rec*>(smem + t_bytes);
  bf16* St = reinterpret_cast<bf16*>(smem + t_bytes +
                                     align128((size_t)chunk_keys * h8 * sizeof(Rec))) +
             warp * kJRows * 32;
  const int plane = blockIdx.y, bg = plane / hg, e = plane % hg;
  Form::stage(T, table + ((size_t)(bg % G) * hg + e) * s1 * s2, s1, s2);

  // the fill: a warp kp keys at once, a lane row lr of key lk
  const int kp = h8 >= 32 ? 1 : 32 / h8, rstep = h8 >= 32 ? 32 : h8;
  const int lk = h8 >= 32 ? 0 : lane / h8, lr = h8 >= 32 ? lane : lane - lk * h8;
  const int j0 = blockIdx.x * keys_per_block, j1 = min(M, j0 + keys_per_block);
  for (int cj = j0; cj < j1; cj += chunk_keys) {
    const int nk = min(chunk_keys, j1 - cj);
    const float* pos_c = pos + ((size_t)bg * M + cj) * 2;
    if (cj != j0) __syncthreads();  // the last chunk's runs are done with Yb
    if (lk < kp) {
      for (int kk = warp * kp + lk; kk < nk; kk += kJWarps * kp) {
        const float by = rpe_key(pos_c + 2 * kk, s1, s2).by;
        for (int r = lr; r < h8; r += rstep)  // rows past h repeat the last
          Yb[kk * h8 + r] = Form::record(ay, min(r, h - 1), by, s1, s2);
      }
    }
    __syncthreads();  // the table (first chunk) and the chunk's y taps

    for (int task = warp; task * 32 < nk * w; task += kJWarps) {
      // the run's pairs f0 .. f0 + n - 1 (f = key * w + column in the
      // chunk); lanes past n repeat the last pair and store nothing
      const int f0 = task * 32, n = min(32, nk * w - f0);
      const int f = f0 + min(lane, n - 1), k = f / w, c = f - k * w;
      const RpeKey key = rpe_key(pos_c + 2 * k, s1, s2);
      const typename Form::Col x = Form::col(T, ax, c, key.bx, s2);
      const Rec* Yk = Yb + k * h8;
      // the lane's store: len (at most 8) pairs from q of a row, contiguous
      // in the rows layout; in the j-major layout seg of them from key kq's
      // column cq, the rest from column 0 of key kq + 1 (w >= 8: two keys
      // at most)
      const int q = 8 * (lane % 4), kq = (f0 + q) / w, cq = f0 + q - kq * w;
      const int len = min(8, n - q), seg = kRows ? len : min(len, w - cq);
      bf16* const d1 = kRows ? out + ((size_t)plane * h * M + cj) * w + f0 + q
                             : out + ((size_t)plane * M + cj + kq) * h * w + cq;
      bf16* const d2 = out + ((size_t)plane * M + cj + kq + 1) * h * w;
      const size_t row_stride = kRows ? (size_t)M * w : (size_t)w;
      // kDirect: the lane's own outputs
      bf16* const own = out + ((size_t)plane * M + cj + k) * h * w + c;
      int po1 = -1, po2 = -1;  // the last row's tap rows and their u
      float pu1 = 0.0f, pu2 = 0.0f;
      for (int g = 0; g < h; g += kJRows) {
        // the eight rows' taps, and whether any lane's key has a row whose
        // first tap row is neither of the last row's ("fresh")
        YTaps y[kJRows];
        bool fresh = false;
        unsigned searched = 0;
        int l1 = po1, l2 = po2;
#pragma unroll
        for (int i = 0; i < kJRows; ++i) {
          const Rec rec = Yk[g + i];
          y[i] = Form::taps(rec, s2x4);
          fresh |= y[i].o1 != l1 && y[i].o1 != l2;
          l1 = y[i].o1, l2 = y[i].o2;
          if (Form::searched(rec)) searched |= 1u << i;
        }
        // the eight rows into registers first: no store to shared memory
        // between their loads
        float v[kJRows];
        if (!__any_sync(kAll, fresh)) {
          // each row's first tap row is the last row's first or second: its
          // u carried over, the second's computed where it moved
#pragma unroll
          for (int i = 0; i < kJRows; ++i) {
            const float u1 = y[i].o1 == po1 ? pu1 : pu2;
            float u2 = pu2;
            if (y[i].o2 != po2) u2 = Form::u(y[i].o2, x);
            v[i] = Form::sample(y[i], u1, u2);
            po1 = y[i].o1, po2 = y[i].o2, pu1 = u1, pu2 = u2;
          }
        } else {
          // a key's first rows, taps that move by two rows or more (every
          // row where ay > 1), and rows past h (the last repeated, not
          // stored): both u computed
#pragma unroll
          for (int i = 0; i < kJRows; ++i) {
            const float u1 = Form::u(y[i].o1, x), u2 = Form::u(y[i].o2, x);
            v[i] = Form::sample(y[i], u1, u2);
            po1 = y[i].o1, po2 = y[i].o2, pu1 = u1, pu2 = u2;
          }
        }
        const auto put = [&](int i, float value) {
          if (kDirect) {
            if (lane < n && g + i < h) own[(g + i) * w] = __float2bfloat16(value);
          } else {
            St[i * 32 + lane] = __float2bfloat16(value);
          }
        };
#pragma unroll
        for (int i = 0; i < kJRows; ++i) put(i, v[i]);
        if (Form::kSearch && lane < n && (searched || !Form::two_taps(x))) {
          // rare: the four-tap search for a row whose y taps need it, or for
          // every row of a lane whose x taps do
          const bool mine = !Form::two_taps(x);
#pragma unroll 1
          for (int i = 0; i < kJRows; ++i)
            if (mine || ((searched >> i) & 1))
              put(i, Form::search(T, ay, min(g + i, h - 1), key.by, s1, s2, x, key.bx));
        }
        if (kDirect) continue;
        __syncwarp();
        // 4 lanes a row: 8 pairs each, as 16-byte stores where they allow
        const int rr = g + lane / 4;
        if (rr < h && q < n) {
          const bf16* src = St + (lane / 4) * 32 + q;
          store_run(d1 + rr * row_stride, src, seg);
          if (!kRows && seg < len) {  // a key's row is w pairs: the run splits
            if (w >= 8) {
              store_run(d2 + rr * w, src + seg, len - seg);
            } else {
              for (int done = seg, kk = kq + 1; done < len; ++kk) {
                const int part = min(len - done, w);
                store_run(out + (((size_t)plane * M + cj + kk) * h + rr) * w, src + done,
                          part);
                done += part;
              }
            }
          }
        }
        __syncwarp();
      }
    }
  }
}

template <typename Form, bool kRows, bool kDirect>
int launch_plane(const void* pos, const void* table, void* out, int BG, int G, int hg, int h,
                 int M, int w, int s1, int s2, float ay, float ax, void* stream) {
  const int h8 = (h + kJRows - 1) / kJRows * kJRows;
  const size_t fixed = fixed_smem<Form>(s1, s2), key_bytes = (size_t)h8 * sizeof(typename Form::Rec);
  // the y taps of as many keys as two blocks an SM leave room for (one at least)
  const int chunk_cap = (int)std::max<size_t>(
      1, std::min<size_t>(M, fixed < (size_t)kPlaneSmem ? (kPlaneSmem - fixed) / key_bytes : 1));
  const size_t smem_cap = fixed + align128((size_t)chunk_cap * key_bytes);
  if (smem_cap > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = rpe_plane_kernel<Form, kRows, kDirect>;
  const int planes = BG * hg;
  const int blocks = blocks_per_device(kernel, smem_cap, kJThreads);
  const int bands = std::min(M, std::max(1, blocks / planes));
  const int keys = (M + bands - 1) / bands;
  // the band's keys in even chunks
  const int chunks = (keys + chunk_cap - 1) / chunk_cap, chunk = (keys + chunks - 1) / chunks;
  const size_t smem = fixed + align128((size_t)chunk * key_bytes);
  kernel<<<dim3((M + keys - 1) / keys, planes), kJThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      (const float*)pos, (const float*)table, (bf16*)out, G, hg, h, M, w, s1, s2, ay, ax,
      keys, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dscf_rpe_rows(const void* pos, const void* table, void* out,
                             int BG, int G, int hg, int h, int M, int w, int s1,
                             int s2, float ay, float ax, void* stream) {
  return launch_plane<Bf16Form, true, false>(pos, table, out, BG, G, hg, h, M, w, s1, s2, ay,
                                             ax, stream);
}

extern "C" int dscf_rpe_packed(const void* pos, const void* table, void* out,
                               int BG, int G, int hg, int h, int M, int w,
                               int s1, int s2, float ay, float ax,
                               void* stream) {
  const auto launch = w < 32 ? launch_plane<Bf16Form, false, true>
                             : launch_plane<Bf16Form, false, false>;
  return launch(pos, table, out, BG, G, hg, h, M, w, s1, s2, ay, ax, stream);
}

extern "C" int dscf_rpe_jmajor(const void* pos, const void* table, void* out,
                               int BG, int G, int hg, int h, int M, int w,
                               int s1, int s2, float ay, float ax,
                               void* stream) {
  const auto launch = w < 32 ? launch_plane<F32Form, false, true>
                             : launch_plane<F32Form, false, false>;
  return launch(pos, table, out, BG, G, hg, h, M, w, s1, s2, ay, ax, stream);
}
