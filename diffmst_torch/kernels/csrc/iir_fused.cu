// K5: a cascade of S biquad sections in transposed direct form II, from zero
// state (scipy.signal.sosfilt), over (rows, T) float32 rows, and its backward.
// Section s of a row has normalized coefficients b0, b1, b2, a1, a2 (a0 = 1):
//
//   y[n]  = b0 x[n] + s1[n-1]
//   s1[n] = (b1 - a1 b0) x[n] - a1 s1[n-1] + s2[n-1]
//   s2[n] = (b2 - a2 b0) x[n] - a2 s1[n-1]
//
// so the state v = (s1, s2) follows v[n] = M v[n-1] + u[n] with
// M = [[-a1, 1], [-a2, 0]], a 2x2 affine map per sample.
//
// Replaces the Pallas kernel diffmst_tpu/kernels/iir_fused.py::_core
// (pallas_call at iir_fused.py:128; public sosfilt_pallas:144), whose body
// is this TDF-II recurrence (iir_fused.py:64-70), and its VJP
// (iir_fused.py:167-170), which differentiated ops/iir.py::sosfilt_scan
// through XLA. The Pallas kernel streamed all sections through VMEM in one
// pass; blocks on the card run in no order, so the forward takes three
// launches for all S sections, each section's output rounded to float32 as
// the Pallas kernel rounds between sections:
//
//   1. cascade_pass<false> (a block per row and chunk of kChunk samples):
//      loads the chunk of x once into shared memory and runs every section
//      over it from a zero state, section after section, kItems samples a
//      thread in registers; writes the chunk's end state, the 2S-vector of
//      all sections' (s1, s2). The cascade is one linear time-invariant
//      system on that vector, v[n] = A v[n-1] + B x[n], with A block
//      lower-triangular and constant along the row; one more block a row,
//      in the grid's first wave, squares A into A^kChunk and its squares.
//   2. cascade_carries (a block per row): the state entering each chunk,
//      carry[c+1] = A^kChunk carry[c] + end[c], as a Hillis-Steele scan over
//      64 chunks at a time in shared memory.
//   3. cascade_pass<true> (the chunks of pass 1): reloads x (an L2 hit where
//      it fits), reruns the cascade from the chunk's carry (section s from
//      entries 2s, 2s+1), and writes y and, when asked, the S - 1 stages the
//      backward reads.
//
// Inside a block a section is still a scan over its threads, but M does not
// vary along the row, so the map of any span of L samples is M^L, known in
// advance: each block first builds, per section, M^(kItems 2^j), and the
// scan carries the 2-vector particular part only (two doubles shuffled and
// four FMAs a round). The chunk pass starts from zero and the apply pass
// rounds each section's output, so the carries and the apply pass differ by
// float32 rounding only. The least traffic is 8 bytes a sample (read x,
// write y), the bound; this design moves 12 (x read twice), plus 4 (S - 1)
// for the stages. What holds it back is arithmetic: the chunk and apply
// passes each run the whole cascade, about nine float64 instructions and
// two float32/float64 conversions (16 a clock an SM) a sample and section,
// plus the block scans. Registers cap the passes at two blocks an SM;
// capping them lower spills and is slower (PERF.md).
//
// The backward runs the sections in reverse order. For a section with
// input u, output y and output cotangent dy, the input's cotangent du is dy
// filtered by the same section backwards in time (the adjoint of a causal
// filter), taken by the same TDF-II scan on reversed time, whose state
// stays at the signal's scale. The coefficients' cotangents need
//   w[n] = dy[n] - a1 w[n+1] - a2 w[n+2]        (the state (w[n], w[n+1])),
// dy through 1/A backwards: db_k = sum_n w[n] u[n-k] (k = 0, 1, 2) and
// da_k = -sum_n w[n] y[n-k] (k = 1, 2), summed per row without atomics.
// w grows like 1/(1-r)^2 times dy at a pole of radius r, and so do those
// sums; du taken from w as b0 w[n] + b1 w[n+1] + b2 w[n+2] would cancel
// that growth and lose its digits (3.8e-5 of its peak at r = 0.9998 in
// float64), hence the second scan. A section's backward reads dy twice and
// u, y once and writes du, and the section inputs are the forward's
// `stages`, which a differentiated forward keeps.

#include "scan_common.cuh"

namespace {

constexpr int kCoefs = 5;  // per section and row: b0, b1, b2, a1, a2

struct Section {
  double b0, b1, b2, a1, a2;
};

// coef: (kCoefs, rows) of one section
__device__ __forceinline__ Section load_section(const float* coef, int rows, int row) {
  return Section{__ldg(coef + row), __ldg(coef + rows + row), __ldg(coef + 2 * rows + row),
                 __ldg(coef + 3 * rows + row), __ldg(coef + 4 * rows + row)};
}

// Forward in time, or (kReverse) backwards, walked as t = T-1-n.
template <bool kReverse>
struct BiquadOp {
  using Map = diffmst::Affine2;
  static constexpr bool kRecompute = true;  // six doubles a map
  const float* x;
  const float* coef;
  float* y;
  int rows;
  int64_t T;

  __device__ __forceinline__ int64_t index(int row, int64_t t) const {
    return (int64_t)row * T + (kReverse ? T - 1 - t : t);
  }

  __device__ __forceinline__ diffmst::Affine2 step(int row, int64_t t) const {
    const Section c = load_section(coef, rows, row);
    const double xv = __ldg(x + index(row, t));
    return diffmst::Affine2{-c.a1, 1.0, -c.a2, 0.0, (c.b1 - c.a1 * c.b0) * xv,
                            (c.b2 - c.a2 * c.b0) * xv};
  }

  // y[n] = b0 x[n] + s1[n-1]: the state before the step
  __device__ __forceinline__ void store(int row, int64_t t, diffmst::Vec2 before,
                                        diffmst::Vec2) const {
    const int64_t i = index(row, t);
    const double b0 = __ldg(coef + row);
    y[i] = (float)(b0 * (double)__ldg(x + i) + before.v1);
  }
};

// The coefficients' cotangents of one section, walked as t = T-1-n; the
// state after sample n is (w[n], w[n+1]).
struct BiquadAdjointOp {
  using Map = diffmst::Affine2;
  static constexpr bool kRecompute = true;
  static constexpr int kSums = kCoefs;  // db0, db1, db2, da1, da2
  const float* dy;
  const float* u;
  const float* y;
  const float* coef;
  int rows;
  int64_t T;

  __device__ __forceinline__ diffmst::Affine2 step(int row, int64_t t) const {
    const double a1 = __ldg(coef + 3 * rows + row), a2 = __ldg(coef + 4 * rows + row);
    const int64_t i = (int64_t)row * T + (T - 1 - t);
    return diffmst::Affine2{-a1, -a2, 1.0, 0.0, (double)__ldg(dy + i), 0.0};
  }

  __device__ __forceinline__ void store(int row, int64_t t, diffmst::Vec2,
                                        diffmst::Vec2 after, double* sums) const {
    const int64_t n = T - 1 - t;
    const int64_t i = (int64_t)row * T + n;
    const double w = after.v1;
    const double u1 = n >= 1 ? (double)__ldg(u + i - 1) : 0.0;
    const double u2 = n >= 2 ? (double)__ldg(u + i - 2) : 0.0;
    const double y1 = n >= 1 ? (double)__ldg(y + i - 1) : 0.0;
    const double y2 = n >= 2 ? (double)__ldg(y + i - 2) : 0.0;
    sums[0] += w * (double)__ldg(u + i);
    sums[1] += w * u1;
    sums[2] += w * u2;
    sums[3] -= w * y1;
    sums[4] -= w * y2;
  }
};

}  // namespace

namespace {

// The forward's fused cascade (passes 1-3 at the top of this file).
constexpr int kCascadeThreads = 256;
constexpr int kCascadeWarps = kCascadeThreads / 32;
constexpr int kItems = 16;                        // samples a thread
constexpr int kChunk = kCascadeThreads * kItems;  // 4096 samples a block
constexpr int kMaxSections = 16;                  // the 2S-vector fits a warp
constexpr int kMaxState = 2 * kMaxSections;
constexpr int kLanePowers = 5;                    // M^(kItems 2^j) for lanes 2^j apart
constexpr int kCarryPowers = 6;                   // A^(kChunk 2^k) for chunks 2^k apart
constexpr unsigned kFull = 0xffffffffu;

// The chunk in shared memory, one float of padding every 32: a thread's
// kItems consecutive samples and a warp's 32 consecutive samples both fall
// in 32 distinct banks.
constexpr int kTile = kChunk + kChunk / 32;
__device__ __forceinline__ int tile_index(int n) { return n + (n >> 5); }
static_assert(kTile * sizeof(float) >= 2 * kMaxState * kMaxState * sizeof(double),
              "a power block squares its matrices in the tile");

using diffmst::Vec2;

struct Mat2 {
  double m11, m12, m21, m22;
};

__device__ __forceinline__ Mat2 mul(const Mat2& p, const Mat2& q) {
  return Mat2{p.m11 * q.m11 + p.m12 * q.m21, p.m11 * q.m12 + p.m12 * q.m22,
              p.m21 * q.m11 + p.m22 * q.m21, p.m21 * q.m12 + p.m22 * q.m22};
}

// p v + w
__device__ __forceinline__ Vec2 affine(const Mat2& p, Vec2 v, Vec2 w) {
  return Vec2{fma(p.m11, v.v1, fma(p.m12, v.v2, w.v1)), fma(p.m21, v.v1, fma(p.m22, v.v2, w.v2))};
}

__device__ __forceinline__ Vec2 shfl_up2(Vec2 v, int d) {
  return Vec2{__shfl_up_sync(kFull, v.v1, d), __shfl_up_sync(kFull, v.v2, d)};
}

// One section of one row, in double: b0, the input's weights on (s1, s2)
// (b1 - a1 b0, b2 - a2 b0), a1, a2, and M^(kItems 2^j) for j <= kLanePowers
// (the last spans one warp's samples).
struct SectionTable {
  double b0, beta1, beta2, a1, a2;
  Mat2 pow[kLanePowers + 1];
};

// Threads 0..sections-1 fill tab[] for the block's row.
__device__ __forceinline__ void load_sections(const float* coef, int rows, int row, int sections,
                                              SectionTable* tab) {
  const int s = threadIdx.x;
  if (s >= sections) return;
  const float* c = coef + (int64_t)s * kCoefs * rows + row;
  const double b0 = __ldg(c), b1 = __ldg(c + rows), b2 = __ldg(c + 2 * rows);
  const double a1 = __ldg(c + 3 * rows), a2 = __ldg(c + 4 * rows);
  SectionTable& t = tab[s];
  t.b0 = b0;
  t.beta1 = b1 - a1 * b0;
  t.beta2 = b2 - a2 * b0;
  t.a1 = a1;
  t.a2 = a2;
  Mat2 p{-a1, 1.0, -a2, 0.0};
  for (int k = 1; k < kItems; k <<= 1) p = mul(p, p);
  for (int j = 0; j <= kLanePowers; ++j) {
    t.pow[j] = p;
    p = mul(p, p);
  }
}

// The cascade's map over one sample, v[n] = A v[n-1] + B x[n], on the
// 2S-vector v of the sections' (s1, s2), and its powers: powers[k] =
// A^(kChunk 2^k), d x d row-major (d = 2S), for k < kCarryPowers. A
// block of the chunk pass's first wave computes them, so that the carry
// pass does not wait on 17 dependent squarings. m: 2 d^2 doubles of shared
// memory.
__device__ void cascade_powers(const float* coef, int rows, int row, int sections, double* m,
                               double* powers) {
  const int d = 2 * sections;
  const int dd = d * d;
  auto cf = [&](int s, int k) { return (double)__ldg(coef + ((int64_t)s * kCoefs + k) * rows + row); };
  // Entry (i, j) carries state j before a sample into state i after it.
  // Section s's own block is M. Its input holds the s1 of each earlier
  // section k (y_k = b0_k u_k + s1_k) times the b0 of the sections between,
  // and enters (s1, s2) through (b1 - a1 b0, b2 - a2 b0).
  for (int idx = threadIdx.x; idx < dd; idx += kCascadeThreads) {
    const int i = idx / d, j = idx % d, s = i >> 1, k = j >> 1;
    double a = 0.0;
    if (k == s) {
      a = (i & 1) ? ((j & 1) ? 0.0 : -cf(s, 4)) : ((j & 1) ? 1.0 : -cf(s, 3));
    } else if (k < s && !(j & 1)) {
      double g = 1.0;
      for (int q = k + 1; q < s; ++q) g *= cf(q, 0);
      const double b0 = cf(s, 0);
      a = g * ((i & 1) ? cf(s, 2) - cf(s, 4) * b0 : cf(s, 1) - cf(s, 3) * b0);
    }
    m[idx] = a;
  }
  __syncthreads();
  int cur = 0;
  for (int span = 1; span < (kChunk << (kCarryPowers - 1)); span <<= 1) {
    for (int idx = threadIdx.x; idx < dd; idx += kCascadeThreads) {
      const int i = idx / d, j = idx % d;
      double acc = 0.0;
      for (int q = 0; q < d; ++q) acc = fma(m[cur * dd + i * d + q], m[cur * dd + q * d + j], acc);
      m[(cur ^ 1) * dd + idx] = acc;
      if (span >= kChunk / 2) {  // the square is A^(2 span), 2 span >= kChunk
        int k = 0;
        while ((kChunk << k) < 2 * span) ++k;
        powers[k * dd + idx] = acc;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

// Writes the block's kChunk values u (kItems a thread) to out[0, n_valid)
// through the tile, so that a warp stores 32 consecutive floats.
__device__ __forceinline__ void store_chunk(const double (&u)[kItems], float* tile, float* out,
                                            int64_t n_valid) {
  __syncthreads();  // the tile's last readers are done
#pragma unroll
  for (int i = 0; i < kItems; ++i) tile[tile_index(threadIdx.x * kItems + i)] = (float)u[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int n = threadIdx.x + i * kCascadeThreads;
    if (n < n_valid) out[n] = tile[tile_index(n)];
  }
}

// Passes 1 (kApply false) and 3, on a grid of (rows, chunks) blocks; pass
// 1's grid has one more chunk index in front, 0, whose blocks compute the
// rows' `powers` (cascade_powers). ends, carries: (rows, n_chunks, 2S)
// states, section s at entries 2s (s1) and 2s + 1 (s2). Pass 1 writes
// `ends`, each chunk's end state from a zero state; pass 3 starts each chunk
// from `carries` and writes y and, where `stages` is not null, the S - 1
// stages ((S - 1, rows, T)).
template <bool kApply>
__global__ void __launch_bounds__(kCascadeThreads)
cascade_pass(const float* __restrict__ x, const float* __restrict__ coef, int rows, int64_t T,
             int sections, double* __restrict__ ends, double* __restrict__ powers,
             const double* __restrict__ carries, float* __restrict__ stages,
             float* __restrict__ y) {
  __shared__ __align__(16) float tile[kTile];
  __shared__ SectionTable tab[kMaxSections];
  __shared__ Vec2 warp_ends[2][kCascadeWarps];
  const int row = blockIdx.x;
  if (!kApply && blockIdx.y == 0) {
    const int dd = 4 * sections * sections;
    cascade_powers(coef, rows, row, sections, reinterpret_cast<double*>(tile),
                   powers + (int64_t)row * kCarryPowers * dd);
    return;
  }
  const int chunk = blockIdx.y - (kApply ? 0 : 1);
  const int n_chunks = gridDim.y - (kApply ? 0 : 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t0 = (int64_t)chunk * kChunk;
  const int64_t n_valid = T - t0;
  const int64_t state0 = ((int64_t)row * n_chunks + chunk) * 2 * sections;

  load_sections(coef, rows, row, sections, tab);
  const float* xr = x + (int64_t)row * T + t0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int n = threadIdx.x + i * kCascadeThreads;
    tile[tile_index(n)] = n < n_valid ? __ldg(xr + n) : 0.0f;
  }
  __syncthreads();
  double u[kItems];  // this thread's samples: a section's input, then its output
#pragma unroll
  for (int i = 0; i < kItems; ++i) u[i] = (double)tile[tile_index(threadIdx.x * kItems + i)];

  for (int s = 0; s < sections; ++s) {
    const SectionTable& c = tab[s];
    const double b0 = c.b0, beta1 = c.beta1, beta2 = c.beta2, a1 = c.a1, a2 = c.a2;
    // the state after this thread's samples, from a zero state before them
    Vec2 p{0.0, 0.0};
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      p = Vec2{fma(-a1, p.v1, fma(beta1, u[i], p.v2)), fma(-a2, p.v1, beta2 * u[i])};
    }
    // inclusive scan over the warp: the state after lane l, from a zero
    // state at the warp's first sample
    Vec2 inc = p;
#pragma unroll
    for (int j = 0; j < kLanePowers; ++j) {
      const Vec2 o = shfl_up2(inc, 1 << j);
      if (lane >= (1 << j)) inc = affine(c.pow[j], o, inc);
    }
    Vec2 exc = shfl_up2(inc, 1);
    if (lane == 0) exc = Vec2{0.0, 0.0};
    // two buffers: section s + 2 writes this one after section s + 1's sync
    if (lane == 31) warp_ends[s & 1][warp] = inc;
    __syncthreads();
    // the state entering this warp, then this thread (M^(lane kItems) by
    // the lane's bits)
    Vec2 v{0.0, 0.0};
    if constexpr (kApply) {
      v = Vec2{__ldg(carries + state0 + 2 * s), __ldg(carries + state0 + 2 * s + 1)};
    }
    for (int w = 0; w < warp; ++w) v = affine(c.pow[kLanePowers], v, warp_ends[s & 1][w]);
#pragma unroll
    for (int j = 0; j < kLanePowers; ++j) {
      if ((lane >> j) & 1) v = affine(c.pow[j], v, Vec2{0.0, 0.0});
    }
    v = Vec2{v.v1 + exc.v1, v.v2 + exc.v2};
    if constexpr (!kApply) {
      if (threadIdx.x == kCascadeThreads - 1) {  // the chunk's end state
        const Vec2 e = affine(c.pow[0], v, p);
        ends[state0 + 2 * s] = e.v1;
        ends[state0 + 2 * s + 1] = e.v2;
      }
      if (s == sections - 1) break;  // the last section's outputs are not needed
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const double out = fma(b0, u[i], v.v1);
      v = Vec2{fma(-a1, v.v1, fma(beta1, u[i], v.v2)), fma(-a2, v.v1, beta2 * u[i])};
      u[i] = (double)(float)out;  // rounded between sections
    }
    if constexpr (kApply) {
      if (s == sections - 1) {
        store_chunk(u, tile, y + (int64_t)row * T + t0, n_valid);
      } else if (stages != nullptr) {
        store_chunk(u, tile, stages + ((int64_t)s * rows + row) * T + t0, n_valid);
      }
    }
  }
}

// Pass 2, a block per row: carries[row, c] = the 2S-vector entering chunk c.
// The state after chunk c is w[c] = A^kChunk w[c-1] + ends[c]. The block
// takes the row's chunks kScan at a time: the first end of a tile gets
// A^kChunk times the state entering the tile, then a Hillis-Steele scan
// over the tile adds, at span 2^k, A^(kChunk 2^k) times the state 2^k
// chunks before. kD >= 2S is the state's width padded for unrolled loops
// (12 for the console's six sections); entries past 2S stay 0.
template <int kD>
__global__ void __launch_bounds__(kCascadeThreads)
cascade_carries(int sections, const double* __restrict__ ends, const double* __restrict__ powers,
                double* __restrict__ carries, int n_chunks) {
  static_assert(kD % 2 == 0 && kD <= kMaxState, "the state fits a warp");
  constexpr int kLevels = kD <= 12 ? kCarryPowers : 4;  // shared memory: 48 KB at most
  constexpr int kScan = 1 << kLevels;                   // chunks a scan
  __shared__ double pw[kLevels][kD * kD];
  __shared__ double w[2][kScan * kD];
  __shared__ double cin[kD];
  const int row = blockIdx.x;
  const int d = 2 * sections;
  const double* pr = powers + (int64_t)row * kCarryPowers * d * d;
  for (int idx = threadIdx.x; idx < kLevels * kD * kD; idx += kCascadeThreads) {
    const int k = idx / (kD * kD), i = idx / kD % kD, j = idx % kD;
    pw[k][i * kD + j] = i < d && j < d ? pr[(k * d + i) * d + j] : 0.0;
  }
  if (threadIdx.x < kD) cin[threadIdx.x] = 0.0;
  const double* e = ends + (int64_t)row * n_chunks * d;
  double* car = carries + (int64_t)row * n_chunks * d;
  for (int c0 = 0; c0 < n_chunks; c0 += kScan) {
    const int n = min(kScan, n_chunks - c0);
    for (int idx = threadIdx.x; idx < kScan * kD; idx += kCascadeThreads) {
      const int c = idx / kD, i = idx % kD;
      w[0][idx] = c < n && i < d ? e[(int64_t)(c0 + c) * d + i] : 0.0;
    }
    __syncthreads();
    if (threadIdx.x < kD) {  // the state entering the tile, through its first chunk
      double acc = w[0][threadIdx.x];
#pragma unroll
      for (int j = 0; j < kD; ++j) acc = fma(pw[0][threadIdx.x * kD + j], cin[j], acc);
      w[0][threadIdx.x] = acc;
    }
    __syncthreads();
    int cur = 0;
#pragma unroll
    for (int k = 0; k < kLevels; ++k) {
      const int span = 1 << k;
      for (int idx = threadIdx.x; idx < kScan * kD; idx += kCascadeThreads) {
        const int c = idx / kD, i = idx % kD;
        double acc = w[cur][idx];
        if (c >= span) {
#pragma unroll
          for (int j = 0; j < kD; ++j) acc = fma(pw[k][i * kD + j], w[cur][(c - span) * kD + j], acc);
        }
        w[cur ^ 1][idx] = acc;
      }
      __syncthreads();
      cur ^= 1;
    }
    // chunk c0 starts from cin, chunk c0 + c from the state after the one before
    for (int idx = threadIdx.x; idx < n * d; idx += kCascadeThreads) {
      const int c = idx / d, i = idx % d;
      car[(int64_t)(c0 + c) * d + i] = c == 0 ? cin[i] : w[cur][(c - 1) * kD + i];
    }
    __syncthreads();
    if (threadIdx.x < kD) cin[threadIdx.x] = w[cur][(n - 1) * kD + threadIdx.x];
    __syncthreads();
  }
}

inline int cascade_chunks(int64_t T) { return (int)((T + kChunk - 1) / kChunk); }

}  // namespace

// ends and carries ((rows, chunks, 2S) each), and powers ((rows,
// kCarryPowers, 2S, 2S)), in doubles.
extern "C" long long diffmst_sosfilt_scratch_bytes(int rows, long long T, int sections) {
  const long long d = 2LL * sections;
  return rows * (2LL * cascade_chunks(T) * d + kCarryPowers * d * d) * (long long)sizeof(double);
}

// coef: (sections, 5, rows), 1 <= sections <= kMaxSections; stages: null, or
// (sections - 1, rows, T), which receives the output of every section but
// the last, which goes to y. Three launches, whatever the number of sections.
// events: null, or four CUDA events recorded before the first launch and
// after each, to time the passes.
extern "C" int diffmst_sosfilt(const float* x, const float* coef, float* stages, float* y,
                               void* scratch, int rows, long long T, int sections,
                               void* stream, void* const* events) {
  const int n_chunks = cascade_chunks(T);
  if (sections < 1 || sections > kMaxSections || n_chunks >= 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long d = 2LL * sections;
  double* ends = static_cast<double*>(scratch);
  double* carries = ends + rows * n_chunks * d;
  double* powers = carries + rows * n_chunks * d;
  auto mark = [&](int k) {
    if (events != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(events[k]), st);
  };
  mark(0);
  cascade_pass<false><<<dim3(rows, n_chunks + 1), kCascadeThreads, 0, st>>>(
      x, coef, rows, T, sections, ends, powers, nullptr, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mark(1);
  if (d <= 12) {
    cascade_carries<12><<<rows, kCascadeThreads, 0, st>>>(sections, ends, powers, carries, n_chunks);
  } else {
    cascade_carries<kMaxState><<<rows, kCascadeThreads, 0, st>>>(sections, ends, powers, carries,
                                                                 n_chunks);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mark(2);
  cascade_pass<true><<<dim3(rows, n_chunks), kCascadeThreads, 0, st>>>(
      x, coef, rows, T, sections, nullptr, nullptr, carries, stages, y);
  err = cudaGetLastError();
  mark(3);
  return (int)err;
}

extern "C" long long diffmst_sosfilt_backward_scratch_bytes(int rows, long long T) {
  return diffmst::scratch_bytes<BiquadAdjointOp>(rows, T);
}

// From the forward's input x, stages and output y, and the output's
// cotangent dy: dx, and dcoef (sections, 5, rows), the cotangents of
// b0, b1, b2, a1, a2. `work` is a (rows, T) buffer; the sections' input
// cotangents alternate between it and dx so that section 0's lands in dx.
extern "C" int diffmst_sosfilt_backward(const float* x, const float* stages, const float* y,
                                        const float* coef, const float* dy, float* dx,
                                        float* work, float* dcoef, void* scratch, int rows,
                                        long long T, int sections, void* stream) {
  const long long n = (long long)rows * T;
  for (int s = sections - 1; s >= 0; --s) {
    const float* u = s == 0 ? x : stages + (s - 1) * n;
    const float* out = s == sections - 1 ? y : stages + s * n;
    const float* d_out = s == sections - 1 ? dy : ((s + 1) % 2 == 0 ? dx : work);
    float* d_in = s % 2 == 0 ? dx : work;
    const long long off = (long long)s * kCoefs * rows;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const BiquadOp<true> filter{d_out, coef + off, d_in, rows, T};
    int err = diffmst::scan_rows(filter, scratch, rows, T, st);
    if (err != 0) return err;
    const BiquadAdjointOp sums{d_out, u, out, coef + off, rows, T};
    err = diffmst::scan_rows(sums, scratch, rows, T, st, dcoef + off);
    if (err != 0) return err;
  }
  return 0;
}
