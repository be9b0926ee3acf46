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
// The backward walks time backwards. For a section with input u, output
// y and output cotangent dy, the input's cotangent du is dy filtered by the
// same section backwards in time (the adjoint of a causal filter), taken by
// the same TDF-II recurrence on reversed time, whose state stays at the
// signal's scale. The coefficients' cotangents need
//   w[n] = dy[n] - a1 w[n+1] - a2 w[n+2]        (the state (w[n], w[n+1])),
// dy through 1/A backwards: db_k = sum_n w[n] u[n-k] (k = 0, 1, 2) and
// da_k = -sum_n w[n] y[n-k] (k = 1, 2). w grows like 1/(1-r)^2 times dy at
// a pole of radius r, and so do those sums; du taken from w as b0 w[n] +
// b1 w[n+1] + b2 w[n+2] would cancel that growth and lose its digits
// (3.8e-5 of its peak at r = 0.9998 in float64), so du keeps its own
// recurrence. Taken in reverse order (stage k is section S-1-k), the
// sections' adjoints are again one linear time-invariant system, on 4S
// states a row: per stage, du's TDF-II pair (entries 4k, 4k+1) and w's pair
// (4k+2, 4k+3), both driven by the stage's input, the cotangent of the
// section's output; w's matrix is M transposed. The backward takes the
// forward's three passes on it, plus a reduction:
//
//   1. adjoint_pass<false>: a block per row and chunk, in reversed time;
//      reads the chunk of dy once and runs every stage from a zero state,
//      du's and w's block scans side by side; writes the chunk's 4S end
//      state. One more block a row squares the 4S x 4S matrix.
//   2. cascade_carries on the 4S-vector (24 wide at six sections).
//   3. adjoint_pass<true>: reruns the chunk from its carry, rounds each
//      stage's du to float32 before the next stage, as the plain version
//      does, writes dx, and adds the five sums of every stage in float64
//      from u and y, which it reads from the forward's stages through
//      shared tiles (a signal is the output of one stage and the input of
//      the next); writes a partial per (section, row, chunk).
//   4. adjoint_sums: a row's partials added in chunk order, no atomics.
//
// 4S fits the carry's 32-wide state up to eight sections; more run in
// groups of eight, each group's du passed to the next through `work`. The
// least traffic is 36 bytes a sample (read x, the five stages, y and dy,
// write dx); this design reads dy twice, 40, 36 of them in the apply pass.
// Per sample and section it runs about 31 float64 instructions and six
// float32/float64 conversions over the two passes. What bounds it is the
// cascade's float64 work, run twice: w and the sums add little to the
// apply pass, but its loads did, a section's tile waited for between two
// sections' work; they are now copied with cp.async into a third tile
// while the section before runs (PERF.md).

#include "scan_common.cuh"

namespace {

// The forward's fused cascade (passes 1-3 at the top of this file) and the
// backward's (passes 1-4).
constexpr int kCoefs = 5;                         // per section and row: b0, b1, b2, a1, a2
constexpr int kCascadeThreads = 256;
constexpr int kCascadeWarps = kCascadeThreads / 32;
constexpr int kItems = 16;                        // samples a thread
constexpr int kChunk = kCascadeThreads * kItems;  // 4096 samples a block
constexpr int kMaxSections = 16;                  // the 2S-vector fits a warp
constexpr int kMaxState = 2 * kMaxSections;
constexpr int kGroup = kMaxState / 4;             // sections a backward group: 4 states each
constexpr int kLanePowers = 5;                    // M^(kItems 2^j) for lanes 2^j apart
constexpr int kCarryPowers = 6;                   // A^(kChunk 2^k) for chunks 2^k apart
constexpr unsigned kFull = 0xffffffffu;

// The chunk in shared memory, one float of padding every 32: a thread's
// kItems consecutive samples and a warp's 32 consecutive samples both fall
// in 32 distinct banks. A tile holds two samples more, positions kChunk and
// kChunk + 1: the backward's u and y before the chunk's first sample. Its
// size is rounded up to 16 bytes: the forward's section tables follow it in
// shared memory, and misaligned they cost the forward 1.3 % (PERF.md).
constexpr int kTile = ((kChunk + 1) + ((kChunk + 1) >> 5) + 1 + 3) / 4 * 4;
__device__ __forceinline__ int tile_index(int n) { return n + (n >> 5); }
static_assert(kTile * sizeof(float) >= 2 * kMaxState * kMaxState * sizeof(double),
              "a power block squares its matrices in the tile");

struct Vec2 {
  double v1;
  double v2;
};

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

// p^T v + w
__device__ __forceinline__ Vec2 affine_t(const Mat2& p, Vec2 v, Vec2 w) {
  return Vec2{fma(p.m11, v.v1, fma(p.m21, v.v2, w.v1)), fma(p.m12, v.v1, fma(p.m22, v.v2, w.v2))};
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

__device__ __forceinline__ double coef_at(const float* coef, int rows, int row, int s, int k) {
  return (double)__ldg(coef + ((int64_t)s * kCoefs + k) * rows + row);
}

__device__ __forceinline__ void fill_table(const float* coef, int rows, int row, int s,
                                           SectionTable& t) {
  const double b0 = coef_at(coef, rows, row, s, 0), b1 = coef_at(coef, rows, row, s, 1);
  const double b2 = coef_at(coef, rows, row, s, 2), a1 = coef_at(coef, rows, row, s, 3);
  const double a2 = coef_at(coef, rows, row, s, 4);
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

// Threads 0..sections-1 fill tab[] for the block's row.
__device__ __forceinline__ void load_sections(const float* coef, int rows, int row, int sections,
                                              SectionTable* tab) {
  const int s = threadIdx.x;
  if (s < sections) fill_table(coef, rows, row, s, tab[s]);
}

// A system's map over one sample, v[n] = A v[n-1] + B x[n], on a d-vector
// v, and its powers: powers[k] = A^(kChunk 2^k), d x d row-major, for k <
// kCarryPowers. entry(i, j) is A's entry (i, j), which carries state j
// before a sample into state i after it. A block of the chunk pass's first
// wave computes them, so that the carry pass does not wait on 17 dependent
// squarings. m: 2 d^2 doubles of shared memory.
template <class Entry>
__device__ void cascade_powers(int d, Entry entry, double* m, double* powers) {
  const int dd = d * d;
  for (int idx = threadIdx.x; idx < dd; idx += kCascadeThreads) m[idx] = entry(idx / d, idx % d);
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
// through the tile, so that a warp stores 32 consecutive floats. With
// kReversed, the thread's values sit at positions counted from the chunk's
// end: position r is out[kChunk - 1 - r].
template <bool kReversed = false>
__device__ __forceinline__ void store_chunk(const double (&u)[kItems], float* tile, float* out,
                                            int64_t n_valid) {
  __syncthreads();  // the tile's last readers are done
#pragma unroll
  for (int i = 0; i < kItems; ++i) tile[tile_index(threadIdx.x * kItems + i)] = (float)u[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int r = threadIdx.x + i * kCascadeThreads;
    const int n = kReversed ? kChunk - 1 - r : r;
    if (n < n_valid) out[n] = tile[tile_index(r)];
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
    // Entry (i, j) carries state j before a sample into state i after it.
    // Section s's own block is M. Its input holds the s1 of each earlier
    // section k (y_k = b0_k u_k + s1_k) times the b0 of the sections
    // between, and enters (s1, s2) through (b1 - a1 b0, b2 - a2 b0).
    auto cf = [&](int s, int k) { return coef_at(coef, rows, row, s, k); };
    auto entry = [&](int i, int j) {
      const int s = i >> 1, k = j >> 1;
      double a = 0.0;
      if (k == s) {
        a = (i & 1) ? ((j & 1) ? 0.0 : -cf(s, 4)) : ((j & 1) ? 1.0 : -cf(s, 3));
      } else if (k < s && !(j & 1)) {
        double g = 1.0;
        for (int q = k + 1; q < s; ++q) g *= cf(q, 0);
        const double b0 = cf(s, 0);
        a = g * ((i & 1) ? cf(s, 2) - cf(s, 4) * b0 : cf(s, 1) - cf(s, 3) * b0);
      }
      return a;
    };
    const int d = 2 * sections;
    cascade_powers(d, entry, reinterpret_cast<double*>(tile),
                   powers + (int64_t)row * kCarryPowers * d * d);
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

// Scan levels of cascade_carries at state width kD: as many as 48 KB of
// static shared memory holds, at most kCarryPowers.
__host__ __device__ constexpr int carry_levels(int d) {
  int levels = kCarryPowers;
  while (levels > 1 &&
         (levels * d * d + 2 * (1 << levels) * d + d) * (int)sizeof(double) > 48 * 1024) {
    --levels;
  }
  return levels;
}

// Pass 2, a block per row: carries[row, c] = the d-vector entering chunk c.
// The state after chunk c is w[c] = A^kChunk w[c-1] + ends[c]. The block
// takes the row's chunks kScan at a time: the first end of a tile gets
// A^kChunk times the state entering the tile, then a Hillis-Steele scan
// over the tile adds, at span 2^k, A^(kChunk 2^k) times the state 2^k
// chunks before. kD >= d is the state's width padded for unrolled loops
// (12 for the forward of the console's six sections, 24 for their
// backward); entries past d stay 0.
template <int kD>
__global__ void __launch_bounds__(kCascadeThreads)
cascade_carries(int d, const double* __restrict__ ends, const double* __restrict__ powers,
                double* __restrict__ carries, int n_chunks) {
  static_assert(kD % 2 == 0 && kD <= kMaxState, "the state fits a warp");
  constexpr int kLevels = carry_levels(kD);
  constexpr int kScan = 1 << kLevels;  // chunks a scan
  __shared__ double pw[kLevels][kD * kD];
  __shared__ double w[2][kScan * kD];
  __shared__ double cin[kD];
  const int row = blockIdx.x;
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

cudaError_t launch_carries(int d, const double* ends, const double* powers, double* carries,
                           int rows, int n_chunks, cudaStream_t st) {
  if (d <= 12) {
    cascade_carries<12><<<rows, kCascadeThreads, 0, st>>>(d, ends, powers, carries, n_chunks);
  } else if (d <= 24) {
    cascade_carries<24><<<rows, kCascadeThreads, 0, st>>>(d, ends, powers, carries, n_chunks);
  } else {
    cascade_carries<kMaxState><<<rows, kCascadeThreads, 0, st>>>(d, ends, powers, carries,
                                                                 n_chunks);
  }
  return cudaGetLastError();
}

// The backward's two recurrences of one stage: du's TDF-II pair (p, matrix
// M) and w's (q, matrix M^T).
struct Pair {
  Vec2 p, q;
};

// A 4-byte copy from device to shared memory that the thread does not wait
// for (cp.async, sm_80 and later), and the wait for all of the thread's.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// tile[r] = v[t0 + kChunk - 1 - r] for r < count (the chunk in reversed
// time, then the samples before it), 0 outside [0, T). v: the row. The
// copies are asynchronous: they have landed after the thread's next
// cp_async_wait_all() and are seen by the block after a sync that follows.
__device__ __forceinline__ void load_reversed(const float* v, int64_t t0, int64_t T, int count,
                                              float* tile) {
  for (int r = threadIdx.x; r < count; r += kCascadeThreads) {
    const int64_t n = t0 + kChunk - 1 - r;
    if (n >= 0 && n < T) {
      cp_async4(tile + tile_index(r), v + n);
    } else {
      tile[tile_index(r)] = 0.0f;
    }
  }
}

// The states entering this thread of a stage's two recurrences, from
// `start` at the chunk's first sample, given `part`, the states after the
// thread's kItems samples from zero: the forward's block scan, for both
// pairs at once. ends: kCascadeWarps warp ends, free until the sync here.
// Every thread of the block calls it.
__device__ __forceinline__ Pair enter_thread(const SectionTable& c, Pair part, Pair start,
                                             Pair* ends) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Pair inc = part;
#pragma unroll
  for (int j = 0; j < kLanePowers; ++j) {
    const Vec2 op = shfl_up2(inc.p, 1 << j), oq = shfl_up2(inc.q, 1 << j);
    if (lane >= (1 << j)) {
      inc.p = affine(c.pow[j], op, inc.p);
      inc.q = affine_t(c.pow[j], oq, inc.q);
    }
  }
  Vec2 ep = shfl_up2(inc.p, 1), eq = shfl_up2(inc.q, 1);
  if (lane == 0) ep = eq = Vec2{0.0, 0.0};
  if (lane == 31) ends[warp] = inc;
  __syncthreads();
  Pair v = start;
  for (int w = 0; w < warp; ++w) {
    v.p = affine(c.pow[kLanePowers], v.p, ends[w].p);
    v.q = affine_t(c.pow[kLanePowers], v.q, ends[w].q);
  }
#pragma unroll
  for (int j = 0; j < kLanePowers; ++j) {
    if ((lane >> j) & 1) {
      v.p = affine(c.pow[j], v.p, Vec2{0.0, 0.0});
      v.q = affine_t(c.pow[j], v.q, Vec2{0.0, 0.0});
    }
  }
  v.p = Vec2{v.p.v1 + ep.v1, v.p.v2 + ep.v2};
  v.q = Vec2{v.q.v1 + eq.v1, v.q.v2 + eq.v2};
  return v;
}

constexpr int kAdjSums = kCoefs;  // db0, db1, db2, da1, da2
// Dynamic shared memory of the backward's passes: one tile (the chunk
// pass), three (the apply pass: two being read, one being filled).
constexpr int kChunkPassSmem = kTile * sizeof(float);
constexpr int kApplyPassSmem = 3 * kTile * sizeof(float);

// The backward's passes 1 (kApply false) and 3 for one group of n_stages
// sections, s_hi down to s_hi - n_stages + 1 (stage k is section s_hi - k),
// on a grid of (rows, chunks) blocks, block j taking the chunk j-th from the
// row's end: time runs backwards. Pass 1's grid has one more chunk index in
// front, 0, whose blocks square the group's matrix into `powers`. din: the
// cotangent entering the group (dy, or the previous group's du). ends,
// carries: (rows, n_chunks, 4 n_stages) states. Pass 3 writes the group's
// du to dout and the stages' sums to partials ((sections, 5, n_chunks,
// rows)); x, stages and y (the forward's, (rows, T) and (sections - 1, rows,
// T)) give each section's u and output.
template <bool kApply>
__global__ void __launch_bounds__(kCascadeThreads)
adjoint_pass(const float* __restrict__ din, const float* __restrict__ x,
             const float* __restrict__ stages, const float* __restrict__ y,
             const float* __restrict__ coef, int rows, int64_t T, int sections, int s_hi,
             int n_stages, double* __restrict__ ends, double* __restrict__ powers,
             const double* __restrict__ carries, double* __restrict__ partials,
             float* __restrict__ dout) {
  extern __shared__ __align__(16) float tiles[];  // kChunkPassSmem or kApplyPassSmem
  __shared__ SectionTable tab[kGroup];
  __shared__ Pair warp_ends[2][kCascadeWarps];
  __shared__ double warp_sums[kApply ? kGroup : 1][kCascadeWarps][kAdjSums];
  const int row = blockIdx.x;
  const int d = 4 * n_stages;
  if (!kApply && blockIdx.y == 0) {
    // Stage k's input e_k is b0 e_{k-1} + p1 of stage k - 1 (before the
    // sample), so it holds the p1 of each earlier stage j times the b0 of
    // the stages between; it enters p through (b1 - a1 b0, b2 - a2 b0) and
    // w[n] through 1. Within a stage: p by M, (w[n], w[n+1]) by M^T.
    auto cf = [&](int k, int c) { return coef_at(coef, rows, row, s_hi - k, c); };
    auto entry = [&](int i, int j) {
      const int si = i >> 2, sj = j >> 2, ri = i & 3, rj = j & 3;
      if (si == sj) {
        switch (ri * 4 + rj) {
          case 0: return -cf(si, 3);   // p1 <- p1
          case 1: return 1.0;          // p1 <- p2
          case 4: return -cf(si, 4);   // p2 <- p1
          case 10: return -cf(si, 3);  // w[n] <- w[n+1]
          case 11: return -cf(si, 4);  // w[n] <- w[n+2]
          case 14: return 1.0;         // w[n+1] <- w[n+1]
          default: return 0.0;
        }
      }
      if (sj > si || rj != 0 || ri == 3) return 0.0;
      double g = 1.0;
      for (int q = sj + 1; q < si; ++q) g *= cf(q, 0);
      const double b0 = cf(si, 0);
      return ri == 0 ? g * (cf(si, 1) - cf(si, 3) * b0)
                     : (ri == 1 ? g * (cf(si, 2) - cf(si, 4) * b0) : g);
    };
    cascade_powers(d, entry, reinterpret_cast<double*>(tiles),
                   powers + (int64_t)row * kCarryPowers * d * d);
    return;
  }
  const int j = blockIdx.y - (kApply ? 0 : 1);
  const int n_chunks = gridDim.y - (kApply ? 0 : 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t0 = (int64_t)(n_chunks - 1 - j) * kChunk;
  const int64_t n_valid = T - t0;
  const int64_t state0 = ((int64_t)row * n_chunks + j) * d;
  // section s's input: x, then the stages; section s's output: signal(s + 1)
  auto signal = [&](int s) {
    const float* v = s == 0 ? x : (s == sections ? y : stages + (int64_t)(s - 1) * rows * T);
    return v + (int64_t)row * T;
  };

  const int tid = threadIdx.x;
  if (tid < n_stages) fill_table(coef, rows, row, s_hi - tid, tab[tid]);
  // The apply pass's tiles: stage k reads its output from buf(k) and its
  // input u from buf(k + 1) while the next stage's u lands in buf(k + 2),
  // which stage k - 1 read before stage k's first sync. din passes through
  // buf(2) before stage 0 fills it.
  auto buf = [&](int k) { return tiles + (k % 3) * kTile; };
  float* const din_tile = kApply ? buf(2) : tiles;
  load_reversed(din + (int64_t)row * T, t0, T, kChunk, din_tile);
  if constexpr (kApply) {
    load_reversed(signal(s_hi + 1), t0, T, kChunk + 2, buf(0));
    load_reversed(signal(s_hi), t0, T, kChunk + 2, buf(1));
  }
  cp_async_wait_all();
  __syncthreads();
  double e[kItems];  // this thread's samples in reversed time: a stage's input, then its du
#pragma unroll
  for (int i = 0; i < kItems; ++i) e[i] = (double)din_tile[tile_index(threadIdx.x * kItems + i)];

  for (int k = 0; k < n_stages; ++k) {
    const SectionTable& c = tab[k];
    const double b0 = c.b0, beta1 = c.beta1, beta2 = c.beta2, a1 = c.a1, a2 = c.a2;
    Pair part{{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const Vec2 p = part.p, q = part.q;
      part.p = Vec2{fma(-a1, p.v1, fma(beta1, e[i], p.v2)), fma(-a2, p.v1, beta2 * e[i])};
      part.q = Vec2{fma(-a1, q.v1, fma(-a2, q.v2, e[i])), q.v1};
    }
    Pair start{{0.0, 0.0}, {0.0, 0.0}};
    if constexpr (kApply) {
      const double* cr = carries + state0 + 4 * k;
      start = Pair{{__ldg(cr), __ldg(cr + 1)}, {__ldg(cr + 2), __ldg(cr + 3)}};
    }
    // two buffers: stage k + 2 writes this one after stage k + 1's sync
    const Pair st = enter_thread(c, part, start, warp_ends[k & 1]);
    if constexpr (!kApply) {
      if (threadIdx.x == kCascadeThreads - 1) {  // the chunk's end state
        const Vec2 ep = affine(c.pow[0], st.p, part.p), eq = affine_t(c.pow[0], st.q, part.q);
        double* out = ends + state0 + 4 * k;
        out[0] = ep.v1;
        out[1] = ep.v2;
        out[2] = eq.v1;
        out[3] = eq.v2;
      }
      if (k == n_stages - 1) break;  // the last stage's du is not needed
      Vec2 v = st.p;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const double out = fma(b0, e[i], v.v1);
        v = Vec2{fma(-a1, v.v1, fma(beta1, e[i], v.v2)), fma(-a2, v.v1, beta2 * e[i])};
        e[i] = (double)(float)out;  // rounded between sections
      }
    } else {
      if (k + 1 < n_stages) load_reversed(signal(s_hi - k - 1), t0, T, kChunk + 2, buf(k + 2));
      // u at reversed positions r, r + 1, r + 2 is u[n], u[n-1], u[n-2]
      const float* ut = buf(k + 1);
      const float* ot = buf(k);
      const int r0 = threadIdx.x * kItems;
      double u0 = ut[tile_index(r0)], u1 = ut[tile_index(r0 + 1)], o1 = ot[tile_index(r0 + 1)];
      double sums[kAdjSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
      Vec2 v = st.p, w = st.q;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const double u2 = ut[tile_index(r0 + i + 2)], o2 = ot[tile_index(r0 + i + 2)];
        const double wn = fma(-a1, w.v1, fma(-a2, w.v2, e[i]));
        w = Vec2{wn, w.v1};
        sums[0] = fma(wn, u0, sums[0]);
        sums[1] = fma(wn, u1, sums[1]);
        sums[2] = fma(wn, u2, sums[2]);
        sums[3] = fma(-wn, o1, sums[3]);
        sums[4] = fma(-wn, o2, sums[4]);
        const double out = fma(b0, e[i], v.v1);
        v = Vec2{fma(-a1, v.v1, fma(beta1, e[i], v.v2)), fma(-a2, v.v1, beta2 * e[i])};
        e[i] = (double)(float)out;  // rounded between sections
        u0 = u1;
        u1 = u2;
        o1 = o2;
      }
#pragma unroll
      for (int m = 0; m < kAdjSums; ++m) {
        double acc = sums[m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off);
        if (lane == 0) warp_sums[k][warp][m] = acc;
      }
      cp_async_wait_all();  // the next stage's sync shows the next u to the block
    }
  }
  if constexpr (kApply) {
    store_chunk<true>(e, buf(0), dout + (int64_t)row * T + t0, n_valid);  // syncs first
    if (tid < kAdjSums * n_stages) {  // the block's sums, warps in order
      const int k = tid / kAdjSums, m = tid % kAdjSums;
      double acc = 0.0;
      for (int w = 0; w < kCascadeWarps; ++w) acc += warp_sums[k][w][m];
      partials[(((int64_t)(s_hi - k) * kAdjSums + m) * n_chunks + j) * rows + row] = acc;
    }
  }
}

// Pass 4: dcoef[s, m, row] = the sum of partials[s, m, :, row], added in
// chunk order; a thread a sum, neighbours on neighbouring rows.
__global__ void adjoint_sums(const double* __restrict__ partials, float* __restrict__ dcoef,
                             int rows, int n_chunks, int sections) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= sections * kAdjSums * rows) return;
  const int sm = idx / rows, row = idx % rows;  // sm = s * 5 + m
  const double* p = partials + (int64_t)sm * n_chunks * rows + row;
  double acc = 0.0;
#pragma unroll 8
  for (int c = 0; c < n_chunks; ++c) acc += __ldg(p + (int64_t)c * rows);
  dcoef[idx] = (float)acc;
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
  err = launch_carries((int)d, ends, powers, carries, rows, n_chunks, st);
  if (err != cudaSuccess) return (int)err;
  mark(2);
  cascade_pass<true><<<dim3(rows, n_chunks), kCascadeThreads, 0, st>>>(
      x, coef, rows, T, sections, nullptr, nullptr, carries, stages, y);
  err = cudaGetLastError();
  mark(3);
  return (int)err;
}

// ends and carries ((rows, chunks, 4G) each) and powers ((rows,
// kCarryPowers, 4G, 4G)) for a group of G = min(sections, kGroup), reused by
// every group, and the partial sums ((sections, 5, chunks, rows)), in doubles.
extern "C" long long diffmst_sosfilt_backward_scratch_bytes(int rows, long long T, int sections) {
  const long long d = 4LL * (sections < kGroup ? sections : kGroup);
  const long long c = cascade_chunks(T);
  return rows * (2LL * c * d + kCarryPowers * d * d + (long long)sections * c * kAdjSums) *
         (long long)sizeof(double);
}

// From the forward's input x, stages ((sections - 1, rows, T)) and output
// y, and the output's cotangent dy: dx, and dcoef (sections, 5, rows), the
// cotangents of b0, b1, b2, a1, a2. Sections run in groups of kGroup from
// the last: three launches a group and one for the sums, four at up to
// kGroup sections. `work` ((rows, T)) holds a group's du for the next
// group; the groups' outputs alternate between it and dx, so that the last
// lands in dx (null at up to kGroup sections). events: null, or, at up to
// kGroup sections, five CUDA events recorded before the first launch and
// after each.
extern "C" int diffmst_sosfilt_backward(const float* x, const float* stages, const float* y,
                                        const float* coef, const float* dy, float* dx,
                                        float* work, float* dcoef, void* scratch, int rows,
                                        long long T, int sections, void* stream,
                                        void* const* events) {
  const int n_chunks = cascade_chunks(T);
  const int groups = (sections + kGroup - 1) / kGroup;
  if (sections < 1 || sections > kMaxSections || n_chunks >= 65535 ||
      (groups > 1 && (work == nullptr || events != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long dmax = 4LL * (sections < kGroup ? sections : kGroup);
  double* ends = static_cast<double*>(scratch);
  double* carries = ends + rows * n_chunks * dmax;
  double* powers = carries + rows * n_chunks * dmax;
  double* partials = powers + rows * kCarryPowers * dmax * dmax;
  auto mark = [&](int k) {
    if (events != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(events[k]), st);
  };
  mark(0);
  const float* din = dy;
  for (int g = 0; g < groups; ++g) {
    const int s_hi = sections - 1 - g * kGroup;
    const int n_stages = s_hi + 1 < kGroup ? s_hi + 1 : kGroup;
    float* dout = (groups - 1 - g) % 2 == 1 ? work : dx;
    adjoint_pass<false><<<dim3(rows, n_chunks + 1), kCascadeThreads, kChunkPassSmem, st>>>(
        din, x, stages, y, coef, rows, T, sections, s_hi, n_stages, ends, powers, nullptr,
        nullptr, nullptr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mark(1);
    err = launch_carries(4 * n_stages, ends, powers, carries, rows, n_chunks, st);
    if (err != cudaSuccess) return (int)err;
    mark(2);
    err = cudaFuncSetAttribute(adjoint_pass<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kApplyPassSmem);
    if (err != cudaSuccess) return (int)err;
    adjoint_pass<true><<<dim3(rows, n_chunks), kCascadeThreads, kApplyPassSmem, st>>>(
        din, x, stages, y, coef, rows, T, sections, s_hi, n_stages, nullptr, nullptr, carries,
        partials, dout);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mark(3);
    din = dout;
  }
  adjoint_sums<<<(sections * kAdjSums * rows + 127) / 128, 128, 0, st>>>(partials, dcoef, rows,
                                                                        n_chunks, sections);
  const cudaError_t err = cudaGetLastError();
  mark(4);
  return (int)err;
}
