// K1: y[n] = a * y[n-1] + b[n] along time over (rows, T) float32 rows, from
// y[-1] = 0, with `a` per row (alpha: (rows,)) or per sample (alpha: (rows, T),
// K4), and its backward; and K3, the release stage of the decoupled
// compressor, y[n] = min(g[n], a * y[n-1] + (1 - a) * g[n]) from y[-1] = 0 dB,
// and its backward.
//
// Replaces the Pallas kernels diffmst_tpu/kernels/scan1p.py::onepole_core
// (pallas_call at scan1p.py:111) and ::minscan_core (pallas_call at
// scan1p.py:253), the reverse-time launches of onepole_core in the VJPs of
// onepole_scan (scan1p.py:142-150) and onepole_scan_tv (K4,
// scan1p.py:176-187), and the VJP of release_min_scan (scan1p.py:294-297),
// which recomputed the min-scan through XLA. Memory-bound: the least traffic
// of K1's forward is read b + write y, 8 bytes a sample (12 with a
// per-sample alpha); of its backward read dy + read y + write db, 12 bytes a
// sample (20 with a per-sample alpha, which also reads alpha and writes
// dalpha). K3 reads g and writes y, 8 bytes a sample; its backward reads dy,
// y and g and writes dg, 16 bytes a sample.
//
// Every one of these kernels, with a row's or a per-sample alpha, is one
// kernel and one cudaMemsetAsync a call: the single-pass scan with decoupled
// look-back of lookback.cuh, which reads every input once. A block stages a
// tile of 256 x kItems samples of its inputs in shared memory by cp.async,
// scans it in float64 from zero, takes the state entering it from the tiles
// before it and writes its outputs over inputs in the tile, then to device
// memory. K1 and K1's backward carry one word a tile, b (the multiplicative
// part is alpha to the tile's length, which each reader computes); K3 two,
// d and c. Where the coefficient varies by sample, a tile's multiplicative
// part is the product of its samples' coefficients and is carried as a
// second word (GatedAffine): K3's backward (a * L[n+1]), K4 (alpha[n]) and
// K4's backward (alpha[n+1]). The backward kernels walk the tiles from the
// row's end; K1's and K3's add the row's dalpha partials in its last tile,
// K4's writes dalpha per sample in alpha's staged slot. On an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md, section 6): K4 takes 0.052 ms at 32 x 262,144
// (1.9 TB/s; the three-pass scan it replaced, 0.134), K4's backward 0.044 ms
// at 32 x 131,072 (1.9 TB/s; 0.124).

#include "lookback.cuh"

namespace {

namespace lookback = diffmst::lookback;

// Samples a thread of the single-pass kernels (a tile is 256 times as many),
// and the blocks an SM must hold, which caps the registers. K1 and K3 stage
// one array, 16 KB a tile; K4 and K1's backward two; K3's and K4's backward
// three, 48 KB.
constexpr int kScanItems = 16;
constexpr int kScanMinBlocks = 4;

// K1 with a row's alpha on the look-back: b staged, y written in its place.
struct OnepoleTileOp {
  using Map = diffmst::Affine;
  using Tile = lookback::Tile<kScanItems>;
  static constexpr bool kReverse = false;
  static constexpr int kItems = kScanItems, kMinBlocks = kScanMinBlocks;
  static constexpr int kIn = 1, kEarly = 1, kOut = 1;
  const float* b;
  const float* alpha;  // (rows,)
  float* y;

  bool aligned(int64_t T) const {
    return T % 4 == 0 && lookback::aligned16(b) && lookback::aligned16(y);
  }

  __device__ __forceinline__ const float* input(int) const { return b; }
  __device__ __forceinline__ float* output(int) const { return y; }
  __device__ __forceinline__ static int out_slot(int) { return 0; }
  __device__ __forceinline__ float params(int row) const { return __ldg(alpha + row); }
  __device__ __forceinline__ double pole(float a) const { return a; }
  __device__ __forceinline__ diffmst::Affine step(float a, float bv) const {
    return diffmst::Affine{a, bv};
  }
  __device__ __forceinline__ void prepare(float, const Tile& tile, int i0,
                                          float (&bv)[kItems]) const {
    tile.read(0, i0, bv);
  }
  __device__ __forceinline__ void finish(float, const Tile& tile, int, int64_t, int i0, int,
                                         const float (&yv)[kItems]) const {
    tile.write(0, i0, yv);
  }
};

// K3 on the look-back: g staged, y written in its place. The map of sample
// n is y -> min(g, a*y + (1-a)*g), a MinAffine composed in double.
struct MinScanTileOp {
  using Map = diffmst::MinAffine;
  using Tile = lookback::Tile<kScanItems>;
  static constexpr bool kReverse = false;
  static constexpr int kItems = kScanItems, kMinBlocks = kScanMinBlocks;
  static constexpr int kIn = 1, kEarly = 1, kOut = 1;
  const float* g;
  const float* alpha;  // (rows,)
  float* y;

  bool aligned(int64_t T) const {
    return T % 4 == 0 && lookback::aligned16(g) && lookback::aligned16(y);
  }

  __device__ __forceinline__ const float* input(int) const { return g; }
  __device__ __forceinline__ float* output(int) const { return y; }
  __device__ __forceinline__ static int out_slot(int) { return 0; }
  __device__ __forceinline__ double params(int row) const { return __ldg(alpha + row); }
  __device__ __forceinline__ double pole(double a) const { return a; }
  __device__ __forceinline__ diffmst::MinAffine step(double a, float gf) const {
    const double gv = gf;
    return diffmst::MinAffine{a, (1.0 - a) * gv, gv};
  }
  __device__ __forceinline__ void prepare(double, const Tile& tile, int i0,
                                          float (&gv)[kItems]) const {
    tile.read(0, i0, gv);
  }
  __device__ __forceinline__ void finish(double, const Tile& tile, int, int64_t, int i0, int,
                                         const float (&yv)[kItems]) const {
    tile.write(0, i0, yv);
  }
};

// K4, K1 with a per-sample alpha, on the look-back: b and alpha staged, y
// written in b's place. Sample n's map is y -> alpha[n]*y + b[n]: prepare()
// gives alpha[n] as its coefficient, so a tile's map is a GatedAffine whose
// multiplicative part is the product of its alphas, carried as two words.
struct OnepoleTvTileOp {
  using Map = lookback::GatedAffine;
  using Tile = lookback::Tile<kScanItems>;
  static constexpr bool kReverse = false, kCoef = true;
  static constexpr int kItems = kScanItems, kMinBlocks = kScanMinBlocks;
  static constexpr int kIn = 2, kEarly = 2, kOut = 1;
  const float* b;
  const float* alpha;  // (rows, T)
  float* y;

  bool aligned(int64_t T) const {
    return T % 4 == 0 && lookback::aligned16(b) && lookback::aligned16(alpha) &&
           lookback::aligned16(y);
  }

  __device__ __forceinline__ const float* input(int a) const { return a == 0 ? b : alpha; }
  __device__ __forceinline__ float* output(int) const { return y; }
  __device__ __forceinline__ static int out_slot(int) { return 0; }
  // no per-row parameter; the pole is unused: the carry publishes the
  // multiplicative part
  __device__ __forceinline__ float params(int) const { return 0.0f; }
  __device__ __forceinline__ double pole(float) const { return 1.0; }
  __device__ __forceinline__ lookback::GatedAffine step(float, float bv, float c) const {
    return {diffmst::Affine{c, bv}};
  }
  __device__ __forceinline__ void prepare(float, const Tile& tile, int, int64_t, int i0,
                                          float (&bv)[kItems], float (&c)[kItems]) const {
    tile.read(0, i0, bv);
    tile.read(1, i0, c);
  }
  __device__ __forceinline__ void finish(float, const Tile& tile, int, int64_t, int i0, int,
                                         const float (&yv)[kItems]) const {
    tile.write(0, i0, yv);
  }
};

// K1's backward with a row's alpha on the look-back, run backwards in time:
// s[n] = dy[n] + a * s[n+1] from s[T] = 0; db = s and dalpha = sum_n s[n] *
// y[n-1] (y[-1] = 0), a row sum. dy staged before the scan, y after; db
// written in dy's place. y[n-1] of a tile's first sample is the tile
// before's last, read from device memory.
struct OnepoleBackwardTileOp {
  using Map = diffmst::Affine;
  using Tile = lookback::Tile<kScanItems>;
  static constexpr bool kReverse = true;
  static constexpr int kSums = 1;
  static constexpr int kItems = kScanItems, kMinBlocks = kScanMinBlocks;
  static constexpr int kIn = 2, kEarly = 1, kOut = 1;
  const float* dy;
  const float* alpha;  // (rows,)
  const float* y;
  float* db;
  int64_t T;

  bool aligned() const {
    return T % 4 == 0 && lookback::aligned16(dy) && lookback::aligned16(y) &&
           lookback::aligned16(db);
  }

  __device__ __forceinline__ const float* input(int a) const { return a == 0 ? dy : y; }
  __device__ __forceinline__ float* output(int) const { return db; }
  __device__ __forceinline__ static int out_slot(int) { return 0; }
  __device__ __forceinline__ float params(int row) const { return __ldg(alpha + row); }
  __device__ __forceinline__ double pole(float a) const { return a; }
  __device__ __forceinline__ diffmst::Affine step(float a, float d) const {
    return diffmst::Affine{a, d};
  }
  __device__ __forceinline__ void prepare(float, const Tile& tile, int i0,
                                          float (&d)[kItems]) const {
    tile.read(0, i0, d);
  }
  __device__ __forceinline__ void finish(float, const Tile& tile, int row, int64_t t, int i0,
                                         int n, const float (&s)[kItems], double* sums) const {
    float yv[kItems];
    tile.read(1, i0, yv);
    const float y_before =
        i0 > 0 ? tile.get(1, i0 - 1) : (t > 0 ? __ldg(y + (int64_t)row * T + t - 1) : 0.0f);
    float part = 0.0f;  // the thread's items in float, the threads and tiles in double
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (i < n) part += s[i] * (i > 0 ? yv[i - 1] : y_before);
    }
    sums[0] += (double)part;
    tile.write(0, i0, s);
  }
};

// K4's backward, the adjoint of the one-pole with a per-sample alpha, on the
// look-back, run backwards in time: s[n] = dy[n] + alpha[n+1] * s[n+1] from
// s[T] = 0; db = s and dalpha[n] = s[n] * y[n-1] (y[-1] = 0), per sample.
// dy and alpha staged before the scan, y after. A sample's coefficient is
// the next sample's alpha: past the thread's last item from the tile, past
// the tile's end from device memory. The row's last sample's multiplies the
// zero state and is moot: it is 0, read from nowhere. A tile's map is a
// GatedAffine, as K4's. db written in dy's place and dalpha in alpha's: the
// barriers after the block scan and the look-back keep every prepare()'s
// reads of alpha before any finish() writes there. y[n-1] of a tile's first
// sample is the tile before's last, read from device memory.
struct OnepoleTvBackwardTileOp {
  using Map = lookback::GatedAffine;
  using Tile = lookback::Tile<kScanItems>;
  static constexpr bool kReverse = true, kCoef = true;
  static constexpr int kItems = kScanItems, kMinBlocks = kScanMinBlocks;
  static constexpr int kIn = 3, kEarly = 2, kOut = 2;
  const float* dy;
  const float* alpha;  // (rows, T)
  const float* y;
  float* db;
  float* dalpha;  // (rows, T)
  int64_t T;

  bool aligned() const {
    return T % 4 == 0 && lookback::aligned16(dy) && lookback::aligned16(alpha) &&
           lookback::aligned16(y) && lookback::aligned16(db) && lookback::aligned16(dalpha);
  }

  __device__ __forceinline__ const float* input(int a) const {
    return a == 0 ? dy : a == 1 ? alpha : y;
  }
  __device__ __forceinline__ float* output(int o) const { return o == 0 ? db : dalpha; }
  __device__ __forceinline__ static int out_slot(int o) { return o; }
  __device__ __forceinline__ float params(int) const { return 0.0f; }
  __device__ __forceinline__ double pole(float) const { return 1.0; }
  __device__ __forceinline__ lookback::GatedAffine step(float, float d, float c) const {
    return {diffmst::Affine{c, d}};
  }

  __device__ __forceinline__ void prepare(float, const Tile& tile, int row, int64_t t, int i0,
                                          float (&d)[kItems], float (&c)[kItems]) const {
    float av[kItems];
    tile.read(0, i0, d);
    tile.read(1, i0, av);
    // samples of the thread that have a next one in the row
    const int64_t with_next = T - 1 - t;
    const float a_after = with_next < kItems ? 0.0f
                          : i0 + kItems < Tile::kTile
                              ? tile.get(1, i0 + kItems)
                              : __ldg(alpha + (int64_t)row * T + t + kItems);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const float a_next = i + 1 < kItems ? av[i + 1] : a_after;
      c[i] = i < with_next ? a_next : 0.0f;
    }
  }

  __device__ __forceinline__ void finish(float, const Tile& tile, int row, int64_t t, int i0,
                                         int, const float (&s)[kItems]) const {
    float v[kItems];  // y, then dalpha in its place from the last item down
    tile.read(2, i0, v);
    const float y_before =
        i0 > 0 ? tile.get(2, i0 - 1) : (t > 0 ? __ldg(y + (int64_t)row * T + t - 1) : 0.0f);
#pragma unroll
    for (int i = kItems - 1; i >= 0; --i) v[i] = s[i] * (i > 0 ? v[i - 1] : y_before);
    tile.write(0, i0, s);
    tile.write(1, i0, v);
  }
};

// K3's backward on the look-back, run backwards in time. y[n] took the
// linear branch a*y[n-1] + (1-a)*g[n] where L[n] = y[n-1] < g[n] (y[-1] =
// 0), and is g[n] otherwise: a tie takes the clamp. The adjoint is a reverse
// one-pole whose coefficient a * L[n+1] is 0 wherever the next sample took
// the clamp: s[n] = dy[n] + a L[n+1] s[n+1]; then dg[n] = s[n] * ((1-a)
// L[n] + 1 - L[n]) and dalpha = sum_n s[n] L[n] (y[n-1] - g[n]), a row sum.
// The branch masks come from the forward's output y. dy, g and y are staged
// before the scan: prepare() gives each sample's coefficient, which needs g
// one sample past the thread's last (past the tile's end, from device
// memory). A tile's map is then a GatedAffine, its multiplicative part a
// product of alphas and zeros, carried as two words. dg written in dy's
// place.
struct MinScanBackwardTileOp {
  using Map = lookback::GatedAffine;
  using Tile = lookback::Tile<kScanItems>;
  static constexpr bool kReverse = true, kCoef = true;
  static constexpr int kSums = 1;
  static constexpr int kItems = kScanItems, kMinBlocks = kScanMinBlocks;
  static constexpr int kIn = 3, kEarly = 3, kOut = 1;
  const float* dy;
  const float* g;
  const float* alpha;  // (rows,)
  const float* y;
  float* dg;
  int64_t T;

  bool aligned() const {
    return T % 4 == 0 && lookback::aligned16(dy) && lookback::aligned16(g) &&
           lookback::aligned16(y) && lookback::aligned16(dg);
  }

  __device__ __forceinline__ const float* input(int a) const {
    return a == 0 ? dy : a == 1 ? g : y;
  }
  __device__ __forceinline__ float* output(int) const { return dg; }
  __device__ __forceinline__ static int out_slot(int) { return 0; }
  __device__ __forceinline__ float params(int row) const { return __ldg(alpha + row); }
  // unused: the carry publishes the multiplicative part
  __device__ __forceinline__ double pole(float a) const { return a; }
  __device__ __forceinline__ lookback::GatedAffine step(float, float d, float c) const {
    return {diffmst::Affine{c, d}};
  }

  __device__ __forceinline__ void prepare(float a, const Tile& tile, int row, int64_t t, int i0,
                                          float (&d)[kItems], float (&c)[kItems]) const {
    float gv[kItems], yv[kItems];
    tile.read(0, i0, d);
    tile.read(1, i0, gv);
    tile.read(2, i0, yv);
    // samples of the thread that have a next one in the row; the last
    // sample's coefficient multiplies the zero state and is moot
    const int64_t with_next = T - 1 - t;
    const float g_after = with_next < kItems ? 0.0f
                          : i0 + kItems < Tile::kTile
                              ? tile.get(1, i0 + kItems)
                              : __ldg(g + (int64_t)row * T + t + kItems);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const float g_next = i + 1 < kItems ? gv[i + 1] : g_after;
      c[i] = i < with_next && yv[i] < g_next ? a : 0.0f;  // a * L[n+1]
    }
  }

  __device__ __forceinline__ void finish(float a, const Tile& tile, int row, int64_t t, int i0,
                                         int n, const float (&s)[kItems], double* sums) const {
    float gv[kItems], yv[kItems];
    tile.read(1, i0, gv);
    tile.read(2, i0, yv);
    const float y_before =
        i0 > 0 ? tile.get(2, i0 - 1) : (t > 0 ? __ldg(y + (int64_t)row * T + t - 1) : 0.0f);
    float part = 0.0f;  // the thread's items in float, the threads and tiles in double
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const float yp = i > 0 ? yv[i - 1] : y_before;
      const bool linear = yp < gv[i];  // L[n]
      if (i < n && linear) part += s[i] * (yp - gv[i]);
      gv[i] = linear ? (1.0f - a) * s[i] : s[i];  // dg
    }
    sums[0] += (double)part;
    tile.write(0, i0, gv);
  }
};

}  // namespace

// The scratch of one diffmst_onepole_core call, with a row's or a
// per-sample alpha.
extern "C" long long diffmst_onepole_scratch_bytes(int rows, long long T, int alpha_per_sample) {
  return alpha_per_sample ? lookback::scratch_bytes<OnepoleTvTileOp>(rows, T)
                          : lookback::scratch_bytes<OnepoleTileOp>(rows, T);
}

extern "C" int diffmst_onepole_core(const float* b, const float* alpha, int alpha_per_sample,
                                    float* y, void* scratch, int rows, long long T,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (alpha_per_sample) {
    const OnepoleTvTileOp op{b, alpha, y};
    return lookback::scan_rows(op, op.aligned(T), scratch, rows, T, s);
  }
  const OnepoleTileOp op{b, alpha, y};
  return lookback::scan_rows(op, op.aligned(T), scratch, rows, T, s);
}

// The scratch of one diffmst_onepole_backward call, as for the forward.
extern "C" long long diffmst_onepole_backward_scratch_bytes(int rows, long long T,
                                                          int alpha_per_sample) {
  return alpha_per_sample ? lookback::scratch_bytes<OnepoleTvBackwardTileOp>(rows, T)
                          : lookback::scratch_bytes<OnepoleBackwardTileOp>(rows, T);
}

// dalpha: (rows,) for a row's alpha, (rows, T) for a per-sample one.
extern "C" int diffmst_onepole_backward(const float* dy, const float* alpha, int alpha_per_sample,
                                        const float* y, float* db, float* dalpha, void* scratch,
                                        int rows, long long T, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (alpha_per_sample) {
    const OnepoleTvBackwardTileOp op{dy, alpha, y, db, dalpha, T};
    return lookback::scan_rows(op, op.aligned(), scratch, rows, T, s);
  }
  const OnepoleBackwardTileOp op{dy, alpha, y, db, T};
  return lookback::scan_rows(op, op.aligned(), scratch, rows, T, s, dalpha);
}

extern "C" long long diffmst_minscan_scratch_bytes(int rows, long long T) {
  return lookback::scratch_bytes<MinScanTileOp>(rows, T);
}

extern "C" int diffmst_release_min_scan(const float* g, const float* alpha, float* y,
                                        void* scratch, int rows, long long T, void* stream) {
  const MinScanTileOp op{g, alpha, y};
  return lookback::scan_rows(op, op.aligned(T), scratch, rows, T,
                             static_cast<cudaStream_t>(stream));
}

extern "C" long long diffmst_minscan_backward_scratch_bytes(int rows, long long T) {
  return lookback::scratch_bytes<MinScanBackwardTileOp>(rows, T);
}

// dalpha: (rows,), the row sums.
extern "C" int diffmst_release_min_scan_backward(const float* dy, const float* g,
                                                 const float* alpha, const float* y, float* dg,
                                                 float* dalpha, void* scratch, int rows,
                                                 long long T, void* stream) {
  const MinScanBackwardTileOp op{dy, g, alpha, y, dg, T};
  return lookback::scan_rows(op, op.aligned(), scratch, rows, T, static_cast<cudaStream_t>(stream),
                             dalpha);
}
