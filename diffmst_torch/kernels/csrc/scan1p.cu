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
// K1 with a row's alpha, K3 and their backward kernels are each one kernel
// and one cudaMemsetAsync a call: the single-pass scan with decoupled
// look-back of lookback.cuh, which reads every input once. A block stages a
// tile of 256 x kItems samples of its inputs in shared memory by cp.async,
// scans it in float64 from zero, takes the state entering it from the tiles
// before it (K1 and K1's backward carry one word, b; K3 two, d and c; K3's
// backward two, a and b: its coefficient a * L[n+1] varies by sample) and
// writes its output over an input in the tile, then to device memory. The
// backward kernels walk the tiles from the row's end, and the last tile of
// each row adds the row's dalpha partials. K4 (a per-sample alpha) and its
// backward stay on the three-pass chunked scan of scan_common.cuh, which
// reads the inputs twice (passes 1 and 3).

#include "lookback.cuh"

namespace {

namespace lookback = diffmst::lookback;

// Samples a thread of the single-pass kernels (a tile is 256 times as many),
// and the blocks an SM must hold, which caps the registers. The backward
// kernels stage two and three arrays, 32 and 48 KB a tile.
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

// K4 (alpha per sample) on the three-pass scan.
struct OnepoleOp {
  using Map = diffmst::Affine;
  const float* b;
  const float* alpha;  // (rows, T)
  float* y;
  int64_t T;

  __device__ __forceinline__ diffmst::Affine step(int row, int64_t t) const {
    const int64_t i = (int64_t)row * T + t;
    return diffmst::Affine{__ldg(alpha + i), __ldg(b + i)};
  }

  __device__ __forceinline__ void store(int row, int64_t t, float v) const {
    y[(int64_t)row * T + t] = v;
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
// three-pass scan, run backwards in time: s[n] = dy[n] + a[n+1] * s[n+1],
// walked as t = T-1-n; db = s and dalpha = s[n] * y[n-1], per sample. The
// first step (n = T-1) multiplies the zero state, so its coefficient is
// moot.
struct OnepoleBackwardOp {
  using Map = diffmst::Affine;
  const float* dy;
  const float* alpha;  // (rows, T)
  const float* y;
  float* db;
  float* dalpha;  // (rows, T)
  int64_t T;

  __device__ __forceinline__ diffmst::Affine step(int row, int64_t t) const {
    const int64_t n = T - 1 - t;
    const int64_t i = (int64_t)row * T + n;
    const float a = n + 1 < T ? __ldg(alpha + i + 1) : 1.0f;
    return diffmst::Affine{a, __ldg(dy + i)};
  }

  __device__ __forceinline__ void store(int row, int64_t t, float s) const {
    const int64_t n = T - 1 - t;
    const int64_t i = (int64_t)row * T + n;
    db[i] = s;
    dalpha[i] = s * (n > 0 ? __ldg(y + i - 1) : 0.0f);
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

// The scratch of one diffmst_onepole_core call: the look-back's with a row's
// alpha, the three-pass scan's with a per-sample one.
extern "C" long long diffmst_onepole_scratch_bytes(int rows, long long T, int alpha_per_sample) {
  return alpha_per_sample ? diffmst::scratch_bytes<OnepoleOp>(rows, T)
                          : lookback::scratch_bytes<OnepoleTileOp>(rows, T);
}

extern "C" int diffmst_onepole_core(const float* b, const float* alpha, int alpha_per_sample,
                                    float* y, void* scratch, int rows, long long T,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (alpha_per_sample) {
    return diffmst::scan_rows(OnepoleOp{b, alpha, y, T}, scratch, rows, T, s);
  }
  const OnepoleTileOp op{b, alpha, y};
  return lookback::scan_rows(op, op.aligned(T), scratch, rows, T, s);
}

// The scratch of one diffmst_onepole_backward call, as for the forward.
extern "C" long long diffmst_onepole_backward_scratch_bytes(int rows, long long T,
                                                          int alpha_per_sample) {
  return alpha_per_sample ? diffmst::scratch_bytes<OnepoleBackwardOp>(rows, T)
                          : lookback::scratch_bytes<OnepoleBackwardTileOp>(rows, T);
}

// dalpha: (rows,) for a row's alpha, (rows, T) for a per-sample one.
extern "C" int diffmst_onepole_backward(const float* dy, const float* alpha, int alpha_per_sample,
                                        const float* y, float* db, float* dalpha, void* scratch,
                                        int rows, long long T, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (alpha_per_sample) {
    return diffmst::scan_rows(OnepoleBackwardOp{dy, alpha, y, db, dalpha, T}, scratch, rows, T, s);
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
