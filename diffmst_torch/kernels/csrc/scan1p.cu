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
// K1 with a row's alpha and K3 are each one kernel and one cudaMemsetAsync a
// call: the single-pass scan with decoupled look-back of lookback.cuh, which
// reads every input once. A block stages a tile of kScanItems x 256 samples
// of b (or g) in shared memory by cp.async, scans it in float64 from zero,
// takes the state entering it from the tiles before it (K1 carries one word,
// b; K3 two, d and c) and writes y over its input in the tile, then to
// device memory. K4 (a per-sample alpha: the pole is not constant along a
// row, so the carry cannot be one word) and the three backward kernels stay
// on the three-pass chunked scan of scan_common.cuh, which reads the inputs
// twice (passes 1 and 3).

#include "lookback.cuh"

namespace {

namespace lookback = diffmst::lookback;

// Samples a thread of the single-pass kernels (a tile is 256 times as many),
// and the blocks an SM must hold, which caps the registers.
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

// The adjoint of the one-pole, run backwards in time: s[n] = dy[n] +
// a[n+1] * s[n+1], walked as t = T-1-n. Gives db = s and dalpha = s[n] *
// y[n-1], per sample, or summed over the row (kSums = 1) for a row's alpha.
// With a per-sample alpha the coefficient of step t is a[n+1]; the first
// step (n = T-1) multiplies the zero state, so its coefficient is moot.
template <bool kPerSample>
struct OnepoleBackwardOp {
  using Map = diffmst::Affine;
  static constexpr int kSums = kPerSample ? 0 : 1;
  const float* dy;
  const float* alpha;
  const float* y;
  float* db;
  float* dalpha;  // (rows, T) per sample; unused per row (the sums are)
  int64_t T;

  __device__ __forceinline__ diffmst::Affine step(int row, int64_t t) const {
    const int64_t n = T - 1 - t;
    const int64_t i = (int64_t)row * T + n;
    float a;
    if constexpr (kPerSample) {
      a = n + 1 < T ? __ldg(alpha + i + 1) : 1.0f;
    } else {
      a = __ldg(alpha + row);
    }
    return diffmst::Affine{a, __ldg(dy + i)};
  }

  __device__ __forceinline__ float y_prev(int64_t i, int64_t n) const {
    return n > 0 ? __ldg(y + i - 1) : 0.0f;
  }

  // per sample
  __device__ __forceinline__ void store(int row, int64_t t, float s) const {
    const int64_t n = T - 1 - t;
    const int64_t i = (int64_t)row * T + n;
    db[i] = s;
    dalpha[i] = s * y_prev(i, n);
  }

  // per row
  __device__ __forceinline__ void store(int row, int64_t t, float s, double* sums) const {
    const int64_t n = T - 1 - t;
    const int64_t i = (int64_t)row * T + n;
    db[i] = s;
    sums[0] += (double)s * (double)y_prev(i, n);
  }
};

// K3's backward. y[n] takes the linear branch a*y[n-1] + (1-a)*g[n] where
// L[n] = y[n-1] < g[n] (y[-1] = 0), and is g[n] otherwise: a tie takes the
// clamp. The adjoint is a reverse one-pole with a per-sample coefficient,
// s[n] = dy[n] + a * L[n+1] * s[n+1], walked as t = T-1-n; then dg[n] =
// s[n] * ((1-a) L[n] + (1 - L[n])) and dalpha = sum_n s[n] L[n] (y[n-1] - g[n]),
// a row sum. The branch masks come from the forward's output y.
struct MinScanBackwardOp {
  using Map = diffmst::Affine;
  static constexpr int kSums = 1;
  const float* dy;
  const float* g;
  const float* alpha;
  const float* y;
  float* dg;
  int64_t T;

  __device__ __forceinline__ float y_prev(int64_t i, int64_t n) const {
    return n > 0 ? __ldg(y + i - 1) : 0.0f;
  }

  __device__ __forceinline__ diffmst::Affine step(int row, int64_t t) const {
    const int64_t n = T - 1 - t;
    const int64_t i = (int64_t)row * T + n;
    // L[n+1]; the first step (n = T-1) multiplies the zero state
    const bool next_linear = n + 1 < T && __ldg(y + i) < __ldg(g + i + 1);
    return diffmst::Affine{next_linear ? (double)__ldg(alpha + row) : 0.0, __ldg(dy + i)};
  }

  __device__ __forceinline__ void store(int row, int64_t t, float s, double* sums) const {
    const int64_t n = T - 1 - t;
    const int64_t i = (int64_t)row * T + n;
    const float a = __ldg(alpha + row);
    const float yp = y_prev(i, n);
    const float gv = __ldg(g + i);
    if (yp < gv) {
      dg[i] = (1.0f - a) * s;
      sums[0] += (double)s * ((double)yp - (double)gv);
    } else {
      dg[i] = s;
    }
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

extern "C" long long diffmst_onepole_backward_scratch_bytes(int rows, long long T) {
  return diffmst::scratch_bytes<OnepoleBackwardOp<false>>(rows, T);
}

// dalpha: (rows,) for a row's alpha, (rows, T) for a per-sample one.
extern "C" int diffmst_onepole_backward(const float* dy, const float* alpha, int alpha_per_sample,
                                        const float* y, float* db, float* dalpha, void* scratch,
                                        int rows, long long T, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (alpha_per_sample) {
    const OnepoleBackwardOp<true> op{dy, alpha, y, db, dalpha, T};
    return diffmst::scan_rows(op, scratch, rows, T, s);
  }
  const OnepoleBackwardOp<false> op{dy, alpha, y, db, nullptr, T};
  return diffmst::scan_rows(op, scratch, rows, T, s, dalpha);
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
  return diffmst::scratch_bytes<MinScanBackwardOp>(rows, T);
}

// dalpha: (rows,), the row sums.
extern "C" int diffmst_release_min_scan_backward(const float* dy, const float* g,
                                                 const float* alpha, const float* y, float* dg,
                                                 float* dalpha, void* scratch, int rows,
                                                 long long T, void* stream) {
  const MinScanBackwardOp op{dy, g, alpha, y, dg, T};
  return diffmst::scan_rows(op, scratch, rows, T, static_cast<cudaStream_t>(stream), dalpha);
}
