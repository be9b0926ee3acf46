// K1: y[n] = a * y[n-1] + b[n] along time over (rows, T) float32 rows, from
// y[-1] = 0, with `a` per row (alpha: (rows,)) or per sample (alpha: (rows, T)),
// and its backward; and K3, the release stage of the decoupled compressor,
// y[n] = min(g[n], a * y[n-1] + (1 - a) * g[n]) from y[-1] = 0 dB, and its
// backward.
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
// y and g and writes dg, 16 bytes a sample. This first version reads the
// inputs twice (scan_common.cuh, passes 1 and 3).

#include "scan_common.cuh"

namespace {

struct OnepoleOp {
  using Map = diffmst::Affine;
  const float* b;
  const float* alpha;
  int alpha_per_sample;
  float* y;
  int64_t T;

  __device__ __forceinline__ diffmst::Affine step(int row, int64_t t) const {
    const int64_t i = (int64_t)row * T + t;
    const float a = alpha_per_sample ? __ldg(alpha + i) : __ldg(alpha + row);
    return diffmst::Affine{a, __ldg(b + i)};
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

// K3: the map of sample n is y -> min(g, a*y + (1-a)*g), a min-affine map
// composed in double as K1's affine maps are.
struct MinScanOp {
  using Map = diffmst::MinAffine;
  const float* g;
  const float* alpha;  // (rows,)
  float* y;
  int64_t T;

  __device__ __forceinline__ diffmst::MinAffine step(int row, int64_t t) const {
    const double a = __ldg(alpha + row);
    const double gv = __ldg(g + (int64_t)row * T + t);
    return diffmst::MinAffine{a, (1.0 - a) * gv, gv};
  }

  __device__ __forceinline__ void store(int row, int64_t t, float v) const {
    y[(int64_t)row * T + t] = v;
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

extern "C" long long diffmst_onepole_scratch_bytes(int rows, long long T) {
  return diffmst::scratch_bytes<OnepoleOp>(rows, T);
}

extern "C" int diffmst_onepole_core(const float* b, const float* alpha, int alpha_per_sample,
                                    float* y, void* scratch, int rows, long long T,
                                    void* stream) {
  const OnepoleOp op{b, alpha, alpha_per_sample, y, T};
  return diffmst::scan_rows(op, scratch, rows, T, static_cast<cudaStream_t>(stream));
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
  return diffmst::scratch_bytes<MinScanOp>(rows, T);
}

extern "C" int diffmst_release_min_scan(const float* g, const float* alpha, float* y,
                                        void* scratch, int rows, long long T, void* stream) {
  const MinScanOp op{g, alpha, y, T};
  return diffmst::scan_rows(op, scratch, rows, T, static_cast<cudaStream_t>(stream));
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
