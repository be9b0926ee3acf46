// K1: y[n] = a * y[n-1] + b[n] along time over (rows, T) float32 rows, from
// y[-1] = 0, with `a` per row (alpha: (rows,)) or per sample (alpha: (rows, T)),
// and its backward.
//
// Replaces the Pallas kernel diffmst_tpu/kernels/scan1p.py::onepole_core
// (pallas_call at scan1p.py:111) and the reverse-time launches of it in the
// VJPs of onepole_scan (scan1p.py:142-150) and onepole_scan_tv (K4,
// scan1p.py:176-187). Memory-bound: the least traffic of the forward is read
// b + write y, 8 bytes a sample (12 with a per-sample alpha); of the backward
// read dy + read y + write db, 12 bytes a sample (20 with a per-sample alpha,
// which also reads alpha and writes dalpha). This first version reads the
// inputs twice (scan_common.cuh, passes 1 and 3).

#include "scan_common.cuh"

namespace {

struct OnepoleOp {
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

}  // namespace

extern "C" long long diffmst_onepole_scratch_bytes(int rows, long long T) {
  return diffmst::scratch_bytes(rows, T);
}

extern "C" int diffmst_onepole_core(const float* b, const float* alpha, int alpha_per_sample,
                                    float* y, void* scratch, int rows, long long T,
                                    void* stream) {
  const OnepoleOp op{b, alpha, alpha_per_sample, y, T};
  return diffmst::scan_rows(op, scratch, rows, T, static_cast<cudaStream_t>(stream));
}

extern "C" long long diffmst_onepole_backward_scratch_bytes(int rows, long long T) {
  return diffmst::scratch_bytes(rows, T, 1);
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
