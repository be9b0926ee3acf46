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
// pass; this first version runs one three-pass scan (scan_common.cuh) per
// section, composing the 2x2 maps in double and rounding each section's
// output to float32, as the Pallas kernel rounds between sections. A
// call therefore moves about 6 x 20 bytes a sample where the least is 8
// (read x, write y); fusing the cascade is later work (ROADMAP).
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

extern "C" long long diffmst_sosfilt_scratch_bytes(int rows, long long T) {
  return diffmst::scratch_bytes<BiquadOp<false>>(rows, T);
}

// coef: (sections, 5, rows); stages: (sections - 1, rows, T), receives the
// output of every section but the last, which goes to y.
extern "C" int diffmst_sosfilt(const float* x, const float* coef, float* stages, float* y,
                               void* scratch, int rows, long long T, int sections,
                               void* stream) {
  const long long n = (long long)rows * T;
  for (int s = 0; s < sections; ++s) {
    const float* in = s == 0 ? x : stages + (s - 1) * n;
    float* out = s == sections - 1 ? y : stages + s * n;
    const BiquadOp<false> op{in, coef + (long long)s * kCoefs * rows, out, rows, T};
    const int err = diffmst::scan_rows(op, scratch, rows, T, static_cast<cudaStream_t>(stream));
    if (err != 0) return err;
  }
  return 0;
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
