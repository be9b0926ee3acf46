// K2: the whole feed-forward compressor in one streaming kernel, per row:
//   x_db = (20 / ln 10) * ln(max(|x|, eps))
//   g_c  = quadratic soft knee of (x_db - threshold)           (dB, <= 0)
//   g_s  = one-pole y[n] = alpha * y[n-1] + (1 - alpha) * g_c[n], y[-1] = 0
//   out  = x_delayed * exp((ln 10 / 20) * (g_s + makeup))
// over (rows, T) float32 rows with five parameters per row, and its backward.
//
// Replaces the Pallas kernel diffmst_tpu/kernels/comp_fused.py::_fused_core
// (pallas_call at comp_fused.py:98) and its VJP (comp_fused.py:167-176),
// which recomputed the forward through XLA's associative scan. Memory-bound.
// Forward: the least traffic is read x + read x_delayed + write out, 12 bytes
// a sample; x_db, g_c and g_s never reach device memory unless a backward
// will follow, when the forward also writes the envelope g_s (4 bytes a
// sample). Backward: read x, x_delayed, g_s and dy, write dx and dx_delayed,
// 24 bytes a sample, plus five sums per row. This first version reads the
// inputs twice (scan_common.cuh, passes 1 and 3).

#include "scan_common.cuh"

namespace {

constexpr float kDbPerNeper = 8.685889638065036f;   // 20 / ln 10
constexpr float kNeperPerDb = 0.11512925464970229f;  // ln 10 / 20
constexpr float kKneeMin = 1e-3f;  // dB: the knee is clamped to it

// The rows of `params` ((5, rows)): threshold_db, 1/ratio - 1, knee_db
// (clamped to kKneeMin here), alpha, makeup_db.
struct Params {
  float thr, irm1, knee, a, makeup;
};

__device__ __forceinline__ Params load_params(const float* params, int rows, int row) {
  return Params{__ldg(params + row), __ldg(params + rows + row), __ldg(params + 2 * rows + row),
                __ldg(params + 3 * rows + row), __ldg(params + 4 * rows + row)};
}

__device__ __forceinline__ float level_db(float xv, float eps) {
  return kDbPerNeper * logf(fmaxf(fabsf(xv), eps));
}

// The static curve's gain in dB and its derivatives by over = x_db -
// threshold, by 1/ratio - 1 and by the knee, for the forward (which keeps
// only the gain; the compiler drops the rest) and the backward alike.
struct KneeGrad {
  float g, d_over, d_irm1, d_knee;
};

__device__ __forceinline__ KneeGrad knee_grad(float over, float irm1, float knee) {
  if (over <= -knee * 0.5f) return KneeGrad{0.0f, 0.0f, 0.0f, 0.0f};
  if (over >= knee * 0.5f) return KneeGrad{irm1 * over, irm1, over, 0.0f};
  const float w = over + knee * 0.5f;
  return KneeGrad{irm1 * (w * w) / (2.0f * knee), irm1 * w / knee, (w * w) / (2.0f * knee),
                  irm1 * w * (knee - w) / (2.0f * knee * knee)};
}

struct CompressorOp {
  using Map = diffmst::Affine;
  const float* x;
  const float* x_delayed;
  const float* params;
  float* out;
  int rows;
  int64_t T;
  float eps;

  __device__ __forceinline__ diffmst::Affine step(int row, int64_t t) const {
    const Params p = load_params(params, rows, row);
    const float g = knee_grad(level_db(__ldg(x + (int64_t)row * T + t), eps) - p.thr, p.irm1,
                              fmaxf(p.knee, kKneeMin)).g;
    return diffmst::Affine{p.a, (1.0f - p.a) * g};
  }

  __device__ __forceinline__ void store(int row, int64_t t, float g_s) const {
    const float makeup = __ldg(params + 4 * rows + row);
    const int64_t i = (int64_t)row * T + t;
    out[i] = __ldg(x_delayed + i) * expf(kNeperPerDb * (g_s + makeup));
  }
};

// The forward of a compressor that will be differentiated: it also writes
// the envelope g_s for the backward.
struct CompressorEnvelopeOp : CompressorOp {
  float* envelope;

  __device__ __forceinline__ void store(int row, int64_t t, float g_s) const {
    envelope[(int64_t)row * T + t] = g_s;
    CompressorOp::store(row, t, g_s);
  }
};

// The backward, run backwards in time (t = T-1-n) over
//   u[n] = dy[n] * gain[n] * x_delayed[n] * ln10/20,   gain = exp(ln10/20 (g_s + makeup)),
// the cotangent of g_s: s[n] = u[n] + alpha * s[n+1] is the cotangent of the
// envelope's state, and (1 - alpha) s[n] that of g_c[n]. Writes dx and
// dx_delayed = dy * gain and sums, per row, the cotangents of the five
// parameters in the order of `params`.
struct CompressorBackwardOp {
  using Map = diffmst::Affine;
  static constexpr int kSums = 5;
  const float* x;
  const float* x_delayed;
  const float* params;
  const float* envelope;
  const float* dy;
  float* dx;
  float* dx_delayed;
  int rows;
  int64_t T;
  float eps;

  __device__ __forceinline__ diffmst::Affine step(int row, int64_t t) const {
    const Params p = load_params(params, rows, row);
    const int64_t i = (int64_t)row * T + (T - 1 - t);
    const float gain = expf(kNeperPerDb * (__ldg(envelope + i) + p.makeup));
    const float u = __ldg(dy + i) * gain * __ldg(x_delayed + i) * kNeperPerDb;
    return diffmst::Affine{p.a, u};
  }

  __device__ __forceinline__ void store(int row, int64_t t, float s, double* sums) const {
    const Params p = load_params(params, rows, row);
    const int64_t n = T - 1 - t;
    const int64_t i = (int64_t)row * T + n;
    const float g_s = __ldg(envelope + i);
    const float gain = expf(kNeperPerDb * (g_s + p.makeup));
    const float dxd = __ldg(dy + i) * gain;
    const float u = dxd * __ldg(x_delayed + i) * kNeperPerDb;
    dx_delayed[i] = dxd;

    const float xv = __ldg(x + i);
    const KneeGrad k = knee_grad(level_db(xv, eps) - p.thr, p.irm1, fmaxf(p.knee, kKneeMin));
    const float dg = (1.0f - p.a) * s;  // cotangent of g_c[n]
    // d x_db / dx = (20 / ln 10) / x where |x| > eps; the clamp holds it at 0 below
    dx[i] = fabsf(xv) > eps ? dg * k.d_over * kDbPerNeper / xv : 0.0f;

    const float g_prev = n > 0 ? __ldg(envelope + i - 1) : 0.0f;
    sums[0] -= (double)dg * (double)k.d_over;  // threshold
    sums[1] += (double)dg * (double)k.d_irm1;  // 1/ratio - 1
    if (p.knee > kKneeMin) sums[2] += (double)dg * (double)k.d_knee;  // knee, where unclamped
    sums[3] += (double)s * ((double)g_prev - (double)k.g);  // alpha
    sums[4] += (double)u;  // makeup
  }
};

}  // namespace

extern "C" long long diffmst_compressor_scratch_bytes(int rows, long long T) {
  return diffmst::scratch_bytes<CompressorEnvelopeOp>(rows, T);
}

// envelope: (rows, T) to receive g_s for a backward, or null.
extern "C" int diffmst_compressor_fused_gain(const float* x, const float* x_delayed,
                                             const float* params, float* out, float* envelope,
                                             void* scratch, int rows, long long T, float eps,
                                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CompressorOp op{x, x_delayed, params, out, rows, T, eps};
  if (envelope != nullptr) {
    return diffmst::scan_rows(CompressorEnvelopeOp{op, envelope}, scratch, rows, T, s);
  }
  return diffmst::scan_rows(op, scratch, rows, T, s);
}

extern "C" long long diffmst_compressor_backward_scratch_bytes(int rows, long long T) {
  return diffmst::scratch_bytes<CompressorBackwardOp>(rows, T);
}

// dparams: (5, rows), the cotangents of the rows of params.
extern "C" int diffmst_compressor_backward(const float* x, const float* x_delayed,
                                           const float* params, const float* envelope,
                                           const float* dy, float* dx, float* dx_delayed,
                                           float* dparams, void* scratch, int rows, long long T,
                                           float eps, void* stream) {
  const CompressorBackwardOp op{x, x_delayed, params, envelope, dy, dx, dx_delayed, rows, T, eps};
  return diffmst::scan_rows(op, scratch, rows, T, static_cast<cudaStream_t>(stream), dparams);
}
