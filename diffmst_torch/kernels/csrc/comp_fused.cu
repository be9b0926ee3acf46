// K2: the whole feed-forward compressor in one streaming kernel, per row:
//   x_db = (20 / ln 10) * ln(max(|x|, eps))
//   g_c  = quadratic soft knee of (x_db - threshold)           (dB, <= 0)
//   g_s  = one-pole y[n] = alpha * y[n-1] + (1 - alpha) * g_c[n], y[-1] = 0
//   out  = x_delayed * exp((ln 10 / 20) * (g_s + makeup))
// over (rows, T) float32 rows with five parameters per row.
//
// Replaces the Pallas kernel diffmst_tpu/kernels/comp_fused.py::_fused_core
// (pallas_call at comp_fused.py:98). Memory-bound: the least traffic is read
// x + read x_delayed + write out, 12 bytes a sample; x_db, g_c and g_s never
// reach device memory. This first version reads x twice (scan_common.cuh,
// passes 1 and 3) and x_delayed once.

#include "scan_common.cuh"

namespace {

constexpr float kDbPerNeper = 8.685889638065036f;   // 20 / ln 10
constexpr float kNeperPerDb = 0.11512925464970229f;  // ln 10 / 20

struct CompressorOp {
  const float* x;
  const float* x_delayed;
  // (5, rows): threshold_db, 1/ratio - 1, knee_db (>= 1e-3), alpha, makeup_db
  const float* params;
  float* out;
  int rows;
  int64_t T;
  float eps;

  __device__ __forceinline__ diffmst::Affine step(int row, int64_t t) const {
    const float thr = __ldg(params + row);
    const float irm1 = __ldg(params + rows + row);
    const float knee = __ldg(params + 2 * rows + row);
    const float a = __ldg(params + 3 * rows + row);
    const float xv = __ldg(x + (int64_t)row * T + t);
    const float x_db = kDbPerNeper * logf(fmaxf(fabsf(xv), eps));
    const float over = x_db - thr;
    float g;
    if (over <= -knee * 0.5f) {
      g = 0.0f;
    } else if (over >= knee * 0.5f) {
      g = irm1 * over;
    } else {
      const float u = over + knee * 0.5f;
      g = irm1 * (u * u) / (2.0f * knee);
    }
    return diffmst::Affine{a, (1.0f - a) * g};
  }

  __device__ __forceinline__ void store(int row, int64_t t, float g_s) const {
    const float makeup = __ldg(params + 4 * rows + row);
    const int64_t i = (int64_t)row * T + t;
    out[i] = __ldg(x_delayed + i) * expf(kNeperPerDb * (g_s + makeup));
  }
};

}  // namespace

extern "C" long long diffmst_compressor_scratch_bytes(int rows, long long T) {
  return diffmst::scratch_bytes(rows, T);
}

extern "C" int diffmst_compressor_fused_gain(const float* x, const float* x_delayed,
                                             const float* params, float* out, void* scratch,
                                             int rows, long long T, float eps, void* stream) {
  const CompressorOp op{x, x_delayed, params, out, rows, T, eps};
  return diffmst::scan_rows(op, scratch, rows, T, static_cast<cudaStream_t>(stream));
}
