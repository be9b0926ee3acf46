// K1: y[n] = a * y[n-1] + b[n] along time over (rows, T) float32 rows, from
// y[-1] = 0, with `a` per row (alpha: (rows,)) or per sample (alpha: (rows, T)).
//
// Replaces the Pallas kernel diffmst_tpu/kernels/scan1p.py::onepole_core
// (pallas_call at scan1p.py:111). Memory-bound: the least traffic is read b
// + write y, 8 bytes a sample (12 with a per-sample alpha). This first
// version reads the inputs twice (scan_common.cuh, passes 1 and 3).

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
