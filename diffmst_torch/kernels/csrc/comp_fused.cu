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
// 24 bytes a sample, plus five sums per row.
//
// Each is one kernel a call, with one cudaMemsetAsync of its counters: a
// single-pass scan with decoupled look-back (lookback.cuh) that reads every
// input once. The forward's tiles are 4,096 samples (256 threads x 16), the
// backward's 2,048 (x 8: its four staged arrays take 32 KB of shared memory,
// as the forward's two do), copied in with 16-byte cp.async where the rows
// are 16-byte aligned (T % 4 == 0), else 4 bytes at a time; 64 registers a
// thread, four blocks an SM. The parameters are loaded once a tile, log and
// exp computed once a sample. The backward walks its tiles from the row's
// end; the last tile of each row adds the row's five partial sums.

#include "lookback.cuh"

namespace {

namespace lookback = diffmst::lookback;

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
// only the gain; the compiler drops the rest) and the backward alike. `inv`
// is 1/knee, taken once a tile: a product by it rounds within an ulp of the
// quotient, and a division in every sample cost the backward 10 % of its
// time (PERF.md, PR 7).
struct KneeGrad {
  float g, d_over, d_irm1, d_knee;
};

__device__ __forceinline__ KneeGrad knee_grad(float over, float irm1, float knee, float inv) {
  if (over <= -knee * 0.5f) return KneeGrad{0.0f, 0.0f, 0.0f, 0.0f};
  if (over >= knee * 0.5f) return KneeGrad{irm1 * over, irm1, over, 0.0f};
  const float w = over + knee * 0.5f;
  const float h = 0.5f * inv;
  return KneeGrad{irm1 * (w * w) * h, irm1 * w * inv, (w * w) * h, irm1 * w * (knee - w) * h * inv};
}

// The forward over tiles of x (staged before the scan) and x_delayed
// (after): prepare() gives each sample's (1 - alpha) * g_c, finish() the
// output x_delayed * gain into x_delayed's place and the envelope g_s into
// x's.
template <bool kEnvelope>
struct CompressorOp {
  using Map = diffmst::Affine;
  using Tile = lookback::Tile<16>;
  static constexpr bool kReverse = false;
  static constexpr int kItems = 16, kMinBlocks = 4;
  static constexpr int kIn = 2, kEarly = 1, kOut = 2;
  const float* x;
  const float* x_delayed;
  const float* prm;
  float* out;
  float* envelope;  // (rows, T) g_s for a backward, when kEnvelope
  int rows;
  int64_t T;
  float eps;

  bool aligned() const {
    return T % 4 == 0 && lookback::aligned16(x) && lookback::aligned16(x_delayed) &&
           lookback::aligned16(out) && (!kEnvelope || lookback::aligned16(envelope));
  }

  __device__ __forceinline__ const float* input(int a) const { return a == 0 ? x : x_delayed; }
  __device__ __forceinline__ float* output(int o) const {
    return o == 0 ? out : (kEnvelope ? envelope : nullptr);
  }
  __device__ __forceinline__ static int out_slot(int o) { return o == 0 ? 1 : 0; }
  __device__ __forceinline__ Params params(int row) const { return load_params(prm, rows, row); }
  __device__ __forceinline__ double pole(const Params& p) const { return p.a; }
  __device__ __forceinline__ diffmst::Affine step(const Params& p, float b) const {
    return diffmst::Affine{p.a, b};
  }

  __device__ __forceinline__ void prepare(const Params& p, const Tile& tile, int i0,
                                          float (&b)[kItems]) const {
    float xv[kItems];
    tile.read(0, i0, xv);
    const float knee = fmaxf(p.knee, kKneeMin);
    const float inv = 1.0f / knee;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      b[i] = (1.0f - p.a) * knee_grad(level_db(xv[i], eps) - p.thr, p.irm1, knee, inv).g;
    }
  }

  __device__ __forceinline__ void finish(const Params& p, const Tile& tile, int, int64_t, int i0,
                                         int, const float (&g_s)[kItems]) const {
    float v[kItems];
    tile.read(1, i0, v);
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[i] *= expf(kNeperPerDb * (g_s[i] + p.makeup));
    tile.write(1, i0, v);
    if constexpr (kEnvelope) tile.write(0, i0, g_s);
  }
};

// The backward, run backwards in time over
//   u[n] = dy[n] * gain[n] * x_delayed[n] * ln10/20,   gain = exp(ln10/20 (g_s + makeup)),
// the cotangent of g_s: s[n] = u[n] + alpha * s[n+1] is the cotangent of the
// envelope's state, and (1 - alpha) s[n] that of g_c[n]. Tiles of g_s, dy
// and x_delayed (staged before the scan) and x (after): prepare() writes
// dx_delayed = dy * gain into dy's place and u into x_delayed's, finish()
// dx into x's, and sums, per row, the cotangents of the five parameters in
// the order of `params`.
struct CompressorBackwardOp {
  using Map = diffmst::Affine;
  using Tile = lookback::Tile<8>;
  static constexpr bool kReverse = true;
  static constexpr int kSums = 5;
  static constexpr int kItems = 8, kMinBlocks = 4;
  static constexpr int kIn = 4, kEarly = 3, kOut = 2;
  const float* x;
  const float* x_delayed;
  const float* prm;
  const float* envelope;
  const float* dy;
  float* dx;
  float* dx_delayed;
  int rows;
  int64_t T;
  float eps;

  bool aligned() const {
    return T % 4 == 0 && lookback::aligned16(x) && lookback::aligned16(x_delayed) &&
           lookback::aligned16(envelope) && lookback::aligned16(dy) && lookback::aligned16(dx) &&
           lookback::aligned16(dx_delayed);
  }

  __device__ __forceinline__ const float* input(int a) const {
    return a == 0 ? envelope : a == 1 ? dy : a == 2 ? x_delayed : x;
  }
  __device__ __forceinline__ float* output(int o) const { return o == 0 ? dx_delayed : dx; }
  __device__ __forceinline__ static int out_slot(int o) { return o == 0 ? 1 : 3; }
  __device__ __forceinline__ Params params(int row) const { return load_params(prm, rows, row); }
  __device__ __forceinline__ double pole(const Params& p) const { return p.a; }
  __device__ __forceinline__ diffmst::Affine step(const Params& p, float u) const {
    return diffmst::Affine{p.a, u};
  }

  __device__ __forceinline__ void prepare(const Params& p, const Tile& tile, int i0,
                                          float (&u)[kItems]) const {
    float env[kItems], d[kItems], xd[kItems];
    tile.read(0, i0, env);
    tile.read(1, i0, d);
    tile.read(2, i0, xd);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      d[i] *= expf(kNeperPerDb * (env[i] + p.makeup));  // dx_delayed
      u[i] = d[i] * xd[i] * kNeperPerDb;
    }
    tile.write(1, i0, d);
    tile.write(2, i0, u);
  }

  __device__ __forceinline__ void finish(const Params& p, const Tile& tile, int row, int64_t t,
                                         int i0, int n, const float (&s)[kItems],
                                         double* sums) const {
    float xv[kItems], env[kItems], u[kItems];
    tile.read(3, i0, xv);
    tile.read(0, i0, env);
    tile.read(2, i0, u);
    // g_s one sample before the thread's first: in the tile, or the tile before
    const float env_before = i0 > 0 ? tile.get(0, i0 - 1)
                                    : (t > 0 ? __ldg(envelope + (int64_t)row * T + t - 1) : 0.0f);
    const float knee = fmaxf(p.knee, kKneeMin);
    const float inv = 1.0f / knee;
    float part[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const KneeGrad k = knee_grad(level_db(xv[i], eps) - p.thr, p.irm1, knee, inv);
      const float dg = (1.0f - p.a) * s[i];  // cotangent of g_c[n]
      // d x_db / dx = (20 / ln 10) / x where |x| > eps; the clamp holds it at 0
      // below. The fast quotient (2 ulp) is 0 only for |x| > 2^126.
      const float dxv = fabsf(xv[i]) > eps ? __fdividef(dg * k.d_over * kDbPerNeper, xv[i]) : 0.0f;
      if (i < n) {  // the thread's items in float, the threads and tiles in double
        const float g_prev = i > 0 ? env[i - 1] : env_before;
        part[0] -= dg * k.d_over;  // threshold
        part[1] += dg * k.d_irm1;  // 1/ratio - 1
        if (p.knee > kKneeMin) part[2] += dg * k.d_knee;  // knee, where unclamped
        part[3] += s[i] * (g_prev - k.g);  // alpha
        part[4] += u[i];  // makeup
      }
      xv[i] = dxv;
    }
#pragma unroll
    for (int q = 0; q < 5; ++q) sums[q] += (double)part[q];
    tile.write(3, i0, xv);
  }
};

}  // namespace

extern "C" long long diffmst_compressor_scratch_bytes(int rows, long long T) {
  return lookback::scratch_bytes<CompressorOp<true>>(rows, T);
}

// envelope: (rows, T) to receive g_s for a backward, or null.
extern "C" int diffmst_compressor_fused_gain(const float* x, const float* x_delayed,
                                             const float* params, float* out, float* envelope,
                                             void* scratch, int rows, long long T, float eps,
                                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (envelope != nullptr) {
    const CompressorOp<true> op{x, x_delayed, params, out, envelope, rows, T, eps};
    return lookback::scan_rows(op, op.aligned(), scratch, rows, T, s);
  }
  const CompressorOp<false> op{x, x_delayed, params, out, nullptr, rows, T, eps};
  return lookback::scan_rows(op, op.aligned(), scratch, rows, T, s);
}

extern "C" long long diffmst_compressor_backward_scratch_bytes(int rows, long long T) {
  return lookback::scratch_bytes<CompressorBackwardOp>(rows, T);
}

// dparams: (5, rows), the cotangents of the rows of params.
extern "C" int diffmst_compressor_backward(const float* x, const float* x_delayed,
                                           const float* params, const float* envelope,
                                           const float* dy, float* dx, float* dx_delayed,
                                           float* dparams, void* scratch, int rows, long long T,
                                           float eps, void* stream) {
  const CompressorBackwardOp op{x, x_delayed, params, envelope, dy, dx, dx_delayed, rows, T, eps};
  return lookback::scan_rows(op, op.aligned(), scratch, rows, T, static_cast<cudaStream_t>(stream),
                             dparams);
}
