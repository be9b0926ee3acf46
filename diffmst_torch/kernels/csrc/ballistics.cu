// The compressor's "ballistics" smoother: per sample, the attack pole where
// the gain g[n] (dB) dips below the state and the release pole elsewhere,
//
//   a[n] = g[n] < y[n-1] ? alpha_a : alpha_r,   y[n] = a[n] y[n-1] + (1 - a[n]) g[n],
//
// over (rows, T) float32 rows from y[-1] = 0, with alpha_a and alpha_r per
// row. A differentiated call also writes the coefficient a[n] it chose
// (float32) and the branch (1 where attack), so that the backward, K4's
// backward kernel (scan1p.cu, OnepoleTvBackwardTileOp) on a[n], uses the
// forward's own decisions.
//
// Replaces diffmst_tpu/ops/compressor.py::_smooth_ballistics (:161), a
// sequential lax.scan, not a Pallas kernel: the pole depends on y[n-1], so
// the maps do not compose ahead of the state and no associative scan (K4's
// forward) can run it.
//
// Bound on the card: the recurrence's latency. Each row is one chain of T
// dependent steps (the compare and the pole's select, then a fused
// multiply-add, in float64), so a call takes at least T steps' latency
// however many rows run beside it; its bytes (read g, write y: 8 a sample,
// 67.1 MB at 32 x 262,144, 20 us at 3.35 TB/s) are far below that. The
// design: one thread a row, and a block of five warps for 32 rows, so rows
// spread over the SMs. Warp 0 only walks the rows: each lane takes its
// row's chunk of 32 samples from shared memory into registers, runs the
// recurrence through it and leaves the outputs in shared memory. Warps 1-4
// move the data, 8 rows each: while warp 0 walks chunk k, they store chunk
// k-1's outputs (coalesced, 128 bytes a row), put chunk k+1 into shared
// memory from registers, and load chunk k+2 into them, so the walk never
// waits for device memory. The state is carried in float64 and stored as
// float32: a float32 carry drifts about 1e-3 dB at a pole of 0.9998.
//
// ballistics_chain is not on any path: one thread runs the same dependent
// step T times on values held in registers, with no memory traffic, and
// chip_smoke.py times it as the recurrence's latency bound.

#include "scan_common.cuh"

namespace {

constexpr int kRows = 32;  // rows a block: one walker lane each

__device__ __forceinline__ double ballistics_step(double y, double g, double aa, double ar,
                                                  bool& attack) {
  attack = g < y;
  const double a = attack ? aa : ar;
  return fma(a, y - g, g);  // a y + (1 - a) g
}

// Samples a chunk: a walker lane's row of a chunk in registers, a mover
// lane's sample of its rows.
constexpr int kChunk = 32;
// Mover warps a block, and the rows each moves.
constexpr int kMovers = 4;
constexpr int kMoverRows = kRows / kMovers;

__global__ void __launch_bounds__(32 * (1 + kMovers))
ballistics_rows(const float* __restrict__ g, const float* __restrict__ alpha_a,
                const float* __restrict__ alpha_r, float* __restrict__ y,
                float* __restrict__ coef, unsigned char* __restrict__ branch, int rows,
                long long T) {
  __shared__ float sg[2][kRows][kChunk + 1];  // input chunks, [buffer][row][sample]
  __shared__ float sy[2][kRows][kChunk + 1];  // output chunks
  __shared__ unsigned char sb[2][kRows][kChunk + 1];  // branches taken (recorded calls)
  __shared__ float salpha[2][kRows];  // each row's attack and release poles
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const bool walker = warp == 0;
  const int r0 = walker ? 0 : (warp - 1) * kMoverRows;  // a mover's first row in the block
  const int base = blockIdx.x * kRows;
  const int n_rows = min(kRows, rows - base);
  const bool record = coef != nullptr;
  const long long chunks = (T + kChunk - 1) / kChunk;

  double state = 0.0, aa = 0.0, ar = 0.0;
  if (walker && lane < n_rows) {
    aa = alpha_a[base + lane];
    ar = alpha_r[base + lane];
    salpha[0][lane] = static_cast<float>(aa);
    salpha[1][lane] = static_cast<float>(ar);
  }
  // a mover's registers: sample `lane` of a chunk of each of its rows
  float pre[kMoverRows];
  auto load = [&](long long k) {
    const long long n = k * kChunk + lane;
#pragma unroll
    for (int i = 0; i < kMoverRows; ++i) {
      const int r = r0 + i;
      pre[i] = (r < n_rows && n < T) ? __ldg(g + (base + r) * T + n) : 0.0f;
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kMoverRows; ++i) sg[buf][r0 + i][lane] = pre[i];
  };
  if (!walker) {
    load(0);
    put(0);
    if (chunks > 1) load(1);
  }
  __syncthreads();

  for (long long k = 0; k <= chunks; ++k) {
    const int buf = static_cast<int>(k & 1);
    if (walker) {
      if (k < chunks) {
        // the chunk's gains into registers first, so that no shared-memory
        // load waits inside the dependent chain; its outputs after it
        const int len = static_cast<int>(min(static_cast<long long>(kChunk), T - k * kChunk));
        float gv[kChunk], yv[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) gv[j] = sg[buf][lane][j];
        unsigned attacks = 0;
        if (len == kChunk) {
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            bool attack;
            state = ballistics_step(state, gv[j], aa, ar, attack);
            yv[j] = static_cast<float>(state);
            attacks |= static_cast<unsigned>(attack) << j;
          }
        } else {  // the row's last, partial chunk
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            if (j < len) {
              bool attack;
              state = ballistics_step(state, gv[j], aa, ar, attack);
              yv[j] = static_cast<float>(state);
              attacks |= static_cast<unsigned>(attack) << j;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j) sy[buf][lane][j] = yv[j];
        if (record) {
#pragma unroll
          for (int j = 0; j < kChunk; ++j) sb[buf][lane][j] = (attacks >> j) & 1u;
        }
      }
    } else {
      if (k + 1 < chunks) put(buf ^ 1);
      if (k + 2 < chunks) load(k + 2);
      const long long n = (k - 1) * kChunk + lane;
      if (k >= 1 && n < T) {  // chunk k - 1's outputs
#pragma unroll
        for (int i = 0; i < kMoverRows; ++i) {
          const int r = r0 + i;
          if (r >= n_rows) break;
          const long long idx = (base + r) * T + n;
          y[idx] = sy[buf ^ 1][r][lane];
          if (record) {
            const unsigned char attack = sb[buf ^ 1][r][lane];
            coef[idx] = salpha[attack ? 0 : 1][r];
            branch[idx] = attack;
          }
        }
      }
    }
    __syncthreads();
  }
}

__global__ void ballistics_chain(double* out, long long T, double aa, double ar) {
  // gains that alternate every 64 samples between -2 and -20 dB, so both
  // branches are taken, computed from the loop counter (no loads)
  double state = 0.0;
  int attacks = 0;
  for (long long n = 0; n < T; ++n) {
    bool attack;
    state = ballistics_step(state, (n & 64) ? -20.0 : -2.0, aa, ar, attack);
    attacks += attack;
  }
  out[0] = state;
  out[1] = attacks;
}

}  // namespace

extern "C" int diffmst_ballistics(const float* g, const float* alpha_a, const float* alpha_r,
                                  float* y, float* coef, unsigned char* branch, int rows,
                                  long long T, void* stream) {
  if (rows <= 0 || T <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
  ballistics_rows<<<blocks, 32 * (1 + kMovers), 0, static_cast<cudaStream_t>(stream)>>>(
      g, alpha_a, alpha_r, y, coef, branch, rows, T);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int diffmst_ballistics_chain(double* out, long long T, double alpha_a, double alpha_r,
                                        void* stream) {
  ballistics_chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out, T, alpha_a, alpha_r);
  return static_cast<int>(cudaGetLastError());
}
