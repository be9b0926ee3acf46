// Chunked scan of first-order recurrences along time, for Hopper (sm_90a).
//
// A row of T samples evolves as state[n] = f_n(state[n-1]) from a zero
// state, where each f_n belongs to a family of maps that is closed under
// composition: the scalar affine map y -> a*y + b (K1, K2, K4 and their
// backward kernels) and the min-affine map y -> min(c, a*y + d) (K3). Maps
// compose associatively, so the recurrence is a scan. The TPU kernels
// walked time chunks in order on one core with the carry in VMEM; blocks on
// a GPU run in parallel and in no order. This file holds the maps, which
// the single-pass scan of lookback.cuh composes, and a scan in three passes
// over (rows, T) row-major data, which serves K4 (a per-sample alpha) and
// its backward:
//
//   1. chunk_totals:  one block per (chunk of kChunk samples, row). Each
//      thread composes its kItems samples in order; a block scan (warp
//      shuffles + one shared map per warp) gives the chunk's total map.
//   2. chunk_carries: one block per row scans the chunk totals into the
//      state entering every chunk.
//   3. chunk_apply:   the pass-1 blocks again. Each recomputes its thread
//      prefixes, applies them to the chunk's carry-in and runs its samples
//      forward, handing each sample's state to the op's store().
//
// A Map type provides `using State`, `static Map identity()`,
// `static Map compose(Map first, Map then)` (apply `first`, then `then`) and
// `State apply(State) const`; the zero state is State{} (a double). An Op
// names its `Map` and supplies step(row, t) -> the Map of sample t, and
// store(row, t, y), which receives the new state rounded to float. Pass 3
// keeps the maps of its loads in registers, so a sample's inputs are read
// twice in all (passes 1 and 3) and its output written once.
//
// A backward (adjoint) scan runs backwards in time. Its Op maps the scan's
// t to the sample T-1-t in both step() and store(), so the passes need not
// know the direction.
//
// Maps are composed in double precision. With a pole near 1 (a = 0.9998 for
// a 250 ms attack at 44.1 kHz) a float32 scan's rounding piles up to about
// 5e-4 dB on gains of tens of dB, whichever order it composes in; in double
// the kernel rounds once, when it stores y as float32. These scans are bound
// by memory, far below the card's float64 rate, so the cost is registers.

#pragma once

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

namespace diffmst {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;  // samples per block
constexpr int kWarps = kThreads / 32;

// y -> a*y + b
struct Affine {
  using State = double;
  double a;
  double b;

  __device__ __forceinline__ static Affine identity() { return Affine{1.0, 0.0}; }
  __device__ __forceinline__ static Affine compose(Affine first, Affine then) {
    return Affine{first.a * then.a, then.a * first.b + then.b};
  }
  __device__ __forceinline__ double apply(double y) const { return a * y + b; }
};

// y -> min(c, a*y + d). The identity's c is +inf; fmin drops the NaN that
// a*c gives where a product of poles underflows to 0, keeping the other
// bound, as the composition of "no clamp yet" requires.
struct MinAffine {
  using State = double;
  double a;
  double d;
  double c;

  __device__ __forceinline__ static MinAffine identity() {
    return MinAffine{1.0, 0.0, __longlong_as_double(0x7ff0000000000000LL)};
  }
  __device__ __forceinline__ static MinAffine compose(MinAffine first, MinAffine then) {
    return MinAffine{first.a * then.a, then.a * first.d + then.d,
                     fmin(then.c, then.a * first.c + then.d)};
  }
  __device__ __forceinline__ double apply(double y) const { return fmin(c, a * y + d); }
};

// The Map type of an Op: what its step() returns.
template <class Op>
using op_map = typename Op::Map;

// Op::kSums, or 0 for an Op that declares none (lookback.cuh's row sums).
template <class Op, class = void>
struct op_sums : std::integral_constant<int, 0> {};
template <class Op>
struct op_sums<Op, std::void_t<decltype(Op::kSums)>> : std::integral_constant<int, Op::kSums> {};

// v from the lane d below, field by field (a Map is a struct of doubles).
template <class T>
__device__ __forceinline__ T shfl_up(const T& v, int d) {
  static_assert(sizeof(T) % sizeof(double) == 0, "a Map is a struct of doubles");
  constexpr int n = sizeof(T) / sizeof(double);
  double r[n];
  memcpy(r, &v, sizeof(T));
#pragma unroll
  for (int k = 0; k < n; ++k) r[k] = __shfl_up_sync(0xffffffffu, r[k], d);
  T out;
  memcpy(&out, r, sizeof(T));
  return out;
}

// Exclusive scan across the block, in thread order: returns the composition
// of every earlier thread's map (identity for thread 0) and writes the
// whole block's composition to *total. Every thread of the block must call it.
template <class Map>
__device__ __forceinline__ Map block_exclusive_scan(Map v, Map* total) {
  __shared__ Map warp_totals[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  Map inc = v;  // inclusive scan within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map p = shfl_up(inc, d);
    if (lane >= d) inc = Map::compose(p, inc);
  }
  const Map e = shfl_up(inc, 1);
  const Map exc = lane == 0 ? Map::identity() : e;
  if (lane == 31) warp_totals[warp] = inc;
  __syncthreads();

  if (warp == 0) {  // inclusive scan of the warp totals
    Map w = lane < kWarps ? warp_totals[lane] : Map::identity();
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Map p = shfl_up(w, d);
      if (lane >= d) w = Map::compose(p, w);
    }
    if (lane < kWarps) warp_totals[lane] = w;
  }
  __syncthreads();

  const Map before = warp == 0 ? Map::identity() : warp_totals[warp - 1];
  *total = warp_totals[kWarps - 1];
  __syncthreads();  // warp_totals is free for the next call
  return Map::compose(before, exc);
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
chunk_totals(Op op, op_map<Op>* totals, int64_t T, int n_chunks) {
  using Map = op_map<Op>;
  const int row = blockIdx.y;
  const int64_t t0 = (int64_t)blockIdx.x * kChunk + (int64_t)threadIdx.x * kItems;
  Map acc = Map::identity();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (t0 + i < T) acc = Map::compose(acc, op.step(row, t0 + i));
  }
  Map total;
  block_exclusive_scan(acc, &total);
  if (threadIdx.x == 0) totals[(int64_t)row * n_chunks + blockIdx.x] = total;
}

// carries[row, c] = the state entering chunk c of the row.
template <class Map>
__global__ void __launch_bounds__(kThreads)
chunk_carries(const Map* totals, typename Map::State* carries, int n_chunks) {
  using State = typename Map::State;
  const Map* tot = totals + (int64_t)blockIdx.x * n_chunks;
  State* car = carries + (int64_t)blockIdx.x * n_chunks;
  const int per = (n_chunks + kThreads - 1) / kThreads;
  const int c0 = threadIdx.x * per;
  Map acc = Map::identity();
  for (int i = 0; i < per; ++i) {
    if (c0 + i < n_chunks) acc = Map::compose(acc, tot[c0 + i]);
  }
  Map total;
  const Map before = block_exclusive_scan(acc, &total);
  State y = before.apply(State{});  // the earlier chunks' map applied to the zero state
  for (int i = 0; i < per; ++i) {
    const int c = c0 + i;
    if (c < n_chunks) {
      car[c] = y;
      y = tot[c].apply(y);
    }
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
chunk_apply(Op op, const typename op_map<Op>::State* carries, int64_t T, int n_chunks) {
  using Map = op_map<Op>;
  using State = typename Map::State;
  const int row = blockIdx.y;
  const int64_t t0 = (int64_t)blockIdx.x * kChunk + (int64_t)threadIdx.x * kItems;
  Map steps[kItems];
  Map acc = Map::identity();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    steps[i] = t0 + i < T ? op.step(row, t0 + i) : Map::identity();
    acc = Map::compose(acc, steps[i]);
  }
  Map total;
  const Map before = block_exclusive_scan(acc, &total);
  State y = before.apply(carries[(int64_t)row * n_chunks + blockIdx.x]);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (t0 + i < T) {
      y = steps[i].apply(y);
      op.store(row, t0 + i, (float)y);
    }
  }
}

inline int num_chunks(int64_t T) { return (int)((T + kChunk - 1) / kChunk); }

// Bytes of scratch a scan of (rows, T) with this Op needs: the chunk totals
// and the carries.
template <class Op>
long long scratch_bytes(int rows, int64_t T) {
  using Map = op_map<Op>;
  const long long n = (long long)rows * num_chunks(T);
  return n * (long long)(sizeof(Map) + sizeof(typename Map::State));
}

// Runs the three passes on `stream`; returns the first launch error (0 =
// none).
template <class Op>
int scan_rows(const Op& op, void* scratch, int rows, int64_t T, cudaStream_t stream) {
  using Map = op_map<Op>;
  using State = typename Map::State;
  const int n_chunks = num_chunks(T);
  Map* totals = static_cast<Map*>(scratch);
  State* carries = reinterpret_cast<State*>(totals + (long long)rows * n_chunks);
  const dim3 grid(n_chunks, rows);
  chunk_totals<Op><<<grid, kThreads, 0, stream>>>(op, totals, T, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_carries<Map><<<rows, kThreads, 0, stream>>>(totals, carries, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_apply<Op><<<grid, kThreads, 0, stream>>>(op, carries, T, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace diffmst

extern "C" const char* diffmst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
