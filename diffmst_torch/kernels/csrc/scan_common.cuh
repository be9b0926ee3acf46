// The maps of first-order recurrences along time, for Hopper (sm_90a).
//
// A row of T samples evolves as state[n] = f_n(state[n-1]) from a zero
// state, where each f_n belongs to a family of maps that is closed under
// composition: the scalar affine map y -> a*y + b (K1, K2, K4 and their
// backward kernels) and the min-affine map y -> min(c, a*y + d) (K3). Maps
// compose associatively, so the recurrence is a scan. The TPU kernels
// walked time chunks in order on one core with the carry in VMEM; blocks on
// a GPU run in parallel and in no order, and the single-pass scan of
// lookback.cuh composes these maps across them.
//
// A Map type provides `using State`, `static Map identity()`,
// `static Map compose(Map first, Map then)` (apply `first`, then `then`) and
// `State apply(State) const`; the zero state is State{} (a double). An Op
// names its `Map` (lookback.cuh says what else it supplies).
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

}  // namespace diffmst

extern "C" const char* diffmst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
