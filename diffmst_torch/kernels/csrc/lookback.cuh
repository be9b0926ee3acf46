// Single-pass chunked scan of first-order recurrences along time, with
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA, 2016), for Hopper (sm_90a).
//
// The recurrence and its maps are those of scan_common.cuh: state[n] =
// f_n(state[n-1]) from a zero state, maps composed in double precision,
// with a pole that is constant along a row or, for a GatedAffine, a
// coefficient that an Op gives each sample; a Map takes part through its
// Carry (below): Affine's (K1 with a row's alpha and its backward, K2 and
// K2's backward), MinAffine's (K3) and GatedAffine's (K3's backward, K4 and
// K4's backward). One launch reads each sample once:
//
//   1. A block takes a ticket from an atomic counter, not its blockIdx, and
//      works on the tile that the ticket names: ticket k is tile k / rows of
//      row k % rows, so all rows advance together. Every tile whose ticket
//      is lower has started, so the waits below always end, whatever order
//      the hardware schedules blocks in.
//   2. The tile's input arrays are copied into shared memory with cp.async,
//      16 bytes a thread where the rows are 16-byte aligned: first those
//      that the scan needs, then those that only the outputs need, which
//      arrive while the block scans and looks back. Each of the kTileThreads
//      threads owns Op::kItems consecutive samples and composes their maps;
//      a block scan gives each thread the maps before it and the tile's
//      aggregate, its map from a zero state.
//   3. The tile publishes its aggregate, and its first warp looks back: the
//      tiles of a row form groups of 32, and the last tile of a group
//      publishes the state entering the next group: the state entering its
//      own, then the group's 32 aggregates. A tile composes the state
//      entering its group with the aggregates of the tiles before it in the
//      group, one a lane, in a fixed tree. The order of every composition
//      depends on the tile's place alone, never on which tiles were done
//      first, so the results are the same bits in every run.
//   4. The threads apply their prefixes to the state entering the tile, run
//      their samples forward and hand the states to the Op, which writes
//      its outputs into the tile; the block copies them to device memory.
//
// A published value is a run of 64-bit words, each written once a call with
// one aligned access over the all-ones pattern that the scratch is filled
// with before the launch (one cudaMemsetAsync on the call's stream, with the
// ticket and the per-row counters). A reader that sees another pattern sees
// the value, so no fence or status word is needed. Each call's scratch must
// be its own.
//
// An Op names its Map, `kReverse`, `kItems` (samples a thread), `kMinBlocks`
// (blocks an SM must hold: it caps the registers), `kIn`
// arrays staged in shared memory of which the first `kEarly` are needed
// before the scan, `kOut` outputs, and supplies:
//   const float* input(int a), float* output(int o)       (rows, T) bases;
//       a null output is not written
//   static int out_slot(int o)    the staged array that holds output o
//   Params params(int row), double pole(const Params&)   once a tile
//   Map step(const Params&, float b)          the map of a sample's input b
//   void prepare(const Params&, const Tile&, int i0, float (&b)[kItems])
//       reads the early arrays at the thread's items i0 .. i0+kItems-1 of
//       the tile and gives each item's b; may write into the tile's items
// An Op that declares `static constexpr bool kCoef = true` gives each item a
// coefficient c beside b, and takes it in step:
//   void prepare(const Params&, const Tile&, int row, int64_t t, int i0,
//                float (&b)[kItems], float (&c)[kItems])
//   Map step(const Params&, float b, float c)
//   void finish(const Params&, const Tile&, int row, int64_t t, int i0,
//               int n, const float (&y)[kItems][, double* sums])
//       gets the states of the thread's n valid items (t: the first's
//       sample in the row) and writes the outputs into the tile's items
// A reverse Op (an adjoint, run backwards in time) gets the same calls; the
// kernel walks its tiles from the row's end (tile j is the j-th chunk from
// the end, so the partial chunk comes first), its threads from the tile's
// end and its items from the last; the Op indexes samples in forward time.
//
// An Op that declares `static constexpr int kSums = S` (S > 0) also reduces
// over each row: finish() adds to S double accumulators, the block adds
// them, and the tile writes its S partials. The last tile of a row to finish
// (a per-row atomic counter after a fence) adds the row's partials in a
// fixed order and writes the sums to sums_out ((S, rows) float32).

#pragma once

#include "scan_common.cuh"

namespace diffmst {
namespace lookback {

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kGroup = 32;  // tiles a group: one a lane of the look-back warp

template <class Op>
constexpr int tile_of() {
  return kTileThreads * Op::kItems;
}

// A tile of kIn arrays of `kTile` floats in shared memory. Each thread's
// items are read and written as 16-byte chunks, and chunk c sits at c ^
// ((c / 8) % chunks-a-thread), so that the 8 threads of a quarter-warp,
// whose chunks are chunks-a-thread apart, hit 8 distinct 16-byte bank groups.
template <int kItems>
struct Tile {
  static constexpr int kTile = kTileThreads * kItems;
  float* base;

  __device__ __forceinline__ static int at(int i) {
    const int c = i >> 2;
    return ((c ^ ((c >> 3) & (kItems / 4 - 1))) << 2) | (i & 3);
  }
  __device__ __forceinline__ float* array(int a) const { return base + a * kTile; }
  // the thread's kItems items from i0 (a multiple of kItems) of array a
  __device__ __forceinline__ void read(int a, int i0, float (&v)[kItems]) const {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(array(a) + at(i0 + 4 * q));
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  }
  __device__ __forceinline__ void write(int a, int i0, const float (&v)[kItems]) const {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      *reinterpret_cast<float4*>(array(a) + at(i0 + 4 * q)) =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }
  __device__ __forceinline__ float get(int a, int i) const { return array(a)[at(i)]; }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies the `valid` samples of a tile from src into array a, asynchronously.
template <bool kVec, int kItems>
__device__ __forceinline__ void stage(const Tile<kItems>& tile, int a, const float* src,
                                      int valid) {
  float* dst = tile.array(a);
  if constexpr (kVec) {
    for (int c = threadIdx.x; 4 * c < valid; c += kTileThreads) {
      cp_async16(dst + Tile<kItems>::at(4 * c), src + 4 * c);
    }
  } else {
    for (int e = threadIdx.x; e < valid; e += kTileThreads) {
      cp_async4(dst + Tile<kItems>::at(e), src + e);
    }
  }
}

// Copies the `valid` samples of array a to dst.
template <bool kVec, int kItems>
__device__ __forceinline__ void unstage(const Tile<kItems>& tile, int a, float* dst, int valid) {
  const float* src = tile.array(a);
  if constexpr (kVec) {
    for (int c = threadIdx.x; 4 * c < valid; c += kTileThreads) {
      __stcs(reinterpret_cast<float4*>(dst) + c,
             *reinterpret_cast<const float4*>(src + Tile<kItems>::at(4 * c)));
    }
  } else {
    for (int e = threadIdx.x; e < valid; e += kTileThreads) {
      __stcs(dst + e, src[Tile<kItems>::at(e)]);
    }
  }
}

// What a tile publishes: the words of its map that vary along a row. The
// multiplicative part of a full tile's map of Affine or MinAffine is the
// row's pole to the power of the tile's length, which each reader computes
// itself. The only partial tile of a row is the last of a forward scan
// (read by no tile) or the first of a reverse one, which is always the
// earliest map of a composition, whose multiplicative part no state depends
// on. A GatedAffine's multiplicative part is a product of per-sample
// coefficients, which no reader can compute: its tiles publish it as a
// word, and its from_words ignores the pole. The state entering a group is
// published as the same words: only its additive part reaches a state
// (maps there are applied to the zero state), but its multiplicative part
// is finite (for a GatedAffine, as long as no product of its coefficients
// overflows: see kUnset), so 0 times it is 0.
template <class Map>
struct Carry;

template <>
struct Carry<Affine> {
  static constexpr int kWords = 1;
  __device__ __forceinline__ static void to_words(const Affine& m, double* w) { w[0] = m.b; }
  __device__ __forceinline__ static Affine from_words(const double* w, double a) {
    return Affine{a, w[0]};
  }
};

// y -> min(c, a*y + d) carries d and c. Where the pole is small, a (the
// pole to the tile's length) and the products of a over a group underflow
// to 0; MinAffine::compose takes fmin with the product a * c, so the NaN of
// 0 * inf (an identity's c) drops out there as it does in a block.
template <>
struct Carry<MinAffine> {
  static constexpr int kWords = 2;
  __device__ __forceinline__ static void to_words(const MinAffine& m, double* w) {
    w[0] = m.d;
    w[1] = m.c;
  }
  __device__ __forceinline__ static MinAffine from_words(const double* w, double a) {
    return MinAffine{a, w[0], w[1]};
  }
};

// y -> a*y + b with a per-sample a (K3's backward, whose coefficient is 0
// wherever the next sample took the clamp; K4 and its backward, whose
// coefficient is a sample's alpha): Affine's compose and apply, a type of
// its own for its Carry.
struct GatedAffine : Affine {
  __device__ __forceinline__ static GatedAffine identity() { return {Affine::identity()}; }
  __device__ __forceinline__ static GatedAffine compose(GatedAffine first, GatedAffine then) {
    return {Affine::compose(first, then)};
  }
};

// y -> a*y + b carries a and b.
template <>
struct Carry<GatedAffine> {
  static constexpr int kWords = 2;
  __device__ __forceinline__ static void to_words(const GatedAffine& m, double* w) {
    w[0] = m.a;
    w[1] = m.b;
  }
  __device__ __forceinline__ static GatedAffine from_words(const double* w, double) {
    return {Affine{w[0], w[1]}};
  }
};

// The fill pattern of unpublished words. No arithmetic result has it (the
// card's NaN is 0x7fff...); a word that had it is published as that NaN.
// Neither can a carried word: an Affine's b and a MinAffine's d are finite,
// a MinAffine's c is a finite minimum of a full tile's inputs or, for the
// identity, +inf (0x7ff0...), and a GatedAffine's a is a product of finite
// per-sample coefficients (K3's backward's poles and zeros, K4's alphas).
// Where they lie in [-1, 1], as a stable one-pole's do, the product is
// finite, or 0 where it underflows (a tile of alphas of 0.05): a composition
// with it is then the later map alone, which is right to double precision,
// since the earlier state's true weight is below 1e-308. Only coefficients
// above 1 in magnitude can overflow it to inf, and inf times the zero state
// is NaN; their outputs overflow float32 over such a run anyway.
constexpr long long kUnset = -1LL;

template <int W>
__device__ __forceinline__ void publish(double* dst, const double (&w)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const double v =
        __double_as_longlong(w[k]) == kUnset ? __longlong_as_double(0x7fffffffffffffffLL) : w[k];
    *reinterpret_cast<volatile double*>(dst + k) = v;
  }
}

// Waits until the W words at src are published and reads them.
template <int W>
__device__ __forceinline__ void wait_words(const double* src, double (&w)[W]) {
  bool all;
  do {
    all = true;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      w[k] = *reinterpret_cast<const volatile double*>(src + k);
      all = all && __double_as_longlong(w[k]) != kUnset;
    }
  } while (!all);
}

template <class T>
__device__ __forceinline__ T shfl_down(const T& v, int d) {
  constexpr int n = sizeof(T) / sizeof(double);
  double r[n];
  memcpy(r, &v, sizeof(T));
#pragma unroll
  for (int k = 0; k < n; ++k) r[k] = __shfl_down_sync(0xffffffffu, r[k], d);
  T out;
  memcpy(&out, r, sizeof(T));
  return out;
}

template <class T>
__device__ __forceinline__ T shfl_idx(const T& v, int src) {
  constexpr int n = sizeof(T) / sizeof(double);
  double r[n];
  memcpy(r, &v, sizeof(T));
#pragma unroll
  for (int k = 0; k < n; ++k) r[k] = __shfl_sync(0xffffffffu, r[k], src);
  T out;
  memcpy(&out, r, sizeof(T));
  return out;
}

// The composition over the warp of m[31], ..., m[0] (higher lanes earlier
// in time), in lane 0, in a tree whose shape is fixed.
template <class Map>
__device__ __forceinline__ Map warp_compose_down(Map m) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map o = shfl_down(m, d);
    if (lane + d < 32) m = Map::compose(o, m);
  }
  return m;
}

// Exclusive scan across the block in thread order, with one barrier: the
// composition of every earlier thread's map, and the block's in *total.
template <class Map>
__device__ __forceinline__ Map block_scan(Map v, Map* total) {
  __shared__ Map warp_totals[kTileWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Map inc = v;  // inclusive scan within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map p = shfl_up(inc, d);
    if (lane >= d) inc = Map::compose(p, inc);
  }
  const Map e = shfl_up(inc, 1);
  if (lane == 31) warp_totals[warp] = inc;
  __syncthreads();
  Map before = Map::identity();
  Map all = Map::identity();
#pragma unroll
  for (int w = 0; w < kTileWarps; ++w) {
    if (w == warp) before = all;
    all = Map::compose(all, warp_totals[w]);
  }
  *total = all;
  return lane == 0 ? before : Map::compose(before, e);
}

// Sums each of v[0..S) over the block in a fixed order; valid in thread 0.
template <int S>
__device__ __forceinline__ void block_sum(double (&v)[S]) {
  __shared__ double warp_sums[kTileWarps][S];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < S; ++k) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], d);
    if (lane == 0) warp_sums[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      double x = 0.0;
      for (int w = 0; w < kTileWarps; ++w) x += warp_sums[w][k];
      v[k] = x;
    }
  }
}

// The scratch of one call over `rows` rows of `nt` tiles: the part that is
// filled with ones before the launch (the ticket, the per-row counters, the
// tiles' aggregates and the states entering the groups), then the partial
// sums.
template <class Map, int S>
struct Scratch {
  static constexpr int kWords = Carry<Map>::kWords;
  unsigned int* ticket;
  unsigned int* row_done;
  double* aggregate;  // (rows, nt, kWords)
  double* prefix;     // (rows, groups, kWords): the state entering group q
  double* partials;   // (rows, nt, S)

  __host__ __device__ static long long groups(long long nt) { return (nt + kGroup - 1) / kGroup; }
  static long long counter_bytes(int rows) { return (4 * (1 + (long long)rows) + 15) / 16 * 16; }
  static long long set_bytes(int rows, long long nt) {
    return counter_bytes(rows) + rows * (nt + groups(nt)) * kWords * (long long)sizeof(double);
  }
  static long long bytes(int rows, long long nt) {
    return set_bytes(rows, nt) + rows * nt * S * (long long)sizeof(double);
  }
  static Scratch at(void* base, int rows, long long nt) {
    char* p = static_cast<char*>(base);
    Scratch s;
    s.ticket = reinterpret_cast<unsigned int*>(p);
    s.row_done = s.ticket + 1;
    s.aggregate = reinterpret_cast<double*>(p + counter_bytes(rows));
    s.prefix = s.aggregate + rows * nt * kWords;
    s.partials = s.prefix + rows * groups(nt) * kWords;
    return s;
  }
};

// The composition of every earlier tile of the row, for tile j of `row`
// whose own aggregate is `aggregate` and whose full predecessors'
// multiplicative part is `a_tile`: the state entering its group (lane 31
// waits for it while lanes 0-30 wait for the tiles before it in the group),
// then those tiles. Publishes the tile's aggregate and, for the last tile of
// a group, the state entering the next group. Every thread of the block
// calls it; the first warp does the work.
template <class Map, int S>
__device__ __forceinline__ Map look_back(const Scratch<Map, S>& s, int row, long long j,
                                         long long nt, const Map& aggregate, double a_tile) {
  using C = Carry<Map>;
  constexpr int W = C::kWords;
  __shared__ Map exclusive;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const long long q = j / kGroup;
    const int r = (int)(j % kGroup);
    double* agg = s.aggregate + (long long)row * nt * W;
    double* prefix = s.prefix + (long long)row * Scratch<Map, S>::groups(nt) * W;
    double w[W];
    if (lane == 0 && r < kGroup - 1 && j + 1 < nt) {  // read by the later tiles of its group
      C::to_words(aggregate, w);
      publish(agg + j * W, w);
    }
    Map m = Map::identity();  // lane l < 31: tile j-1-l of the group
    if (lane < r) {
      wait_words(agg + (j - 1 - lane) * W, w);
      m = C::from_words(w, a_tile);
    } else if (lane == 31 && q > 0) {
      wait_words(prefix + q * W, w);
    }
    Map g = Map::identity();  // the state entering the group, from lane 31
    if (q > 0) {
      double gw[W];
#pragma unroll
      for (int k = 0; k < W; ++k) gw[k] = __shfl_sync(0xffffffffu, w[k], 31);
      g = C::from_words(gw, a_tile);
    }
    const Map before = Map::compose(g, shfl_idx(warp_compose_down(m), 0));
    if (r == kGroup - 1 && j + 1 < nt) {  // the state entering the next group
      const Map up = shfl_up(m, 1);       // lane l: tile j-l
      const Map group = warp_compose_down(lane == 0 ? aggregate : up);
      if (lane == 0) {
        C::to_words(Map::compose(g, group), w);
        publish(prefix + (q + 1) * W, w);
      }
    }
    if (lane == 0) exclusive = before;
  }
  __syncthreads();
  return exclusive;
}

// The S row sums of a row whose tiles have all written their partials, by
// the first warp: lane l adds tiles l, l + 32, ... in order, then the lanes
// are added in a fixed tree. Valid in lane 0.
template <int S>
__device__ __forceinline__ void row_sums(const double* partials, long long nt, double (&v)[S]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < S; ++k) v[k] = 0.0;
  for (long long j = lane; j < nt; j += 32) {
#pragma unroll
    for (int k = 0; k < S; ++k) v[k] += __ldcg(partials + j * S + k);
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], d);
  }
}

// Op::kCoef, or false for an Op that declares none.
template <class Op, class = void>
struct op_coef : std::false_type {};
template <class Op>
struct op_coef<Op, std::void_t<decltype(Op::kCoef)>> : std::bool_constant<Op::kCoef> {};

// The map of item i: from its b, and its c for an Op with a coefficient.
template <class Op, class P, int N, int M>
__device__ __forceinline__ op_map<Op> item_map(const Op& op, const P& p, const float (&b)[N],
                                               const float (&c)[M], int i) {
  if constexpr (op_coef<Op>::value) {
    return op.step(p, b[i], c[i]);
  } else {
    return op.step(p, b[i]);
  }
}

template <class Op, bool kVec>
__global__ void __launch_bounds__(kTileThreads, Op::kMinBlocks)
scan_tiles(Op op, Scratch<op_map<Op>, op_sums<Op>::value> s, int rows, int64_t T, long long nt,
           float* sums_out) {
  using Map = op_map<Op>;
  using State = typename Map::State;
  constexpr int S = op_sums<Op>::value;
  constexpr bool kRev = Op::kReverse;
  constexpr int kItems = Op::kItems;
  constexpr int kTile = kTileThreads * kItems;
  extern __shared__ __align__(16) float smem[];
  const Tile<kItems> tile{smem};

  __shared__ unsigned int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(s.ticket, 1u) + 1u;  // the counter starts at ~0
  __syncthreads();
  const int row = (int)(ticket % (unsigned)rows);
  const long long j = ticket / (unsigned)rows;  // the tile's place in scan order
  const int64_t tile_t0 = (kRev ? nt - 1 - j : j) * kTile;
  const int valid = (int)(T - tile_t0 < kTile ? T - tile_t0 : kTile);
  const int64_t g0 = (int64_t)row * T + tile_t0;

#pragma unroll
  for (int a = 0; a < Op::kIn; ++a) {
    stage<kVec>(tile, a, op.input(a) + g0, valid);
    if (a == Op::kEarly - 1 || a == Op::kIn - 1) cp_async_commit();
  }
  const auto p = op.params(row);
  double a_tile = op.pole(p);  // the pole to the power kTile, by squaring
#pragma unroll
  for (int k = 1; k < kTile; k <<= 1) a_tile *= a_tile;
  if constexpr (Op::kEarly < Op::kIn) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  const int place = kRev ? kTileThreads - 1 - (int)threadIdx.x : (int)threadIdx.x;
  const int i0 = place * kItems;
  const int n = valid - i0 <= 0 ? 0 : (valid - i0 >= kItems ? kItems : valid - i0);
  float b[kItems];
  float c[op_coef<Op>::value ? kItems : 1];
  if constexpr (op_coef<Op>::value) {
    op.prepare(p, tile, row, tile_t0 + i0, i0, b, c);
  } else {
    op.prepare(p, tile, i0, b);
  }

  // this thread's map, its items in scan order
  Map acc = Map::identity();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = kRev ? kItems - 1 - k : k;
    if (i < n) acc = Map::compose(acc, item_map(op, p, b, c, i));
  }
  Map aggregate;
  const Map before = block_scan(acc, &aggregate);
  const Map exclusive = look_back(s, row, j, nt, aggregate, a_tile);
  cp_async_wait<0>();
  __syncthreads();  // the late arrays are in

  State y = before.apply(exclusive.apply(State{}));
  float ys[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = kRev ? kItems - 1 - k : k;
    if (i < n) y = item_map(op, p, b, c, i).apply(y);
    ys[i] = (float)y;
  }
  double sums[S > 0 ? S : 1] = {};
  if constexpr (S > 0) {
    op.finish(p, tile, row, tile_t0 + i0, i0, n, ys, sums);
  } else {
    op.finish(p, tile, row, tile_t0 + i0, i0, n, ys);
  }
  __shared__ bool last;
  if constexpr (S > 0) {  // the partials first: the fence then waits on no other store
    block_sum<S>(sums);
    if (threadIdx.x == 0) {
      const long long slot = (long long)row * nt + j;
#pragma unroll
      for (int k = 0; k < S; ++k) __stcg(s.partials + slot * S + k, sums[k]);
      __threadfence();
      last = atomicAdd(s.row_done + row, 1u) + 1u == (unsigned)(nt - 1);  // from ~0
    }
  }
  __syncthreads();
#pragma unroll
  for (int o = 0; o < Op::kOut; ++o) {
    if (op.output(o) != nullptr) unstage<kVec>(tile, Op::out_slot(o), op.output(o) + g0, valid);
  }
  if constexpr (S > 0) {
    if (last && threadIdx.x < 32) {
      __threadfence();
      double v[S];
      row_sums<S>(s.partials + (long long)row * nt * S, nt, v);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < S; ++k) sums_out[(long long)k * rows + row] = (float)v[k];
      }
    }
  }
}

template <class Op>
long long num_tiles(int64_t T) {
  return (T + tile_of<Op>() - 1) / tile_of<Op>();
}

// Bytes of scratch a scan of (rows, T) with this Op needs.
template <class Op>
long long scratch_bytes(int rows, int64_t T) {
  return Scratch<op_map<Op>, op_sums<Op>::value>::bytes(rows, num_tiles<Op>(T));
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Fills the scratch's counters and words with ones and runs the one kernel
// on `stream`, with 16-byte copies where `aligned`; for an Op with S sums,
// writes them to `sums_out` ((S, rows) float32). Returns the first error (0
// = none).
template <class Op>
int scan_rows(const Op& op, bool aligned, void* scratch, int rows, int64_t T, cudaStream_t stream,
              float* sums_out = nullptr) {
  using Sc = Scratch<op_map<Op>, op_sums<Op>::value>;
  const long long nt = num_tiles<Op>(T);
  if (rows * nt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0xff, Sc::set_bytes(rows, nt), stream);
  if (err != cudaSuccess) return (int)err;
  const Sc s = Sc::at(scratch, rows, nt);
  const unsigned grid = (unsigned)(rows * nt);
  const int smem = Op::kIn * tile_of<Op>() * (int)sizeof(float);
  auto kernel = aligned ? scan_tiles<Op, true> : scan_tiles<Op, false>;
  if (smem >= 48 * 1024) {  // 48 KB and the static shared memory need the opt-in
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kTileThreads, smem, stream>>>(op, s, rows, T, nt, sums_out);
  return (int)cudaGetLastError();
}

}  // namespace lookback
}  // namespace diffmst
