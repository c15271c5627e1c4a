// The streaming core of the three DIA SpMV kernels: spmv_dia_kernel
// (spmv_dia.cu) and spmv_dot_kernel (krylov_fused.cu) are this row loop,
// without and with a p.Ap epilogue; spmv_dot_direction_kernel
// (krylov_fused.cu) is the second with the CG direction update folded into
// its x loads (dia_rows_direction, at the end).
//
// y[g] = sum_d bands[p, d, i] * x[g + off_d] over the flat stacked vector
// (g = p*m + i; reads outside [0, n) are zero), accumulated in band order
// at the accum width and narrowed once, as the plain version does.
//
// What bounds it on the H100, and what the design does about it:
//
//  * Bytes.  Per row, nb band values stream from device memory once, x is
//    read nb times at nb shifts (one value from device memory, the rest
//    from L1/L2), and y is written once: 72 B per row in f64 for 7 bands
//    against 14 flops.  Reaching the byte rate needs tens of KB of loads in
//    flight per SM.  A band loop whose trip count is known only at run time
//    does not unroll, and an offset array indexed in it is copied to local
//    memory: each band's loads then wait on an offset read, and such a
//    kernel measured half its byte floor on the H100.  So the band loops
//    unroll over a compile-time band count (NB = 7 for the main path, NB =
//    kMaxBands with a `d < nb` predicate for any other), and every band and
//    x load of a thread's rows is issued before its first multiply.
//  * No local memory.  The offsets travel in DiaArgs, a __grid_constant__
//    kernel parameter read only at compile-time indices, so they stay in
//    the parameter bank (`ptxas -v`: 0 bytes stack frame; chip_smoke.py
//    checks it).
//  * L2.  The bands are read once (518 MB at the 210^3 pressure shape), so
//    they load with the streaming hint (ld.global.cs, evict first) and y is
//    stored with it; x loads through the read-only path, so the lines read
//    at g - plane, g and g + plane stay in L2 between those reads.
//  * Checks.  A block whose rows and shifted reads all lie inside [0, n)
//    (all but the few at the vector's ends) runs without bounds checks.
//    The part index costs one division per thread, carried across its
//    rows.
//  * Rows per thread.  On the H100, f64 and f32 run within 1 % of each
//    other at 1, 2, 4 or 8 rows per thread and 128 or 256 threads per
//    block (91 % and 89 % of the byte floor): one row's 2*nb independent
//    loads already keep enough in flight.  The bf16 SpMV+dot, with a
//    quarter of the bytes per row, reaches 60 / 67 / 64 % at 1 / 2 / 4
//    rows, so a thread owns 2 rows (64 registers or fewer in f64).
//  * The guard.  The Krylov loops replay captured blocks of iterations
//    (solvers/device_loop.py); a kernel given a non-null DiaArgs::active
//    reads its lane's device flag first and, while it is false, returns
//    without loading or writing anything; a launch in which any lane's flag
//    is true adds one to its device counter DiaArgs::count (common.cuh:
//    count_lanes).
//  * Lanes.  gridDim.y = B stacked systems of P parts each (a cohort):
//    block row y offsets bands, x, y (and the partials, by
//    DiaArgs::part_stride) to lane y, whose rows are [0, n) as for a
//    single system, so reads outside the lane are zero like reads outside
//    the vector.  The kernels take kLanes as a template argument: a single
//    system's launch (kLanes false) is the code before lanes, its
//    operands read from the parameter bank; the offset pointers of a
//    cohort's launch cost registers (the bf16 SpMV+dot went from 44 to 56
//    and ran 5 % slower when one code served both).
//
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kDiaRows = 2;                        // rows per thread
constexpr int kDiaThreads = 256;                   // threads per block
constexpr int kDiaGroup = kThreads / kDiaRows;     // threads per partial
constexpr int kDiaTile = kDiaThreads * kDiaRows;   // rows per block
static_assert(kThreads % kDiaRows == 0 && kDiaGroup % 32 == 0 &&
              kDiaThreads % kDiaGroup == 0, "a partial block is whole warps");

// The kernels' scalar arguments, passed by value.
struct DiaArgs {
  long long off[kMaxBands];  // band offsets; 0 past nb
  long long m;               // rows per part
  long long n;               // rows in all, P * m
  long long lo, hi;          // rows in [lo, hi) read x inside [0, n) only
  long long part_stride;     // partials from one lane to the next
  const bool* active;        // the loop guard, one flag per lane (null:
                             // unguarded)
  unsigned long long* count; // a guarded launch's counter (null: none)
  int nb;
};

// True when a guarded launch's flag says this block's lane has stopped; a
// guarded launch in which some lane goes on counts itself once.
template <bool kLanes>
__device__ __forceinline__ bool dia_idle(const DiaArgs& a) {
  if (a.active == nullptr) return false;
  if constexpr (kLanes) {
    count_lanes(a.active, a.count);
    return !a.active[blockIdx.y];
  } else {
    if (!*a.active) return true;
    count_launch(a.count);
    return false;
  }
}

inline DiaArgs make_dia_args(const long long* offsets, int nb, long long P,
                             long long m, const void* active = nullptr,
                             void* count = nullptr,
                             long long part_stride = 0) {
  DiaArgs a;
  a.part_stride = part_stride;
  a.active = static_cast<const bool*>(active);
  a.count = static_cast<unsigned long long*>(count);
  a.m = m;
  a.n = P * m;
  a.nb = nb;
  long long lo_off = 0, hi_off = 0;
  for (int d = 0; d < kMaxBands; ++d) {
    a.off[d] = d < nb ? offsets[d] : 0;
    lo_off = a.off[d] < lo_off ? a.off[d] : lo_off;
    hi_off = a.off[d] > hi_off ? a.off[d] : hi_off;
  }
  a.lo = -lo_off;
  a.hi = a.n - hi_off;
  return a;
}

inline dim3 dia_grid(long long n, long long lanes) {
  return dim3(static_cast<unsigned int>((n + kDiaTile - 1) / kDiaTile),
              static_cast<unsigned int>(lanes));
}

// The lane of a block, and an operand advanced to it (`per_lane` elements
// from one lane to the next).
__device__ __forceinline__ long long lane_of_block() { return blockIdx.y; }
template <typename T>
__device__ __forceinline__ T* lane_ptr(T* p, long long per_lane) {
  return p + lane_of_block() * per_lane;
}

// Loads with cache hints: streaming (evict first) for data read once,
// read-only for x.  bf16 goes through its 16-bit pattern.
__device__ __forceinline__ double ld_stream(const double* p) { return __ldcs(p); }
__device__ __forceinline__ float ld_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ __nv_bfloat16 ld_stream(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ double ld_ro(const double* p) { return __ldg(p); }
__device__ __forceinline__ float ld_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_ro(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void st_stream(double* p, double v) { __stcs(p, v); }
__device__ __forceinline__ void st_stream(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void st_stream(__nv_bfloat16* p, __nv_bfloat16 v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

// One thread's rows g = g0 + kDiaGroup*k (k < kDiaRows): stores y[g] and
// returns the accum-width row sums in acc[k] and, with kDot, x[g] at the
// accum width in xg[k]; both 0 for rows at or past n.  kEdge: the block may
// hold rows past n or reads outside [0, n), so every one is checked.
template <typename S, typename A, int NB, bool kEdge, bool kDot>
__device__ __forceinline__ void dia_rows(const S* __restrict__ bands,
                                         const S* __restrict__ x,
                                         S* __restrict__ y, const DiaArgs& a,
                                         long long g0, A (&acc)[kDiaRows],
                                         A (&xg)[kDiaRows]) {
  const int nb = NB < kMaxBands ? NB : a.nb;
  const long long m = a.m, n = a.n;
  // the part of the first row, then carried: rows kDiaGroup apart cross at
  // most one part boundary each unless the parts are shorter than that
  long long p = n <= 0x7fffffffLL
                    ? static_cast<long long>(static_cast<unsigned int>(g0) /
                                             static_cast<unsigned int>(m))
                    : g0 / m;
  long long i = g0 - p * m;
  long long g[kDiaRows];
  bool live[kDiaRows];
  const S* b[kDiaRows];
#pragma unroll
  for (int k = 0; k < kDiaRows; ++k) {
    if (k > 0) {
      i += kDiaGroup;
      while (i >= m) { i -= m; ++p; }
    }
    g[k] = g0 + static_cast<long long>(k) * kDiaGroup;
    live[k] = !kEdge || g[k] < n;
    b[k] = bands + g[k] + p * (nb - 1) * m;  // band 0 of row i of part p
  }
  // every load of every row first ...
  S bv[kDiaRows][NB];
  A xv[kDiaRows][NB];
#pragma unroll
  for (int k = 0; k < kDiaRows; ++k) {
#pragma unroll
    for (int d = 0; d < NB; ++d) {
      if (d < nb) bv[k][d] = live[k] ? ld_stream(b[k] + d * m) : cvt<S>(A(0));
    }
  }
#pragma unroll
  for (int k = 0; k < kDiaRows; ++k) {
#pragma unroll
    for (int d = 0; d < NB; ++d) {
      if (d < nb) {
        const long long j = g[k] + a.off[d];
        xv[k][d] = (!kEdge || (live[k] && j >= 0 && j < n))
                       ? cvt<A>(ld_ro(x + j)) : A(0);
      }
    }
    if (kDot) xg[k] = live[k] ? cvt<A>(ld_ro(x + g[k])) : A(0);
  }
  // ... then the sums, in band order
#pragma unroll
  for (int k = 0; k < kDiaRows; ++k) {
    A s = A(0);
#pragma unroll
    for (int d = 0; d < NB; ++d) {
      if (d < nb) s = s + cvt<A>(bv[k][d]) * xv[k][d];
    }
    if (live[k]) st_stream(y + g[k], cvt<S>(s));
    acc[k] = live[k] ? s : A(0);
  }
}

// The rows of dia_rows with the CG direction update folded into the x
// loads (spmv_dot_direction_kernel, krylov_fused.cu): x is the new
// direction p' = z at the loop's first iteration (`first`: z's bits, no
// arithmetic, no read of p), else z + beta p rounded as
// cg_direction_kernel rounds it (common.cuh: cg_step; beta already rounded
// to S).  It is formed at every shifted read (0 outside [0, n), whatever
// beta is) and at the thread's own rows, whose p' it stores to p_new and
// returns in xg[k] at the accum width.  The compute type of every dtype
// pair is its accum type, so the sums take the values a launch of
// cg_direction then dia_rows would read.  The rows, their parts and the
// order of every load and sum are dia_rows'; every load (bands, z, and p
// after the first iteration) is issued before the first multiply.
template <typename S, typename A, int NB, bool kEdge>
__device__ __forceinline__ void dia_rows_direction(
    const S* __restrict__ bands, const S* __restrict__ z,
    const S* __restrict__ p, S* __restrict__ p_new, S* __restrict__ y,
    const DiaArgs& a, long long g0, bool first, A beta, A (&acc)[kDiaRows],
    A (&xg)[kDiaRows]) {
  static_assert(std::is_same<typename Compute<S>::type, A>::value,
                "the direction is computed at the accum width");
  const int nb = NB < kMaxBands ? NB : a.nb;
  const long long m = a.m, n = a.n;
  long long q = n <= 0x7fffffffLL
                    ? static_cast<long long>(static_cast<unsigned int>(g0) /
                                             static_cast<unsigned int>(m))
                    : g0 / m;
  long long i = g0 - q * m;
  long long g[kDiaRows];
  bool live[kDiaRows];
  const S* b[kDiaRows];
#pragma unroll
  for (int k = 0; k < kDiaRows; ++k) {
    if (k > 0) {
      i += kDiaGroup;
      while (i >= m) { i -= m; ++q; }
    }
    g[k] = g0 + static_cast<long long>(k) * kDiaGroup;
    live[k] = !kEdge || g[k] < n;
    b[k] = bands + g[k] + q * (nb - 1) * m;  // band 0 of row i of part q
  }
  // every load of every row first: the bands, then z and p at each
  // shifted read (d < NB) and at the row itself (d = NB) ...
  S bv[kDiaRows][NB];
#pragma unroll
  for (int k = 0; k < kDiaRows; ++k) {
#pragma unroll
    for (int d = 0; d < NB; ++d) {
      if (d < nb) bv[k][d] = live[k] ? ld_stream(b[k] + d * m) : cvt<S>(A(0));
    }
  }
  S zv[kDiaRows][NB + 1], pv[kDiaRows][NB + 1];
#pragma unroll
  for (int k = 0; k < kDiaRows; ++k) {
#pragma unroll
    for (int d = 0; d <= NB; ++d) {
      if (d < nb || d == NB) {
        const long long j = d < NB ? g[k] + a.off[d] : g[k];
        const bool in = !kEdge || (live[k] && j >= 0 && j < n);
        zv[k][d] = in ? ld_ro(z + j) : cvt<S>(A(0));
        pv[k][d] = in && !first ? ld_ro(p + j) : cvt<S>(A(0));
      }
    }
  }
  // ... then the directions and the sums, in band order
#pragma unroll
  for (int k = 0; k < kDiaRows; ++k) {
    A xv[NB + 1];
#pragma unroll
    for (int d = 0; d <= NB; ++d) {
      if (d < nb || d == NB) {
        const long long j = d < NB ? g[k] + a.off[d] : g[k];
        const bool in = !kEdge || (live[k] && j >= 0 && j < n);
        xv[d] = first ? cvt<A>(zv[k][d])
                : in  ? cg_step<S>(cvt<A>(zv[k][d]), cvt<A>(pv[k][d]), beta)
                      : A(0);
      }
    }
    // the first direction is z's own bits (a NaN payload included)
    if (live[k]) p_new[g[k]] = first ? zv[k][NB] : cvt<S>(xv[NB]);
    xg[k] = live[k] ? xv[NB] : A(0);
    A s = A(0);
#pragma unroll
    for (int d = 0; d < NB; ++d) {
      if (d < nb) s = s + cvt<A>(bv[k][d]) * xv[d];
    }
    if (live[k]) st_stream(y + g[k], cvt<S>(s));
    acc[k] = live[k] ? s : A(0);
  }
}

}  // namespace repro
