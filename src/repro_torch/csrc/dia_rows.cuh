// The streaming core of the two DIA SpMV kernels: spmv_dia_kernel
// (spmv_dia.cu) and spmv_dot_kernel (krylov_fused.cu) are this row loop,
// without and with a p.Ap epilogue.
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
//    reads that device flag first and, while it is false, returns without
//    loading or writing anything; while it is true, the launch adds one to
//    its device counter DiaArgs::count (common.cuh: count_launch).
//
#pragma once

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
  const bool* active;        // the loop guard (null: unguarded)
  unsigned long long* count; // a guarded launch's counter (null: none)
  int nb;
};

// True when a guarded launch's flag says the loop has stopped; a guarded
// launch that goes on counts itself.
__device__ __forceinline__ bool dia_idle(const DiaArgs& a) {
  if (a.active == nullptr) return false;
  if (!*a.active) return true;
  count_launch(a.count);
  return false;
}

inline DiaArgs make_dia_args(const long long* offsets, int nb, long long P,
                             long long m, const void* active = nullptr,
                             void* count = nullptr) {
  DiaArgs a;
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

inline unsigned int dia_blocks(long long n) {
  return static_cast<unsigned int>((n + kDiaTile - 1) / kDiaTile);
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

}  // namespace repro
