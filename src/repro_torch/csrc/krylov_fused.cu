// Fused Krylov-iteration kernels for the pressure CG: one-pass SpMV + p.Ap,
// and one-pass axpy pair + Jacobi apply + (r.z, r.r).
//
// Replaces the TPU kernels of src/repro/kernels/krylov_fused/krylov_fused.py:
//   * `spmv_dot_single` (body `_spmv_dot_kernel`; stacked wrapper
//     `fused_matvec_dot`, krylov_fused/ops.py) — (A p, p . A p);
//   * `fused_axpy_precond_single` (body `_axpy_precond_kernel`; stacked
//     wrapper `fused_update_step`) — x' = x + alpha p, r' = r - alpha Ap,
//     z = r' * inv_diag, and the r'.z and r'.r' dots.
// The CG loop runs spmv_dot as spmv_dot_direction_kernel: the same rows
// with the loop's direction update p <- z + beta p folded into the loads
// of p (notes at the kernel).
//
// Bound: bytes.  spmv_dot moves 72 bytes per row in f64 (7 bands, p, Ap)
// for 2*7 + 2 flops; axpy_precond moves 64 (five reads, three writes) for
// 9.  spmv_dot is the streaming core of dia_rows.cuh (several rows per
// thread, every load issued before the first multiply, offsets in the
// parameter bank, streaming hints for the bands) with a p.Ap epilogue.
// axpy_precond gives each warp one partial's 256 rows as 16-byte vectors
// and sums the partial inside the warp (notes at the kernel).  The
// reductions write one accum-width partial per kThreads (256) consecutive
// flat rows, summed in the tree order of common.cuh; the wrapper sums the
// partials with torch.sum.  No atomics: the order of every sum is fixed, so
// Krylov iteration counts reproduce from run to run.
//
// The Krylov loops (solvers/device_loop.py) replay captured blocks of
// iterations and guard them on a one-byte device flag: the guarded entry
// points below pass it, and the kernel returns without reading or writing
// anything while it is false.  A cohort of B systems of one shape runs as
// one launch of B lanes (common.cuh: gridDim.y = B, one flag, one alpha and
// one run of partials per lane; a lane's launch is the single system's).
// The loops update x and r in place, through axpy_precond_inplace_kernel:
// the same rows, loads and arithmetic with x and r read through coherent
// loads and not declared __restrict__, since they are written by the same
// kernel (aliasing a __restrict__ operand, or reading a written location
// through the read-only path, is undefined).
#include "dia_rows.cuh"

using namespace repro;

// ---------------------------------------------------------------------------
// (A p, p . A p): the rows of dia_rows.cuh plus the p.Ap partial of each
// 256-row block, from the accum-width row sums before they are narrowed.
// The partial is summed in the tree order of common.cuh over the block's
// rows v[0..255]: level s adds v[r + s] to v[r] for r < s, s = 128, ..., 1.
// Thread t of a group holds v[t + kDiaGroup*k], so the levels 128 down to
// kDiaGroup are its own rows, the levels down to 32 cross the group's
// warps through shared memory, and 16 down to 1 are warp shuffles.
// ---------------------------------------------------------------------------
template <typename A>
__device__ __forceinline__ void dot_partial(const A (&xg)[kDiaRows],
                                            const A (&acc)[kDiaRows], int t,
                                            long long row0, long long n,
                                            A* __restrict__ partials) {
  A v[kDiaRows];
#pragma unroll
  for (int k = 0; k < kDiaRows; ++k) v[k] = xg[k] * acc[k];
#pragma unroll
  for (int s = kDiaRows / 2; s >= 1; s >>= 1) {
#pragma unroll
    for (int k = 0; k < s; ++k) v[k] = v[k] + v[k + s];
  }
  A sum = v[0];
  if constexpr (kDiaGroup > 32) {
    __shared__ A red[kDiaThreads];
#pragma unroll
    for (int s = kDiaGroup / 2; s >= 32; s >>= 1) {
      red[threadIdx.x] = sum;
      __syncthreads();
      if (t < s) sum = sum + red[threadIdx.x + s];
      if (s > 32) __syncthreads();
    }
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1)
    sum = sum + __shfl_down_sync(0xffffffffu, sum, s);
  if (t == 0 && row0 < n) partials[row0 / kThreads] = sum;
}

template <typename S, typename A, int NB, bool kLanes>
__global__ void __launch_bounds__(kDiaThreads)
spmv_dot_kernel(const S* __restrict__ bands, const S* __restrict__ x,
                S* __restrict__ y, A* __restrict__ partials,
                const __grid_constant__ DiaArgs a) {
  if (dia_idle<kLanes>(a)) return;
  if constexpr (kLanes) {
    bands = lane_ptr(bands, a.n * a.nb);
    x = lane_ptr(x, a.n);
    y = lane_ptr(y, a.n);
    partials = lane_ptr(partials, a.part_stride);
  }
  const long long blk = static_cast<long long>(blockIdx.x) * kDiaTile;
  const int t = threadIdx.x % kDiaGroup;
  const long long row0 = blk + (threadIdx.x / kDiaGroup) * kThreads;
  A acc[kDiaRows], xg[kDiaRows];
  if (blk >= a.lo && blk + kDiaTile <= a.hi)
    dia_rows<S, A, NB, false, true>(bands, x, y, a, row0 + t, acc, xg);
  else
    dia_rows<S, A, NB, true, true>(bands, x, y, a, row0 + t, acc, xg);
  dot_partial(xg, acc, t, row0, a.n, partials);
}

// ---------------------------------------------------------------------------
// The CG direction update folded into the next iteration's SpMV+dot:
// p' = z + beta p (p' = z at the loop's first iteration), then (A p',
// p'.Ap') exactly as spmv_dot_kernel computes them from a stored p'.
//
// Replaces, on the CG loop (solvers/cg.py), the pair cg_direction_kernel
// (krylov_loop.cu; JAX src/repro/solvers/cg.py:74) then spmv_dot_kernel
// (JAX spmv_dot_single, src/repro/kernels/krylov_fused/krylov_fused.py:118).
//
//  * The race on p.  Blocks read p at halo offsets (+-1, +-nx, +-plane)
//    while others write p', so p cannot be updated in place: the loop keeps
//    two direction buffers per lane, and a lane at iteration k (its carried
//    count, read on the device) reads buffer k % 2 and writes buffer
//    (k + 1) % 2 (common.cuh: dir_buf).  Nothing ties the parity to a
//    block's place in a captured graph, and a frozen lane keeps its own.
//  * beta.  cg_advance has already replaced gamma by gamma_new when this
//    kernel runs, so it keeps beta = gamma_new / gamma (accum width, one per
//    lane) for it; this kernel rounds beta to S as cg_direction does.
//  * Bits.  Every direction value is rounded as cg_direction rounds it and
//    the sums and partials are spmv_dot_kernel's, so p', Ap and the
//    partials are bitwise the pair's and the Krylov counts repeat.  At
//    k == 0 p' takes z's bits with no arithmetic (0 * inf would be NaN).
//  * Bytes: 11 values a row (7 bands, z, p, p', Ap): 88 B in f64, 44 B in
//    f32, 22 B in bf16, against the pair's 12 (3 + 9) and two launches.  z
//    and p go through the read-only path (neither is written here: p' is
//    the other buffer), so their shifted reads hit L1/L2 as x's do in
//    spmv_dot.  The rest is spmv_dot's design (dia_rows.cuh): NB a
//    template argument, every load before the first multiply, offsets in
//    the parameter bank, streaming bands, kLanes a template argument.
// ---------------------------------------------------------------------------
template <typename S, typename A, int NB, bool kLanes>
__global__ void __launch_bounds__(kDiaThreads)
spmv_dot_direction_kernel(const S* __restrict__ bands,
                          const S* __restrict__ z, S* p0, S* p1,
                          S* __restrict__ y, A* __restrict__ partials,
                          const A* __restrict__ beta,
                          const int* __restrict__ iter,
                          const __grid_constant__ DiaArgs a) {
  if (dia_idle<kLanes>(a)) return;
  if constexpr (kLanes) {
    bands = lane_ptr(bands, a.n * a.nb);
    z = lane_ptr(z, a.n);
    p0 = lane_ptr(p0, a.n);
    p1 = lane_ptr(p1, a.n);
    y = lane_ptr(y, a.n);
    partials = lane_ptr(partials, a.part_stride);
    beta = lane_ptr(beta, 1);
    iter = lane_ptr(iter, 1);
  }
  const int k = *iter;
  const A b = cvt<A>(cvt<S>(*beta));
  const S* p = dir_buf(p0, p1, k);
  S* p_new = dir_buf(p0, p1, k + 1);
  const long long blk = static_cast<long long>(blockIdx.x) * kDiaTile;
  const int t = threadIdx.x % kDiaGroup;
  const long long row0 = blk + (threadIdx.x / kDiaGroup) * kThreads;
  A acc[kDiaRows], xg[kDiaRows];
  if (blk >= a.lo && blk + kDiaTile <= a.hi)
    dia_rows_direction<S, A, NB, false>(bands, z, p, p_new, y, a, row0 + t,
                                        k == 0, b, acc, xg);
  else
    dia_rows_direction<S, A, NB, true>(bands, z, p, p_new, y, a, row0 + t,
                                       k == 0, b, acc, xg);
  dot_partial(xg, acc, t, row0, a.n, partials);
}

// ---------------------------------------------------------------------------
// The second half of a CG iteration: x' = x + alpha p, r' = r - alpha Ap,
// z = r' * inv_diag, and the r'.z and r'.r' partials.  alpha is read from
// device memory (the accum-width gamma / pAp the solver just computed: no
// host round trip) and narrowed to the storage dtype, as the TPU kernel's
// wrapper does.  Every product and sum is rounded to the storage dtype in
// the plain version's order, so x', r' and z are bitwise the plain
// version's and the partials bitwise block_partials_plain's.
//
// Bound: bytes, 8 values per row (five reads, three writes: 64 B in f64,
// 32 B in f32, 16 B in bf16) against 9 flops.  What the design does:
//
//  * One warp per partial.  A warp owns the 256 rows of one partial and a
//    thread kAxpyRows = 8 of them, as kAxpyRows / W vectors of W = 16 /
//    sizeof(S) consecutive rows (2 f64, 4 f32, 8 bf16): vector w of lane l
//    holds rows 32*W*w + W*l + [0, W) of the partial.  Every operand moves
//    as 16-byte loads and stores, neighbouring lanes on neighbouring
//    vectors, and every load of a thread is issued before its first
//    multiply.
//  * No barriers.  The partial is summed in the tree order of common.cuh
//    inside its warp: the levels that pair two vectors of one thread are
//    register adds, the five that pair lanes (16 down to 1 lanes apart) are
//    __shfl_down_sync on each of the W values still live, and the levels
//    below W are register adds again.  r.z and r.r take the same steps.
//    One row per thread with a shared-memory tree per 256-row block costs
//    20 __syncthreads() and up to ~50 shared-memory accesses a thread for
//    the two dots, the same for 16 bytes of rows (bf16) as for 64 (f64):
//    on the H100 that left bf16 at 48 % of its floor.
//  * Checks.  Only the warp that holds the vector's end loads and stores
//    row by row with bounds checks; a warp past the end returns at once
//    (whole warps, so every shuffle has all 32 lanes).
//  * Measured on the H100 (raw launches at 9,261,000 rows, in turns with
//    the variants): 87-89 % of the floor in f64 and f32 and 82 % in bf16,
//    against 88 / 85 / 48 % for one row per thread.  Read-only loads
//    (__ldg) beat the streaming hint (__ldcs) by 1.5-2.5 % in every
//    dtype; 128 threads per block instead of 256, or streaming stores,
//    changed nothing beyond 1 %.
// ---------------------------------------------------------------------------
constexpr int kAxpyRows = 8;       // rows per thread
constexpr int kAxpyThreads = 256;  // threads per block
static_assert(32 * kAxpyRows == kThreads, "one warp per partial");

// W = 16 / sizeof(S) consecutive values as one 16-byte load through the
// read-only path, widened to the compute type; and back, from values
// already rounded to S, as one plain 16-byte store.  bf16 pairs travel as
// 32-bit words, the lower address in the low half.
__device__ __forceinline__ void ld16(const double* p, double* v) {
  const double2 t = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = t.x;
  v[1] = t.y;
}
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float* v) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void st16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}
__device__ __forceinline__ void st16(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                 bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
}

// v rounded to the storage dtype and widened back
template <typename S, typename C>
__device__ __forceinline__ C rnd(C v) { return cvt<C>(cvt<S>(v)); }

// ... and the coherent 16-byte loads of the in-place form's x and r.
__device__ __forceinline__ void ld16c(const double* p, double* v) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x;
  v[1] = t.y;
}
__device__ __forceinline__ void ld16c(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void ld16c(const __nv_bfloat16* p, float* v) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// The rows of one warp (both kernels below); kInPlace: xo == x, ro == r.
template <typename S, typename A, bool kInPlace>
__device__ __forceinline__ void axpy_precond_rows(
    const S* x, const S* r, const S* p, const S* ap, const S* inv,
    const A* alpha, S* xo, S* ro, S* zo, A* rz_part, A* rr_part,
    long long n) {
  using C = typename Compute<S>::type;
  constexpr int W = 16 / sizeof(S);   // rows per 16-byte vector
  constexpr int L = kAxpyRows / W;    // vectors per thread and operand
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kAxpyThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const long long base = warp * kThreads;  // the partial's first row
  if (base >= n) return;
  const bool edge = base + kThreads > n;
  long long g[L];
#pragma unroll
  for (int w = 0; w < L; ++w) g[w] = base + (32 * w + lane) * W;
  const C a = cvt<C>(cvt<S>(*alpha));
  C xv[L][W], rv[L][W], pv[L][W], av[L][W], iv[L][W];
  if (!edge) {
#pragma unroll
    for (int w = 0; w < L; ++w) {
      if constexpr (kInPlace) {
        ld16c(x + g[w], xv[w]);
        ld16c(r + g[w], rv[w]);
      } else {
        ld16(x + g[w], xv[w]);
        ld16(r + g[w], rv[w]);
      }
      ld16(p + g[w], pv[w]);
      ld16(ap + g[w], av[w]);
      ld16(inv + g[w], iv[w]);
    }
  } else {
#pragma unroll
    for (int w = 0; w < L; ++w) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const long long i = g[w] + k;
        const bool live = i < n;
        xv[w][k] = live ? cvt<C>(x[i]) : C(0);
        rv[w][k] = live ? cvt<C>(r[i]) : C(0);
        pv[w][k] = live ? cvt<C>(p[i]) : C(0);
        av[w][k] = live ? cvt<C>(ap[i]) : C(0);
        iv[w][k] = live ? cvt<C>(inv[i]) : C(0);
      }
    }
  }
  // x' in xv, r' in rv, z in iv; the dots' terms at the accum width
  A rz[L][W], rr[L][W];
#pragma unroll
  for (int w = 0; w < L; ++w) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const C ap_scaled = rnd<S>(a * av[w][k]);
      const C p_scaled = rnd<S>(a * pv[w][k]);
      xv[w][k] = rnd<S>(xv[w][k] + p_scaled);
      rv[w][k] = rnd<S>(rv[w][k] - ap_scaled);
      iv[w][k] = rnd<S>(rv[w][k] * iv[w][k]);
      const A rn = cvt<A>(rv[w][k]);
      rz[w][k] = rn * cvt<A>(iv[w][k]);
      rr[w][k] = rn * rn;
    }
  }
  if (!edge) {
#pragma unroll
    for (int w = 0; w < L; ++w) {
      st16(xo + g[w], xv[w]);
      st16(ro + g[w], rv[w]);
      st16(zo + g[w], iv[w]);
    }
  } else {
#pragma unroll
    for (int w = 0; w < L; ++w) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const long long i = g[w] + k;
        if (i < n) {
          xo[i] = cvt<S>(xv[w][k]);
          ro[i] = cvt<S>(rv[w][k]);
          zo[i] = cvt<S>(iv[w][k]);
        } else {
          rz[w][k] = rr[w][k] = A(0);  // the zero padding of the partial
        }
      }
    }
  }
  // levels 128 .. 32W: the vectors of one thread
#pragma unroll
  for (int s = L / 2; s >= 1; s >>= 1) {
#pragma unroll
    for (int w = 0; w < s; ++w) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        rz[w][k] = rz[w][k] + rz[w + s][k];
        rr[w][k] = rr[w][k] + rr[w + s][k];
      }
    }
  }
  // levels 16W .. W: lanes d apart (lanes >= d add what no level reads)
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      rz[0][k] = rz[0][k] + __shfl_down_sync(0xffffffffu, rz[0][k], d);
      rr[0][k] = rr[0][k] + __shfl_down_sync(0xffffffffu, rr[0][k], d);
    }
  }
  // levels W/2 .. 1: the rows of one vector
#pragma unroll
  for (int s = W / 2; s >= 1; s >>= 1) {
#pragma unroll
    for (int k = 0; k < s; ++k) {
      rz[0][k] = rz[0][k] + rz[0][k + s];
      rr[0][k] = rr[0][k] + rr[0][k + s];
    }
  }
  if (lane == 0) {
    rz_part[warp] = rz[0][0];
    rr_part[warp] = rr[0][0];
  }
}

template <typename S, typename A>
__global__ void __launch_bounds__(kAxpyThreads)
axpy_precond_kernel(const S* __restrict__ x, const S* __restrict__ r,
                    const S* __restrict__ p, const S* __restrict__ ap,
                    const S* __restrict__ inv, const A* __restrict__ alpha,
                    S* __restrict__ xo, S* __restrict__ ro,
                    S* __restrict__ zo, A* __restrict__ rz_part,
                    A* __restrict__ rr_part, long long n) {
  axpy_precond_rows<S, A, false>(x, r, p, ap, inv, alpha, xo, ro, zo, rz_part,
                                 rr_part, n);
}

// x <- x + alpha p and r <- r - alpha Ap in place, under the loops' guard;
// block row y is lane y (n rows, its own alpha, flag and partials).  With
// iter (the CG loop's count k, one per lane), p is the direction the fold
// just wrote, buffer (k + 1) % 2 of the pair (p, p1); cg_advance moves k
// after this kernel.
template <typename S, typename A>
__global__ void __launch_bounds__(kAxpyThreads)
axpy_precond_inplace_kernel(S* x, S* r, const S* __restrict__ p,
                            const S* __restrict__ p1,
                            const int* __restrict__ iter,
                            const S* __restrict__ ap,
                            const S* __restrict__ inv,
                            const A* __restrict__ alpha,
                            S* __restrict__ zo, A* __restrict__ rz_part,
                            A* __restrict__ rr_part, long long n,
                            long long part_stride,
                            const bool* __restrict__ active,
                            unsigned long long* count) {
  if (active != nullptr) {
    count_lanes(active, count);
    if (!active[blockIdx.y]) return;
  }
  x = lane_ptr(x, n);
  r = lane_ptr(r, n);
  if (iter != nullptr) p = dir_buf(p, p1, iter[blockIdx.y] + 1);
  axpy_precond_rows<S, A, true>(x, r, lane_ptr(p, n), lane_ptr(ap, n),
                                lane_ptr(inv, n), lane_ptr(alpha, 1), x, r,
                                lane_ptr(zo, n),
                                lane_ptr(rz_part, part_stride),
                                lane_ptr(rr_part, part_stride), n);
}

template <typename S, typename A, int NB>
static void launch_spmv_dot_nb(const S* b, const S* x, S* y, A* part,
                               const DiaArgs& a, long long lanes,
                               cudaStream_t stream) {
  if (lanes > 1)
    spmv_dot_kernel<S, A, NB, true>
        <<<dia_grid(a.n, lanes), kDiaThreads, 0, stream>>>(b, x, y, part, a);
  else
    spmv_dot_kernel<S, A, NB, false>
        <<<dia_grid(a.n, 1), kDiaThreads, 0, stream>>>(b, x, y, part, a);
}

template <typename S, typename A>
static int launch_spmv_dot(const void* bands, const void* x, void* y,
                           void* partials, const DiaArgs& a, long long lanes,
                           cudaStream_t stream) {
  if (a.n == 0) return 0;
  const S* b = static_cast<const S*>(bands);
  const S* xs = static_cast<const S*>(x);
  S* ys = static_cast<S*>(y);
  A* part = static_cast<A*>(partials);
  if (a.nb == 7)
    launch_spmv_dot_nb<S, A, 7>(b, xs, ys, part, a, lanes, stream);
  else
    launch_spmv_dot_nb<S, A, kMaxBands>(b, xs, ys, part, a, lanes, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename A, int NB>
static void launch_direction_nb(const S* b, const S* z, S* p0, S* p1, S* y,
                                A* part, const A* beta, const int* iter,
                                const DiaArgs& a, long long lanes,
                                cudaStream_t stream) {
  if (lanes > 1)
    spmv_dot_direction_kernel<S, A, NB, true>
        <<<dia_grid(a.n, lanes), kDiaThreads, 0, stream>>>(
            b, z, p0, p1, y, part, beta, iter, a);
  else
    spmv_dot_direction_kernel<S, A, NB, false>
        <<<dia_grid(a.n, 1), kDiaThreads, 0, stream>>>(
            b, z, p0, p1, y, part, beta, iter, a);
}

// in: bands, z, beta, iter; out: p0, p1 (the pair), y, partials
template <typename S, typename A>
static int launch_spmv_dot_direction(const void* const* in, void* const* out,
                                     const DiaArgs& a, long long lanes,
                                     cudaStream_t stream) {
  if (a.n == 0) return 0;
  const S* b = static_cast<const S*>(in[0]);
  const S* z = static_cast<const S*>(in[1]);
  const A* beta = static_cast<const A*>(in[2]);
  const int* iter = static_cast<const int*>(in[3]);
  S* p0 = static_cast<S*>(out[0]);
  S* p1 = static_cast<S*>(out[1]);
  S* y = static_cast<S*>(out[2]);
  A* part = static_cast<A*>(out[3]);
  if (a.nb == 7)
    launch_direction_nb<S, A, 7>(b, z, p0, p1, y, part, beta, iter, a, lanes,
                                 stream);
  else
    launch_direction_nb<S, A, kMaxBands>(b, z, p0, p1, y, part, beta, iter, a,
                                         lanes, stream);
  return static_cast<int>(cudaGetLastError());
}

constexpr long long kAxpyBlockRows = kAxpyThreads / 32 * kThreads;

inline unsigned int axpy_blocks(long long n) {
  return static_cast<unsigned int>((n + kAxpyBlockRows - 1) / kAxpyBlockRows);
}

inline dim3 axpy_grid(long long n, long long lanes) {
  return dim3(axpy_blocks(n), static_cast<unsigned int>(lanes));
}

template <typename S, typename A>
static int launch_axpy(const void* const* in, const void* alpha,
                       void* const* out, long long n, cudaStream_t stream) {
  if (n == 0) return 0;
  axpy_precond_kernel<S, A><<<axpy_blocks(n), kAxpyThreads, 0, stream>>>(
      static_cast<const S*>(in[0]), static_cast<const S*>(in[1]),
      static_cast<const S*>(in[2]), static_cast<const S*>(in[3]),
      static_cast<const S*>(in[4]), static_cast<const A*>(alpha),
      static_cast<S*>(out[0]), static_cast<S*>(out[1]),
      static_cast<S*>(out[2]), static_cast<A*>(out[3]),
      static_cast<A*>(out[4]), n);
  return static_cast<int>(cudaGetLastError());
}

// in: x, r (updated in place), p, the pair's second buffer p1, the loop
// count iter (null: read p), Ap, inv; out: z, rz, rr partials
template <typename S, typename A>
static int launch_axpy_inplace(void* const* xr, const void* const* in,
                               const void* alpha, void* const* out,
                               long long n, long long lanes,
                               long long part_stride, const void* active,
                               void* count, cudaStream_t stream) {
  if (n == 0) return 0;
  if (lanes < 1 || lanes > 65535) return -1;
  axpy_precond_inplace_kernel<S, A>
      <<<axpy_grid(n, lanes), kAxpyThreads, 0, stream>>>(
          static_cast<S*>(xr[0]), static_cast<S*>(xr[1]),
          static_cast<const S*>(in[0]), static_cast<const S*>(in[1]),
          static_cast<const int*>(in[2]), static_cast<const S*>(in[3]),
          static_cast<const S*>(in[4]), static_cast<const A*>(alpha),
          static_cast<S*>(out[0]), static_cast<A*>(out[1]),
          static_cast<A*>(out[2]), n, part_stride,
          static_cast<const bool*>(active),
          static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

// bands (lanes*P, nb, m), x (lanes*P, m) -> y (lanes*P, m) and, per lane,
// ceil(P*m / 256) partials, lane l's from partials + l * part_stride;
// nb <= 8.  Returns cudaGetLastError() after the launch; -1 for an unknown
// dtype code or lane count.
static int dispatch_spmv_dot(int dtype_code, const void* bands,
                             const void* x, void* y, void* partials,
                             const DiaArgs& a, long long lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || lanes > 65535) return -1;
  switch (dtype_code) {
    case kF64:
      return launch_spmv_dot<double, double>(bands, x, y, partials, a, lanes,
                                             s);
    case kF32:
      return launch_spmv_dot<float, float>(bands, x, y, partials, a, lanes, s);
    case kBF16F32:
      return launch_spmv_dot<__nv_bfloat16, float>(bands, x, y, partials, a,
                                                   lanes, s);
    default: return -1;
  }
}

extern "C" int spmv_dot_launch(int dtype_code, const void* bands,
                               const void* x, void* y, void* partials,
                               long long P, long long m,
                               const long long* offsets, int nb,
                               long long lanes, long long part_stride,
                               void* stream) {
  return dispatch_spmv_dot(
      dtype_code, bands, x, y, partials,
      make_dia_args(offsets, nb, P, m, nullptr, nullptr, part_stride), lanes,
      stream);
}

// The same under the Krylov loops' guard: nothing of lane l is read or
// written while the one-byte device flag active[l] is false; a launch in
// which any lane runs adds one to the device counter `count` (one
// unsigned 64-bit value).
extern "C" int spmv_dot_guarded_launch(int dtype_code, const void* bands,
                                       const void* x, void* y,
                                       void* partials, long long P,
                                       long long m, const long long* offsets,
                                       int nb, long long lanes,
                                       long long part_stride,
                                       const void* active, void* count,
                                       void* stream) {
  return dispatch_spmv_dot(
      dtype_code, bands, x, y, partials,
      make_dia_args(offsets, nb, P, m, active, count, part_stride), lanes,
      stream);
}

// The CG direction update folded into the SpMV+dot, under the loops'
// guard (active and count as for spmv_dot_guarded_launch; active may be
// null: unguarded).  bands (lanes*P, nb, m), z (lanes*P, m), the direction
// pair p0, p1 (lanes*P, m) each, one accum beta and one int32 iter per
// lane: lane l reads its direction from buffer iter[l] % 2, writes
// p' = z (iter 0) or z + beta p there to buffer (iter[l] + 1) % 2, and
// writes y = A p' and the p'.Ap' partials as spmv_dot_launch does.
extern "C" int spmv_dot_direction_launch(
    int dtype_code, const void* bands, const void* z, void* p0, void* p1,
    void* y, void* partials, const void* beta, const void* iter, long long P,
    long long m, const long long* offsets, int nb, long long lanes,
    long long part_stride, const void* active, void* count, void* stream) {
  const void* in[4] = {bands, z, beta, iter};
  void* out[4] = {p0, p1, y, partials};
  const DiaArgs a =
      make_dia_args(offsets, nb, P, m, active, count, part_stride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || lanes > 65535) return -1;
  switch (dtype_code) {
    case kF64:
      return launch_spmv_dot_direction<double, double>(in, out, a, lanes, s);
    case kF32:
      return launch_spmv_dot_direction<float, float>(in, out, a, lanes, s);
    case kBF16F32:
      return launch_spmv_dot_direction<__nv_bfloat16, float>(in, out, a,
                                                             lanes, s);
    default: return -1;
  }
}

// x, r, p, Ap, inv_diag (n,) and a device scalar alpha (accum dtype) ->
// x', r', z (n,) and the r.z, r.r partials (ceil(n / 256),) each.  The
// five vectors and three outputs must start on 16-byte boundaries.
extern "C" int axpy_precond_launch(int dtype_code, const void* x,
                                   const void* r, const void* p,
                                   const void* ap, const void* inv,
                                   const void* alpha, void* xo, void* ro,
                                   void* zo, void* rz_part, void* rr_part,
                                   long long n, void* stream) {
  const void* in[5] = {x, r, p, ap, inv};
  void* out[5] = {xo, ro, zo, rz_part, rr_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case kF64: return launch_axpy<double, double>(in, alpha, out, n, s);
    case kF32: return launch_axpy<float, float>(in, alpha, out, n, s);
    case kBF16F32: return launch_axpy<__nv_bfloat16, float>(in, alpha, out, n, s);
    default: return -1;
  }
}

// x, r (lanes*n,) updated in place; p, Ap, inv_diag (lanes*n,); one device
// scalar alpha per lane (accum dtype) -> z (lanes*n,) and, per lane, the
// r.z, r.r partials (ceil(n / 256),) each, lane l's at l * part_stride;
// active one byte per lane or null; count (one unsigned 64-bit value, or
// null) gains one when a guarded launch runs in any lane.  iter (one int32
// per lane, or null): lane l reads its p from buffer (iter[l] + 1) % 2 of
// the pair (p, p1).  The vectors, and every lane's rows, must start on
// 16-byte boundaries.
extern "C" int axpy_precond_inplace_launch(int dtype_code, void* x, void* r,
                                           const void* p, const void* p1,
                                           const void* iter, const void* ap,
                                           const void* inv, const void* alpha,
                                           void* zo, void* rz_part,
                                           void* rr_part, long long n,
                                           long long lanes,
                                           long long part_stride,
                                           const void* active, void* count,
                                           void* stream) {
  void* xr[2] = {x, r};
  const void* in[5] = {p, p1, iter, ap, inv};
  void* out[3] = {zo, rz_part, rr_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case kF64:
      return launch_axpy_inplace<double, double>(xr, in, alpha, out, n, lanes,
                                                 part_stride, active, count,
                                                 s);
    case kF32:
      return launch_axpy_inplace<float, float>(xr, in, alpha, out, n, lanes,
                                               part_stride, active, count, s);
    case kBF16F32:
      return launch_axpy_inplace<__nv_bfloat16, float>(
          xr, in, alpha, out, n, lanes, part_stride, active, count, s);
    default: return -1;
  }
}
