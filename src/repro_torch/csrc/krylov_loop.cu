// Device-side control of the Krylov loops that solvers/device_loop.py runs
// as captured CUDA-graph blocks: the CG direction update and the CG
// iteration's scalar tail.
//
// Port-only kernels: no TPU kernel does this work.  They replace, in the
// JAX solver src/repro/solvers/cg.py, the body line
// `p = z + beta.astype(z.dtype) * p` with beta = gamma_new / gamma (:74;
// cg_direction_kernel), `alpha = gamma / pAp` with the `jnp.sum` of the
// SpMV+dot's partials (:74 and src/repro/kernels/krylov_fused/ops.py:47;
// cg_alpha_kernel), and the `jnp.sum` of the axpy's partials (ops.py:68)
// with the `lax.while_loop` carry update and condition (`cond` :64, the
// loop :78; cg_advance_kernel).
//
// The CG loop itself no longer launches cg_direction: the update is folded
// into the next iteration's SpMV+dot (spmv_dot_direction_kernel,
// krylov_fused.cu), which reads the beta that cg_advance keeps.
// cg_direction stays as the unfused form the fold is held against.  An
// iteration is four launches: the fold, cg_alpha, the in-place axpy and
// cg_advance.
//
// The guard.  A captured block replays K iterations whether or not the
// solve has converged, so every kernel that writes the loop's state reads
// the one-byte device flag `active` first and returns at once when it is
// false (the SpMV and axpy kernels take the same flag); a launch that goes
// on adds one to its device launch counter (common.cuh: count_launch).
// cg_advance is the only writer of the flag: after every reader of gamma in
// the iteration it sets gamma <- gamma_new, rr <- rr_new, k += 1 and
// active <- (rr > thr) && (k < maxiter).  A NaN rr compares false, so a
// NaN start runs 0 iterations.
//
// The tail's sums.  The SpMV+dot and the axpy kernel leave one partial per
// kThreads rows of a lane (common.cuh); cg_alpha sums a lane's p.Ap
// partials into pAp and forms alpha = gamma / pAp, cg_advance sums its r.z
// and r.r partials into gamma_new and rr_new before the carry update.
// Each lane is one thread-block cluster of kTailCtas CTAs (grid
// (kTailCtas, lanes)).  Of a lane's n partials, CTA c takes the contiguous
// run [c L, c L + L), L = J kThreads W, J = ceil(n / (kTailCtas kThreads
// W)), W = 16 / sizeof(A) (zeros past n); thread t adds, in rounds j = 0
// .. J-1, the W values of the 16-byte vector at c L + (j kThreads + t) W
// to its sum, one after another from +0.0; a warp then adds down a shuffle
// tree (lane i takes lane i + h, h = 16, 8, 4, 2, 1), the CTA adds its 8
// warp sums down a tree (w[i] += w[i + h], h = 4, 2, 1), and rank 0 adds
// the kTailCtas CTA sums in rank order through distributed shared memory.
// No atomics: the order depends on n and these constants only, so a sum
// repeats bit for bit, a lane of a cohort gives its solo run's bits, and
// kernels/krylov_loop's lane_tree_sums_plain is the same order in PyTorch.
// (A thread's sum starts at +0.0 and so is never -0.0; the zeros past n
// change nothing, and a run of -0.0 alone sums to +0.0.)
//
// Lanes.  A cohort of B systems runs as one launch: cg_direction with
// gridDim.y = B (block row y is lane y: its rows, its gamma pair and its
// flag, common.cuh), cg_alpha and cg_advance with cluster row y.  All CTAs
// of a lane read its flag, so a cluster returns whole.  cg_direction and
// cg_alpha count once when any lane's flag is set.  cg_advance rewrites
// the flags, so no thread can read every lane's flag before some lane has
// rewritten its own: it counts per lane (count[y] += 1), and the loop takes
// the most any lane counted, the launches that ran (kernels/
// device_counts.py).
//
// Rounding.  cg_direction must give the bits of PyTorch's eager
// `z + beta.to(z.dtype) * p`: beta is an IEEE division at the accum width,
// rounded to the storage dtype; the product and the sum are each rounded
// to the storage dtype, with no contraction (__dmul_rn / __dadd_rn,
// __fmul_rn / __fadd_rn; bf16 widens to float and rounds back after the
// multiply and again after the add, as PyTorch's bf16 element-wise kernels
// do).  alpha and beta are div_rn of the accum dtype, as torch.div.
//
// Bound: bytes.  cg_direction reads z and p and writes p: 3 values per row
// (222 MB in f64 at the 210^3 pressure shape, a 0.066 ms floor at
// 3.35 TB/s) against 2 flops; each thread moves one 16-byte vector of each
// operand, z through the read-only path and p, which the kernel writes,
// through plain coherent loads.  The eager pair it replaces launches two
// kernels and moves 5 values per row.  cg_alpha reads one run of partials
// a lane, cg_advance two (289 KB and 579 KB in f64 at 210^3, well under a
// microsecond at 3.35 TB/s): their time is the launch and the cluster's
// round trips.
#include "common.cuh"

#include <cooperative_groups.h>
#include <cstdint>

using namespace repro;

namespace {

// One 16-byte vector of W = 16 / sizeof(S) values, widened to the compute
// type: `ro` through the read-only path, `rw` through coherent loads (the
// kernel writes it).  Stores take values already rounded to S.
template <typename S> struct Vec;
template <> struct Vec<double> {
  static constexpr int W = 2;
  __device__ static void ro(const double* p, double* v) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = t.x; v[1] = t.y;
  }
  __device__ static void rw(const double* p, double* v) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
  __device__ static void st(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};
template <> struct Vec<float> {
  static constexpr int W = 4;
  __device__ static void ro(const float* p, float* v) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ static void rw(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ static void st(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int W = 8;
  __device__ static void widen(const uint4 t, float* v) {
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static void ro(const __nv_bfloat16* p, float* v) {
    widen(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  __device__ static void rw(const __nv_bfloat16* p, float* v) {
    widen(*reinterpret_cast<const uint4*>(p), v);
  }
  __device__ static unsigned pair(float lo, float hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
            << 16);
  }
  __device__ static void st(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pair(v[0], v[1]), pair(v[2], v[3]), pair(v[4], v[5]),
                   pair(v[6], v[7]));
  }
};

}  // namespace

// p <- z + beta * p, beta = gamma_new / gamma (accum dtype) rounded to S.
// Thread t owns rows [t*W, t*W + W): a 16-byte vector of each operand, or,
// for the one thread at a ragged end, checked scalars.  Block row y is lane
// y (n rows each).
template <typename S, typename A>
__global__ void __launch_bounds__(kThreads)
cg_direction_kernel(S* p, const S* __restrict__ z,
                    const A* __restrict__ gamma_new,
                    const A* __restrict__ gamma,
                    const bool* __restrict__ active,
                    unsigned long long* count, long long n) {
  if (active != nullptr) {
    count_lanes(active, count);
    if (!active[blockIdx.y]) return;
  }
  const long long lane = blockIdx.y;
  p += lane * n;
  z += lane * n;
  gamma_new += lane;
  gamma += lane;
  using C = typename Compute<S>::type;
  constexpr int W = Vec<S>::W;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * W;
  if (i0 >= n) return;
  const C beta = cvt<C>(cvt<S>(div_rn(*gamma_new, *gamma)));
  if (i0 + W <= n) {
    C pv[W], zv[W];
    Vec<S>::rw(p + i0, pv);
    Vec<S>::ro(z + i0, zv);
#pragma unroll
    for (int k = 0; k < W; ++k) pv[k] = cg_step<S>(zv[k], pv[k], beta);
    Vec<S>::st(p + i0, pv);
  } else {
    for (long long i = i0; i < n; ++i)
      p[i] = cvt<S>(cg_step<S>(cvt<C>(z[i]), cvt<C>(p[i]), beta));
  }
}

// CTAs of one lane's cluster in the tail kernels (portable cluster size)
constexpr int kTailCtas = 8;
// vectors each thread has in flight per run of partials
constexpr int kTailUnroll = 4;
static_assert(kThreads == 256, "the CTA tree adds 8 warp sums");

// Values i .. i + W - 1 of a run of n partials, zeros past n or when the
// round is past the last (live false): one 16-byte load when the run is
// aligned and the vector whole, else checked scalars.  The values, not the
// loads, fix the order of the sums.
template <typename A>
__device__ __forceinline__ void run_values(const A* run, long long i,
                                           long long n, bool live, A* v) {
  constexpr int W = Vec<A>::W;
  if (live && i + W <= n &&
      (reinterpret_cast<std::uintptr_t>(run) & 15) == 0) {
    Vec<A>::ro(run + i, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < W; ++e)
    v[e] = (live && i + e < n) ? __ldg(run + i + e) : A(0);
}

// The sums of NS runs of n partials each in the tree at the top of this
// file, one cluster for all NS; every thread of the cluster calls it.  The
// sums are in `out` of rank 0's thread 0 only.
template <typename A, int NS>
__device__ __forceinline__ void tree_sums(const A* const (&runs)[NS],
                                          long long n, A (&out)[NS]) {
  namespace cg = cooperative_groups;
  constexpr int W = Vec<A>::W;
  constexpr int U = kTailUnroll;
  __shared__ A warp_sum[NS][kThreads / 32];
  __shared__ A cta_sum[NS];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int c = cluster.block_rank();
  const int t = threadIdx.x;
  const long long per = static_cast<long long>(kTailCtas) * kThreads * W;
  const long long J = (n + per - 1) / per;
  const long long L = J * kThreads * W;
  A acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = A(0);
  for (long long j0 = 0; j0 < J; j0 += U) {
    A v[NS][U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = c * L + ((j0 + u) * kThreads + t) * W;
#pragma unroll
      for (int s = 0; s < NS; ++s)
        run_values<A>(runs[s], i, n, j0 + u < J, v[s][u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int e = 0; e < W; ++e) acc[s] = add_rn(acc[s], v[s][u][e]);
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1)
      acc[s] = add_rn(acc[s], __shfl_down_sync(0xffffffffu, acc[s], h));
    if ((t & 31) == 0) warp_sum[s][t >> 5] = acc[s];
  }
  __syncthreads();
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      A w[kThreads / 32];
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) w[i] = warp_sum[s][i];
#pragma unroll
      for (int h = kThreads / 64; h >= 1; h >>= 1)
#pragma unroll
        for (int i = 0; i < h; ++i) w[i] = add_rn(w[i], w[i + h]);
      cta_sum[s] = w[0];
    }
  }
  cluster.sync();
  if (c == 0 && t == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      A sum = cta_sum[s];
#pragma unroll
      for (int r = 1; r < kTailCtas; ++r)
        sum = add_rn(sum, cluster.map_shared_rank(&cta_sum[0], r)[s]);
      out[s] = sum;
    }
  }
  // every CTA's shared memory stays until rank 0 has read it
  cluster.sync();
}

__device__ __forceinline__ bool tail_writer() {
  return cooperative_groups::this_cluster().block_rank() == 0 &&
         threadIdx.x == 0;
}

// pAp <- the sum of lane y's p.Ap partials (part + y * stride, npl of
// them) and, with gamma, alpha <- gamma / pAp; under the guard `active`
// (null: unguarded) nothing of a lane whose flag is false is written.
template <typename A>
__global__ void __cluster_dims__(kTailCtas, 1, 1) __launch_bounds__(kThreads)
cg_alpha_kernel(const A* __restrict__ part, long long npl, long long stride,
                A* pAp, const A* __restrict__ gamma, A* alpha,
                const bool* __restrict__ active, unsigned long long* count) {
  const long long lane = blockIdx.y;
  if (active != nullptr) {
    count_lanes(active, count);
    if (!active[lane]) return;
  }
  const A* const runs[1] = {part + lane * stride};
  A sum[1];
  tree_sums<A, 1>(runs, npl, sum);
  if (!tail_writer()) return;
  pAp[lane] = sum[0];
  if (gamma != nullptr) alpha[lane] = div_rn(gamma[lane], sum[0]);
}

// The loop guard (see the notes at the top), lane y by cluster row y:
// gamma_new and rr_new <- the sums of the lane's r.z and r.r partials
// first.  beta (null: not kept) takes gamma_new / gamma before gamma is
// overwritten: the next iteration's direction update reads it
// (spmv_dot_direction_kernel).  Every CTA of the lane has read the flag
// before rank 0 rewrites it (the sums' first cluster barrier).  count: one
// counter per lane.
template <typename A>
__global__ void __cluster_dims__(kTailCtas, 1, 1) __launch_bounds__(kThreads)
cg_advance_kernel(A* gamma, A* gamma_new, A* rr, A* rr_new, int* k,
                  bool* active, const A* __restrict__ thr, int maxiter,
                  A* beta, const A* __restrict__ rz_part,
                  const A* __restrict__ rr_part, long long npl,
                  long long stride, unsigned long long* count) {
  const long long lane = blockIdx.y;
  if (!active[lane]) return;
  const A* const runs[2] = {rz_part + lane * stride, rr_part + lane * stride};
  A sums[2];
  tree_sums<A, 2>(runs, npl, sums);
  if (!tail_writer()) return;
  if (count != nullptr) count[lane] += 1;
  gamma_new[lane] = sums[0];
  rr_new[lane] = sums[1];
  if (beta != nullptr) beta[lane] = div_rn(sums[0], gamma[lane]);
  gamma[lane] = sums[0];
  rr[lane] = sums[1];
  const int kn = k[lane] + 1;
  k[lane] = kn;
  active[lane] = sums[1] > thr[lane] && kn < maxiter;
}

template <typename S, typename A>
static int launch_direction(void* p, const void* z, const void* gamma_new,
                            const void* gamma, long long n, long long lanes,
                            const void* active, void* count,
                            cudaStream_t stream) {
  if (n == 0) return 0;
  if (lanes < 1 || lanes > 65535) return -1;
  constexpr long long W = Vec<S>::W;
  const long long vecs = (n + W - 1) / W;
  cg_direction_kernel<S, A><<<dim3(n_blocks(vecs),
                                   static_cast<unsigned int>(lanes)),
                              kThreads, 0, stream>>>(
      static_cast<S*>(p), static_cast<const S*>(z),
      static_cast<const A*>(gamma_new), static_cast<const A*>(gamma),
      static_cast<const bool*>(active),
      static_cast<unsigned long long*>(count), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename A>
static int launch_alpha(const void* part, long long npl, long long stride,
                        void* pAp, const void* gamma, void* alpha,
                        long long lanes, const void* active, void* count,
                        cudaStream_t stream) {
  if (lanes < 1 || lanes > 65535 || npl < 1) return -1;
  cg_alpha_kernel<A><<<dim3(kTailCtas, static_cast<unsigned int>(lanes)),
                       kThreads, 0, stream>>>(
      static_cast<const A*>(part), npl, stride, static_cast<A*>(pAp),
      static_cast<const A*>(gamma), static_cast<A*>(alpha),
      static_cast<const bool*>(active),
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

template <typename A>
static int launch_advance(void* gamma, void* gamma_new, void* rr,
                          void* rr_new, void* k, void* active,
                          const void* thr, int maxiter, void* beta,
                          const void* rz_part, const void* rr_part,
                          long long npl, long long stride, long long lanes,
                          void* count, cudaStream_t stream) {
  if (lanes < 1 || lanes > 65535 || npl < 1 || rz_part == nullptr ||
      rr_part == nullptr)
    return -1;
  cg_advance_kernel<A><<<dim3(kTailCtas, static_cast<unsigned int>(lanes)),
                         kThreads, 0, stream>>>(
      static_cast<A*>(gamma), static_cast<A*>(gamma_new), static_cast<A*>(rr),
      static_cast<A*>(rr_new), static_cast<int*>(k),
      static_cast<bool*>(active), static_cast<const A*>(thr), maxiter,
      static_cast<A*>(beta), static_cast<const A*>(rz_part),
      static_cast<const A*>(rr_part), npl, stride,
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

// p, z (lanes*n,) storage dtype, 16-byte aligned at every lane; gamma_new,
// gamma one accum value per lane; active one byte per lane or null
// (unguarded); count one unsigned 64-bit value that a guarded launch which
// runs in any lane adds one to, or null.  Returns cudaGetLastError() after
// the launch; -1 for an unknown dtype code or lane count.
extern "C" int cg_direction_launch(int dtype_code, void* p, const void* z,
                                   const void* gamma_new, const void* gamma,
                                   long long n, long long lanes,
                                   const void* active, void* count,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case kF64:
      return launch_direction<double, double>(p, z, gamma_new, gamma, n, lanes,
                                              active, count, s);
    case kF32:
      return launch_direction<float, float>(p, z, gamma_new, gamma, n, lanes,
                                            active, count, s);
    case kBF16F32:
      return launch_direction<__nv_bfloat16, float>(p, z, gamma_new, gamma, n,
                                                    lanes, active, count, s);
    default: return -1;
  }
}

// part: lane y's npl partials at part + y * stride (accum code kF64:
// double, kF32: float); pAp, gamma, alpha one accum value per lane (gamma
// null: pAp only, alpha unused); active one byte per lane or null
// (unguarded); count as for cg_direction_launch; at most 65535 lanes.
extern "C" int cg_alpha_launch(int accum_code, const void* part,
                               long long npl, long long stride, void* pAp,
                               const void* gamma, void* alpha,
                               long long lanes, const void* active,
                               void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (accum_code) {
    case kF64:
      return launch_alpha<double>(part, npl, stride, pAp, gamma, alpha, lanes,
                                  active, count, s);
    case kF32:
      return launch_alpha<float>(part, npl, stride, pAp, gamma, alpha, lanes,
                                 active, count, s);
    default: return -1;
  }
}

// gamma, gamma_new, rr, rr_new, thr, beta: one accum value per lane (code
// kF64: double, kF32: float; beta may be null); k one int32 per lane;
// active one byte per lane; rz_part, rr_part: the r.z and r.r partials as
// cg_alpha_launch takes its part; count: null or one unsigned 64-bit
// counter per lane.
extern "C" int cg_advance_launch(int accum_code, void* gamma, void* gamma_new,
                                 void* rr, void* rr_new, void* k,
                                 void* active, const void* thr, int maxiter,
                                 void* beta, const void* rz_part,
                                 const void* rr_part, long long npl,
                                 long long stride, long long lanes,
                                 void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (accum_code) {
    case kF64:
      return launch_advance<double>(gamma, gamma_new, rr, rr_new, k, active,
                                    thr, maxiter, beta, rz_part, rr_part, npl,
                                    stride, lanes, count, s);
    case kF32:
      return launch_advance<float>(gamma, gamma_new, rr, rr_new, k, active,
                                   thr, maxiter, beta, rz_part, rr_part, npl,
                                   stride, lanes, count, s);
    default: return -1;
  }
}
