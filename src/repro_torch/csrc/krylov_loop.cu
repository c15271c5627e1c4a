// Device-side control of the Krylov loops that solvers/device_loop.py runs
// as captured CUDA-graph blocks: the CG direction update and the CG loop
// guard.
//
// Port-only kernels: no TPU kernel does this work.  They replace, in the
// JAX solver src/repro/solvers/cg.py, the body line
// `p = z + beta.astype(z.dtype) * p` with beta = gamma_new / gamma (:74;
// cg_direction_kernel) and the `lax.while_loop` carry update and condition
// (`cond` :64, the loop :78; cg_advance_kernel).
//
// The CG loop itself no longer launches cg_direction: the update is folded
// into the next iteration's SpMV+dot (spmv_dot_direction_kernel,
// krylov_fused.cu), which reads the beta that cg_advance keeps.
// cg_direction stays as the unfused form the fold is held against.
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
// Lanes.  A cohort of B systems runs as one launch: cg_direction with
// gridDim.y = B (block row y is lane y: its rows, its gamma pair and its
// flag, common.cuh), cg_advance with one thread per lane.  Each launch
// counts once when any lane's flag is set.
//
// Rounding.  cg_direction must give the bits of PyTorch's eager
// `z + beta.to(z.dtype) * p`: beta is an IEEE division at the accum width,
// rounded to the storage dtype; the product and the sum are each rounded
// to the storage dtype, with no contraction (__dmul_rn / __dadd_rn,
// __fmul_rn / __fadd_rn; bf16 widens to float and rounds back after the
// multiply and again after the add, as PyTorch's bf16 element-wise kernels
// do).
//
// Bound: bytes.  cg_direction reads z and p and writes p: 3 values per row
// (222 MB in f64 at the 210^3 pressure shape, a 0.066 ms floor at
// 3.35 TB/s) against 2 flops; each thread moves one 16-byte vector of each
// operand, z through the read-only path and p, which the kernel writes,
// through plain coherent loads.  The eager pair it replaces launches two
// kernels and moves 5 values per row.  cg_advance is one thread: its time
// is the launch.
#include "common.cuh"

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

// The loop guard, one thread per lane (see the notes at the top).  Every
// thread reads its flag before any writes one, so thread 0 counts the
// launch when any lane goes on.  beta (null: not kept) takes gamma_new /
// gamma before gamma is overwritten: the next iteration's direction update
// reads it (spmv_dot_direction_kernel).
template <typename A>
__global__ void cg_advance_kernel(A* gamma, const A* gamma_new, A* rr,
                                  const A* rr_new, int* k, bool* active,
                                  const A* thr, int maxiter, A* beta,
                                  unsigned long long* count) {
  const int l = threadIdx.x;
  const bool on = active[l];
  const int any = __syncthreads_or(on);
  if (l == 0 && any && count != nullptr) *count += 1;
  if (!on) return;
  if (beta != nullptr) beta[l] = div_rn(gamma_new[l], gamma[l]);
  gamma[l] = gamma_new[l];
  const A r = rr_new[l];
  rr[l] = r;
  const int kn = k[l] + 1;
  k[l] = kn;
  active[l] = r > thr[l] && kn < maxiter;
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
static int launch_advance(void* gamma, const void* gamma_new, void* rr,
                          const void* rr_new, void* k, void* active,
                          const void* thr, int maxiter, void* beta,
                          long long lanes, void* count, cudaStream_t stream) {
  if (lanes < 1 || lanes > 1024) return -1;
  cg_advance_kernel<A><<<1, static_cast<unsigned int>(lanes), 0, stream>>>(
      static_cast<A*>(gamma), static_cast<const A*>(gamma_new),
      static_cast<A*>(rr), static_cast<const A*>(rr_new), static_cast<int*>(k),
      static_cast<bool*>(active), static_cast<const A*>(thr), maxiter,
      static_cast<A*>(beta), static_cast<unsigned long long*>(count));
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

// gamma, gamma_new, rr, rr_new, thr, beta: one accum value per lane (code
// kF64: double, kF32: float; beta may be null); k one int32 per lane;
// active one byte per lane; count as for cg_direction_launch; at most 1024
// lanes.
extern "C" int cg_advance_launch(int accum_code, void* gamma,
                                 const void* gamma_new, void* rr,
                                 const void* rr_new, void* k, void* active,
                                 const void* thr, int maxiter, void* beta,
                                 long long lanes, void* count,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (accum_code) {
    case kF64:
      return launch_advance<double>(gamma, gamma_new, rr, rr_new, k, active, thr,
                                    maxiter, beta, lanes, count, s);
    case kF32:
      return launch_advance<float>(gamma, gamma_new, rr, rr_new, k, active, thr,
                                   maxiter, beta, lanes, count, s);
    default: return -1;
  }
}
