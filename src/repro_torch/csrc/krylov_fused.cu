// Fused Krylov-iteration kernels for the pressure CG: one-pass SpMV + p.Ap,
// and one-pass axpy pair + Jacobi apply + (r.z, r.r).
//
// Replaces the TPU kernels of src/repro/kernels/krylov_fused/krylov_fused.py:
//   * `spmv_dot_single` (body `_spmv_dot_kernel`; stacked wrapper
//     `fused_matvec_dot`, krylov_fused/ops.py) — (A p, p . A p);
//   * `fused_axpy_precond_single` (body `_axpy_precond_kernel`; stacked
//     wrapper `fused_update_step`) — x' = x + alpha p, r' = r - alpha Ap,
//     z = r' * inv_diag, and the r'.z and r'.r' dots.
//
// Bound: bytes.  spmv_dot moves 72 bytes per row in f64 (7 bands, p, Ap)
// for 2*7 + 2 flops; axpy_precond moves 64 (five reads, three writes) for
// 9.  Both are one thread per row over all parts, with coalesced
// neighbouring-thread accesses, so each input is read once and each output
// written once.  The reductions write one accum-width partial per block of
// kThreads rows, summed inside the block in a fixed tree order; the wrapper
// sums the partials with torch.sum.  No atomics: the order of every sum is
// fixed, so Krylov iteration counts reproduce from run to run.
#include "common.cuh"

using namespace repro;

// ---------------------------------------------------------------------------
// (A p, p . A p): the DIA SpMV of spmv_dia.cu plus a p.Ap block partial taken
// from the accum-width row sum, before it is narrowed to the storage dtype.
// ---------------------------------------------------------------------------
template <typename S, typename A>
__global__ void spmv_dot_kernel(const S* __restrict__ bands,
                                const S* __restrict__ x, S* __restrict__ y,
                                A* __restrict__ partials, long long m,
                                long long n, BandOffsets offs) {
  __shared__ A smem[kThreads];
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  A prod = A(0);
  if (g < n) {
    const long long p = g / m;
    const S* b = bands + p * offs.nb * m + (g - p * m);
    A acc = A(0);
    for (int d = 0; d < offs.nb; ++d) {
      const long long j = g + offs.off[d];
      const A xv = (j >= 0 && j < n) ? cvt<A>(x[j]) : A(0);
      acc = acc + cvt<A>(b[d * m]) * xv;
    }
    y[g] = cvt<S>(acc);
    prod = cvt<A>(x[g]) * acc;
  }
  const A total = block_sum(prod, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// ---------------------------------------------------------------------------
// The second half of a CG iteration.  alpha is read from device memory (the
// accum-width gamma / pAp the solver just computed: no host round trip) and
// narrowed to the storage dtype, as the TPU kernel's wrapper does.
// ---------------------------------------------------------------------------
template <typename S, typename A>
__global__ void axpy_precond_kernel(const S* __restrict__ x,
                                    const S* __restrict__ r,
                                    const S* __restrict__ p,
                                    const S* __restrict__ ap,
                                    const S* __restrict__ inv,
                                    const A* __restrict__ alpha,
                                    S* __restrict__ xo, S* __restrict__ ro,
                                    S* __restrict__ zo, A* __restrict__ rz_part,
                                    A* __restrict__ rr_part, long long n) {
  using C = typename Compute<S>::type;
  __shared__ A smem[kThreads];
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  A rz = A(0), rr = A(0);
  if (g < n) {
    // every product and sum is rounded to the storage dtype, as the plain
    // version's separate element-wise ops are
    const C a = cvt<C>(cvt<S>(*alpha));
    const C ap_scaled = cvt<C>(cvt<S>(a * cvt<C>(ap[g])));
    const C p_scaled = cvt<C>(cvt<S>(a * cvt<C>(p[g])));
    const S xn = cvt<S>(cvt<C>(x[g]) + p_scaled);
    const S rn = cvt<S>(cvt<C>(r[g]) - ap_scaled);
    const S z = cvt<S>(cvt<C>(rn) * cvt<C>(inv[g]));
    xo[g] = xn;
    ro[g] = rn;
    zo[g] = z;
    const A rn_a = cvt<A>(rn);
    rz = rn_a * cvt<A>(z);
    rr = rn_a * rn_a;
  }
  const A rz_total = block_sum(rz, smem);
  const A rr_total = block_sum(rr, smem);
  if (threadIdx.x == 0) {
    rz_part[blockIdx.x] = rz_total;
    rr_part[blockIdx.x] = rr_total;
  }
}

template <typename S, typename A>
static int launch_spmv_dot(const void* bands, const void* x, void* y,
                           void* partials, long long P, long long m,
                           BandOffsets offs, cudaStream_t stream) {
  const long long n = P * m;
  if (n == 0) return 0;
  spmv_dot_kernel<S, A><<<n_blocks(n), kThreads, 0, stream>>>(
      static_cast<const S*>(bands), static_cast<const S*>(x),
      static_cast<S*>(y), static_cast<A*>(partials), m, n, offs);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename A>
static int launch_axpy(const void* const* in, const void* alpha,
                       void* const* out, long long n, cudaStream_t stream) {
  if (n == 0) return 0;
  axpy_precond_kernel<S, A><<<n_blocks(n), kThreads, 0, stream>>>(
      static_cast<const S*>(in[0]), static_cast<const S*>(in[1]),
      static_cast<const S*>(in[2]), static_cast<const S*>(in[3]),
      static_cast<const S*>(in[4]), static_cast<const A*>(alpha),
      static_cast<S*>(out[0]), static_cast<S*>(out[1]),
      static_cast<S*>(out[2]), static_cast<A*>(out[3]),
      static_cast<A*>(out[4]), n);
  return static_cast<int>(cudaGetLastError());
}

// bands (P, nb, m), x (P, m) -> y (P, m), partials (ceil(P*m / 256),).
// Returns cudaGetLastError() after the launch; -1 for an unknown dtype code.
extern "C" int spmv_dot_launch(int dtype_code, const void* bands,
                               const void* x, void* y, void* partials,
                               long long P, long long m,
                               const long long* offsets, int nb,
                               void* stream) {
  const BandOffsets offs = make_offsets(offsets, nb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case kF64: return launch_spmv_dot<double, double>(bands, x, y, partials, P, m, offs, s);
    case kF32: return launch_spmv_dot<float, float>(bands, x, y, partials, P, m, offs, s);
    case kBF16F32:
      return launch_spmv_dot<__nv_bfloat16, float>(bands, x, y, partials, P, m, offs, s);
    default: return -1;
  }
}

// x, r, p, Ap, inv_diag (n,) and a device scalar alpha (accum dtype) ->
// x', r', z (n,) and the r.z, r.r partials (ceil(n / 256),) each.
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
