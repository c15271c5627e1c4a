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
// 9.  spmv_dot is the streaming core of dia_rows.cuh (several rows per
// thread, every load issued before the first multiply, offsets in the
// parameter bank, streaming hints for the bands) with a p.Ap epilogue.
// axpy_precond is one thread per row over all parts, with coalesced
// neighbouring-thread accesses; its five loads are independent, so one row
// per thread keeps enough bytes in flight.  The reductions write one
// accum-width partial per kThreads (256) consecutive flat rows, summed in
// block_sum's fixed tree order; the wrapper sums the partials with
// torch.sum.  No atomics: the order of every sum is fixed, so Krylov
// iteration counts reproduce from run to run.
#include "dia_rows.cuh"

using namespace repro;

// ---------------------------------------------------------------------------
// (A p, p . A p): the rows of dia_rows.cuh plus the p.Ap partial of each
// 256-row block, from the accum-width row sums before they are narrowed.
// The partial is summed in exactly block_sum's order over the block's rows
// v[0..255]: level s adds v[r + s] to v[r] for r < s, s = 128, 64, ..., 1.
// Thread t of a group holds v[t + kDiaGroup*k], so the levels 128 down to
// kDiaGroup are its own rows, the levels down to 32 cross the group's
// warps through shared memory, and 16 down to 1 are warp shuffles.
// ---------------------------------------------------------------------------
template <typename S, typename A, int NB>
__global__ void __launch_bounds__(kDiaThreads)
spmv_dot_kernel(const S* __restrict__ bands, const S* __restrict__ x,
                S* __restrict__ y, A* __restrict__ partials,
                const __grid_constant__ DiaArgs a) {
  const long long blk = static_cast<long long>(blockIdx.x) * kDiaTile;
  const int t = threadIdx.x % kDiaGroup;
  const long long row0 = blk + (threadIdx.x / kDiaGroup) * kThreads;
  A acc[kDiaRows], xg[kDiaRows];
  if (blk >= a.lo && blk + kDiaTile <= a.hi)
    dia_rows<S, A, NB, false, true>(bands, x, y, a, row0 + t, acc, xg);
  else
    dia_rows<S, A, NB, true, true>(bands, x, y, a, row0 + t, acc, xg);
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
  if (t == 0 && row0 < a.n) partials[row0 / kThreads] = sum;
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
                           void* partials, const DiaArgs& a,
                           cudaStream_t stream) {
  if (a.n == 0) return 0;
  const S* b = static_cast<const S*>(bands);
  const S* xs = static_cast<const S*>(x);
  S* ys = static_cast<S*>(y);
  A* part = static_cast<A*>(partials);
  if (a.nb == 7)
    spmv_dot_kernel<S, A, 7><<<dia_blocks(a.n), kDiaThreads, 0, stream>>>(
        b, xs, ys, part, a);
  else
    spmv_dot_kernel<S, A, kMaxBands>
        <<<dia_blocks(a.n), kDiaThreads, 0, stream>>>(b, xs, ys, part, a);
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

// bands (P, nb, m), x (P, m) -> y (P, m), partials (ceil(P*m / 256),);
// nb <= 8.
// Returns cudaGetLastError() after the launch; -1 for an unknown dtype code.
extern "C" int spmv_dot_launch(int dtype_code, const void* bands,
                               const void* x, void* y, void* partials,
                               long long P, long long m,
                               const long long* offsets, int nb,
                               void* stream) {
  const DiaArgs a = make_dia_args(offsets, nb, P, m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case kF64: return launch_spmv_dot<double, double>(bands, x, y, partials, a, s);
    case kF32: return launch_spmv_dot<float, float>(bands, x, y, partials, a, s);
    case kBF16F32:
      return launch_spmv_dot<__nv_bfloat16, float>(bands, x, y, partials, a, s);
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
