// Banded (DIA) SpMV over stacked parts — the Krylov solvers' matvec.
//
// Replaces the TPU kernel `spmv_dia_single` (src/repro/kernels/spmv_dia/
// spmv_dia.py, body `_kernel`) and its stacked wrapper `spmv_dia_pallas`
// (src/repro/kernels/spmv_dia/ops.py).
//
// Computes y[p, i] = sum_d bands[p, d, i] * x_pad[p, plane + i + off_d] with
// x_pad = [down halo | x[p] | up halo].  On the contiguous stacked layout
// (P, m) the halo of part p is the neighbouring parts' boundary planes, so
// x_pad[p, plane + i + off] is the flat vector at g + off (g = p*m + i),
// and zero outside [0, P*m): no halo copy is made.  That needs
// |off_d| <= plane <= m, which the wrapper checks.
//
// Bound: bytes (72 B per row in f64 for 7 bands against 14 flops).  The
// row loop is the streaming core of dia_rows.cuh, whose notes say what
// limits it on the H100 and what the design does about it; this kernel is
// that core with no epilogue.
#include "dia_rows.cuh"

using namespace repro;

template <typename S, typename A, int NB, bool kLanes>
__global__ void __launch_bounds__(kDiaThreads)
spmv_dia_kernel(const S* __restrict__ bands, const S* __restrict__ x,
                S* __restrict__ y, const __grid_constant__ DiaArgs a) {
  if (dia_idle<kLanes>(a)) return;
  if constexpr (kLanes) {
    bands = lane_ptr(bands, a.n * a.nb);
    x = lane_ptr(x, a.n);
    y = lane_ptr(y, a.n);
  }
  const long long blk = static_cast<long long>(blockIdx.x) * kDiaTile;
  const long long g0 = blk + (threadIdx.x / kDiaGroup) * kThreads +
                       threadIdx.x % kDiaGroup;
  A acc[kDiaRows], xg[kDiaRows];
  if (blk >= a.lo && blk + kDiaTile <= a.hi)
    dia_rows<S, A, NB, false, false>(bands, x, y, a, g0, acc, xg);
  else
    dia_rows<S, A, NB, true, false>(bands, x, y, a, g0, acc, xg);
}

template <typename S, typename A, int NB>
static void launch_nb(const S* b, const S* x, S* y, const DiaArgs& a,
                      long long lanes, cudaStream_t stream) {
  if (lanes > 1)
    spmv_dia_kernel<S, A, NB, true>
        <<<dia_grid(a.n, lanes), kDiaThreads, 0, stream>>>(b, x, y, a);
  else
    spmv_dia_kernel<S, A, NB, false>
        <<<dia_grid(a.n, 1), kDiaThreads, 0, stream>>>(b, x, y, a);
}

template <typename S, typename A>
static int launch(const void* bands, const void* x, void* y,
                  const DiaArgs& a, long long lanes, cudaStream_t stream) {
  if (a.n == 0) return 0;
  const S* b = static_cast<const S*>(bands);
  const S* xs = static_cast<const S*>(x);
  S* ys = static_cast<S*>(y);
  if (a.nb == 7)
    launch_nb<S, A, 7>(b, xs, ys, a, lanes, stream);
  else
    launch_nb<S, A, kMaxBands>(b, xs, ys, a, lanes, stream);
  return static_cast<int>(cudaGetLastError());
}

// bands (lanes*P, nb, m), x (lanes*P, m), y (lanes*P, m): all contiguous,
// on one device; nb <= 8; each lane of P parts a system of its own.
// Returns cudaGetLastError() after the launch (0 on success); -1 for an
// unknown dtype code or lane count.
static int dispatch(int dtype_code, const void* bands, const void* x, void* y,
                    const DiaArgs& a, long long lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || lanes > 65535) return -1;
  switch (dtype_code) {
    case kF64: return launch<double, double>(bands, x, y, a, lanes, s);
    case kF32: return launch<float, float>(bands, x, y, a, lanes, s);
    case kBF16F32:
      return launch<__nv_bfloat16, float>(bands, x, y, a, lanes, s);
    default: return -1;
  }
}

extern "C" int spmv_dia_launch(int dtype_code, const void* bands,
                               const void* x, void* y, long long P,
                               long long m, const long long* offsets, int nb,
                               long long lanes, void* stream) {
  return dispatch(dtype_code, bands, x, y, make_dia_args(offsets, nb, P, m),
                  lanes, stream);
}

// The same under the Krylov loops' guard: nothing of lane l is read or
// written while the one-byte device flag active[l] is false; a launch in
// which any lane runs adds one to the device counter `count` (one unsigned
// 64-bit value).
extern "C" int spmv_dia_guarded_launch(int dtype_code, const void* bands,
                                       const void* x, void* y, long long P,
                                       long long m, const long long* offsets,
                                       int nb, long long lanes,
                                       const void* active, void* count,
                                       void* stream) {
  return dispatch(dtype_code, bands, x, y,
                  make_dia_args(offsets, nb, P, m, active, count), lanes,
                  stream);
}
