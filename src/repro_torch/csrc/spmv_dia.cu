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

template <typename S, typename A, int NB>
__global__ void __launch_bounds__(kDiaThreads)
spmv_dia_kernel(const S* __restrict__ bands, const S* __restrict__ x,
                S* __restrict__ y, const __grid_constant__ DiaArgs a) {
  if (dia_idle(a)) return;
  const long long blk = static_cast<long long>(blockIdx.x) * kDiaTile;
  const long long g0 = blk + (threadIdx.x / kDiaGroup) * kThreads +
                       threadIdx.x % kDiaGroup;
  A acc[kDiaRows], xg[kDiaRows];
  if (blk >= a.lo && blk + kDiaTile <= a.hi)
    dia_rows<S, A, NB, false, false>(bands, x, y, a, g0, acc, xg);
  else
    dia_rows<S, A, NB, true, false>(bands, x, y, a, g0, acc, xg);
}

template <typename S, typename A>
static int launch(const void* bands, const void* x, void* y,
                  const DiaArgs& a, cudaStream_t stream) {
  if (a.n == 0) return 0;
  const S* b = static_cast<const S*>(bands);
  const S* xs = static_cast<const S*>(x);
  S* ys = static_cast<S*>(y);
  if (a.nb == 7)
    spmv_dia_kernel<S, A, 7><<<dia_blocks(a.n), kDiaThreads, 0, stream>>>(
        b, xs, ys, a);
  else
    spmv_dia_kernel<S, A, kMaxBands>
        <<<dia_blocks(a.n), kDiaThreads, 0, stream>>>(b, xs, ys, a);
  return static_cast<int>(cudaGetLastError());
}

// bands (P, nb, m), x (P, m), y (P, m): all contiguous, on one device;
// nb <= 8.  Returns cudaGetLastError() after the launch (0 on success); -1
// for an unknown dtype code.
static int dispatch(int dtype_code, const void* bands, const void* x, void* y,
                    const DiaArgs& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case kF64: return launch<double, double>(bands, x, y, a, s);
    case kF32: return launch<float, float>(bands, x, y, a, s);
    case kBF16F32: return launch<__nv_bfloat16, float>(bands, x, y, a, s);
    default: return -1;
  }
}

extern "C" int spmv_dia_launch(int dtype_code, const void* bands,
                               const void* x, void* y, long long P,
                               long long m, const long long* offsets, int nb,
                               void* stream) {
  return dispatch(dtype_code, bands, x, y, make_dia_args(offsets, nb, P, m),
                  stream);
}

// The same under the Krylov loops' guard: nothing is read or written while
// the one-byte device flag `active` is false; a launch that runs adds one
// to the device counter `count` (one unsigned 64-bit value).
extern "C" int spmv_dia_guarded_launch(int dtype_code, const void* bands,
                                       const void* x, void* y, long long P,
                                       long long m, const long long* offsets,
                                       int nb, const void* active,
                                       void* count, void* stream) {
  return dispatch(dtype_code, bands, x, y,
                  make_dia_args(offsets, nb, P, m, active, count), stream);
}
