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
// Bound: bytes.  Per row it reads nb band values and (through the cache)
// one x value, and writes one y value — 72 bytes in f64 for 7 bands —
// against 2*nb flops, far below the card's ratio of flops to bytes.  The
// design is one thread per row over all parts: neighbouring threads read
// neighbouring band and x addresses (coalesced), and the seven shifted x
// reads of a block hit the same few cache lines, so x is read from device
// memory about once.  Bands accumulate in band order, as the plain version
// does.
#include "common.cuh"

using namespace repro;

template <typename S, typename A>
__global__ void spmv_dia_kernel(const S* __restrict__ bands,
                                const S* __restrict__ x, S* __restrict__ y,
                                long long m, long long n, BandOffsets offs) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= n) return;
  const long long p = g / m;
  const S* b = bands + p * offs.nb * m + (g - p * m);
  A acc = A(0);
  for (int d = 0; d < offs.nb; ++d) {
    const long long j = g + offs.off[d];
    const A xv = (j >= 0 && j < n) ? cvt<A>(x[j]) : A(0);
    acc = acc + cvt<A>(b[d * m]) * xv;
  }
  y[g] = cvt<S>(acc);
}

template <typename S, typename A>
static int launch(const void* bands, const void* x, void* y, long long P,
                  long long m, BandOffsets offs, cudaStream_t stream) {
  const long long n = P * m;
  if (n == 0) return 0;
  spmv_dia_kernel<S, A><<<n_blocks(n), kThreads, 0, stream>>>(
      static_cast<const S*>(bands), static_cast<const S*>(x),
      static_cast<S*>(y), m, n, offs);
  return static_cast<int>(cudaGetLastError());
}

// bands (P, nb, m), x (P, m), y (P, m): all contiguous, on one device.
// Returns cudaGetLastError() after the launch (0 on success); -1 for an
// unknown dtype code.
extern "C" int spmv_dia_launch(int dtype_code, const void* bands,
                               const void* x, void* y, long long P,
                               long long m, const long long* offsets, int nb,
                               void* stream) {
  const BandOffsets offs = make_offsets(offsets, nb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case kF64: return launch<double, double>(bands, x, y, P, m, offs, s);
    case kF32: return launch<float, float>(bands, x, y, P, m, offs, s);
    case kBF16F32: return launch<__nv_bfloat16, float>(bands, x, y, P, m, offs, s);
    default: return -1;
  }
}
