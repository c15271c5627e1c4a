// On-device momentum assembly into DIA bands — the paper's "full
// refactoring" baseline: face fluxes and conductances straight to the 7
// bands, with no LDU buffers and no repartition update.
//
// Replaces the TPU kernel `momentum_bands_single` (src/repro/kernels/
// stencil_assembly/stencil_assembly.py, body `_kernel`) and its stacked
// wrapper `momentum_bands_pallas` (src/repro/kernels/stencil_assembly/
// ops.py).
//
// Inputs are seven cell-indexed face arrays, stacked (P, m) and contiguous:
// phi_x[c] is the flux through the face between cells c and c+1 (zero where
// there is none), phi_y and phi_z likewise at strides nx and plane; gx, gy,
// gz the diffusive conductances with the same masking; bnd the boundary
// closure of the diagonal.  Output (P, 7, m) in the band order
// [-plane, -nx, -1, 0, +1, +nx, +plane]:
//   off-diagonal toward c+s:  min(phi_s[c], 0) - g_s[c]
//   off-diagonal toward c-s:  min(-phi_s[c-s], 0) - g_s[c-s]
//   diagonal:  vdt + bnd + sum over the six faces of max(+-phi, 0) + g,
// summed left to right in the TPU kernel's order, so that with -fmad=false
// the kernel rounds exactly as its plain version does.
//
// Halo without copies: the TPU wrapper pads every part by `plane` on both
// sides and fills the left pad of phi_z and gz from the previous part's top
// plane.  Here the arrays are read flat, with [0, P*m) the only valid
// range.  A -plane read at a part's first plane then lands on the previous
// part's top plane of phi_z / gz, which is the TPU wrapper's halo fill; a
// -1 or -nx read that crosses a row, plane or part edge lands on a cell
// whose +x / +y face is absent, where phi and g are zero, as the TPU
// wrapper's zero pad gives.  So no padded copies are made and the row count
// need not be a multiple of any block.
//
// Bound: bytes.  Per row it reads 7 values (the shifted reads hit lines
// that neighbouring rows, or rows `plane` earlier, brought into the cache)
// and writes 7, 112 bytes in f64, against about 25 additions and
// comparisons.  One thread per row over all parts: every read and write is
// coalesced.  nx, plane and vdt are scalar arguments, so no band-offset
// table is indexed in a loop (which put the SpMV kernels' offsets in a
// local-memory frame).
#include "common.cuh"

using namespace repro;

// min(a, 0) and max(a, 0) that pass a NaN through, as torch's clamps do
template <typename T>
__device__ __forceinline__ T min0(T a) { return a > T(0) ? T(0) : a; }
template <typename T>
__device__ __forceinline__ T max0(T a) { return a < T(0) ? T(0) : a; }

template <typename T>
__global__ void momentum_bands_kernel(
    const T* __restrict__ phi_x, const T* __restrict__ phi_y,
    const T* __restrict__ phi_z, const T* __restrict__ gx,
    const T* __restrict__ gy, const T* __restrict__ gz,
    const T* __restrict__ bnd, T* __restrict__ out, long long m, long long n,
    long long nx, long long plane, T vdt) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= n) return;
  const long long p = g / m;
  const T px = phi_x[g], py = phi_y[g], pz = phi_z[g];
  const T cgx = gx[g], cgy = gy[g], cgz = gz[g];
  const T pxm = g >= 1 ? phi_x[g - 1] : T(0);
  const T cgxm = g >= 1 ? gx[g - 1] : T(0);
  const T pym = g >= nx ? phi_y[g - nx] : T(0);
  const T cgym = g >= nx ? gy[g - nx] : T(0);
  const T pzm = g >= plane ? phi_z[g - plane] : T(0);
  const T cgzm = g >= plane ? gz[g - plane] : T(0);

  T d = vdt + bnd[g];
  d = d + max0(px);
  d = d + cgx;
  d = d + max0(-pxm);
  d = d + cgxm;
  d = d + max0(py);
  d = d + cgy;
  d = d + max0(-pym);
  d = d + cgym;
  d = d + max0(pz);
  d = d + cgz;
  d = d + max0(-pzm);
  d = d + cgzm;

  T* o = out + p * 7 * m + (g - p * m);
  o[0] = min0(-pzm) - cgzm;
  o[m] = min0(-pym) - cgym;
  o[2 * m] = min0(-pxm) - cgxm;
  o[3 * m] = d;
  o[4 * m] = min0(px) - cgx;
  o[5 * m] = min0(py) - cgy;
  o[6 * m] = min0(pz) - cgz;
}

template <typename T>
static int launch(const void* const* in, void* out, long long P, long long m,
                  long long nx, long long plane, double vdt,
                  cudaStream_t stream) {
  const long long n = P * m;
  if (n == 0) return 0;
  const T* a[7];
  for (int k = 0; k < 7; ++k) a[k] = static_cast<const T*>(in[k]);
  momentum_bands_kernel<T><<<n_blocks(n), kThreads, 0, stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], static_cast<T*>(out), m, n,
      nx, plane, static_cast<T>(vdt));
  return static_cast<int>(cudaGetLastError());
}

// phi_x, phi_y, phi_z, gx, gy, gz, bnd (P, m) each, out (P, 7, m): all
// contiguous, on one device, of one dtype (code kF64 or kF32).  Returns
// cudaGetLastError() after the launch (0 on success); -1 for another code.
extern "C" int momentum_bands_launch(
    int dtype_code, const void* phi_x, const void* phi_y, const void* phi_z,
    const void* gx, const void* gy, const void* gz, const void* bnd,
    void* out, long long P, long long m, long long nx, long long plane,
    double vdt, void* stream) {
  const void* in[7] = {phi_x, phi_y, phi_z, gx, gy, gz, bnd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case kF64: return launch<double>(in, out, P, m, nx, plane, vdt, s);
    case kF32: return launch<float>(in, out, P, m, nx, plane, vdt, s);
    default: return -1;
  }
}
