// Repartition value update — the permutation P∘U applied to the staged
// coefficient buffers (paper fig. 3b).
//
// Replaces the TPU kernel `coef_update_single` (src/repro/kernels/
// coef_update/coef_update.py, body `_kernel`) and its stacked wrapper
// `coef_update_pallas` (src/repro/kernels/coef_update/ops.py).
//
// Computes out[c, i] = buf[c, src[i]] for every coarse part c: the plan is
// uniform across coarse parts, so one int32 index serves all of them.
// `buf` (n_c, n_buf) holds each part's alpha concatenated fine-part LDU
// buffers plus a trailing sentinel zero slot, and empty band positions
// index that slot, so src[i] may equal n_buf - 1: the kernel relies on no
// bound tighter than src[i] < n_buf, which the plan guarantees.  Part
// offsets c * n_buf are computed in 64 bits (at 210^3 / alpha 30 one part's
// buffer alone is 64.65M entries).
//
// Bound: bytes.  Per output it reads a 4-byte index and writes one value,
// and every buffer value is read about once; no arithmetic is done.  The
// TPU kernel keeps the whole staging buffer in VMEM (a 3M-entry budget);
// on Hopper a buffer of that size does not fit any on-chip memory, so the
// design is one thread per output over all parts: index reads and output
// writes are coalesced, and the buffer reads follow the plan's band order,
// which walks the buffer in runs (the diagonal, the upper and lower face
// arrays), so neighbouring threads mostly hit neighbouring cache lines.
// The tail is guarded: no padding of src to a block multiple.  The kernel
// moves raw bits, templated on the element width, so one instantiation
// serves each of float64, float32 and bfloat16 and the result is bit for
// bit the plain version's.
#include "common.cuh"

#include <cstdint>

using namespace repro;

template <typename W>
__global__ void coef_update_kernel(const W* __restrict__ buf,
                                   const int32_t* __restrict__ src,
                                   W* __restrict__ out, long long n_buf,
                                   long long n_out, long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long c = t / n_out;
  const long long i = t - c * n_out;
  out[t] = buf[c * n_buf + static_cast<long long>(src[i])];
}

template <typename W>
static int launch(const void* buf, const void* src, void* out, long long n_c,
                  long long n_buf, long long n_out, cudaStream_t stream) {
  const long long total = n_c * n_out;
  if (total == 0) return 0;
  coef_update_kernel<W><<<n_blocks(total), kThreads, 0, stream>>>(
      static_cast<const W*>(buf), static_cast<const int32_t*>(src),
      static_cast<W*>(out), n_buf, n_out, total);
  return static_cast<int>(cudaGetLastError());
}

// buf (n_c, n_buf), src (n_out,) int32, out (n_c, n_out): contiguous, on one
// device; itemsize is the element width in bytes (8, 4 or 2).  Returns
// cudaGetLastError() after the launch (0 on success); -1 for another width.
extern "C" int coef_update_launch(int itemsize, const void* buf,
                                  const void* src, void* out, long long n_c,
                                  long long n_buf, long long n_out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 8: return launch<uint64_t>(buf, src, out, n_c, n_buf, n_out, s);
    case 4: return launch<uint32_t>(buf, src, out, n_c, n_buf, n_out, s);
    case 2: return launch<uint16_t>(buf, src, out, n_c, n_buf, n_out, s);
    default: return -1;
  }
}
