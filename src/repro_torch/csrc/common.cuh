// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// Dtype pairs: every kernel is instantiated for the (storage, accum) pairs
// the JAX kernels take — (double, double), (float, float) and
// (__nv_bfloat16, float) — selected at run time by a small integer code
// that the Python wrappers pass (see kernels/_build.py: DTYPE_CODES).
//
// The libraries are built with -fmad=false: a kernel then rounds after
// every multiply and every add, in the same order as its plain PyTorch
// version, so element-wise outputs agree with it bit for bit and only the
// block reductions differ in order.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace repro {

// threads (= rows) per block of the one-row-per-thread kernels, and the
// rows of one partial of every reduction
constexpr int kThreads = 256;
constexpr int kMaxBands = 8;

enum DtypeCode { kF64 = 0, kF32 = 1, kBF16F32 = 2 };

// Widening load and narrowing store between storage and accum/compute types.
template <typename To, typename From>
__device__ __forceinline__ To cvt(From v) { return static_cast<To>(v); }
template <>
__device__ __forceinline__ float cvt<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

// The type element-wise arithmetic on a storage type is carried out in:
// bf16 values are widened to float and every result rounded back, which is
// what PyTorch's own bf16 element-wise kernels do.
template <typename S> struct Compute { using type = S; };
template <> struct Compute<__nv_bfloat16> { using type = float; };

// IEEE round-to-nearest arithmetic, never contracted.
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// One value of the CG direction update p <- z + beta p in the compute type
// C, with z, p and beta already rounded to the storage dtype S and widened:
// the product rounded to S, then the sum, as PyTorch's eager
// `z + beta.to(z.dtype) * p` rounds (cg_direction_kernel, krylov_loop.cu,
// and the fold in spmv_dot_direction_kernel, krylov_fused.cu).
template <typename S, typename C>
__device__ __forceinline__ C cg_step(C z, C p, C beta) {
  const C t = cvt<C>(cvt<S>(mul_rn(beta, p)));
  return cvt<C>(cvt<S>(add_rn(z, t)));
}

// The CG loop's two direction buffers (solvers/cg.py): iteration k reads
// the direction from buffer k % 2 and writes the next one to buffer
// (k + 1) % 2, so no block overwrites a value that another block still
// reads at a halo offset.
template <typename T>
__device__ __forceinline__ T* dir_buf(T* buf0, T* buf1, int k) {
  return (k & 1) ? buf1 : buf0;
}

// The reductions (spmv_dot_kernel, axpy_precond_kernel) write one
// accum-width partial per kThreads consecutive flat rows v[0..kThreads-1]
// (zero past the vector's end), summed in one fixed tree order: level s =
// kThreads/2, ..., 2, 1 adds v[r + s] to v[r] for every r < s.  No atomics,
// so a run reproduces its partials bit for bit, and
// kernels/krylov_fused's block_partials_plain is that order in PyTorch.

// The Krylov loops' launch counters.  A launch that runs from a replayed
// CUDA graph never passes through its Python wrapper, so a guarded kernel
// counts itself: once its guard has passed, thread 0 of block 0 adds one
// to `count` (null: not counted).  Launches on one stream do not overlap
// and one thread writes, so no atomic is needed.
__device__ __forceinline__ void count_launch(unsigned long long* count) {
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *count += 1;
}

// Lanes.  A cohort of B systems of one shape (solvers/device_loop.py) runs
// as one launch with gridDim.y = B: block row y works on lane y alone, at
// lane offsets of its operands, exactly as a launch on that lane alone
// would (same grid along x, same rows, same partials), and reads only
// lane y's flag active[y].  Nothing crosses a lane border.  A guarded
// launch counts once when any lane's flag is set: thread 0 of block (0, 0)
// reads the B flags.  B = 1 is the single-system launch.
__device__ __forceinline__ void count_lanes(const bool* active,
                                            unsigned long long* count) {
  if (count == nullptr || blockIdx.x != 0 || blockIdx.y != 0 ||
      threadIdx.x != 0)
    return;
  bool any = false;
  for (unsigned int l = 0; l < gridDim.y; ++l) any = any || active[l];
  if (any) *count += 1;
}

inline unsigned int n_blocks(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace repro
