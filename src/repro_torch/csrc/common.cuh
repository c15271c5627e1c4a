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

inline unsigned int n_blocks(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace repro
