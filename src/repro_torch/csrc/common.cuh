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

// Block-wide sum of one value per thread in a fixed tree order (no
// atomics), so a run reproduces its partials bit for bit.  `smem` holds
// kThreads entries; the trailing barrier lets the caller reuse it at once.
template <typename A>
__device__ __forceinline__ A block_sum(A v, A* smem) {
  smem[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) smem[threadIdx.x] = smem[threadIdx.x] + smem[threadIdx.x + s];
    __syncthreads();
  }
  A total = smem[0];
  __syncthreads();
  return total;
}

inline unsigned int n_blocks(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace repro
