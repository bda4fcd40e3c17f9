// The generic target part of the device runtime: a target that provides
// no intrinsic (src/repro_torch/core/targets/generic.py gives the define
// that selects it).  Everything a portable kernel needs still works,
// through the portable part or plain CUDA: the warp reductions go
// through shared memory (the same butterfly as the sm_90 part, each
// exchange a store, a warp barrier and a load) and the reciprocal
// divides.  The two intrinsics with no portable form are the paper's
// Listing 4 stub: a kernel that calls one fails to compile with "target
// dependent implementation missing"; a kernel that does not builds.
#pragma once

#include <cuda_runtime.h>

namespace rt {
namespace detail {

// One row of 32 floats per warp of a 1-D team of up to 1,024 threads.
__device__ __forceinline__ float* warp_row() {
  __shared__ float rows[1024];
  return rows + (threadIdx.x & ~31u);
}

template <typename T>
struct missing {
  static constexpr bool value = false;
};

}  // namespace detail

__device__ __forceinline__ float warp_reduce_sum(float v) {
  float* row = detail::warp_row();
  const unsigned lane = threadIdx.x & 31;
  for (int o = 16; o > 0; o >>= 1) {
    row[lane] = v;
    __syncwarp();
    v += row[lane ^ o];
    __syncwarp();
  }
  return v;
}

__device__ __forceinline__ float warp_reduce_max(float v) {
  float* row = detail::warp_row();
  const unsigned lane = threadIdx.x & 31;
  for (int o = 16; o > 0; o >>= 1) {
    row[lane] = v;
    __syncwarp();
    v = fmaxf(v, row[lane ^ o]);
    __syncwarp();
  }
  return v;
}

__device__ __forceinline__ float approx_reciprocal(float x) { return 1.f / x; }

template <typename T>
__device__ __forceinline__ T atomic_inc(T* x, T e) {
  static_assert(detail::missing<T>::value,
                "atomic_inc: target dependent implementation missing");
  return *x;
}

template <typename T>
__device__ __forceinline__ void make_async_copy(T* dst_shared,
                                                const T* src_global) {
  static_assert(detail::missing<T>::value,
                "make_async_copy: target dependent implementation missing");
}

template <typename T = void>
__device__ __forceinline__ void wait_async_copies() {
  static_assert(detail::missing<T>::value,
                "wait_async_copies: target dependent implementation missing");
}

}  // namespace rt
