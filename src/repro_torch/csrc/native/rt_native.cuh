// The device runtime's surface bound straight to CUDA, with no target
// context: the counterpart of benchmarks/native_rt.py (NativeRuntime),
// the pre-paper "CUDA device runtime" of the paper's Fig. 2.
//
// A source written once against the facade (the SPEC ACCEL stand-ins,
// csrc/spec_accel/*.cu) includes this header in place of
// rt/runtime.cuh when it is built with -DREPRO_RT_NATIVE, so one source
// gives both members of a twin pair, as the reference binds one Pallas
// body to both runtimes.  Nothing under rt/ is included: each member is
// written here against CUDA itself (blockIdx, gridDim, __syncthreads,
// an extern __shared__ carve-out, the __shfl_xor_sync butterfly,
// cp.async), with the arithmetic of the sm_90a target part instruction
// for instruction, so the two builds can be bit-identical
// (src/repro_torch/bench/parity.py holds them so and compares their
// SASS).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace rt {

// A team is a CTA; axis 0, 1, 2 are the grid's x, y, z.
__device__ __forceinline__ unsigned team_id(int axis = 0) {
  return axis == 0 ? blockIdx.x : axis == 1 ? blockIdx.y : blockIdx.z;
}

__device__ __forceinline__ unsigned num_teams(int axis = 0) {
  return axis == 0 ? gridDim.x : axis == 1 ? gridDim.y : gridDim.z;
}

__device__ __forceinline__ unsigned thread_id() { return threadIdx.x; }

__device__ __forceinline__ void barrier() { __syncthreads(); }

// Buffers carved in declaration order out of the launch's dynamic
// shared memory, each aligned to its type; uninitialized.  The extern
// array is declared in a static member, as rt/memory.cuh declares it:
// declared in the template member instead, nvcc laid pbt.cu's kernels
// out otherwise than the portable build's (other SASS, same bits).
class Arena {
 public:
  template <typename T>
  __device__ __forceinline__ T* alloc_shared(size_t n) {
    offset_ = (offset_ + alignof(T) - 1) / alignof(T) * alignof(T);
    T* p = reinterpret_cast<T*>(base() + offset_);
    offset_ += n * sizeof(T);
    return p;
  }

 private:
  __device__ __forceinline__ static unsigned char* base() {
    extern __shared__ __align__(16) unsigned char native_shared[];
    return native_shared;
  }

  size_t offset_ = 0;
};

// 16 bytes from global to shared memory with cp.async, waited on by
// wait_async_copies (every copy this thread issued committed as one
// group and waited for), the sm_90a target part's instructions.
constexpr bool has_async_copy = true;

__device__ __forceinline__ void make_async_copy(void* dst_shared,
                                                const void* src_global) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src_global)
               : "memory");
}

template <typename T = void>
__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The special-function unit's cosine, the sm_90a target part's
// instruction (MUFU.COS).
__device__ __forceinline__ float approx_cos(float x) { return __cosf(x); }

// Warp-shuffle butterfly, the sm_90a target part's: every lane ends
// with the sum (max) over its aligned group of `width` lanes (a power of
// two up to 32), the whole warp by default.
__device__ __forceinline__ float warp_reduce_sum(float v, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_reduce_max(float v, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Floats of scratch a reduction over a 1-D team of `nt` threads needs.
__host__ __device__ constexpr int reduce_scratch(int nt) { return nt / 32; }

// The sum (max) over the team of NT threads, returned to every thread:
// the warp butterfly, one hop through `scratch`, the first warp's
// butterfly over the partials.  Every thread must call it.  Every
// thread reads scratch[0] after the last barrier, so `scratch` may be
// reused only after a barrier that follows the call: two reductions in
// a row take a carve-out each.
template <int NT>
__device__ __forceinline__ float reduce_sum(float v, float* scratch) {
  v = warp_reduce_sum(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float p = threadIdx.x < NT / 32 ? scratch[threadIdx.x] : 0.f;
    p = warp_reduce_sum(p);
    if (threadIdx.x == 0) scratch[0] = p;
  }
  __syncthreads();
  return scratch[0];
}

template <int NT>
__device__ __forceinline__ float reduce_max(float v, float* scratch) {
  v = warp_reduce_max(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
    float p = threadIdx.x < NT / 32 ? scratch[threadIdx.x] : neg_inf;
    p = warp_reduce_max(p);
    if (threadIdx.x == 0) scratch[0] = p;
  }
  __syncthreads();
  return scratch[0];
}

}  // namespace rt
