// The sm_90a target part of the device runtime: what `declare variant
// match(device={arch(nvptx64)})` provides in the paper, selected by the
// `cuda` target context (src/repro_torch/core/targets/cuda.py).  Each
// function wraps one hardware instruction or CUDA intrinsic.
#pragma once

#include <cuda_runtime.h>

namespace rt {

// Warp-shuffle butterfly: every lane ends with the warp's sum (max).
__device__ __forceinline__ float warp_reduce_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_reduce_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The hardware's approximate reciprocal (MUFU.RCP), as the TPU variant
// of repro's approx_reciprocal takes pl.reciprocal(approx=True).
__device__ __forceinline__ float approx_reciprocal(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// { v = x; x = x >= e ? 0 : x + 1; } return v;  native on CUDA, with
// exactly the wraparound of src/repro/core/atomics.py atomic_inc.
__device__ __forceinline__ unsigned atomic_inc(unsigned* x, unsigned e) {
  return atomicInc(x, e);
}

// make_async_copy: 16 bytes from global to shared memory with cp.async,
// completed by wait_async_copies (HBM -> VMEM DMA on the TPU).
__device__ __forceinline__ void make_async_copy(void* dst_shared,
                                                const void* src_global) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src_global)
               : "memory");
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

}  // namespace rt
