// Shared helpers of the port's CUDA kernels: element conversion (f32,
// bf16, and the int8 / fp8-e4m3 storage of quantized KV pools), the
// large-negative mask value of the reference kernels, and the error
// string entry point every library exports for its ctypes wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Masked scores use -1e30 rather than -inf, as the reference does, so a
// fully masked row never produces inf - inf = NaN.
constexpr float NEG_INF = -1e30f;

// dtype codes passed by the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int DTYPE_I8 = 2;   // quantized KV pools
constexpr int DTYPE_FP8 = 3;  // __nv_fp8_e4m3, the encoding of torch.float8_e4m3fn

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);  // exact: every e4m3 value is an f32
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch does
}

// Two floats rounded to bf16 (nearest even) in one 32-bit word, the
// first in the low half: a row pair of an mma fragment.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// max(a, b) that propagates NaN, as jnp.max and torch.amax do (fmaxf
// drops it): a NaN score must make the decode kernels' running max NaN,
// so that the row comes out 0 as the reference's does.  sm_80 and later
// have it as one instruction (max.NaN.f32, an FMNMX); elsewhere the test
// is spelled out.  On finite inputs it is fmaxf, bit for bit.
__device__ __forceinline__ float max_nan(float a, float b) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800 && !defined(REPRO_RT_TARGET_GENERIC)
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : b != b ? b : fmaxf(a, b);
#endif
}

// The warp's max, NaN if any lane holds NaN (max_nan).
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage the first `rows` rows of a row-major ROWS x D tile of T into
// shared memory as f32 (row stride `ld`), each element as
// `to_f32(x) * scale`: the dequantization of a quantized block, exactly
// the reference's `f32(k) * k_scale`; rows past `rows` become 0.  Each
// thread issues all its 16-byte loads before it converts and stores
// any, so the tile costs about one memory latency, not one per
// element: with one small CTA per SM nothing else would hide it.  A
// 16-byte load holds 16 / sizeof(T) elements (16 of int8 or fp8).
// `src` must be 16-byte aligned (the Python wrappers check).
template <typename T, int ROWS, int D, int NT>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           float* dst, int ld, int rows,
                                           float scale = 1.f) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int PER_ROW = D / VEC;
  constexpr int ITERS = ROWS * PER_ROW / NT;
  static_assert(D % VEC == 0 && ROWS * PER_ROW % NT == 0, "tile shape");
  uint4 buf[ITERS];
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int idx = threadIdx.x + i * NT;
    buf[i] = idx / PER_ROW < rows
                 ? __ldg(reinterpret_cast<const uint4*>(src) + idx)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / PER_ROW, c = idx % PER_ROW * VEC;
    const T* e = reinterpret_cast<const T*>(&buf[i]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[r * ld + c + j] = to_f32(e[j]) * scale;
  }
}

// Raise a kernel's dynamic shared-memory cap once per instantiation;
// when its static and dynamic shared memory pass 48 KB together, a
// launch without it is refused (the generic target's warp rows are
// static).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  if (bytes + attr.sharedSizeBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
