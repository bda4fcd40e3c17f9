// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * (w + weight_offset), in f32,
// cast back to the input type.  Written against the device runtime
// (rt/runtime.cuh): the portable member of the twin pair whose native
// member is native/rmsnorm_native.cu (B11a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py
// (rmsnorm_fwd, body _rms_kernel).
//
// Bound on the H100: bytes.  Each row is read, reduced and written once
// (about 2 flops per byte), far below the card's 295 flops/byte ridge.
// Design: one team of 256 threads per row; threads stride the row so
// every load is coalesced; the sum of squares is the runtime's block
// reduction (warp reductions and one hop through a carve-out of the
// shared arena).  The second pass re-reads the row (at d = 4096 in
// bf16, 8 KB, still in L1/L2) instead of holding it in registers, which
// keeps any d legal.
#include "common.cuh"
#include "rt/runtime.cuh"

namespace {

constexpr int NT = 256;
constexpr size_t SMEM_BYTES = rt::reduce_scratch(NT) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int d, float eps, float offset) {
  rt::Arena arena;
  float* red = arena.alloc_shared<float>(rt::reduce_scratch(NT));
  const T* xr = x + static_cast<size_t>(rt::team_id(0)) * d;
  T* yr = y + static_cast<size_t>(rt::team_id(0)) * d;

  float ss = 0.f;
  for (int i = rt::thread_id(); i < d; i += NT) {
    const float v = repro::to_f32(xr[i]);
    ss += v * v;
  }
  const float inv = rsqrtf(rt::reduce_sum<NT>(ss, red) * (1.0f / d) + eps);
  for (int i = rt::thread_id(); i < d; i += NT) {
    const float v = repro::to_f32(xr[i]) * inv;
    yr[i] = repro::from_f32<T>(v * (repro::to_f32(w[i]) + offset));
  }
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int rows,
                           int d, float eps, float offset, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  if (dtype == repro::DTYPE_F32) {
    rmsnorm_kernel<float><<<rows, NT, SMEM_BYTES, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), d, eps, offset);
  } else if (dtype == repro::DTYPE_BF16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, NT, SMEM_BYTES, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
        d, eps, offset);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
