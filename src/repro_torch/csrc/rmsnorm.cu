// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * (w + weight_offset), in f32,
// cast back to the input type.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py
// (rmsnorm_fwd, body _rms_kernel).
//
// Bound on the H100: bytes.  Each row is read, reduced and written once
// (about 2 flops per byte), far below the card's 295 flops/byte ridge.
// Design: one block of 256 threads per row; threads stride the row so
// every load is coalesced; the sum of squares is reduced with warp
// shuffles and one shared-memory hop.  The second pass re-reads the row
// (at d = 4096 in bf16, 8 KB, still in L1/L2) instead of holding it in
// registers, which keeps any d legal.
#include "common.cuh"

namespace {

constexpr int NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int d, float eps, float offset) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = y + static_cast<size_t>(blockIdx.x) * d;
  __shared__ float red[NT / 32];

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += NT) {
    const float v = repro::to_f32(xr[i]);
    ss += v * v;
  }
  ss = repro::warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < NT / 32 ? red[threadIdx.x] : 0.f;
    v = repro::warp_sum(v);
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(red[0] * (1.0f / d) + eps);
  for (int i = threadIdx.x; i < d; i += NT) {
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
    rmsnorm_kernel<float><<<rows, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), d, eps, offset);
  } else if (dtype == repro::DTYPE_BF16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
        d, eps, offset);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
