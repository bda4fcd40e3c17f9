// RMSNorm written straight against CUDA, with no device runtime: the
// native member (B11a) of the twin pair whose portable member is
// rmsnorm.cu.  It is the "CUDA original" of the paper's comparison:
// blockIdx, a static __shared__ array and the shuffle butterfly are
// hard-coded where rmsnorm.cu calls rt::team_id, rt::Arena and
// rt::reduce_sum.  The arithmetic is the same, in the same order, so
// the outputs are bit-identical (src/repro_torch/bench/parity.py holds
// them so and compares the two builds' SASS).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/native.py
// (rmsnorm_native, body _rms_kernel_native).
//
// Bound on the H100: bytes, as rmsnorm.cu: one read and one write of
// each row.  Design: rmsnorm.cu's, one block of 256 threads per row.
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
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < NT / 32 ? red[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

extern "C" int rmsnorm_native_fwd(const void* x, const void* w, void* y,
                                  int rows, int d, float eps, float offset,
                                  int dtype, void* stream) {
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
