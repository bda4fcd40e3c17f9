// RMSNorm written straight against CUDA, with no device runtime: the
// native member (B11a) of the twin pair whose portable member is
// rmsnorm.cu.  It is the "CUDA original" of the paper's comparison:
// blockIdx, shared memory, cp.async and the shuffle butterfly are
// hard-coded where rmsnorm.cu calls rt::team_id, rt::Arena,
// rt::make_async_copy and rt::reduce_sum.  The arithmetic is the same,
// in the same order, and so is the schedule, so the outputs are
// bit-identical (src/repro_torch/bench/parity.py holds them so and
// compares the two builds' SASS).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/native.py
// (rmsnorm_native, body _rms_kernel_native).
//
// Bound on the H100: bytes, as rmsnorm.cu: one read and one write of
// each row.  Design: rmsnorm.cu's, blocks of 256 threads: rows of whole
// 16-byte vectors up to MAX_STAGED_BYTES are staged into shared memory
// by 16-byte cp.async copies, all in flight together, two rows a block
// below TWO_ROWS_BYTES and one above, then summed row after row in the
// strided order and written 16 bytes at a time; other rows stream with
// scalar loads, a block a row.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr size_t RED_BYTES = NT / 32 * sizeof(float);
constexpr size_t MAX_STAGED_BYTES = 48 * 1024 - 256;
constexpr size_t TWO_ROWS_BYTES = 8 * 1024;

// The block's sum of the threads' `ss`: the shuffle butterfly, one hop
// through `red`, the first warp's butterfly over the partials.
__device__ __forceinline__ float block_sum(float ss, float* red) {
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < NT / 32 ? red[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int rows, int d, float eps, float offset) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  if constexpr (ROWS > 0) {
    const int nvec = d / VEC;
    T* xs = reinterpret_cast<T*>(smem + ROWS * RED_BYTES);
    const int row0 = blockIdx.x * ROWS;
    const int n = rows - row0 < ROWS ? rows - row0 : ROWS;
    const T* xr = x + static_cast<size_t>(row0) * d;
    for (int i = threadIdx.x; i < n * nvec; i += NT) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(xs + i * VEC));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(xr + i * VEC)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const T* xsr = xs + r * d;
      T* yr = y + static_cast<size_t>(row0 + r) * d;
      float ss = 0.f;
      for (int i = threadIdx.x; i < d; i += NT) {
        const float v = repro::to_f32(xsr[i]);
        ss += v * v;
      }
      const float inv =
          rsqrtf(block_sum(ss, red + r * (NT / 32)) * (1.0f / d) + eps);
      for (int i = threadIdx.x; i < nvec; i += NT) {
        const uint4 xv = reinterpret_cast<const uint4*>(xsr)[i];
        const uint4 wv = __ldg(reinterpret_cast<const uint4*>(w) + i);
        const T* xe = reinterpret_cast<const T*>(&xv);
        const T* we = reinterpret_cast<const T*>(&wv);
        uint4 yv;
        T* ye = reinterpret_cast<T*>(&yv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float v = repro::to_f32(xe[j]) * inv;
          ye[j] = repro::from_f32<T>(v * (repro::to_f32(we[j]) + offset));
        }
        reinterpret_cast<uint4*>(yr)[i] = yv;
      }
    }
  } else {
    const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
    T* yr = y + static_cast<size_t>(blockIdx.x) * d;
    float ss = 0.f;
    for (int i = threadIdx.x; i < d; i += NT) {
      const float v = repro::to_f32(xr[i]);
      ss += v * v;
    }
    const float inv = rsqrtf(block_sum(ss, red) * (1.0f / d) + eps);
    for (int i = threadIdx.x; i < d; i += NT) {
      const float v = repro::to_f32(xr[i]) * inv;
      yr[i] = repro::from_f32<T>(v * (repro::to_f32(w[i]) + offset));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d,
                   float eps, float offset, cudaStream_t s) {
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (row_bytes % 16 != 0 || row_bytes > MAX_STAGED_BYTES)
    rmsnorm_kernel<T, 0><<<rows, NT, RED_BYTES, s>>>(xt, wt, yt, rows, d,
                                                     eps, offset);
  else if (row_bytes < TWO_ROWS_BYTES)
    rmsnorm_kernel<T, 2><<<(rows + 1) / 2, NT, 2 * (RED_BYTES + row_bytes),
                           s>>>(xt, wt, yt, rows, d, eps, offset);
  else
    rmsnorm_kernel<T, 1><<<rows, NT, RED_BYTES + row_bytes, s>>>(
        xt, wt, yt, rows, d, eps, offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rmsnorm_native_fwd(const void* x, const void* w, void* y,
                                  int rows, int d, float eps, float offset,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  if (dtype == repro::DTYPE_F32)
    return launch<float>(x, w, y, rows, d, eps, offset, s);
  if (dtype == repro::DTYPE_BF16)
    return launch<__nv_bfloat16>(x, w, y, rows, d, eps, offset, s);
  return cudaErrorInvalidValue;
}
