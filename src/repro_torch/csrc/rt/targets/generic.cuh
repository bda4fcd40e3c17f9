// The generic target part of the device runtime: a target that provides
// no intrinsic (src/repro_torch/core/targets/generic.py gives the define
// that selects it).  Everything a portable kernel needs still works,
// through the portable part or plain CUDA: the warp reductions go
// through shared memory (the same butterfly as the sm_90 part, each
// exchange a store, a warp barrier and a load) and the reciprocal
// divides.  The warp matrix product and the ldmatrix loads exchange
// fragments through a per-warp row of shared memory: each lane computes
// its four sums with f32 FMA, k in order, and each load reads the
// elements the PTX ISA's layout gives a lane, one by one.  The two
// intrinsics with no portable form are the paper's Listing 4 stub: a
// kernel that calls one fails to compile with "target dependent
// implementation missing"; a kernel that does not builds.
#pragma once

#include <cuda_runtime.h>

namespace rt {
namespace detail {

// One row of 32 floats per warp of a 1-D team of up to 1,024 threads.
__device__ __forceinline__ float* warp_row() {
  __shared__ float rows[1024];
  return rows + (threadIdx.x & ~31u);
}

// One row of 96 eight-byte words per warp (the fragments of one product:
// A's 128 words and B's 64; or the 32 row addresses of one load).
__device__ __forceinline__ unsigned long long* frag_row() {
  __shared__ unsigned long long rows[32 * 96];
  return rows + (threadIdx.x >> 5) * 96;
}

// The bf16 halves of a 32-bit word as f32 (exact: bf16 is f32's top half).
__device__ __forceinline__ float lo_f32(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Lane l's words of an ldmatrix: tile i's row l / 4 (addresses from lanes
// 8 i .. 8 i + 7), 4 bytes at column 2 (l % 4); with trans, the 16-bit
// elements at column l / 4 of rows 2 (l % 4) and 2 (l % 4) + 1.
template <int N, bool TRANS>
__device__ __forceinline__ void load_matrix(unsigned (&r)[N],
                                            const void* row) {
  auto rows = reinterpret_cast<const unsigned char**>(frag_row());
  const unsigned lane = threadIdx.x & 31;
  rows[lane] = static_cast<const unsigned char*>(row);
  __syncwarp();
  for (int i = 0; i < N; ++i) {
    if constexpr (TRANS) {
      const unsigned short* r0 = reinterpret_cast<const unsigned short*>(
          rows[8 * i + 2 * (lane & 3)]);
      const unsigned short* r1 = reinterpret_cast<const unsigned short*>(
          rows[8 * i + 2 * (lane & 3) + 1]);
      r[i] = static_cast<unsigned>(r0[lane >> 2]) |
             static_cast<unsigned>(r1[lane >> 2]) << 16;
    } else {
      r[i] = reinterpret_cast<const unsigned*>(
          rows[8 * i + (lane >> 2)])[lane & 3];
    }
  }
  __syncwarp();
}

template <typename T>
struct missing {
  static constexpr bool value = false;
};

}  // namespace detail

__device__ __forceinline__ float warp_reduce_sum(float v, int width = 32) {
  float* row = detail::warp_row();
  const unsigned lane = threadIdx.x & 31;
  for (int o = width / 2; o > 0; o >>= 1) {
    row[lane] = v;
    __syncwarp();
    v += row[lane ^ o];
    __syncwarp();
  }
  return v;
}

__device__ __forceinline__ float warp_reduce_max(float v, int width = 32) {
  float* row = detail::warp_row();
  const unsigned lane = threadIdx.x & 31;
  for (int o = width / 2; o > 0; o >>= 1) {
    row[lane] = v;
    __syncwarp();
    v = fmaxf(v, row[lane ^ o]);
    __syncwarp();
  }
  return v;
}

// d += a b with sm90.cuh's fragments: the lanes store theirs (A as 16
// rows of 8 words, B as 8 columns of 8 words), then each lane sums its
// four outputs over k = 0 .. 15 in order.
__device__ __forceinline__ void mma_bf16_m16n8k16(float (&d)[4],
                                                  const unsigned (&a)[4],
                                                  const unsigned (&b)[2]) {
  unsigned* w = reinterpret_cast<unsigned*>(detail::frag_row());
  unsigned* wa = w;        // A[r][word c]: w[8 r + c]
  unsigned* wb = w + 128;  // B[column n][word c]: w[128 + 8 n + c]
  const unsigned lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  wa[8 * g + t] = a[0];
  wa[8 * (g + 8) + t] = a[1];
  wa[8 * g + t + 4] = a[2];
  wa[8 * (g + 8) + t + 4] = a[3];
  wb[8 * g + t] = b[0];
  wb[8 * g + t + 4] = b[1];
  __syncwarp();
  for (int e = 0; e < 4; ++e) {
    const unsigned* ra = wa + 8 * (g + (e >> 1) * 8);
    const unsigned* rb = wb + 8 * (2 * t + (e & 1));
    float acc = d[e];
    for (int c = 0; c < 8; ++c) {
      acc = fmaf(detail::lo_f32(ra[c]), detail::lo_f32(rb[c]), acc);
      acc = fmaf(detail::hi_f32(ra[c]), detail::hi_f32(rb[c]), acc);
    }
    d[e] = acc;
  }
  __syncwarp();
}

__device__ __forceinline__ void load_matrix_x4(unsigned (&r)[4],
                                               const void* row) {
  detail::load_matrix<4, false>(r, row);
}
__device__ __forceinline__ void load_matrix_x4_trans(unsigned (&r)[4],
                                                     const void* row) {
  detail::load_matrix<4, true>(r, row);
}
__device__ __forceinline__ void load_matrix_x2(unsigned (&r)[2],
                                               const void* row) {
  detail::load_matrix<2, false>(r, row);
}
__device__ __forceinline__ void load_matrix_x2_trans(unsigned (&r)[2],
                                                     const void* row) {
  detail::load_matrix<2, true>(r, row);
}

__device__ __forceinline__ float approx_reciprocal(float x) { return 1.f / x; }

// No special-function unit: the accurate cosine.
__device__ __forceinline__ float approx_cos(float x) { return cosf(x); }

constexpr bool has_async_copy = false;

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
