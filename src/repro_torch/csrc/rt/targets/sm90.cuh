// The sm_90a target part of the device runtime: what `declare variant
// match(device={arch(nvptx64)})` provides in the paper, selected by the
// `cuda` target context (src/repro_torch/core/targets/cuda.py).  Each
// function wraps one hardware instruction or CUDA intrinsic.
#pragma once

#include <cuda_runtime.h>

namespace rt {

// Warp-shuffle butterfly: every lane ends with the sum (max) over its
// aligned group of `width` lanes (a power of two up to 32): the whole
// warp by default, the four lanes of a quad that share an mma row with
// width 4.
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

// One warp-level tensor-core product, d += a b, of a 16 x 16 bf16 tile A
// (row-major) and a 16 x 8 bf16 tile B (column-major) into 16 x 8 f32
// sums, with the PTX ISA's fragment layouts (runtime.cuh lists them).
__device__ __forceinline__ void mma_bf16_m16n8k16(float (&d)[4],
                                                  const unsigned (&a)[4],
                                                  const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix: 8 x 8 tiles of 16-bit elements from the arena, lane i giving
// the address of row i % 8 of tile i / 8 (16 bytes, 16-byte aligned);
// lane l receives elements (l / 4, 2 (l % 4) + {0, 1}) of each tile, or
// with .trans elements (2 (l % 4) + {0, 1}, l / 4).
__device__ __forceinline__ void load_matrix_x4(unsigned (&r)[4],
                                               const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void load_matrix_x4_trans(unsigned (&r)[4],
                                                     const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The two-tile forms: only lanes 0-15's addresses are read.
__device__ __forceinline__ void load_matrix_x2(unsigned (&r)[2],
                                               const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void load_matrix_x2_trans(unsigned (&r)[2],
                                                     const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// The hardware's approximate reciprocal (MUFU.RCP), as the TPU variant
// of repro's approx_reciprocal takes pl.reciprocal(approx=True).
__device__ __forceinline__ float approx_reciprocal(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The special-function unit's cosine (MUFU.COS, through __cosf): an
// absolute error of about 2^-21.4 on [-pi, pi], growing with |x|
// beyond, so a caller reduces the argument to one turn first.
__device__ __forceinline__ float approx_cos(float x) { return __cosf(x); }

// { v = x; x = x >= e ? 0 : x + 1; } return v;  native on CUDA, with
// exactly the wraparound of src/repro/core/atomics.py atomic_inc.
__device__ __forceinline__ unsigned atomic_inc(unsigned* x, unsigned e) {
  return atomicInc(x, e);
}

// make_async_copy: 16 bytes from global to shared memory with cp.async,
// completed by wait_async_copies (HBM -> VMEM DMA on the TPU).  A kernel
// that also builds for a target without it tests has_async_copy.
constexpr bool has_async_copy = true;

__device__ __forceinline__ void make_async_copy(void* dst_shared,
                                                const void* src_global) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src_global)
               : "memory");
}

// Commits every copy this thread issued and waits for all of them (a
// template only so that a kernel can name it where the generic target's
// stub must stay uninstantiated).
template <typename T = void>
__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

}  // namespace rt
