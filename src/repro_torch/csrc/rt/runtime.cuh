// The device runtime: the facade the port's portable kernels are written
// against, the CUDA counterpart of src/repro/core/runtime.py
// (DeviceRuntime) with intrinsics.py, atomics.py and memory.py.
//
// Common part, portable CUDA: teams and threads, static_partition,
// block-level reductions, the team's shared-memory arena (memory.cuh)
// and the portable atomics (atomics.cuh).  Target part, chosen at
// compile time by the flags that the active target context gives
// (src/repro_torch/core/targets/*.py, compiler_params):
//
//   targets/sm90.cuh     default, the `declare variant match(device=
//                        {arch(nvptx64)})` of this port: warp shuffles,
//                        rcp.approx, native atomicInc, cp.async, and the
//                        tensor core (mma.sync, ldmatrix);
//   targets/generic.cuh  -DREPRO_RT_TARGET_GENERIC: no intrinsic at all;
//                        reductions and the warp matrix product through
//                        shared memory, an exact reciprocal, and
//                        atomic_inc / make_async_copy that fail to compile
//                        where they are called (has_async_copy is false).
//
// The warp matrix intrinsics, for a warp's lane l, g = l / 4, t = l % 4
// (the PTX ISA's layouts of mma.m16n8k16 and ldmatrix.m8n8):
//
//   mma_bf16_m16n8k16(d, a, b)   d += A B: A 16 x 16 bf16, B 16 x 8 bf16,
//                                d 16 x 8 f32.  a[0] holds A(g, 2t..2t+1),
//                                a[1] A(g+8, 2t..), a[2] A(g, 2t+8..),
//                                a[3] A(g+8, 2t+8..); b[0] B(2t..2t+1, g),
//                                b[1] B(2t+8.., g); d[0..1] C(g, 2t..2t+1),
//                                d[2..3] C(g+8, 2t..2t+1) (the low half of
//                                a word is the lower index).  So the C
//                                layout of two n-adjacent products is the
//                                A layout of the next k16 step.
//   load_matrix_x4(r, p)         ldmatrix of four 8 x 8 b16 tiles from the
//   load_matrix_x2(r, p)         arena: lane l passes p, the address of row
//                                l % 8 of tile l / 8 (16 bytes, 16-byte
//                                aligned; x2 reads lanes 0-15's); r[i] gets
//                                tile i's (g, 2t..2t+1).
//   load_matrix_x4_trans(r, p)   the same tiles transposed: r[i] gets tile
//   load_matrix_x2_trans(r, p)   i's (2t, g) low and (2t+1, g) high, the B
//                                fragment of a row-major (k, n) tile.
//
// warp_reduce_sum/max(v, width) reduce over aligned groups of `width`
// lanes: width 4 is the quad that holds one row of an mma's C tile.
//
// Every function is __forceinline__, so a kernel written against the
// facade compiles to the instructions it would hold if it were written
// against CUDA directly (src/repro_torch/bench/parity.py compares them).
#pragma once

#include <cuda_runtime.h>

#include "rt/atomics.cuh"
#include "rt/memory.cuh"
#if defined(REPRO_RT_TARGET_GENERIC)
#include "rt/targets/generic.cuh"
#else
#include "rt/targets/sm90.cuh"
#endif

namespace rt {

// -- teams and threads (omp_get_team_num, omp_get_thread_num, barrier) --
// A team is a CTA; axis 0, 1, 2 are the grid's x, y, z.
__device__ __forceinline__ unsigned team_id(int axis = 0) {
  return axis == 0 ? blockIdx.x : axis == 1 ? blockIdx.y : blockIdx.z;
}

__device__ __forceinline__ unsigned num_teams(int axis = 0) {
  return axis == 0 ? gridDim.x : axis == 1 ? gridDim.y : gridDim.z;
}

__device__ __forceinline__ unsigned thread_id() { return threadIdx.x; }

__device__ __forceinline__ void barrier() { __syncthreads(); }

// -- worksharing (#pragma omp for schedule(static)) --------------------
// [lo, hi) owned by `team`, as DeviceRuntime.static_partition computes
// it on the host; lo may pass total for the last teams (an empty range).
struct Range {
  int lo, hi;
};

__host__ __device__ __forceinline__ Range static_partition(int total,
                                                           int teams,
                                                           int team) {
  const int chunk = (total + teams - 1) / teams;
  const int lo = team * chunk;
  return {lo, lo + chunk < total ? lo + chunk : total};
}

// -- block-level reductions --------------------------------------------
// Floats of the arena a reduction over a 1-D team of `nt` threads needs
// (one per warp).
__host__ __device__ constexpr int reduce_scratch(int nt) { return nt / 32; }

// The sum over the team of NT threads, returned to every thread: the
// target's warp reduction, one hop through `scratch`, the first warp's
// reduction of the partials.  Every thread of the team must call it.
// Every thread reads the result from scratch[0] after the call's last
// barrier, so a carve-out passed to rt::reduce_* may be reused (by
// another reduction, or written at all) only after a barrier that
// follows the call: two reductions in a row take a carve-out each.
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
