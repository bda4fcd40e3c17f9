// 503.postencil (B12): one out-of-place sweep of the 5-point Jacobi
// stencil, y = 0.2 (c + n + s + e + w) over a zero border (the
// reference's jnp.pad(x, 1): not periodic, not clamped), in f32.  The
// launcher makes `iters` sweeps, one launch each.
//
// Written once against the device runtime's facade and built twice:
// against rt/runtime.cuh (the portable member; under target("generic")
// with the generic target part too) and, with -DREPRO_RT_NATIVE,
// against native/rt_native.cuh (the native member), as the reference
// binds its one Pallas body to DeviceRuntime and to NativeRuntime.
//
// Replaces the TPU kernel benchmarks/spec_accel.py:53 (postencil, body
// kern).  Its _overlap_rows is host-side layout for Pallas's Blocked
// specs and has no counterpart: a team reads its halo directly.
//
// Bound on the H100: bytes.  A sweep reads and writes every cell once
// (8 bytes) for 5 flops, far below the f32 ridge of 20 flops a byte.
// Design: a 2-D grid of teams, each a tile of TH x TW cells (the
// reference's one team per 64 full rows would leave most SMs idle at
// the card's shape): the team stages its tile and a one-cell halo
// (zero outside the grid) in a carve-out of the shared arena, takes a
// barrier, and each thread computes TH * TW / NT cells of one column
// from the carve-out.  The sum is taken in the reference's order, left
// to right, then multiplied by f32(0.2).
#include "common.cuh"
#if defined(REPRO_RT_NATIVE)
#include "native/rt_native.cuh"
#else
#include "rt/runtime.cuh"
#endif

namespace {

constexpr int TW = 64, TH = 16, NT = 256;
constexpr int SW = TW + 2, SH = TH + 2;      // the staged tile, with halo
constexpr size_t SMEM_BYTES = SH * SW * sizeof(float);
static_assert(NT % TW == 0 && TH % (NT / TW) == 0, "tile shape");

__global__ void __launch_bounds__(NT)
postencil_kernel(const float* __restrict__ x, float* __restrict__ y, int h,
                 int w) {
  rt::Arena arena;
  float* tile = arena.alloc_shared<float>(SH * SW);
  const int c0 = rt::team_id(0) * TW, r0 = rt::team_id(1) * TH;
  const int tid = rt::thread_id();
  for (int i = tid; i < SH * SW; i += NT) {
    const int r = r0 + i / SW - 1, c = c0 + i % SW - 1;
    tile[i] = r >= 0 && r < h && c >= 0 && c < w
                  ? x[static_cast<size_t>(r) * w + c]
                  : 0.f;
  }
  rt::barrier();
  const int tc = tid % TW, c = c0 + tc;
  if (c >= w) return;
#pragma unroll
  for (int k = 0; k < TH * TW / NT; ++k) {
    const int tr = tid / TW + k * (NT / TW);
    const float* p = tile + (tr + 1) * SW + tc + 1;
    const float sum = p[0] + p[-SW] + p[SW] + p[1] + p[-1];  // c n s e w
    y[static_cast<size_t>(r0 + tr) * w + c] = 0.2f * sum;
  }
}

}  // namespace

// One sweep x -> y of an h x w grid; h a multiple of TH (the launcher
// takes the reference's multiples of 64).
extern "C" int postencil_sweep(const float* x, float* y, int h, int w,
                               void* stream) {
  if (h <= 0 || w <= 0 || h % TH != 0 || h / TH > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((w + TW - 1) / TW, h / TH);
  postencil_kernel<<<grid, NT, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(x, y, h, w);
  return cudaGetLastError();
}
