// 514.pomriq (B14): the MRI-Q phase sum Q(x_i) = sum_k phi_k cos(2 pi
// k . x_i) for nx points x (nx, 3) over nk samples k (nk, 3) with
// weights phi (nk,), all f32; out (nx, 1).
//
// Written once against the device runtime's facade and built twice
// (portable against rt/runtime.cuh, native with -DREPRO_RT_NATIVE
// against native/rt_native.cuh), as postencil.cu.  It stages with plain
// loads, not rt::make_async_copy, so it also builds for the generic
// target, whose stub refuses that intrinsic.
//
// Replaces the TPU kernel benchmarks/spec_accel.py:137 (pomriq, body
// kern).  Its grid's second axis is "arbitrary": a sequential
// accumulation over k-blocks in team-shared scratch.  Teams here run in
// no order, so that axis becomes a loop inside the team.
//
// Bound on the H100: operations, the nx * nk cosines (16 a clock per
// SM for the special-function unit's rate; the accurate cosf is a
// polynomial on the FMA pipe, which costs more) and 8 flops per pair
// beside them; the bytes are a few MB.  Design: a team of BX threads
// per BX points, one point a thread in registers; each k-tile of BK
// samples and weights is staged in carve-outs of the shared arena
// between barriers and read by every thread (a broadcast).  Each tile's
// sum is added to the point's accumulator, as the reference adds each
// k-block's into its scratch.  The phase is f32(2 pi) * (x0 k0 + x1 k1 +
// x2 k2), and cosf is the accurate one: phases reach tens of radians,
// where __cosf's error grows past any tolerance.
#include "common.cuh"
#if defined(REPRO_RT_NATIVE)
#include "native/rt_native.cuh"
#else
#include "rt/runtime.cuh"
#endif

namespace {

constexpr int BX = 128, BK = 128, NT = BX;
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr size_t SMEM_BYTES = (3 * BK + BK) * sizeof(float);
static_assert(NT == BK, "a thread stages one weight of a tile");

__global__ void __launch_bounds__(NT)
pomriq_kernel(const float* __restrict__ x, const float* __restrict__ kg,
              const float* __restrict__ phi, float* __restrict__ out,
              int nk) {
  rt::Arena arena;
  float* ks = arena.alloc_shared<float>(3 * BK);
  float* ps = arena.alloc_shared<float>(BK);
  const int tid = rt::thread_id();
  const size_t i = static_cast<size_t>(rt::team_id(0)) * BX + tid;
  const float x0 = x[3 * i], x1 = x[3 * i + 1], x2 = x[3 * i + 2];
  float acc = 0.f;
  for (int k0 = 0; k0 < nk; k0 += BK) {
    for (int e = tid; e < 3 * BK; e += NT)
      ks[e] = kg[static_cast<size_t>(k0) * 3 + e];
    ps[tid] = phi[k0 + tid];
    rt::barrier();
    float part = 0.f;
    for (int k = 0; k < BK; ++k) {
      const float d = x0 * ks[3 * k] + x1 * ks[3 * k + 1] + x2 * ks[3 * k + 2];
      part += cosf(TWO_PI * d) * ps[k];
    }
    acc += part;
    rt::barrier();  // the next tile overwrites the carve-outs
  }
  out[i] = acc;
}

}  // namespace

// nx and nk multiples of BX and BK (the reference's blocks of 128).
extern "C" int pomriq_fwd(const float* x, const float* kg, const float* phi,
                          float* out, int nx, int nk, void* stream) {
  if (nx <= 0 || nk <= 0 || nx % BX != 0 || nk % BK != 0)
    return cudaErrorInvalidValue;
  pomriq_kernel<<<nx / BX, NT, SMEM_BYTES,
                  static_cast<cudaStream_t>(stream)>>>(x, kg, phi, out, nk);
  return cudaGetLastError();
}
