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
// Bound on the H100: operations, the nx * nk cosines at the
// special-function unit's rate (16 a clock per SM) and 8 flops per pair
// beside them; the bytes are a few MB.
//
// Design: the cosine runs on the special-function unit (MUFU.COS, the
// runtime's rt::approx_cos; the generic target's is the accurate cosf)
// after an exact reduction.  The phase's argument d = x0 k0 + x1
// k1 + x2 k2 (f32, in turns) loses its whole turns first: r = d -
// rint(d), with rint as (d + 1.5 2^23) - 1.5 2^23 in round-to-nearest
// adds (the FMA pipe, no conversion), is exact for |d| < 2^22 and lies in
// [-1/2, 1/2], so the cosine sees f32(2 pi) r in [-pi, pi], where its
// absolute error is about 2^-21.4 (bench/spec_accel.py tolerance() has
// the whole error argument).  A team of NT threads holds P points a
// thread in registers (x and the accumulator), so one broadcast read of
// a sample, staged as one 16-byte {k0, k1, k2, phi} in the shared arena,
// feeds P pairs; TILE samples are staged between two barriers.  Each
// block of BK samples is summed on its own and added to the point's
// accumulator in turn, as the reference adds each k-block's sum into its
// scratch.
#include "common.cuh"
#if defined(REPRO_RT_NATIVE)
#include "native/rt_native.cuh"
#else
#include "rt/runtime.cuh"
#endif

namespace {

// Points a thread and threads a team: 2 x 256 measured fastest at the
// card shape (PERF.md section 6).
constexpr int NT = 256, P = 2, BX = NT * P;
constexpr int BK = 128;                      // samples a block (the reference's)
constexpr int TILE = 4 * BK;                 // samples staged at once
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float ROUND = 12582912.f;          // 1.5 * 2^23: adds round to integers
constexpr size_t SMEM_BYTES = TILE * sizeof(float4);

__global__ void __launch_bounds__(NT)
pomriq_kernel(const float* __restrict__ x, const float* __restrict__ kg,
              const float* __restrict__ phi, float* __restrict__ out,
              int nx, int nk) {
  rt::Arena arena;
  float4* ks = arena.alloc_shared<float4>(TILE);  // {k0, k1, k2, phi}
  const int tid = rt::thread_id();
  // point j of this thread: i0 + j NT (nx is a multiple of 128 and NT of
  // 128, so a row of NT points is live or dead for the whole team); the
  // wrapper keeps 3 nx within int
  const int i0 = static_cast<int>(rt::team_id(0)) * BX + tid;
  float x0[P], x1[P], x2[P], acc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = i0 + j * NT;
    const bool live = i < nx;
    x0[j] = live ? x[3 * i] : 0.f;
    x1[j] = live ? x[3 * i + 1] : 0.f;
    x2[j] = live ? x[3 * i + 2] : 0.f;
    acc[j] = 0.f;
  }
  for (int k0 = 0; k0 < nk; k0 += TILE) {
    const int nt = min(TILE, nk - k0);  // a multiple of BK
    for (int e = tid; e < nt; e += NT) {
      const int kk = k0 + e;
      ks[e] = make_float4(kg[3 * kk], kg[3 * kk + 1], kg[3 * kk + 2], phi[kk]);
    }
    rt::barrier();
    for (int b = 0; b < nt; b += BK) {
      float part[P];
#pragma unroll
      for (int j = 0; j < P; ++j) part[j] = 0.f;
#pragma unroll 4
      for (int k = b; k < b + BK; ++k) {
        const float4 sk = ks[k];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float d = x0[j] * sk.x + x1[j] * sk.y + x2[j] * sk.z;
          const float r = __fsub_rn(d, __fsub_rn(__fadd_rn(d, ROUND), ROUND));
          part[j] += rt::approx_cos(TWO_PI * r) * sk.w;
        }
      }
#pragma unroll
      for (int j = 0; j < P; ++j) acc[j] += part[j];
    }
    rt::barrier();  // the next tile overwrites the carve-out
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = i0 + j * NT;
    if (i < nx) out[i] = acc[j];
  }
}

}  // namespace

// nx and nk multiples of 128 (the reference's blocks); |x . k| < 2^22.
extern "C" int pomriq_fwd(const float* x, const float* kg, const float* phi,
                          float* out, int nx, int nk, void* stream) {
  if (nx <= 0 || nk <= 0 || nx % 128 != 0 || nk % BK != 0)
    return cudaErrorInvalidValue;
  pomriq_kernel<<<(nx + BX - 1) / BX, NT, SMEM_BYTES,
                  static_cast<cudaStream_t>(stream)>>>(x, kg, phi, out, nx,
                                                       nk);
  return cudaGetLastError();
}
