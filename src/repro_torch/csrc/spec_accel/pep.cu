// 552.pep (B15): the embarrassingly parallel pipeline.  For each block
// of NB int32 seeds: the uint32 hash a = s 1664525 + 1013904223,
// b = (a ^ (a >> 16)) 2246822519 (mod 2^32, logical shift), the
// uniforms (f32(a) + 1) / 2^32 and (f32(b) + 1) / 2^32, Box-Muller
// z = sqrt(-2 log u1) cos(2 pi u2), then the block's
// [sum z, sum z^2, max z, sum |z|] into one row of out (n / NB, 4) f32.
//
// Written once against the device runtime's facade and built twice
// (portable against rt/runtime.cuh, native with -DREPRO_RT_NATIVE
// against native/rt_native.cuh), as postencil.cu.
//
// Replaces the TPU kernel benchmarks/spec_accel.py:182 (pep, body kern).
//
// Bound on the H100: bytes, 4 a seed read (and 16 a block written),
// against two int-to-float conversions, a logarithm, a square root and a
// cosine a seed at the conversion and special-function rate (16 a clock
// per SM each), about the bytes' time.  Design: one warp owns one block,
// so the four moments are warp reductions (rt::warp_reduce_*), with no
// arena and no barrier, and a team of WARPS warps holds WARPS blocks (the
// last team may be ragged: each warp guards its own block).  Lane l reads
// its 8 seeds as two coalesced 16-byte loads, seeds [4 l, 4 l + 4) and
// [128 + 4 l, 128 + 4 l + 4) of the block, both issued before any
// arithmetic, so each warp keeps 1 KB in flight.  The hash and the
// uniforms are the reference's bit for bit; the logarithm and the square
// root are the accurate ones (for u1 = 1 - 2^-24, log u1 is about -6e-8,
// within the special-function logarithm's absolute error of it, which
// could turn -2 log u1 negative and z into a NaN).  The cosine runs on
// the special-function unit (rt::approx_cos; the generic target's is the
// accurate cosf) after an exact reduction of the phase to one turn, as
// pomriq.cu does: u2 lies in (0, 1], so t = u2 - rint(u2), with rint as
// (u2 + 1.5 2^23) - 1.5 2^23, is exact and lies in [-1/2, 1/2], and
// cos(2 pi u2) = cos(f32(2 pi) t) up to f32(2 pi) t's rounding
// (bench/spec_accel.py tolerance() has the error argument).
#include "common.cuh"
#if defined(REPRO_RT_NATIVE)
#include "native/rt_native.cuh"
#else
#include "rt/runtime.cuh"
#endif

namespace {

constexpr int NB = 256;              // seeds a block (the reference's)
constexpr int WARPS = 8;             // blocks a team, one a warp
constexpr int NT = 32 * WARPS;
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float ROUND = 12582912.f;  // 1.5 * 2^23: adds round to integers

// z of one seed.
__device__ __forceinline__ float box_muller(int seed) {
  const unsigned s = static_cast<unsigned>(seed);
  const unsigned a = s * 1664525u + 1013904223u;
  const unsigned b = (a ^ (a >> 16)) * 2246822519u;
  const float u1 = (__uint2float_rn(a) + 1.0f) / 4294967296.0f;
  const float u2 = (__uint2float_rn(b) + 1.0f) / 4294967296.0f;
  const float r = sqrtf(-2.0f * logf(u1));
  const float t = __fsub_rn(u2, __fsub_rn(__fadd_rn(u2, ROUND), ROUND));
  return r * rt::approx_cos(TWO_PI * t);
}

__global__ void __launch_bounds__(NT)
pep_kernel(const int* __restrict__ seeds, float* __restrict__ out,
           int blocks) {
  const int lane = rt::thread_id() & 31;
  const int blk = static_cast<int>(rt::team_id(0)) * WARPS +
                  static_cast<int>(rt::thread_id() >> 5);
  if (blk >= blocks) return;
  const int4* p =
      reinterpret_cast<const int4*>(seeds + static_cast<size_t>(blk) * NB) +
      lane;
  const int4 lo = p[0], hi = p[NB / 8];
  const int s[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  float sum = 0.f, sq = 0.f, ab = 0.f, mx = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float z = box_muller(s[e]);
    sum += z;
    sq += z * z;
    ab += fabsf(z);
    mx = e == 0 ? z : fmaxf(mx, z);
  }
  sum = rt::warp_reduce_sum(sum);
  sq = rt::warp_reduce_sum(sq);
  mx = rt::warp_reduce_max(mx);
  ab = rt::warp_reduce_sum(ab);
  if (lane == 0)
    *reinterpret_cast<float4*>(out + 4 * static_cast<size_t>(blk)) =
        make_float4(sum, sq, mx, ab);
}

}  // namespace

// n a multiple of NB (the reference's blocks of 256); seeds and out
// 16-byte aligned (the wrapper's check).
extern "C" int pep_fwd(const int* seeds, float* out, int n, void* stream) {
  if (n <= 0 || n % NB != 0) return cudaErrorInvalidValue;
  const int blocks = n / NB;
  pep_kernel<<<(blocks + WARPS - 1) / WARPS, NT, 0,
               static_cast<cudaStream_t>(stream)>>>(seeds, out, blocks);
  return cudaGetLastError();
}
