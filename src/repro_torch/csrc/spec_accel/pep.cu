// 552.pep (B15): the embarrassingly parallel pipeline.  For each block
// of NT int32 seeds: the uint32 hash a = s 1664525 + 1013904223,
// b = (a ^ (a >> 16)) 2246822519 (mod 2^32, logical shift), the
// uniforms (f32(a) + 1) / 2^32 and (f32(b) + 1) / 2^32, Box-Muller
// z = sqrt(-2 log u1) cos(2 pi u2), then the block's
// [sum z, sum z^2, max z, sum |z|] into one row of out (n / NT, 4) f32.
//
// Written once against the device runtime's facade and built twice
// (portable against rt/runtime.cuh, native with -DREPRO_RT_NATIVE
// against native/rt_native.cuh), as postencil.cu.
//
// Replaces the TPU kernel benchmarks/spec_accel.py:182 (pep, body kern).
//
// Bound on the H100: bytes, 4 a seed read (and 16 a block written),
// against a logarithm, a square root and a cosine a seed at the
// special-function unit's 16 a clock per SM, about 0.6 of the bytes'
// time.  Design: one team of NT threads per block, a seed a thread; the
// four sums are the runtime's block reductions, each on its own
// carve-out of the arena (a reduction's scratch may be reused only
// after a barrier that follows it).
#include "common.cuh"
#if defined(REPRO_RT_NATIVE)
#include "native/rt_native.cuh"
#else
#include "rt/runtime.cuh"
#endif

namespace {

constexpr int NT = 256;
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr size_t SMEM_BYTES = 4 * rt::reduce_scratch(NT) * sizeof(float);

__global__ void __launch_bounds__(NT)
pep_kernel(const int* __restrict__ seeds, float* __restrict__ out) {
  rt::Arena arena;
  float* r_sum = arena.alloc_shared<float>(rt::reduce_scratch(NT));
  float* r_sq = arena.alloc_shared<float>(rt::reduce_scratch(NT));
  float* r_max = arena.alloc_shared<float>(rt::reduce_scratch(NT));
  float* r_abs = arena.alloc_shared<float>(rt::reduce_scratch(NT));
  const size_t team = rt::team_id(0);
  const unsigned s = static_cast<unsigned>(seeds[team * NT + rt::thread_id()]);
  const unsigned a = s * 1664525u + 1013904223u;
  const unsigned b = (a ^ (a >> 16)) * 2246822519u;
  const float u1 = (__uint2float_rn(a) + 1.0f) / 4294967296.0f;
  const float u2 = (__uint2float_rn(b) + 1.0f) / 4294967296.0f;
  const float r = sqrtf(-2.0f * logf(u1));
  const float z = r * cosf(TWO_PI * u2);
  const float sum = rt::reduce_sum<NT>(z, r_sum);
  const float sq = rt::reduce_sum<NT>(z * z, r_sq);
  const float mx = rt::reduce_max<NT>(z, r_max);
  const float ab = rt::reduce_sum<NT>(fabsf(z), r_abs);
  if (rt::thread_id() == 0) {
    out[4 * team] = sum;
    out[4 * team + 1] = sq;
    out[4 * team + 2] = mx;
    out[4 * team + 3] = ab;
  }
}

}  // namespace

// n a multiple of NT (the reference's blocks of 256).
extern "C" int pep_fwd(const int* seeds, float* out, int n, void* stream) {
  if (n <= 0 || n % NT != 0) return cudaErrorInvalidValue;
  pep_kernel<<<n / NT, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      seeds, out);
  return cudaGetLastError();
}
