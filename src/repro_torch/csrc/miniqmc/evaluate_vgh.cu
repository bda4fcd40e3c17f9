// evaluate_vgh (B18), miniQMC's first hot region (paper Table 1): the
// cubic B-spline value, gradient and hessian of NS splines for each of
// NW walkers.  coefs4 (NW, 4, NS) holds each spline's four gathered
// taps and t (NW, 1) the walker's offset in [0, 1); out value, grad
// and hess, each (NW, NS) f32:
//   value = w0 c0 + w1 c1 + w2 c2 + w3 c3, the basis weights
//     w0 = (1 - 3t + 3t^2 - t^3) / 6, w1 = (4 - 6t^2 + 3t^3) / 6,
//     w2 = (1 + 3t + 3t^2 - 3t^3) / 6, w3 = t^3 / 6;
//   grad with d0 = (-1 + 2t - t^2) / 2, d1 = (-4t + 3t^2) / 2,
//     d2 = (1 + 2t - 3t^2) / 2, d3 = t^2 / 2;
//   hess with h0 = 1 - t, h1 = 3t - 2, h2 = 1 - 3t, h3 = t;
// each weight in the reference's expression, the division by 6 as
// written, each sum left to right.
//
// Written once against the device runtime's facade and built twice
// (portable against rt/runtime.cuh, native with -DREPRO_RT_NATIVE
// against native/rt_native.cuh), as csrc/spec_accel/postencil.cu.
//
// Replaces the TPU kernel benchmarks/miniqmc.py:43 (evaluate_vgh, body
// kern), whose grid takes blocks of min(8, NW) walkers.
//
// Bound on the H100: bytes, 28 a (walker, spline) (16 read, 12 written)
// for 21 flops.  Design: a 2-D grid of teams; team (j, w) owns NT
// splines of one block of walkers, one spline a thread.  Every thread
// computes each walker's 12 weights from t (a broadcast read; a few
// dozen flops beside the walker's NT columns), then the spline's three
// 4-tap sums.  Reads of the taps and writes of the three outputs run
// along NS, so a warp's accesses are coalesced.
#include "common.cuh"
#if defined(REPRO_RT_NATIVE)
#include "native/rt_native.cuh"
#else
#include "rt/runtime.cuh"
#endif

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
evaluate_vgh_kernel(const float* __restrict__ coefs,
                    const float* __restrict__ t, float* __restrict__ val,
                    float* __restrict__ grad, float* __restrict__ hess,
                    int walkers, int ns) {
  const int j = rt::team_id(0) * NT + rt::thread_id();
  if (j >= ns) return;
  const int w0 = rt::team_id(1) * walkers;
  for (int w = w0; w < w0 + walkers; ++w) {
    const float tt = t[w];
    const float t2 = tt * tt;
    const float t3 = t2 * tt;
    const float a0 = (1.f - 3.f * tt + 3.f * t2 - t3) / 6.f;
    const float a1 = (4.f - 6.f * t2 + 3.f * t3) / 6.f;
    const float a2 = (1.f + 3.f * tt + 3.f * t2 - 3.f * t3) / 6.f;
    const float a3 = t3 / 6.f;
    const float d0 = (-1.f + 2.f * tt - t2) / 2.f;
    const float d1 = (-4.f * tt + 3.f * t2) / 2.f;
    const float d2 = (1.f + 2.f * tt - 3.f * t2) / 2.f;
    const float d3 = t2 / 2.f;
    const float h0 = 1.f - tt;
    const float h1 = 3.f * tt - 2.f;
    const float h2 = 1.f - 3.f * tt;
    const float h3 = tt;
    const float* c = coefs + static_cast<size_t>(w) * 4 * ns + j;
    const float c0 = c[0], c1 = c[ns], c2 = c[2 * ns], c3 = c[3 * ns];
    const size_t o = static_cast<size_t>(w) * ns + j;
    val[o] = a0 * c0 + a1 * c1 + a2 * c2 + a3 * c3;
    grad[o] = d0 * c0 + d1 * c1 + d2 * c2 + d3 * c3;
    hess[o] = h0 * c0 + h1 * c1 + h2 * c2 + h3 * c3;
  }
}

}  // namespace

// nw walkers in blocks of `walkers` (nw a multiple of it), ns splines.
extern "C" int evaluate_vgh_fwd(const float* coefs, const float* t,
                                float* val, float* grad, float* hess, int nw,
                                int walkers, int ns, void* stream) {
  if (nw <= 0 || ns <= 0 || walkers <= 0 || nw % walkers != 0 ||
      nw / walkers > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((ns + NT - 1) / NT, nw / walkers);
  evaluate_vgh_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      coefs, t, val, grad, hess, walkers, ns);
  return cudaGetLastError();
}
