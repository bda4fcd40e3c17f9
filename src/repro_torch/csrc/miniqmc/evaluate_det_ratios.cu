// evaluate_det_ratios (B19), miniQMC's second hot region (paper Table
// 1, evaluateDetRatios): the Sherman-Morrison determinant ratios of
// each walker, r = phi A_inv, a (1, N) by (N, N) product in f32;
// a_inv (NW, N, N), phi (NW, N), out (NW, N).
//
// The product is the kernel's own body in the reference, so it is
// written here by hand: no cuBLAS, no torch.matmul.
//
// Written once against the device runtime's facade and built twice
// (portable against rt/runtime.cuh, native with -DREPRO_RT_NATIVE
// against native/rt_native.cuh), as csrc/spec_accel/postencil.cu.
//
// Replaces the TPU kernel benchmarks/miniqmc.py:89 (evaluate_det_ratios,
// body kern), one grid step a walker.
//
// Bound on the H100: bytes, the 4 N^2 of each walker's A_inv read once,
// against 2 N^2 flops (0.5 a byte, far below the f32 ridge of 20).
// Design: one team a walker, the reference's grid (NW,).  The team
// stages phi in a carve-out of the shared arena; each thread owns the
// output columns j = tid, tid + NT, ... and sums phi_i A[i, j] over i in
// order, in f32, so a warp reads 32 consecutive floats of a row of A
// at each step: coalesced.  Only NW teams run, so the card fills only
// when NW reaches a few per SM.
#include "common.cuh"
#if defined(REPRO_RT_NATIVE)
#include "native/rt_native.cuh"
#else
#include "rt/runtime.cuh"
#endif

namespace {

constexpr int NT = 256;
// phi staged in shared memory: at most the 48 KB a launch takes
// without opting in to more
constexpr int MAX_N = 48 * 1024 / sizeof(float);

__global__ void __launch_bounds__(NT)
evaluate_det_ratios_kernel(const float* __restrict__ a_inv,
                           const float* __restrict__ phi,
                           float* __restrict__ ratios, int n) {
  rt::Arena arena;
  float* ps = arena.alloc_shared<float>(n);
  const size_t w = rt::team_id(0);
  const int tid = rt::thread_id();
  for (int i = tid; i < n; i += NT) ps[i] = phi[w * n + i];
  rt::barrier();
  const float* a = a_inv + w * n * n;
  for (int j = tid; j < n; j += NT) {
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) acc += ps[i] * a[static_cast<size_t>(i) * n + j];
    ratios[w * n + j] = acc;
  }
}

}  // namespace

// nw walkers of n orbitals; 1 <= n <= MAX_N.
extern "C" int evaluate_det_ratios_fwd(const float* a_inv, const float* phi,
                                       float* ratios, int nw, int n,
                                       void* stream) {
  if (nw <= 0 || n <= 0 || n > MAX_N) return cudaErrorInvalidValue;
  evaluate_det_ratios_kernel<<<nw, NT, n * sizeof(float),
                               static_cast<cudaStream_t>(stream)>>>(
      a_inv, phi, ratios, n);
  return cudaGetLastError();
}
