// 504.polbm (B13): one D2Q9 lattice-Boltzmann step on an (h, w, 9) f32
// lattice: the BGK collision (tau = 0.6) of each cell, then streaming,
// periodic: the collided value of plane k at cell (i, j) lands at
// ((i + cx_k) mod h, (j + cy_k) mod w), cx moving axis 0.
//
// Written once against the device runtime's facade and built twice
// (portable against rt/runtime.cuh, native with -DREPRO_RT_NATIVE
// against native/rt_native.cuh), as postencil.cu.
//
// Replaces the TPU kernel benchmarks/spec_accel.py:101 (polbm, body
// kern), and the nine jnp.roll calls and the stack that follow it there:
// as separate passes they would be ten launches and two more trips over
// the lattice, more than the collision itself.
//
// Bound on the H100: bytes.  Each cell's 36 bytes are read once and
// written once for about 185 flops (11 of them divisions), below the f32
// ridge of 20 flops a byte.  Design: one thread per cell, NT cells a
// team; rho, u_x, u_y and feq exactly as the reference writes them (a
// division by rho and by 0.6, no reciprocal; sums over k in order), and
// the streaming fused into the store.
#include "common.cuh"
#if defined(REPRO_RT_NATIVE)
#include "native/rt_native.cuh"
#else
#include "rt/runtime.cuh"
#endif

namespace {

constexpr int Q = 9, NT = 256;

__global__ void __launch_bounds__(NT)
polbm_kernel(const float* __restrict__ f, float* __restrict__ out, int h,
             int w) {
  // the reference's _D2Q9 and _W9 (f32 of 4/9, 1/9, 1/36)
  const int dx[Q] = {0, 1, -1, 0, 0, 1, -1, 1, -1};
  const int dy[Q] = {0, 0, 0, 1, -1, 1, -1, -1, 1};
  const float wq[Q] = {0.4444444477558136f, 0.1111111119389534f,
                       0.1111111119389534f, 0.1111111119389534f,
                       0.1111111119389534f, 0.02777777798473835f,
                       0.02777777798473835f, 0.02777777798473835f,
                       0.02777777798473835f};
  const int cell = rt::team_id(0) * NT + rt::thread_id();
  if (cell >= h * w) return;
  const int i = cell / w, j = cell % w;
  float fl[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) fl[k] = f[static_cast<size_t>(cell) * Q + k];

  float rho = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    rho += fl[k];
    sx += fl[k] * static_cast<float>(dx[k]);
    sy += fl[k] * static_cast<float>(dy[k]);
  }
  const float ux = sx / rho, uy = sy / rho;
  const float usq = ux * ux + uy * uy;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const float cu = static_cast<float>(dx[k]) * ux +
                     static_cast<float>(dy[k]) * uy;
    const float feq =
        rho * wq[k] * (1.f + 3.f * cu + 4.5f * cu * cu - 1.5f * usq);
    int ii = i + dx[k], jj = j + dy[k];
    ii = ii < 0 ? ii + h : ii >= h ? ii - h : ii;
    jj = jj < 0 ? jj + w : jj >= w ? jj - w : jj;
    out[(static_cast<size_t>(ii) * w + jj) * Q + k] =
        fl[k] - (fl[k] - feq) / 0.6f;
  }
}

}  // namespace

// One step of an (h, w, 9) lattice; f and out must not overlap.
extern "C" int polbm_step(const float* f, float* out, int h, int w,
                          void* stream) {
  if (h <= 0 || w <= 0) return cudaErrorInvalidValue;
  const int teams = static_cast<int>((static_cast<long long>(h) * w + NT - 1)
                                     / NT);
  polbm_kernel<<<teams, NT, 0, static_cast<cudaStream_t>(stream)>>>(f, out,
                                                                      h, w);
  return cudaGetLastError();
}
