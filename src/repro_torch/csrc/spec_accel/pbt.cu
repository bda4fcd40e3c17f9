// 570.pbt (B17): batched tridiagonal solves by the Thomas algorithm.
// For each of nb systems of n unknowns (lower l, diagonal d, upper u,
// right-hand side r; rows of (nb, n) f32 arrays) the forward sweep
//   cp_0 = u_0 / d_0,  dp_0 = r_0 / d_0,
//   m = d_i - l_i cp_{i-1},  cp_i = u_i / m,  dp_i = (r_i - l_i dp_{i-1}) / m
// writes cp and dp to their (nb, n) outputs, as the reference's kernel
// does, and the back substitution x_{n-1} = dp_{n-1},
// x_i = dp_i - cp_i x_{i+1} reads them back.  The divisions are exact
// IEEE divisions, as the reference writes them: no __fdividef, no
// approximate reciprocal.
//
// Written once against the device runtime's facade and built twice
// (portable against rt/runtime.cuh, native with -DREPRO_RT_NATIVE
// against native/rt_native.cuh), as postencil.cu.
//
// Replaces the TPU kernel benchmarks/spec_accel.py:249 (pbt, body
// kern).  Its grid (1,) holds every system in one block, each sweep a
// loop over columns of the (nb, n) block; here a system is a thread.
//
// Bound on the H100: bytes, 28 an unknown (four inputs read, three
// outputs written) against about 8 flops and 2 divisions.  Design: one
// thread a system, NT systems a team, so the sweeps run in parallel
// over systems and in order along each.  The known cost of this simple
// design: a warp's 32 threads read and write 32 rows at once, so every
// access is strided by n floats and touches 32 sectors of 32 bytes for
// 4 bytes each.  A thread's next 7 reads of an input can hit the line
// its first read brought into L1 only while the L1 holds a 128-byte
// line per thread and input: at 16 warps a SM it cannot, and the
// kernel runs at about 1/25 of its bound at (65536, 512) (PERF.md,
// scripts/torch_pbt_scaling.py).  Staging tiles of columns through the
// arena, transposed, would make the accesses coalesced.
#include "common.cuh"
#if defined(REPRO_RT_NATIVE)
#include "native/rt_native.cuh"
#else
#include "rt/runtime.cuh"
#endif

namespace {

constexpr int NT = 128;

__global__ void __launch_bounds__(NT)
pbt_kernel(const float* __restrict__ lo, const float* __restrict__ di,
           const float* __restrict__ up, const float* __restrict__ rh,
           float* __restrict__ x, float* __restrict__ cp,
           float* __restrict__ dp, int nb, int n) {
  const long long b =
      static_cast<long long>(rt::team_id(0)) * NT + rt::thread_id();
  if (b >= nb) return;
  const size_t row = static_cast<size_t>(b) * n;
  const float *l = lo + row, *d = di + row, *u = up + row, *r = rh + row;
  float *xr = x + row, *c = cp + row, *e = dp + row;
  float c_prev = u[0] / d[0];
  float e_prev = r[0] / d[0];
  c[0] = c_prev;
  e[0] = e_prev;
  for (int i = 1; i < n; ++i) {
    const float li = l[i];
    const float m = d[i] - li * c_prev;
    c_prev = u[i] / m;
    e_prev = (r[i] - li * e_prev) / m;
    c[i] = c_prev;
    e[i] = e_prev;
  }
  float xi = e_prev;  // x_{n-1} = dp_{n-1}
  xr[n - 1] = xi;
  for (int i = n - 2; i >= 0; --i) {
    xi = e[i] - c[i] * xi;
    xr[i] = xi;
  }
}

}  // namespace

// nb systems of n unknowns, each row of (nb, n) f32 arrays; nb, n >= 1.
extern "C" int pbt_fwd(const float* lo, const float* di, const float* up,
                       const float* rh, float* x, float* cp, float* dp,
                       int nb, int n, void* stream) {
  if (nb <= 0 || n <= 0) return cudaErrorInvalidValue;
  pbt_kernel<<<(nb + NT - 1) / NT, NT, 0,
               static_cast<cudaStream_t>(stream)>>>(lo, di, up, rh, x, cp,
                                                    dp, nb, n);
  return cudaGetLastError();
}
