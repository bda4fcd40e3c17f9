// 554.pcg (B16): the banded SpMV of the CG solve,
// y_i = diag_i x_i + off_i (x_{i+1} + x_{i-1}) with x_{-1} = x_n = 0,
// in f32.  The launcher makes one launch before CG's loop and one an
// iteration (9 for the reference's 8); the dots and vector updates stay
// torch operations outside the kernel, as the reference keeps them jnp
// operations outside its Pallas body.
//
// The operator is the reference's exactly, and it is not symmetric:
// A[i, i+1] = off_i but A[i+1, i] = off_{i+1}.  CG still converges in
// its fixed iterations on these inputs because the rows are strongly
// diagonally dominant (diag >= 2, off <= 0.4).  It is not symmetrised.
//
// Written once against the device runtime's facade and built twice
// (portable against rt/runtime.cuh, native with -DREPRO_RT_NATIVE
// against native/rt_native.cuh), as postencil.cu.
//
// Replaces the TPU kernel benchmarks/spec_accel.py:211 (pcg, body
// spmv_kern).  Its grid (1,), the whole (1, n) vector one block, is a
// Pallas layout for the TPU's vector memory, not a law of the function:
// here teams of NT threads each own NT consecutive rows, for any n >= 1.
//
// Bound on the H100: bytes, 16 a row (diag, off and x read once, y
// written once) for 4 flops.  Design: one row a thread; the neighbours
// are read from global memory (each x is read by three threads of one
// or two neighbouring teams, so the repeats hit L1 or L2, not DRAM),
// zero past both ends.  The sum is the reference's, d x + o (u + l).
#include "common.cuh"
#if defined(REPRO_RT_NATIVE)
#include "native/rt_native.cuh"
#else
#include "rt/runtime.cuh"
#endif

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
pcg_spmv_kernel(const float* __restrict__ diag, const float* __restrict__ off,
                const float* __restrict__ x, float* __restrict__ y,
                long long n) {
  const long long i =
      static_cast<long long>(rt::team_id(0)) * NT + rt::thread_id();
  if (i >= n) return;
  const float up = i + 1 < n ? x[i + 1] : 0.f;
  const float down = i > 0 ? x[i - 1] : 0.f;
  y[i] = diag[i] * x[i] + off[i] * (up + down);
}

}  // namespace

// y = A x for the tridiagonal A of diag and off; n >= 1.
extern "C" int pcg_spmv_fwd(const float* diag, const float* off,
                            const float* x, float* y, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const unsigned teams = static_cast<unsigned>((n + NT - 1LL) / NT);
  pcg_spmv_kernel<<<teams, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      diag, off, x, y, n);
  return cudaGetLastError();
}
