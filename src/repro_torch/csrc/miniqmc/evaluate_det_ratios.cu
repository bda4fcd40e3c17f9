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
// stages phi in a carve-out of the shared arena.  What bounds a team is
// the bytes it keeps in flight: at N = 1024 only NW = 256 teams of 256
// threads run, two an SM, and one 4-byte load a column at a time leaves
// about 8 KB a team in flight, too little to cover the memory's latency
// at 3.35 TB/s.  So a thread owns 4 adjacent output columns and loads
// them for ROWS rows at once, all before it sums any: 16-byte loads of
// 16 rows (256 bytes a thread, 64 KB a team) where the rows are 16-byte
// aligned (N a multiple of 4), else 4-byte loads of 8 rows, the columns
// past N of the last group read as 0 and not stored.  A warp reads 512
// contiguous bytes of a row at each step: coalesced.  Where N / 4
// columns leave threads idle (N <= 512), the team's threads form
// row_slices(N) slices of whole warps, each summing its own contiguous
// share of the rows, and the slices' partial sums meet in a second
// carve-out, added in slice order.  Each column's sum runs i = 0 .. N - 1
// in order, one fmaf a term, within a slice; no atomic enters, so every
// run gives the same bits.
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

// Columns j .. j + 3 of one row of A: one 16-byte load (VEC: rows
// 16-byte aligned, j + 3 < n), or four 4-byte loads, 0 past n.
template <bool VEC>
__device__ __forceinline__ float4 load_cols(const float* __restrict__ row,
                                            int j, int n) {
  if constexpr (VEC) {
    return *reinterpret_cast<const float4*>(row + j);
  } else {
    return make_float4(row[j], j + 1 < n ? row[j + 1] : 0.f,
                       j + 2 < n ? row[j + 2] : 0.f,
                       j + 3 < n ? row[j + 3] : 0.f);
  }
}

__device__ __forceinline__ void add_row(float acc[4], float p, float4 x) {
  acc[0] = fmaf(p, x.x, acc[0]);
  acc[1] = fmaf(p, x.y, acc[1]);
  acc[2] = fmaf(p, x.z, acc[2]);
  acc[3] = fmaf(p, x.w, acc[3]);
}

// Row slices of a team for n orbitals: the threads that the n / 4
// column groups need, in whole warps, divide the team; the rest take
// other rows.
__host__ __device__ constexpr int row_slices(int n) {
  const int groups = (n + 3) / 4;
  return groups > NT / 2 ? 1 : groups > NT / 4 ? 2 : groups > NT / 8 ? 4 : 8;
}

// SLICED: several row slices (row_slices(n) > 1); a compile-time
// choice, so that the one-slice body keeps all ROWS loads in flight.
template <bool VEC, bool SLICED>
__global__ void __launch_bounds__(NT)
evaluate_det_ratios_kernel(const float* __restrict__ a_inv,
                           const float* __restrict__ phi,
                           float* __restrict__ ratios, int n) {
  constexpr int ROWS = VEC ? 16 : 8;  // rows of loads in flight
  const int slices = SLICED ? row_slices(n) : 1;
  const int tc = SLICED ? NT / slices : NT;  // threads a slice
  rt::Arena arena;
  float* ps = arena.alloc_shared<float>(n);
  float* part = arena.alloc_shared<float>(SLICED ? slices * n : 0);
  const size_t w = rt::team_id(0);
  const int tid = rt::thread_id();
  for (int i = tid; i < n; i += NT) ps[i] = phi[w * n + i];
  rt::barrier();
  const float* a = a_inv + w * n * n;
  float* out = ratios + w * n;
  const int slice = SLICED ? tid / tc : 0;
  const int per = SLICED ? (n + slices - 1) / slices : n;
  const int i_end = SLICED ? min(n, (slice + 1) * per) : n;
  float* dst = SLICED ? part + slice * n : out;
  for (int j = 4 * (SLICED ? tid % tc : tid); j < n; j += 4 * tc) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int i = slice * per;
    for (; i + ROWS <= i_end; i += ROWS) {
      float4 x[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
        x[u] = load_cols<VEC>(a + static_cast<size_t>(i + u) * n, j, n);
#pragma unroll
      for (int u = 0; u < ROWS; ++u) add_row(acc, ps[i + u], x[u]);
    }
    for (; i < i_end; ++i)
      add_row(acc, ps[i],
              load_cols<VEC>(a + static_cast<size_t>(i) * n, j, n));
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(dst + j) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (j + k < n) dst[j + k] = acc[k];
    }
  }
  if constexpr (SLICED) {
    rt::barrier();
    for (int j = tid; j < n; j += NT) {
      float r = part[j];
      for (int sl = 1; sl < slices; ++sl) r += part[sl * n + j];
      out[j] = r;
    }
  }
}

// The build for n's alignment (VEC) and slices.
template <bool VEC>
void launch_for(const float* a_inv, const float* phi, float* ratios, int nw,
                int n, size_t bytes, cudaStream_t st) {
  if (row_slices(n) > 1)
    evaluate_det_ratios_kernel<VEC, true>
        <<<nw, NT, bytes, st>>>(a_inv, phi, ratios, n);
  else
    evaluate_det_ratios_kernel<VEC, false>
        <<<nw, NT, bytes, st>>>(a_inv, phi, ratios, n);
}

}  // namespace

// nw walkers of n orbitals; 1 <= n <= MAX_N; a_inv and ratios 16-byte
// aligned (the wrapper checks).
extern "C" int evaluate_det_ratios_fwd(const float* a_inv, const float* phi,
                                       float* ratios, int nw, int n,
                                       void* stream) {
  if (nw <= 0 || n <= 0 || n > MAX_N) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // phi, and the slices' partial sums where there are several (at most
  // 1,024 floats: several slices only for n <= 512)
  const int slices = row_slices(n);
  const size_t bytes = (n + (slices > 1 ? slices * n : 0)) * sizeof(float);
  if (n % 4 == 0)
    launch_for<true>(a_inv, phi, ratios, nw, n, bytes, st);
  else
    launch_for<false>(a_inv, phi, ratios, nw, n, bytes, st);
  return cudaGetLastError();
}
