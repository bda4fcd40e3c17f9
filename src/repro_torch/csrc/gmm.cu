// Grouped matmul of MoE experts in the capacity layout:
// (E, C, K) @ (E, K, N) -> (E, C, N), summed in f32, rows at or past
// group_sizes[e] written as 0, the output in the lhs type.
//
// Replaces the TPU kernel src/repro/kernels/gmm/gmm.py (gmm_fwd, body
// _gmm_kernel).
//
// Bound on the H100: bytes at decode, operations at prefill.  At 8
// slots a call multiplies C = 8 rows per expert by the expert's whole
// weight matrix (64 x 2048 x 1408 in bf16, 369 MB: 16 flops per weight
// byte, far below the card's 295 flops/byte ridge); a prefill of 3 x
// 511 tokens gives C = 184 (about 150 flops per byte, but this kernel
// runs them as f32 FMA on the CUDA cores, whose 67 TFLOP/s make it the
// limit there).  mma.sync, then wgmma and TMA, are later PRs' work.
// Design: one CTA per (N tile, C tile, expert), the TPU's sequential K
// grid axis a loop inside it.  Each step stages a BC x BK slice of the
// tokens and a BK x BN slice of the weights in shared memory as f32;
// the next step's 16-byte loads are issued into registers before the
// current step's FMAs, so the weight stream stays in flight.  Each
// thread owns a TM x TN block of the output.  Two builds: BC = 8 for
// decode (C <= 8), so a CTA covers all of its expert's rows and every
// weight tile is fetched once; BC = 64 otherwise.  group_sizes is read
// on the device: a C tile wholly at or past its expert's size skips its
// K loop and writes zeros, as the reference's `ic * block_c < size`
// predicate does, and rows at or past the size are written as 0.
#include "common.cuh"

namespace {

constexpr int BN = 128;  // output columns per CTA
constexpr int BK = 32;   // depth per loop step

// A ROWS x COLS tile of T, loaded 16 bytes per thread-load into
// registers (all of a thread's loads in flight together), then stored
// to shared memory as f32.  Rows past `rows` and columns past `cols`
// (a multiple of the vector width) read as 0.
template <typename T, int ROWS, int COLS, int NT>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = COLS / VEC;
  static constexpr int TOTAL = ROWS * PER_ROW;
  static constexpr int ITERS = (TOTAL + NT - 1) / NT;
  static_assert(COLS % VEC == 0, "tile width");
  uint4 buf[ITERS];

  __device__ void load(const T* __restrict__ src, size_t ld, int rows,
                       int cols) {
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int r = idx / PER_ROW, c = idx % PER_ROW * VEC;
      buf[i] = idx < TOTAL && r < rows && c < cols
                   ? __ldg(reinterpret_cast<const uint4*>(src + r * ld + c))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ void store(float* dst, int lds) const {
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (idx >= TOTAL) continue;
      const int r = idx / PER_ROW, c = idx % PER_ROW * VEC;
      const T* e = reinterpret_cast<const T*>(&buf[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[r * lds + c + j] = repro::to_f32(e[j]);
    }
  }
};

template <typename T, int BC, int TM, int TN>
__global__ void __launch_bounds__((BC / TM) * (BN / TN))
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
           const int* __restrict__ group_sizes, T* __restrict__ out, int c,
           int k, int n) {
  constexpr int TY = BC / TM, TX = BN / TN, NT = TY * TX;
  constexpr int LDA = BK + 1;
  __shared__ float sA[BC * LDA];
  __shared__ float sB[BK * BN];

  const int e = blockIdx.z, c0 = blockIdx.y * BC, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int size = group_sizes[e];
  T* ob = out + static_cast<size_t>(e) * c * n;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (c0 < size) {  // else no valid row: skip the K loop
    const T* ab = lhs + (static_cast<size_t>(e) * c + c0) * k;
    const T* bb = rhs + static_cast<size_t>(e) * k * n + n0;
    Tile<T, BC, BK, NT> ta;
    Tile<T, BK, BN, NT> tb;
    const int rows = min(BC, c - c0), cols = n - n0;
    ta.load(ab, k, rows, k);
    tb.load(bb, n, min(BK, k), cols);
    for (int k0 = 0; k0 < k; k0 += BK) {
      __syncthreads();  // the previous step's readers are done
      ta.store(sA, LDA);
      tb.store(sB, BN);
      __syncthreads();
      const int k1 = k0 + BK;
      if (k1 < k) {  // the next step's loads fly during these FMAs
        ta.load(ab + k1, k, rows, k - k1);
        tb.load(bb + static_cast<size_t>(k1) * n, n, min(BK, k - k1), cols);
      }
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = sA[(ty + TY * i) * LDA + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = sB[kk * BN + tx + TX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = c0 + ty + TY * i;
    if (r >= c) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + TX * j;
      if (col < n)
        ob[static_cast<size_t>(r) * n + col] =
            repro::from_f32<T>(r < size ? acc[i][j] : 0.f);
    }
  }
}

template <typename T, int BC, int TM, int TN>
cudaError_t launch(const void* lhs, const void* rhs, const int* sizes,
                   void* out, int e, int c, int k, int n,
                   cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (c + BC - 1) / BC, e);
  gmm_kernel<T, BC, TM, TN><<<grid, (BC / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), sizes,
      static_cast<T*>(out), c, k, n);
  return cudaGetLastError();
}

// block_c 8: 128 threads of 2 x 4 outputs; block_c 64: 256 of 4 x 8.
template <typename T>
cudaError_t dispatch_c(int block_c, const void* lhs, const void* rhs,
                       const int* sizes, void* out, int e, int c, int k,
                       int n, cudaStream_t stream) {
  if (block_c == 8)
    return launch<T, 8, 2, 4>(lhs, rhs, sizes, out, e, c, k, n, stream);
  if (block_c == 64)
    return launch<T, 64, 4, 8>(lhs, rhs, sizes, out, e, c, k, n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// block_n / block_k are the tuning table's values: this build holds one
// N x K schedule, 128 x 32, and refuses any other.  K and N must be
// whole 16-byte vectors of the element type.
extern "C" int gmm_fwd(const void* lhs, const void* rhs,
                       const void* group_sizes, void* out, int e, int c,
                       int k, int n, int block_c, int block_n, int block_k,
                       int dtype, void* stream) {
  if (block_n != BN || block_k != BK || e < 0 || c < 0 || k < 0 || n < 0)
    return cudaErrorInvalidValue;
  if (e == 0 || c == 0 || n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sizes = static_cast<const int*>(group_sizes);
  if (dtype == repro::DTYPE_F32) {
    if (k % 4 || n % 4) return cudaErrorInvalidValue;
    return dispatch_c<float>(block_c, lhs, rhs, sizes, out, e, c, k, n, s);
  }
  if (dtype == repro::DTYPE_BF16) {
    if (k % 8 || n % 8) return cudaErrorInvalidValue;
    return dispatch_c<__nv_bfloat16>(block_c, lhs, rhs, sizes, out, e, c, k,
                                     n, s);
  }
  return cudaErrorInvalidValue;
}
