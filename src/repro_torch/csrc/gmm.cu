// Grouped matmul of MoE experts in the capacity layout:
// (E, C, K) @ (E, K, N) -> (E, C, N), summed in f32, rows at or past
// group_sizes[e] written as 0, the output in the lhs type.
//
// Replaces the TPU kernel src/repro/kernels/gmm/gmm.py (gmm_fwd, body
// _gmm_kernel).
//
// Bound on the H100: bytes at decode, bytes at jamba's prefill and
// operations beside them.  At 8 slots a call multiplies C = 8 rows per
// expert by the expert's whole weight matrix (64 x 2048 x 1408 in bf16,
// 369 MB: 16 flops per weight byte, far below the card's 295
// flops/byte ridge); a prefill of 3 x 511 tokens gives C = 184 (about
// 150 flops per byte), jamba's of 2 x 511 C = 160 over 6.4 GB of
// weights (1.97 ms of bytes, 1.04 ms of bf16 tensor-core operations).
//
// bf16 runs on the tensor cores (rt::mma_bf16_m16n8k16 and
// rt::load_matrix_* of the device runtime; otherwise plain CUDA, with
// no generic build), fed from shared memory through a 4-stage cp.async
// ring of BK = 32 deep tiles, three in flight while one is multiplied;
// rows are padded by 16 bytes so every ldmatrix hits 32 distinct banks,
// and a K that is not a multiple of 32 (or 16) is zero-filled there
// (cp.async's source size 0), as are rows past C and columns past N.
// Each 32-deep step's products are summed by the tensor core in a fresh
// accumulator and then added to the running f32 total, rather than
// chained through one accumulator over all of K (up to 1,536 products of
// sixteen at jamba's down projection): the total is an f32 sum of K / 32
// step sums, nearer an f32 dot than one chain through the tensor core's
// accumulator.
// Two builds of the capacity tile:
//   - prefill (BC = 64): one CTA of 4 warps per 64 x 128 output tile of
//     one expert, each warp a 32 x 64 quarter; lhs A fragments by
//     ldmatrix, the (K, N) rhs reaches the B operand by ldmatrix.trans;
//     the C tiles of one N tile are neighbours in the grid, so the
//     weight tile they share is read from L2 after the first;
//   - decode (BC = 8, C <= 8): the roles swap so each m16n8k16 uses all
//     its rows: a 16-column slice of the weights is the A side (W^T by
//     ldmatrix.trans) and the <= 8 token rows the n = 8 side; one CTA of
//     4 warps per 128 weight columns walks all of K (jamba 192 x 16 =
//     3,072 CTAs, deepseek 11 x 64 = 704).
// f32 keeps the CUDA-core body: each step stages a BC x BK slice of the
// tokens and a BK x BN slice of the weights in shared memory as f32, the
// next step's 16-byte loads in flight during the current step's FMAs,
// each thread owning a TM x TN block of the output.  group_sizes is read
// on the device: a C tile wholly at or past its expert's size skips its
// K loop and writes zeros, as the reference's `ic * block_c < size`
// predicate does, and rows at or past the size are written as 0.
#include "common.cuh"
#include "rt/runtime.cuh"

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

// ------------------------------------------------ the bf16 bodies -----

using bf16 = __nv_bfloat16;
constexpr int NTM = 128;    // threads per CTA: 4 warps
constexpr int STAGES = 4;   // tiles in the ring: 3 in flight
constexpr int BCP = 64;     // the prefill build's capacity tile
constexpr int MI = BCP / 32;  // its m16 tiles a warp (a warp: BCP / 2 rows)
constexpr int LK = BK + 8;  // row stride of a K-contiguous tile
constexpr int LN = BN + 8;  // row stride of an N-contiguous tile

// 16 bytes from global to shared memory by cp.async; with `valid` false
// no byte is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS x COLS (a multiple of 8) of a row-major bf16 matrix with leading
// dimension ld, from (r0, c0): rows at or past `rows` and columns at or
// past `cols` are zero-filled.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t ld, int r0, int c0,
                                          int rows, int cols) {
  constexpr int PER_ROW = COLS / 8, TOTAL = ROWS * PER_ROW;
#pragma unroll
  for (int i = 0; i < (TOTAL + NTM - 1) / NTM; ++i) {
    const int idx = threadIdx.x + i * NTM;
    if (TOTAL % NTM && idx >= TOTAL) break;
    const int r = idx / PER_ROW, c = idx % PER_ROW * 8;
    const bool ok = r0 + r < rows && c0 + c < cols;
    cp16(dst + r * LD + c,
         ok ? src + static_cast<size_t>(r0 + r) * ld + c0 + c : src, ok);
  }
}

// Prefill: a BCP x 128 output tile of expert e, warps in a 2 x 2 grid of
// BCP / 2 x 64 quarters.
__global__ void __launch_bounds__(NTM)
gmm_mma_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
               const int* __restrict__ group_sizes, bf16* __restrict__ out,
               int c, int k, int n) {
  constexpr int BC = BCP;
  constexpr int A_TILE = BC * LK, B_TILE = BK * LN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // STAGES x BC x LK
  bf16* sB = sA + STAGES * A_TILE;               // STAGES x BK x LN

  const int e = blockIdx.z, c0 = blockIdx.x * BC, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;  // this warp's quarter
  const int size = group_sizes[e];
  const bf16* ab = lhs + static_cast<size_t>(e) * c * k;
  const bf16* bb = rhs + static_cast<size_t>(e) * k * n;

  float acc[MI][8][4] = {};

  if (c0 < size) {  // else no valid row: skip the K loop
    const int nk = (k + BK - 1) / BK;
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) {
      if (p < nk) {
        load_tile<BC, BK, LK>(sA + p * A_TILE, ab, k, c0, p * BK, c, k);
        load_tile<BK, BN, LN>(sB + p * B_TILE, bb, n, p * BK, n0, k, n);
      }
      cp_commit();
    }
    // ldmatrix rows: A tiles (rows of C), B tiles by .trans (rows of K)
    const int arow = wm * (BC / 2) + lane % 16, acol = lane / 16 * 8;
    const int brow = lane % 16, bcol = wn * 64 + lane / 16 * 8;
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<STAGES - 2>();
      __syncthreads();  // tile kt landed; every warp is done with kt - 1
      const int nxt = kt + STAGES - 1;
      if (nxt < nk) {
        const int st = nxt % STAGES;
        load_tile<BC, BK, LK>(sA + st * A_TILE, ab, k, c0, nxt * BK, c, k);
        load_tile<BK, BN, LN>(sB + st * B_TILE, bb, n, nxt * BK, n0, k, n);
      }
      cp_commit();
      const bf16* cA = sA + kt % STAGES * A_TILE;
      const bf16* cB = sB + kt % STAGES * B_TILE;
      float part[MI][8][4] = {};  // this step's sums, then added to acc
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        unsigned a[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          rt::load_matrix_x4(a[i], cA + (arow + 16 * i) * LK + ks * 16 + acol);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned bf[4];
          rt::load_matrix_x4_trans(bf, cB + (ks * 16 + brow) * LN + bcol +
                                           16 * j);
          const unsigned b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            rt::mma_bf16_m16n8k16(part[i][2 * j], a[i], b0);
            rt::mma_bf16_m16n8k16(part[i][2 * j + 1], a[i], b1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[i][j][x] += part[i][j][x];
    }
    cp_wait<0>();
  }

  bf16* ob = out + static_cast<size_t>(e) * c * n;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = c0 + wm * (BC / 2) + 16 * i + g + 8 * h;
      if (row >= c) continue;
      const bool live = row < size;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn * 64 + 8 * j + 2 * t;  // n is even
        if (col < n)
          *reinterpret_cast<unsigned*>(ob + static_cast<size_t>(row) * n +
                                       col) =
              repro::pack_bf16(live ? acc[i][j][2 * h] : 0.f,
                               live ? acc[i][j][2 * h + 1] : 0.f);
      }
    }
  }
}

// Decode (C <= 8): out^T = W^T x^T for 128 weight columns of expert e,
// each warp 32 of them as two m16 tiles; the tokens are the n = 8 side.
__global__ void __launch_bounds__(NTM)
gmm_mma_decode_kernel(const bf16* __restrict__ lhs,
                      const bf16* __restrict__ rhs,
                      const int* __restrict__ group_sizes,
                      bf16* __restrict__ out, int c, int k, int n) {
  constexpr int BC = 8;
  constexpr int W_TILE = BK * LN, X_TILE = BC * LK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sW = reinterpret_cast<bf16*>(smem_raw);  // STAGES x BK x LN
  bf16* sX = sW + STAGES * W_TILE;               // STAGES x BC x LK

  const int e = blockIdx.z, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int size = group_sizes[e];
  const bf16* xb = lhs + static_cast<size_t>(e) * c * k;
  const bf16* wb = rhs + static_cast<size_t>(e) * k * n;

  float acc[2][4] = {};

  if (size > 0) {  // else no valid row: skip the K loop
    const int nk = (k + BK - 1) / BK;
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) {
      if (p < nk) {
        load_tile<BK, BN, LN>(sW + p * W_TILE, wb, n, p * BK, n0, k, n);
        load_tile<BC, BK, LK>(sX + p * X_TILE, xb, k, 0, p * BK, c, k);
      }
      cp_commit();
    }
    // ldmatrix rows: W^T's A tiles by .trans (rows of K), x's B tiles
    // (token rows; x2 reads lanes 0-15)
    const int wrow = lane % 8 + lane / 16 * 8;
    const int wcol = warp * 32 + lane / 8 % 2 * 8;
    const int xrow = lane % 8, xcol = lane / 8 % 2 * 8;
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<STAGES - 2>();
      __syncthreads();  // tile kt landed; every warp is done with kt - 1
      const int nxt = kt + STAGES - 1;
      if (nxt < nk) {
        const int st = nxt % STAGES;
        load_tile<BK, BN, LN>(sW + st * W_TILE, wb, n, nxt * BK, n0, k, n);
        load_tile<BC, BK, LK>(sX + st * X_TILE, xb, k, 0, nxt * BK, c, k);
      }
      cp_commit();
      const bf16* cW = sW + kt % STAGES * W_TILE;
      const bf16* cX = sX + kt % STAGES * X_TILE;
      float part[2][4] = {};  // this step's sums, then added to acc
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        unsigned xf[2];
        rt::load_matrix_x2(xf, cX + xrow * LK + ks * 16 + xcol);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          unsigned a[4];
          rt::load_matrix_x4_trans(a, cW + (ks * 16 + wrow) * LN + wcol +
                                          16 * i);
          rt::mma_bf16_m16n8k16(part[i], a, xf);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i][x] += part[i][x];
    }
    cp_wait<0>();
  }

  // acc[i]: weight columns n0 + 32 warp + 16 i + g (+ 8), tokens 2t, 2t+1
  bf16* ob = out + static_cast<size_t>(e) * c * n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int col = n0 + warp * 32 + 16 * i + g + 8 * (x >> 1);
      const int row = 2 * t + (x & 1);
      if (row < c && col < n)
        ob[static_cast<size_t>(row) * n + col] =
            repro::from_f32<bf16>(row < size ? acc[i][x] : 0.f);
    }
  }
}

constexpr size_t mma_smem_bytes(bool decode) {
  return STAGES * sizeof(bf16) *
         (decode ? BK * LN + 8 * LK : BCP * LK + BK * LN);
}

cudaError_t launch_mma(bool decode, const void* lhs, const void* rhs,
                       const int* sizes, void* out, int e, int c, int k,
                       int n, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes(decode);
  static const cudaError_t attr_p =
      repro::allow_smem(gmm_mma_kernel, mma_smem_bytes(false));
  static const cudaError_t attr_d =
      repro::allow_smem(gmm_mma_decode_kernel, mma_smem_bytes(true));
  if (attr_p != cudaSuccess) return attr_p;
  if (attr_d != cudaSuccess) return attr_d;
  const dim3 grid(decode ? 1 : (c + BCP - 1) / BCP, (n + BN - 1) / BN, e);
  if (decode)
    gmm_mma_decode_kernel<<<grid, NTM, bytes, stream>>>(
        static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs), sizes,
        static_cast<bf16*>(out), c, k, n);
  else
    gmm_mma_kernel<<<grid, NTM, bytes, stream>>>(
        static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs), sizes,
        static_cast<bf16*>(out), c, k, n);
  return cudaGetLastError();
}

// ------------------------------------------------- the f32 launch -------

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

// f32: block_c 8, 128 threads of 2 x 4 outputs; block_c 64, 256 of 4 x 8.
cudaError_t dispatch_f32(int block_c, const void* lhs, const void* rhs,
                         const int* sizes, void* out, int e, int c, int k,
                         int n, cudaStream_t stream) {
  if (block_c == 8)
    return launch<float, 8, 2, 4>(lhs, rhs, sizes, out, e, c, k, n, stream);
  if (block_c == 64)
    return launch<float, 64, 4, 8>(lhs, rhs, sizes, out, e, c, k, n, stream);
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
    return dispatch_f32(block_c, lhs, rhs, sizes, out, e, c, k, n, s);
  }
  if (dtype == repro::DTYPE_BF16) {
    if (k % 8 || n % 8 || (block_c != 8 && block_c != BCP) ||
        (block_c == 8 && c > 8))
      return cudaErrorInvalidValue;
    return launch_mma(block_c == 8, lhs, rhs, sizes, out, e, c, k, n, s);
  }
  return cudaErrorInvalidValue;
}
