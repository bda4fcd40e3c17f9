// Selective scan of mamba layers, the diagonal SSM recurrence
//   h_t = exp(A * dt_t) * h_{t-1} + (dt_t * x_t) B_t^T
//   y_t = h_t C_t + D * x_t
// over exactly S steps from a zero state, all math in f32; returns y in
// x's type and the final state h_T in f32.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/mamba_scan.py
// (mamba_scan_fwd, body _mamba_kernel).
//
// Bound on the H100: operations, the exponentials.  Every (token,
// channel, state) takes one exp: at jamba's prefill of 2 x 511 tokens,
// d_inner 16384 and 16 states that is 268 M of them, about 64 us at 16
// per clock per SM (the multi-function unit's rate on sm_90); the bytes
// (x, dt and y in bf16, the small B/C rows, A, D and h_T) are about 104
// MB, 31 us at 3.35 TB/s.
// Design: channels and batch rows are independent and time is the only
// serial axis, so one thread owns one (batch row, channel) and keeps
// that channel's states and its row of A (pre-scaled by log2 e, so each
// decay is one ex2) in registers; the TPU's sequential chunk grid axis
// is a loop inside the CTA.  A CTA of 128 threads takes 128 channels of
// one batch row and walks time in chunks of CHUNK steps: the chunk's x
// and dt columns and its B and C rows (shared by every channel) are
// staged in shared memory as f32, and the next chunk's 16-byte loads
// are issued into registers before this chunk's steps run, so the loads
// fly during the math.  y is stored as each step ends (a warp writes 32
// neighbouring channels), h_T once at the end.  The scan never pads:
// a chunk past the end of the sequence reads no rows.
#include "common.cuh"

namespace {

constexpr int BD = 128;     // channels per CTA, one thread each
constexpr int CHUNK = 32;   // time steps staged per pass
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the multi-function unit (one instruction; denormal results
// flush to 0, far below any state's resolution).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A ROWS x COLS tile of T, loaded 16 bytes per thread-load into
// registers (all of a thread's loads in flight together), then stored
// to shared memory as f32.  Rows past `rows` and columns past `cols` (a
// multiple of the vector width) read as 0.
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

  __device__ void store(float* dst) const {
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int idx = threadIdx.x + i * NT;
      if (idx >= TOTAL) continue;
      const int r = idx / PER_ROW, c = idx % PER_ROW * VEC;
      const T* e = reinterpret_cast<const T*>(&buf[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[r * COLS + c + j] = repro::to_f32(e[j]);
    }
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(BD)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ D,
                  T* __restrict__ y, float* __restrict__ h_out, int s,
                  int d) {
  __shared__ float sx[CHUNK * BD];
  __shared__ float sdt[CHUNK * BD];
  __shared__ __align__(16) float sb[CHUNK * N];
  __shared__ __align__(16) float sc[CHUNK * N];

  const int b = blockIdx.y, c0 = blockIdx.x * BD, tid = threadIdx.x;
  const int c = c0 + tid;
  const bool live = c < d;
  const int cols = min(BD, d - c0);

  float a[N], h[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = live ? A[static_cast<size_t>(c) * N + j] * LOG2E : 0.f;
    h[j] = 0.f;
  }
  const float dskip = live ? D[c] : 0.f;

  const size_t row0 = static_cast<size_t>(b) * s;
  const T* xb = x + row0 * d + c0;
  const T* dtb = dt + row0 * d + c0;
  const T* bb = Bm + row0 * N;
  const T* cb = Cm + row0 * N;
  T* yb = y + row0 * d + c;

  Tile<T, CHUNK, BD, BD> tx, tdt;
  Tile<T, CHUNK, N, BD> tb, tc;
  int rows = min(CHUNK, s);
  tx.load(xb, d, rows, cols);
  tdt.load(dtb, d, rows, cols);
  tb.load(bb, N, rows, N);
  tc.load(cb, N, rows, N);

  for (int t0 = 0; t0 < s; t0 += CHUNK) {
    const int steps = rows;
    __syncthreads();  // the previous chunk's readers are done
    tx.store(sx);
    tdt.store(sdt);
    tb.store(sb);
    tc.store(sc);
    __syncthreads();
    const int t1 = t0 + CHUNK;
    if (t1 < s) {  // the next chunk's loads fly during these steps
      rows = min(CHUNK, s - t1);
      const size_t off = static_cast<size_t>(t1);
      tx.load(xb + off * d, d, rows, cols);
      tdt.load(dtb + off * d, d, rows, cols);
      tb.load(bb + off * N, N, rows, N);
      tc.load(cb + off * N, N, rows, N);
    }
#pragma unroll 2
    for (int t = 0; t < steps; ++t) {
      const float xt = sx[t * BD + tid];
      const float dtt = sdt[t * BD + tid];
      const float dtx = dtt * xt;
      const float4* b4 = reinterpret_cast<const float4*>(sb + t * N);
      const float4* c4 = reinterpret_cast<const float4*>(sc + t * N);
      float yv = 0.f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 bv = b4[q], cv = c4[q];
        const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cj[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * q + k;
          h[j] = fmaf(fast_exp2(a[j] * dtt), h[j], dtx * bj[k]);
          yv = fmaf(h[j], cj[k], yv);
        }
      }
      if (live)
        yb[static_cast<size_t>(t0 + t) * d] =
            repro::from_f32<T>(fmaf(dskip, xt, yv));
    }
  }

  if (live) {
    float4* ho = reinterpret_cast<float4*>(
        h_out + (static_cast<size_t>(b) * d + c) * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      ho[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D, void* y,
                   void* h_out, int b, int s, int d, cudaStream_t stream) {
  const dim3 grid((d + BD - 1) / BD, b);
  mamba_scan_kernel<T, N><<<grid, BD, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(h_out), s, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int n, const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* D,
                       void* y, void* h_out, int b, int s, int d,
                       cudaStream_t stream) {
  if (n == 8) return launch<T, 8>(x, dt, A, Bm, Cm, D, y, h_out, b, s, d, stream);
  if (n == 16) return launch<T, 16>(x, dt, A, Bm, Cm, D, y, h_out, b, s, d, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, dt (b, s, d) and Bm, Cm (b, s, n) of `dtype` (f32 or bf16); A (d, n)
// and D (d,) f32; y (b, s, d) of `dtype` and h_out (b, d, n) f32.  chunk
// is the tuning table's value: this build holds CHUNK and refuses any
// other.  d must be a whole number of 16-byte vectors of the type.
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* D,
                              void* y, void* h_out, int b, int s, int d,
                              int n, int chunk, int dtype, void* stream) {
  if (chunk != CHUNK || b < 0 || s < 0 || d < 0) return cudaErrorInvalidValue;
  if (b == 0 || d == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32) {
    if (d % 4) return cudaErrorInvalidValue;
    return dispatch_n<float>(n, x, dt, A, Bm, Cm, D, y, h_out, b, s, d, st);
  }
  if (dtype == repro::DTYPE_BF16) {
    if (d % 8) return cudaErrorInvalidValue;
    return dispatch_n<__nv_bfloat16>(n, x, dt, A, Bm, Cm, D, y, h_out, b, s,
                                     d, st);
  }
  return cudaErrorInvalidValue;
}
