// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * (w + weight_offset), in f32,
// cast back to the input type.  Written against the device runtime
// (rt/runtime.cuh): the portable member of the twin pair whose native
// member is native/rmsnorm_native.cu (B11a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py
// (rmsnorm_fwd, body _rms_kernel).
//
// Bound on the H100: bytes.  Each row is read, reduced and written once
// (about 2 flops per byte), far below the card's 295 flops/byte ridge.
// Design: a team of 256 threads takes ROWS consecutive rows (1 or 2),
// and every byte of them is in flight at once.  The team first stages
// its rows into the arena with 16-byte copies, all issued before any is
// waited on (rt::make_async_copy where the target has it, a plain
// 16-byte load and store on the generic target: a compile-time choice
// of the target part), so its rows cost about one memory latency: at
// gemma2's width of 2304 in bf16, two rows are 576 copies, at most 3 a
// thread.  Then, row after row, thread t sums x[t]^2, x[t + 256]^2, ...
// from the arena, in that order, and the runtime's block reduction (warp
// reductions and one hop through a carve-out of the arena, one carve-out
// a row) adds the threads' sums: the arithmetic of the streaming body
// below term for term, so every schedule gives the same bits.  The
// second pass is elementwise: each thread reads 16 bytes of the staged
// row and of w and writes 16 bytes of y.
//
// Schedule, chosen by shape: rows of whole 16-byte vectors up to
// MAX_STAGED_BYTES are staged, two a team below TWO_ROWS_BYTES (gemma2's
// rows of 2304, 4.5 KB in bf16, and deepseek's and xlstm's of 2048: one
// row a team left too few bytes in flight there; scripts/
// torch_rmsnorm_variants.py times both), one a team above (granite's
// and xlstm's 4096, 8 KB; jamba's 8192, 16 KB, the widest row the
// served paths pass); any other row, narrower than a vector's multiple
// or wider, takes the streaming body (a team a row, threads striding it
// with scalar loads, the second pass re-reading it from L1/L2: the
// design before), which keeps any d legal.
#include "common.cuh"
#include "rt/runtime.cuh"

namespace {

constexpr int NT = 256;
constexpr size_t RED_BYTES = rt::reduce_scratch(NT) * sizeof(float);
// the most a staged row may take: with the reduction's carve-out it
// stays inside the 48 KB a launch gets without raising its cap
constexpr size_t MAX_STAGED_BYTES = 48 * 1024 - 256;
// rows narrower than this are staged two a team
constexpr size_t TWO_ROWS_BYTES = 8 * 1024;

// 16 bytes from global to the arena: asynchronously where the target
// has it, a plain load and store on the generic target.
template <typename E>
__device__ __forceinline__ void copy16(E* dst, const E* src) {
  if constexpr (rt::has_async_copy)
    rt::make_async_copy(dst, src);
  else
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
}

template <typename E>
__device__ __forceinline__ void copies_landed() {
  if constexpr (rt::has_async_copy) rt::wait_async_copies<E>();
}

// ROWS > 0: ROWS rows a team through the arena (d * sizeof(T) a
// multiple of 16 bytes); ROWS == 0: the streaming body, a row a team.
template <typename T, int ROWS>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int rows, int d, float eps, float offset) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte vector
  rt::Arena arena;
  if constexpr (ROWS > 0) {
    float* red = arena.alloc_shared<float>(ROWS * rt::reduce_scratch(NT));
    const int nvec = d / VEC;
    T* xs = reinterpret_cast<T*>(arena.alloc_shared<uint4>(ROWS * nvec));
    const int row0 = rt::team_id(0) * ROWS;
    const int n = rows - row0 < ROWS ? rows - row0 : ROWS;
    const T* xr = x + static_cast<size_t>(row0) * d;
    for (int i = rt::thread_id(); i < n * nvec; i += NT)  // rows adjoin
      copy16(xs + i * VEC, xr + i * VEC);
    copies_landed<T>();
    rt::barrier();
    for (int r = 0; r < n; ++r) {
      const T* xsr = xs + r * d;
      T* yr = y + static_cast<size_t>(row0 + r) * d;
      float ss = 0.f;
      for (int i = rt::thread_id(); i < d; i += NT) {
        const float v = repro::to_f32(xsr[i]);
        ss += v * v;
      }
      const float inv =
          rsqrtf(rt::reduce_sum<NT>(ss, red + r * rt::reduce_scratch(NT)) *
                     (1.0f / d) + eps);
      for (int i = rt::thread_id(); i < nvec; i += NT) {
        const uint4 xv = reinterpret_cast<const uint4*>(xsr)[i];
        const uint4 wv = __ldg(reinterpret_cast<const uint4*>(w) + i);
        const T* xe = reinterpret_cast<const T*>(&xv);
        const T* we = reinterpret_cast<const T*>(&wv);
        uint4 yv;
        T* ye = reinterpret_cast<T*>(&yv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float v = repro::to_f32(xe[j]) * inv;
          ye[j] = repro::from_f32<T>(v * (repro::to_f32(we[j]) + offset));
        }
        reinterpret_cast<uint4*>(yr)[i] = yv;
      }
    }
  } else {
    float* red = arena.alloc_shared<float>(rt::reduce_scratch(NT));
    const T* xr = x + static_cast<size_t>(rt::team_id(0)) * d;
    T* yr = y + static_cast<size_t>(rt::team_id(0)) * d;
    float ss = 0.f;
    for (int i = rt::thread_id(); i < d; i += NT) {
      const float v = repro::to_f32(xr[i]);
      ss += v * v;
    }
    const float inv = rsqrtf(rt::reduce_sum<NT>(ss, red) * (1.0f / d) + eps);
    for (int i = rt::thread_id(); i < d; i += NT) {
      const float v = repro::to_f32(xr[i]) * inv;
      yr[i] = repro::from_f32<T>(v * (repro::to_f32(w[i]) + offset));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d,
                   float eps, float offset, cudaStream_t s) {
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (row_bytes % 16 != 0 || row_bytes > MAX_STAGED_BYTES)
    rmsnorm_kernel<T, 0><<<rows, NT, RED_BYTES, s>>>(xt, wt, yt, rows, d,
                                                     eps, offset);
  else if (row_bytes < TWO_ROWS_BYTES)
    rmsnorm_kernel<T, 2><<<(rows + 1) / 2, NT, 2 * (RED_BYTES + row_bytes),
                           s>>>(xt, wt, yt, rows, d, eps, offset);
  else
    rmsnorm_kernel<T, 1><<<rows, NT, RED_BYTES + row_bytes, s>>>(
        xt, wt, yt, rows, d, eps, offset);
  return cudaGetLastError();
}

}  // namespace

// x, w, y 16-byte aligned (the wrapper checks it).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int rows,
                           int d, float eps, float offset, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  if (dtype == repro::DTYPE_F32) return launch<float>(x, w, y, rows, d, eps,
                                                       offset, s);
  if (dtype == repro::DTYPE_BF16)
    return launch<__nv_bfloat16>(x, w, y, rows, d, eps, offset, s);
  return cudaErrorInvalidValue;
}
