// Flash attention forward written straight against CUDA, with no device
// runtime: the native member (B11b) of the twin pair whose portable
// member is flash_attention.cu.  It is the "CUDA original" of the
// paper's comparison, as src/repro/kernels/flash_attention/native.py is
// against pltpu: blockIdx, a hand-carved extern __shared__ buffer and
// the shuffle butterflies are hard-coded where flash_attention.cu calls
// rt::team_id, rt::Arena and rt::warp_reduce_*.  Both divide by l
// exactly at the end (flash_attention.cu says why).  Like the reference's
// native kernel it takes equal q and kv lengths and no q offset, and
// equal key and value widths (64, 128, 256).  The arithmetic is the
// portable kernel's, in the same order, so the outputs are
// bit-identical (src/repro_torch/bench/parity.py holds them so and
// compares the two builds' SASS).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/native.py
// (flash_attention_native, body _fa_kernel_native).
//
// Bound on the H100: as flash_attention.cu, bytes for prompts up to
// about 740 tokens, then operations; like it, this kernel runs the math
// as f32 FMA on the CUDA cores.  Design: flash_attention.cu's, one
// 256-thread CTA per (batch, q head, 64-row q tile) looping over kv
// tiles.
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // q rows per CTA
constexpr int BK = 64;   // kv rows per loop step
constexpr int NT = 256;  // threads per CTA: a 16 x 16 grid
constexpr int LDS = BK + 1;

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(BQ) * (D + 1) + BK * (D + 1) + BK * D +
         BQ * LDS + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_native_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int hq,
                    int hkv, int s, float scale, int causal, int window,
                    float softcap) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // BQ x LD, pre-scaled
  float* sK = sQ + BQ * LD;     // BK x LD
  float* sV = sK + BK * LD;     // BK x D
  float* sS = sV + BK * D;      // BQ x LDS: scores, then probabilities
  float* sM = sS + BQ * LDS;    // running row max
  float* sL = sM + BQ;          // running row sum
  float* sA = sL + BQ;          // this step's rescale factor per row

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * BQ;  // first q row
  const T* qb = q + static_cast<size_t>(b * hq + h) * s * D;
  const T* kb = k + static_cast<size_t>(b * hkv + kvh) * s * D;
  const T* vb = v + static_cast<size_t>(b * hkv + kvh) * s * D;

  repro::stage_tile<T, BQ, D, NT>(qb + static_cast<size_t>(q0) * D, sQ, LD,
                                  s - q0, scale);
  if (tid < BQ) {
    sM[tid] = repro::NEG_INF;
    sL[tid] = 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  // kv tiles that can hold an unmasked key for some row of this q tile
  int hi = (s + BK - 1) / BK;
  if (causal) hi = min(hi, (q0 + BQ - 1) / BK + 1);
  int lo = 0;
  if (window > 0) {
    const int t = q0 - window - (BK - 1);  // tiles with k_start <= t are dead
    lo = t >= 0 ? t / BK + 1 : 0;
  }

  const int warp = tid / 32, lane = tid % 32;
  for (int it = lo; it < hi; ++it) {
    const int k0 = it * BK;
    __syncthreads();  // the previous step's readers of sK/sV/sS are done
    repro::stage_tile<T, BK, D, NT>(kb + static_cast<size_t>(k0) * D, sK, LD,
                                    s - k0);
    repro::stage_tile<T, BK, D, NT>(vb + static_cast<size_t>(k0) * D, sV, D,
                                    s - k0);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, cc = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + cc;
        float x = sc[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kp < s;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
        sS[r * LDS + cc] = ok ? x : repro::NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: each warp owns 8 rows, each lane 2 columns
    for (int rr = 0; rr < BQ / (NT / 32); ++rr) {
      const int r = warp * (BQ / (NT / 32)) + rr;
      const float x0 = sS[r * LDS + lane], x1 = sS[r * LDS + lane + 32];
      const float m_old = sM[r];
      float mx = fmaxf(x0, x1);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      // a row with no live key so far keeps p = 0 (exp(0) would be 1)
      const bool live = m_new > repro::NEG_INF / 2;
      const float p0 = live ? expf(x0 - m_new) : 0.f;
      const float p1 = live ? expf(x1 - m_new) : 0.f;
      sS[r * LDS + lane] = p0;
      sS[r * LDS + lane + 32] = p1;
      float sum = p0 + p1;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = live ? expf(m_old - m_new) : 0.f;
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = sV[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* ob = o + static_cast<size_t>(b * hq + h) * s * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= s) continue;
    float l = sL[r];
    l = l == 0.f ? 1.f : l;  // fully masked rows come out as 0
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[static_cast<size_t>(q0 + r) * D + tx + 16 * j] =
          repro::from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int hq, int hkv, int s, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  if (bytes > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_native_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  flash_native_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, int b, int hq, int hkv, int s, float scale,
                       int causal, int window, float softcap,
                       cudaStream_t stream) {
  if (d == 64)
    return launch<T, 64>(q, k, v, o, b, hq, hkv, s, scale, causal, window,
                         softcap, stream);
  if (d == 128)
    return launch<T, 128>(q, k, v, o, b, hq, hkv, s, scale, causal, window,
                          softcap, stream);
  if (d == 256)
    return launch<T, 256>(q, k, v, o, b, hq, hkv, s, scale, causal, window,
                          softcap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_native_fwd(const void* q, const void* k,
                                          const void* v, void* o, int b,
                                          int hq, int hkv, int s, int d,
                                          float scale, int causal,
                                          int window, float softcap,
                                          int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  if (b == 0 || s == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return dispatch_d<float>(d, q, k, v, o, b, hq, hkv, s, scale, causal,
                             window, softcap, st);
  if (dtype == repro::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, b, hq, hkv, s, scale,
                                     causal, window, softcap, st);
  return cudaErrorInvalidValue;
}
