// Stabilised mLSTM matrix-memory recurrence of xLSTM's mLSTM layers, per
// (batch row, head), over exactly S steps from C = 0, n = 0, m = -inf:
//   m_t = max(log_sig(f_t) + m_{t-1}, i_t)
//   i'  = exp(i_t - m_t);  f' = exp(log_sig(f_t) + m_{t-1} - m_t)
//   C_t = f' C_{t-1} + i' k_t v_t^T          (Dk x Dv, f32)
//   n_t = f' n_{t-1} + i' k_t
//   h_t = (C_t^T q_t) / max(|n_t . q_t|, exp(-m_t))
// with q and k scaled by Dk^-0.5; all math in f32, h in q's type and,
// when asked, the final state (C_T, n_T, m_T) in f32.
//
// Replaces the TPU kernel src/repro/kernels/mlstm_scan/mlstm_scan.py
// (mlstm_scan_fwd, body _mlstm_kernel).  The TPU kernel returns h only;
// this one can also return the final state, which the reference's
// serving prefill takes from its plain scan (mlstm_scan_ref with
// return_state), so that the prefill on the card runs this kernel too.
//
// Bound on the H100: operations.  Each step of each head updates every
// element of C (a multiply and a fused multiply-add) and reads it once
// more for the numerator (a fused multiply-add): 5 Dk Dv f32 operations,
// outside the tensor cores.  At xlstm-1.3b's Dk = Dv = 1024, 4 heads and
// a prefill of 2 x 511 tokens that is 21.4 GFLOP, 0.32 ms at the 67
// TFLOP/s of f32 on the CUDA cores; the bytes (q, k, v and h in bf16,
// the gates, and 32 MiB of final state) take about 0.02 ms.
//
// Design: C of one head at Dk = Dv = 1024 is 4 MiB of f32, far past a
// CTA's shared memory, so the value columns are split over CTAs: a CTA
// of 8 warps owns all Dk rows of 32 columns (4 per warp), and each lane
// keeps its 4 columns of Dk / 32 rows in registers (128 floats at Dk
// 1024; rows interleaved in runs of 4 so a warp's 16-byte reads of q
// and k are conflict-free).  The numerator over Dk is then a sum inside
// the lane and a butterfly over the warp: no barrier inside a step.
// n (Dk floats) and the scalar stabiliser are kept, redundantly, by
// every warp.  The TPU's sequential chunk axis is a loop inside the
// CTA: q and k rows, the CTA's v columns and the gates of CHUNK steps
// are staged raw in shared memory by cp.async, double-buffered, so the
// next chunk's loads fly while this chunk's steps run.  The stabiliser
// depends on the gates alone: at the start of a chunk lane t of every
// warp computes step t's m, i' and f' (one exp each, the max-plus
// recurrence of m walked by shuffles), and each step reads them by
// shuffle.  The scan never pads: the last chunk runs only its own
// steps, so the returned state is the state after exactly S steps.
#include "common.cuh"

namespace {

constexpr int NT = 256;            // threads per CTA
constexpr int WARPS = NT / 32;
constexpr int COLS = 4;            // value columns per warp (per lane)
constexpr int BV = WARPS * COLS;   // value columns per CTA
constexpr int CHUNK = 8;           // time steps staged per pass
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)), as torch computes it.
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// V consecutive elements of shared memory as f32 (16 or 8 bytes at once
// for runs of 4).
template <int V>
__device__ __forceinline__ void load_run(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = p[e];
  }
}

template <int V>
__device__ __forceinline__ void load_run(const __nv_bfloat16* p,
                                         float (&o)[V]) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(b2[0]);
    const float2 c = __bfloat1622float2(b2[1]);
    o[0] = a.x; o[1] = a.y; o[2] = c.x; o[3] = c.y;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = __bfloat162float(p[e]);
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 u;
  __nv_bfloat162* b2 = reinterpret_cast<__nv_bfloat162*>(&u);
  b2[0] = __floats2bfloat162_rn(v[0], v[1]);  // round to nearest even
  b2[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// Shared memory of one pipeline stage: q and k rows (CHUNK x DK), the
// CTA's v columns (CHUNK x BV) in T, and the two gates (CHUNK) in f32.
template <typename T, int DK>
struct Stage {
  static constexpr size_t QK = static_cast<size_t>(CHUNK) * DK * sizeof(T);
  static constexpr size_t V = static_cast<size_t>(CHUNK) * BV * sizeof(T);
  static constexpr size_t G = CHUNK * sizeof(float);
  static constexpr size_t BYTES = 2 * QK + V + 2 * G;
  static_assert(QK % 16 == 0 && V % 16 == 0, "stage alignment");
};

template <typename T, int DK>
__global__ void __launch_bounds__(NT, 1)
mlstm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, T* __restrict__ h,
                  float* __restrict__ c_out, float* __restrict__ n_out,
                  float* __restrict__ m_out, int s, int dv, float scale) {
  using St = Stage<T, DK>;
  constexpr int VEC = DK >= 128 ? 4 : 1;   // rows per run
  constexpr int J = DK / (32 * VEC);        // runs per lane
  constexpr int QV = 16 / sizeof(T);        // elements per 16-byte copy
  static_assert(DK % (32 * VEC) == 0, "Dk");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * BV;
  const size_t bh = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const T* qb = q + bh * s * DK;
  const T* kb = k + bh * s * DK;
  const T* vb = v + bh * s * dv + col0;
  const float* ib = ig + bh * s;
  const float* fb = fg + bh * s;

  // start the copies of the chunk at t0 into stage `st` (one commit
  // group per thread, empty for a thread with nothing to copy)
  auto load = [&](int st, int t0) {
    unsigned char* base = smem + st * St::BYTES;
    T* sq = reinterpret_cast<T*>(base);
    T* sk = reinterpret_cast<T*>(base + St::QK);
    T* sv = reinterpret_cast<T*>(base + 2 * St::QK);
    float* si = reinterpret_cast<float*>(base + 2 * St::QK + St::V);
    float* sf = si + CHUNK;
    const int rows = min(CHUNK, s - t0);
    const int nqk = rows * DK / QV;
    const size_t off = static_cast<size_t>(t0) * DK;
    for (int i = tid; i < nqk; i += NT) {
      cp_async16(sq + i * QV, qb + off + i * QV);
      cp_async16(sk + i * QV, kb + off + i * QV);
    }
    constexpr int VPR = BV / QV;            // 16-byte copies per v row
    if (tid < rows * VPR) {
      const int r = tid / VPR, c = tid % VPR * QV;
      cp_async16(sv + r * BV + c, vb + static_cast<size_t>(t0 + r) * dv + c);
    }
    if (tid < rows) {
      cp_async4(si + tid, ib + t0 + tid);
      cp_async4(sf + tid, fb + t0 + tid);
    }
    cp_async_commit();
  };

  float cst[J][VEC][COLS], nst[J][VEC];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      nst[j][e] = 0.f;
#pragma unroll
      for (int c = 0; c < COLS; ++c) cst[j][e][c] = 0.f;
    }
  float m = __int_as_float(0xff800000);  // -inf
  T* hb = h + bh * s * dv + col0 + warp * COLS;

  const int nchunks = (s + CHUNK - 1) / CHUNK;
  if (nchunks > 0) load(0, 0);
  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = ci * CHUNK, steps = min(CHUNK, s - t0);
    if (ci + 1 < nchunks) {
      load((ci + 1) & 1, t0 + CHUNK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's stage is complete and visible
    const unsigned char* base = smem + (ci & 1) * St::BYTES;
    const T* sq = reinterpret_cast<const T*>(base);
    const T* sk = reinterpret_cast<const T*>(base + St::QK);
    const T* sv = reinterpret_cast<const T*>(base + 2 * St::QK);
    const float* si = reinterpret_cast<const float*>(base + 2 * St::QK + St::V);
    const float* sf = si + CHUNK;

    // the chunk's stabiliser: lane t holds step t's gates, walks m to
    // step t with the others, then takes its own exponentials
    float my_i = 0.f, my_f = 0.f;
    if (lane < steps) {
      my_i = si[lane];
      my_f = log_sigmoid(sf[lane]);
    }
    float my_mprev = 0.f, my_m = 0.f;
    for (int t = 0; t < steps; ++t) {
      const float ft = __shfl_sync(FULL, my_f, t);
      const float it = __shfl_sync(FULL, my_i, t);
      const float mn = fmaxf(ft + m, it);
      if (lane == t) {
        my_mprev = m;
        my_m = mn;
      }
      m = mn;
    }
    // i' carries k's scale; at m_{t-1} = -inf, f' is exp(-inf) = 0
    const float my_ip = expf(my_i - my_m) * scale;
    const float my_fp = expf(my_f + my_mprev - my_m);
    const float my_em = expf(-my_m);

#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
      const float ip = __shfl_sync(FULL, my_ip, t);
      const float fp = __shfl_sync(FULL, my_fp, t);
      const float em = __shfl_sync(FULL, my_em, t);
      float vv[COLS];
      load_run<COLS>(sv + t * BV + warp * COLS, vv);
      float num[COLS] = {0.f, 0.f, 0.f, 0.f}, dn = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r0 = (j * 32 + lane) * VEC;
        float kk[VEC], qq[VEC];
        load_run<VEC>(sk + t * DK + r0, kk);
        load_run<VEC>(sq + t * DK + r0, qq);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float a = ip * kk[e];
          nst[j][e] = fmaf(fp, nst[j][e], a);
          dn = fmaf(nst[j][e], qq[e], dn);
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            cst[j][e][c] = fmaf(fp, cst[j][e][c], a * vv[c]);
            num[c] = fmaf(cst[j][e][c], qq[e], num[c]);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          num[c] += __shfl_xor_sync(FULL, num[c], o);
        dn += __shfl_xor_sync(FULL, dn, o);
      }
      if (lane == 0) {
        // q's scale, applied to the sums
        const float inv = scale / fmaxf(fabsf(dn * scale), em);
        float out[COLS];
#pragma unroll
        for (int c = 0; c < COLS; ++c) out[c] = num[c] * inv;
        store4(hb + static_cast<size_t>(t0 + t) * dv, out);
      }
    }
    __syncthreads();  // every warp is done with the stage before reuse
  }

  if (c_out != nullptr) {
    float* cb = c_out + bh * DK * dv + col0 + warp * COLS;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store4(cb + static_cast<size_t>((j * 32 + lane) * VEC + e) * dv,
               cst[j][e]);
    if (blockIdx.x == 0 && warp == 0) {
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          n_out[bh * DK + (j * 32 + lane) * VEC + e] = nst[j][e];
      if (lane == 0) m_out[bh] = m;
    }
  }
}

template <typename T, int DK>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ig, const void* fg, void* h, void* c_out,
                   void* n_out, void* m_out, int b, int nh, int s, int dv,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = 2 * Stage<T, DK>::BYTES;
  auto kernel = mlstm_scan_kernel<T, DK>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(dv / BV, nh, b);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<T*>(h),
      static_cast<float*>(c_out), static_cast<float*>(n_out),
      static_cast<float*>(m_out), s, dv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dk(int dk, const void* q, const void* k, const void* v,
                        const void* ig, const void* fg, void* h, void* c_out,
                        void* n_out, void* m_out, int b, int nh, int s,
                        int dv, float scale, cudaStream_t stream) {
  if (dk == 32)
    return launch<T, 32>(q, k, v, ig, fg, h, c_out, n_out, m_out, b, nh, s,
                         dv, scale, stream);
  if (dk == 1024)
    return launch<T, 1024>(q, k, v, ig, fg, h, c_out, n_out, m_out, b, nh,
                           s, dv, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k (b, nh, s, dk) and v (b, nh, s, dv) of `dtype` (f32 or bf16);
// ig, fg (b, nh, s) f32; h (b, nh, s, dv) of `dtype`.  c_out (b, nh, dk,
// dv), n_out (b, nh, dk) and m_out (b, nh), all f32, receive the final
// state, or c_out is null and none is written.  dk is 32 or 1024, dv a
// multiple of 32; chunk is the tuning table's value: this build holds
// CHUNK and refuses any other.
extern "C" int mlstm_scan_fwd(const void* q, const void* k, const void* v,
                              const void* ig, const void* fg, void* h,
                              void* c_out, void* n_out, void* m_out, int b,
                              int nh, int s, int dk, int dv, int chunk,
                              float scale, int dtype, void* stream) {
  if (chunk != CHUNK || b < 0 || nh < 0 || s < 0 || dv <= 0 || dv % BV)
    return cudaErrorInvalidValue;
  if (b == 0 || nh == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return dispatch_dk<float>(dk, q, k, v, ig, fg, h, c_out, n_out, m_out, b,
                              nh, s, dv, scale, st);
  if (dtype == repro::DTYPE_BF16)
    return dispatch_dk<__nv_bfloat16>(dk, q, k, v, ig, fg, h, c_out, n_out,
                                      m_out, b, nh, s, dv, scale, st);
  return cudaErrorInvalidValue;
}
