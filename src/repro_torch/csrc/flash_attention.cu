// Flash attention forward (prefill): online-softmax blocked attention
// with GQA, causal / sliding-window / tanh-softcap masks, a static q
// offset, ragged lengths, and fully masked rows written as 0.  Written
// against the device runtime (rt/runtime.cuh): the portable member of
// the twin pair whose native member is native/flash_attention_native.cu
// (B11b).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py (flash_attention_fwd, body _fa_kernel).
// Keys may be wider than values: MLA's 192 query/key columns against
// 128 value columns are a build of their own (DK, DV) beside the
// equal-dim ones.
//
// Bound on the H100: bytes for prompts up to about 740 tokens, then
// operations (causal, 32/8 heads of 128: 0.4 S flops per byte moved,
// 205 at S = 512, against the card's bf16 ridge of 295).  This
// first kernel is far from either: it runs the math as f32 FMA on the
// CUDA cores, not on the tensor cores; mma.sync, then wgmma and TMA, are
// later PRs' work.
// Design: one 256-thread team per (batch, q head, 64-row q tile); the
// TPU's sequential kv grid axis becomes a loop inside the team, carrying
// (m, l, acc) in carve-outs of the shared arena and in registers.  Q, K
// and V tiles are staged in shared memory as f32 by stage_tile (16-byte
// loads, all in flight together; K and Q rows padded to d + 1 floats so
// the 16 threads of a half-warp hit 16 banks); each thread owns a 4 x 4
// block of the score tile and a 4 x (dv/16) block of the output.  KV
// tiles that lie wholly after the causal bound or before the window are
// skipped, as the reference's `needed` predicate does.
#include "common.cuh"
#include "rt/runtime.cuh"

namespace {

constexpr int BQ = 64;   // q rows per CTA
constexpr int BK = 64;   // kv rows per loop step
constexpr int NT = 256;  // threads per CTA: a 16 x 16 grid
constexpr int LDS = BK + 1;

template <int DK, int DV>
constexpr size_t smem_floats() {
  return static_cast<size_t>(BQ) * (DK + 1) + BK * (DK + 1) + BK * DV +
         BQ * LDS + 3 * BQ;
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq,
                 int hkv, int sq, int skv, float scale, int causal,
                 int window, float softcap, int q_offset) {
  constexpr int LD = DK + 1;
  constexpr int DC = DV / 16;  // output columns per thread
  rt::Arena arena;
  float* sQ = arena.alloc_shared<float>(BQ * LD);   // pre-scaled
  float* sK = arena.alloc_shared<float>(BK * LD);
  float* sV = arena.alloc_shared<float>(BK * DV);
  float* sS = arena.alloc_shared<float>(BQ * LDS);  // scores, then probs
  float* sM = arena.alloc_shared<float>(BQ);        // running row max
  float* sL = arena.alloc_shared<float>(BQ);        // running row sum
  float* sA = arena.alloc_shared<float>(BQ);        // this step's rescale

  const int tid = rt::thread_id();
  const int h = rt::team_id(1), b = rt::team_id(2);
  const int kvh = h / (hq / hkv);
  const int q0 = rt::team_id(0) * BQ;  // first q row (local)
  const int qpos0 = q0 + q_offset;    // its global position
  const T* qb = q + static_cast<size_t>(b * hq + h) * sq * DK;
  const T* kb = k + static_cast<size_t>(b * hkv + kvh) * skv * DK;
  const T* vb = v + static_cast<size_t>(b * hkv + kvh) * skv * DV;

  repro::stage_tile<T, BQ, DK, NT>(qb + static_cast<size_t>(q0) * DK, sQ, LD,
                                   sq - q0, scale);
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
  int hi = (skv + BK - 1) / BK;
  if (causal) hi = min(hi, (qpos0 + BQ - 1) / BK + 1);
  int lo = 0;
  if (window > 0) {
    const int t = qpos0 - window - (BK - 1);  // tiles with k_start <= t are dead
    lo = t >= 0 ? t / BK + 1 : 0;
  }

  const int warp = tid / 32, lane = tid % 32;
  for (int it = lo; it < hi; ++it) {
    const int k0 = it * BK;
    rt::barrier();  // the previous step's readers of sK/sV/sS are done
    repro::stage_tile<T, BK, DK, NT>(kb + static_cast<size_t>(k0) * DK, sK,
                                     LD, skv - k0);
    repro::stage_tile<T, BK, DV, NT>(vb + static_cast<size_t>(k0) * DV, sV,
                                     DV, skv - k0);
    rt::barrier();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < DK; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, cc = tx + 16 * j;
        const int qp = qpos0 + r, kp = k0 + cc;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kp < skv;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
        sS[r * LDS + cc] = ok ? x : repro::NEG_INF;
      }
    }
    rt::barrier();

    // online softmax: each warp owns 8 rows, each lane 2 columns
    for (int rr = 0; rr < BQ / (NT / 32); ++rr) {
      const int r = warp * (BQ / (NT / 32)) + rr;
      const float x0 = sS[r * LDS + lane], x1 = sS[r * LDS + lane + 32];
      const float m_old = sM[r];
      const float m_new =
          fmaxf(m_old, rt::warp_reduce_max(fmaxf(x0, x1)));
      // a row with no live key so far keeps p = 0 (exp(0) would be 1)
      const bool live = m_new > repro::NEG_INF / 2;
      const float p0 = live ? expf(x0 - m_new) : 0.f;
      const float p1 = live ? expf(x1 - m_new) : 0.f;
      sS[r * LDS + lane] = p0;
      sS[r * LDS + lane + 32] = p1;
      const float sum = rt::warp_reduce_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = live ? expf(m_old - m_new) : 0.f;
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
      }
    }
    rt::barrier();

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
      for (int j = 0; j < DC; ++j) vv[j] = sV[c * DV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  rt::barrier();

  T* ob = o + static_cast<size_t>(b * hq + h) * sq * DV;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    float l = sL[r];
    l = l == 0.f ? 1.f : l;  // fully masked rows come out as 0
    // An exact division where the reference's finalize takes
    // rt.approx_reciprocal: multiplying by rt::approx_reciprocal(l)
    // moved the served tokens' teacher-forced gaps on the card past
    // their 0.05-logit limit (PERF.md §6).
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[static_cast<size_t>(q0 + r) * DV + tx + 16 * j] =
          repro::from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int hq, int hkv, int sq, int skv, float scale,
                   int causal, int window, float softcap, int q_offset,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats<DK, DV>() * sizeof(float);
  static const cudaError_t attr =
      repro::allow_smem(flash_fwd_kernel<T, DK, DV>, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_fwd_kernel<T, DK, DV><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, scale,
      causal, window, softcap, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, int dv, const void* q, const void* k,
                       const void* v,
                       void* o, int b, int hq, int hkv, int sq, int skv,
                       float scale, int causal, int window, float softcap,
                       int q_offset, cudaStream_t stream) {
  if (d == 192 && dv == 128)  // MLA: 149 KB of shared memory
    return launch<T, 192, 128>(q, k, v, o, b, hq, hkv, sq, skv, scale,
                               causal, window, softcap, q_offset, stream);
  if (dv != d) return cudaErrorInvalidValue;
  if (d == 64)
    return launch<T, 64, 64>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                             window, softcap, q_offset, stream);
  if (d == 128)
    return launch<T, 128, 128>(q, k, v, o, b, hq, hkv, sq, skv, scale,
                               causal, window, softcap, q_offset, stream);
  if (d == 256)  // 214.5 KB of shared memory: under the 227 KB opt-in cap
    return launch<T, 256, 256>(q, k, v, o, b, hq, hkv, sq, skv, scale,
                               causal, window, softcap, q_offset, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// block_q / block_kv are the tuning table's values: this build holds
// one schedule, 64 x 64, and refuses any other.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int b, int hq,
                                   int hkv, int sq, int skv, int d, int dv,
                                   float scale, int causal, int window,
                                   float softcap, int q_offset, int block_q,
                                   int block_kv, int dtype, void* stream) {
  if (block_q != BQ || block_kv != BK || hkv <= 0 || hq % hkv != 0)
    return cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return dispatch_d<float>(d, dv, q, k, v, o, b, hq, hkv, sq, skv, scale,
                             causal, window, softcap, q_offset, s);
  if (dtype == repro::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(d, dv, q, k, v, o, b, hq, hkv, sq, skv,
                                     scale, causal, window, softcap,
                                     q_offset, s);
  return cudaErrorInvalidValue;
}
