// The flash-decode step shared by the dense and the paged decode
// kernels, as flash_decode_step (src/repro/kernels/decode_attention/
// decode_attention.py:37) is shared by the reference's kernels: they
// differ only in where a block of K/V rows comes from.
//
// One CTA serves one (batch row, kv head) and all G = Hq / Hkv query
// heads of its group, so each K/V row is read from memory once.  The
// CTA has D threads; thread c owns output column c of every group row.
// Per block of up to BK_MAX tokens: stage K and V in shared memory as
// f32 (stage_tile: every thread's 16-byte loads in flight together, so
// a block pays about one memory latency), score every (row, token)
// pair, run the online-softmax update (one warp per row), and
// accumulate P V in registers.  The outputs are the unnormalized
// residuals (acc, m, l) of the reference's contract.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int BK_MAX = 64;  // tokens per block
constexpr int G_MAX = 8;    // query heads per kv head

template <int D>
constexpr size_t decode_smem_floats() {
  return static_cast<size_t>(G_MAX) * D + BK_MAX * (D + 1) + BK_MAX * D +
         G_MAX * BK_MAX + 3 * G_MAX;
}

template <int D>
struct DecodeSmem {
  float* q;  // G_MAX x D, pre-scaled
  float* k;  // BK_MAX x (D + 1)
  float* v;  // BK_MAX x D
  float* s;  // G_MAX x BK_MAX: scores, then probabilities
  float* m;  // running max per row
  float* l;  // running sum per row
  float* a;  // this block's rescale factor per row
  __device__ explicit DecodeSmem(float* base) {
    q = base;
    k = q + G_MAX * D;
    v = k + BK_MAX * (D + 1);
    s = v + BK_MAX * D;
    m = s + G_MAX * BK_MAX;
    l = m + G_MAX;
    a = l + G_MAX;
  }
};

// Load the group's query rows (scaled) and reset the running state.
template <typename T, int D>
__device__ void decode_init(const DecodeSmem<D>& sm, const T* qrows, int g,
                            float scale, float acc[G_MAX]) {
  for (int i = threadIdx.x; i < g * D; i += D) sm.q[i] = to_f32(qrows[i]) * scale;
  if (threadIdx.x < G_MAX) {
    sm.m[threadIdx.x] = NEG_INF;
    sm.l[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < G_MAX; ++i) acc[i] = 0.f;
}

// One block update.  `kblk`/`vblk` point at `rows` contiguous K/V rows
// holding tokens k_start .. k_start + rows - 1; tokens at or past
// `length` are masked, as is anything outside the window.
template <typename T, int D>
__device__ void decode_block(const DecodeSmem<D>& sm, const T* __restrict__ kblk,
                             const T* __restrict__ vblk, int rows, int k_start,
                             int length, int g, int window, float softcap,
                             float acc[G_MAX]) {
  constexpr int LD = D + 1;
  constexpr int NW = D / 32;
  const int tid = threadIdx.x;
  __syncthreads();  // the previous block's readers are done
  stage_tile<T, BK_MAX, D, D>(kblk, sm.k, LD, rows);
  stage_tile<T, BK_MAX, D, D>(vblk, sm.v, D, rows);
  __syncthreads();
  for (int i = tid; i < g * BK_MAX; i += D) {
    const int gi = i / BK_MAX, t = i % BK_MAX;
    const float* qr = sm.q + gi * D;
    const float* kr = sm.k + t * LD;
    float x = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) x = fmaf(qr[c], kr[c], x);
    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
    const int kp = k_start + t;
    bool ok = t < rows && kp < length;
    if (window > 0) ok = ok && (length - 1 - kp) < window;
    sm.s[gi * BK_MAX + t] = ok ? x : NEG_INF;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int gi = warp; gi < g; gi += NW) {
    float* sr = sm.s + gi * BK_MAX;
    const float x0 = sr[lane], x1 = sr[lane + 32];
    const float m_old = sm.m[gi];
    const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
    const bool live = m_new > NEG_INF / 2;  // guards of decode_attention.py:84-91
    const float p0 = live ? expf(x0 - m_new) : 0.f;
    const float p1 = live ? expf(x1 - m_new) : 0.f;
    sr[lane] = p0;
    sr[lane + 32] = p1;
    const float sum = warp_sum(p0 + p1);
    if (lane == 0) {
      const float alpha = live ? expf(m_old - m_new) : 0.f;
      sm.a[gi] = alpha;
      sm.l[gi] = alpha * sm.l[gi] + sum;
      sm.m[gi] = m_new;
    }
  }
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G_MAX; ++gi)
    if (gi < g) acc[gi] *= sm.a[gi];
  for (int t = 0; t < rows; ++t) {
    const float vv = sm.v[t * D + tid];
#pragma unroll
    for (int gi = 0; gi < G_MAX; ++gi)
      if (gi < g) acc[gi] = fmaf(sm.s[gi * BK_MAX + t], vv, acc[gi]);
  }
}

// Write the residuals of the group's rows: acc (B, Hq, D), m/l (B, Hq).
template <int D>
__device__ void decode_store(const DecodeSmem<D>& sm, const float acc[G_MAX],
                             int g, size_t row0, float* acc_out, float* m_out,
                             float* l_out) {
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G_MAX; ++gi)
    if (gi < g) acc_out[(row0 + gi) * D + threadIdx.x] = acc[gi];
  if (threadIdx.x < g) {
    m_out[row0 + threadIdx.x] = sm.m[threadIdx.x];
    l_out[row0 + threadIdx.x] = sm.l[threadIdx.x];
  }
}

}  // namespace repro
