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
// Two bodies, chosen by the activations' type.
//
// bf16: the chunkwise form on the tensor cores (xLSTM, arXiv:2405.04517;
// its plain version is kernels/mlstm_scan/ref.py with `chunk=`).  Within
// a chunk of L steps from t0, with F the cumulative log_sig(f) from t0
// and m_in the stabiliser carried in,
//   D[t, s] = exp(F_t - F_s + i_s - m_t) (s <= t),  g_t = exp(F_t + m_in - m_t)
//   h_t = (sum_s D[t,s] (q_t.k_s) v_s + g_t C^T q_t)
//         / max(|sum_s D[t,s] (q_t.k_s) + g_t n.q_t|, exp(-m_t))
//   C  <- g_L C + sum_s exp(F_L - F_s + i_s - m_L) k_s v_s^T, n alike;
// every weight is at most 1.  m is walked step by step at the chunk's
// start, as the recurrent body walks it.  Bound on the H100: bytes (q,
// k, v and h in bf16, the gates and the 32 MiB of f32 state at
// xlstm-1.3b's 2 x 511 tokens, 4 heads of Dk = Dv = 1024: 67.1 MB, 0.020
// ms); the products Q C and K^T (w V) are 4 S Dk Dv flops a head, 17.1
// GFLOP, 0.017 ms at the bf16 tensor-core rate.
//
// Its design: grid (Dv / BV, heads, batch), one CTA walking its head's
// chunks in order.  The CTA's block of C^T (BV x Dk, f32) lives in the
// warps' registers as mma accumulator fragments, each warp holding the
// rows of its own slice of Dk (128 floats a lane at Dk 1024).  An m16n8
// accumulator tile has the layout of an A fragment, so C^T feeds C^T Q^T
// straight from the registers, as B2 feeds P V.  The four products run
// as rt::mma_bf16_m16n8k16 (mma.sync): per warp, over its slice of Dk,
// (Q C)^T, Q K^T and the update C^T += (w V)^T K; the partial sums over
// Dk meet once a chunk in the arena, summed in warp order, and (D o S) V
// takes one tile per warp.  Operands that are not exactly bf16 (C, D o
// S, w V) enter as a bf16 high part and a bf16 low part whose products
// are added, about 16 bits of each.  Dk^-0.5 multiplies f32 values only
// (w carries one factor into C and n, the scores take two); n and n . q
// stay f32 on the CUDA cores.  Warp 0 walks m while the others start on
// their products, and publishes each step's values in the arena.  Each
// warp stages its own slice of Q and K by cp.async and waits for it
// alone: the next chunk's Q is copied once the scores have read this
// one, its K once the update has, and V and the gates, which every warp
// reads, a chunk ahead in two buffers.  Rows past the last step are
// zeros in the arena and are not stored: the scan never pads, and the
// returned state is the state after exactly S steps.
//
// f32: the recurrent body, kept because a chunkwise f32 body on bf16
// halves of q, k and v (about 2^-17 of each product) moved xlstm-1.3b's
// f32 loss of a 2 x 512 batch 1.25e-3 from its plain version at 48
// layers on an H100 (PERF.md section 6), past the 1e-3 the served f32
// path is held to.
// Bound on the H100: operations, 5 Dk Dv f32 operations a step (21.4
// GFLOP at the shape above, 0.32 ms).  A CTA of 8 warps owns all Dk rows
// of 32 value columns (4 per warp), each lane keeping its 4 columns of
// Dk / 32 rows in registers (rows in runs of 4, so a warp's 16-byte
// reads of q and k are conflict-free); the numerator over Dk is a sum
// inside the lane and a butterfly over the warp.  q, k, v and the gates
// of CHUNK steps are staged raw by cp.async, double-buffered; at the
// start of a chunk lane t of every warp computes step t's m, i' and f'
// and each step reads them by shuffle.
#include "common.cuh"
#include "rt/runtime.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BV = 32;  // value columns per CTA
constexpr int L = 32;   // the chunkwise body's steps a chunk (one lane a
                        // step in the walk of m)
constexpr unsigned FULL = 0xffffffffu;

// The chunkwise body's shape at key head dim DK.
template <int DK>
struct Cfg {
  static constexpr int DKW = DK < 128 ? DK : 128;  // key rows a warp holds
  static constexpr int NW = DK / DKW;              // warps per CTA
  static constexpr int NT = 32 * NW;
  static constexpr int LQ = DK + 8;  // arena row strides (elements): Q, K,
  static constexpr int LV = BV + 8;  // V and w V,
  static constexpr int LP = L + 8;   // D o S,
  static constexpr int LS = L + 4;   // and the f32 partial sums
  static_assert(L % 16 == 0 && L <= 32 && DK % DKW == 0 && DKW % 32 == 0,
                "chunk and key head dim");
  static_assert(NT <= L * L && (L * BV) % (2 * NT) == 0, "one CTA's share");
  // the arena's bytes, in the kernel's order of carve-outs
  static constexpr size_t BYTES =
      2 * size_t(L) * LQ * sizeof(bf16) +              // Q, K
      2 * size_t(L) * LV * sizeof(bf16) +              // V, two buffers
      2 * size_t(L) * LV * sizeof(bf16) +              // w V's halves
      2 * size_t(L) * LP * sizeof(bf16) +              // D o S's halves
      size_t(NW) * L * LS * sizeof(float) +            // S partials
      size_t(NW) * BV * LS * sizeof(float) +           // (Q C)^T partials
      size_t(NW) * L * sizeof(float) +                 // n . q partials
      size_t(L) * sizeof(float) +                      // denominators
      size_t(DK) * sizeof(float) +                     // n
      4 * size_t(L) * sizeof(float) +                  // gates, two buffers
      8 * size_t(L) * sizeof(float);                   // the walk's results
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)), as torch computes it.
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// x as a bf16 high part and the bf16 rounding of what it leaves (the
// remainder is exact in f32), two values a word: a fragment's pair.
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  hi = repro::pack_bf16(x0, x1);
  lo = repro::pack_bf16(x0 - __uint_as_float(hi << 16),
                        x1 - __uint_as_float(hi & 0xffff0000u));
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// d += a b with A as its two halves (a[0] high, a[1] low).
__device__ __forceinline__ void mma_halves(float (&d)[4],
                                           const unsigned (&a)[2][4],
                                           const unsigned (&b)[2]) {
  rt::mma_bf16_m16n8k16(d, a[0], b);
  rt::mma_bf16_m16n8k16(d, a[1], b);
}

template <int DK>
__global__ void __launch_bounds__(Cfg<DK>::NT, 1)
mlstm_chunk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg, bf16* __restrict__ h,
                   float* __restrict__ c_out, float* __restrict__ n_out,
                   float* __restrict__ m_out, int s, int dv, float scale) {
  using C = Cfg<DK>;
  constexpr int DKW = C::DKW, NW = C::NW, NT = C::NT;
  constexpr int LQ = C::LQ, LV = C::LV, LP = C::LP, LS = C::LS;
  constexpr int ND = DKW / 8;    // n8 tiles of a warp's C^T row block
  constexpr int KD = DKW / 16;   // k16 steps over a warp's slice of Dk
  constexpr int KL = L / 16;     // k16 steps (and m16 tiles) over a chunk
  rt::Arena arena;
  bf16* sQ = arena.alloc_shared<bf16>(L * LQ);      // [t][d]
  bf16* sK = arena.alloc_shared<bf16>(L * LQ);      // [s][d]
  bf16* sV = arena.alloc_shared<bf16>(2 * L * LV);  // [buffer][s][c]
  bf16* sW = arena.alloc_shared<bf16>(2 * L * LV);   // [half][s][c]
  bf16* sP = arena.alloc_shared<bf16>(2 * L * LP);   // [half][t][s]
  float* pS = arena.alloc_shared<float>(NW * L * LS);    // [w][t][s]
  float* pQC = arena.alloc_shared<float>(NW * BV * LS);  // [w][c][t]
  float* pNQ = arena.alloc_shared<float>(NW * L);        // [w][t]
  float* sDen = arena.alloc_shared<float>(L);
  float* sN = arena.alloc_shared<float>(DK);
  float* sG = arena.alloc_shared<float>(4 * L);  // [buffer][i, f][t]
  // the walk's results: m_t, F_t, i_t, g_t scale, exp(-m_t), w_t; g_L
  float* sT = arena.alloc_shared<float>(8 * L);

  const int tid = rt::thread_id(), lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;  // fragment row, column pair
  const int col0 = rt::team_id(0) * BV, d0 = warp * DKW;
  const size_t bh = static_cast<size_t>(rt::team_id(2)) * rt::num_teams(1) +
                    rt::team_id(1);
  const bf16* qb = q + bh * s * DK;
  const bf16* kb = k + bh * s * DK;
  const bf16* vb = v + bh * s * dv + col0;
  const float* ib = ig + bh * s;
  const float* fb = fg + bh * s;
  bf16* hb = h + bh * s * dv + col0;
  const float scale2 = scale * scale;

  // this warp's slice of Q or K for the chunk at t0 into the arena by
  // cp.async, left in flight; rows past the last step become zeros
  auto load_slice = [&](bf16* dst, const bf16* src, int t0) {
    const int rows = min(L, s - t0);
    constexpr int PER_ROW = DKW / 8;  // 16-byte copies a row
    for (int i = lane; i < L * PER_ROW; i += 32) {
      const int r = i / PER_ROW, c = d0 + i % PER_ROW * 8;
      bf16* d = dst + r * LQ + c;
      if (r < rows)
        rt::make_async_copy(d, src + static_cast<size_t>(t0 + r) * DK + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // V (the CTA's columns) and the gates of the chunk at t0 into buffer
  // `st` (cp.async, every thread of the CTA); V's rows past the last
  // step become zeros
  auto load_vg = [&](int st, int t0) {
    const int rows = min(L, s - t0);
    constexpr int PER_ROW = BV / 8;  // 16-byte copies a row
    bf16* dst = sV + st * L * LV;
    for (int i = tid; i < L * PER_ROW; i += NT) {
      const int r = i / PER_ROW, c = i % PER_ROW * 8;
      if (r < rows)
        rt::make_async_copy(dst + r * LV + c,
                            vb + static_cast<size_t>(t0 + r) * dv + c);
      else
        *reinterpret_cast<uint4*>(dst + r * LV + c) = make_uint4(0, 0, 0, 0);
    }
    if (tid < rows) {
      cp_async4(sG + st * 2 * L + tid, ib + t0 + tid);
      cp_async4(sG + st * 2 * L + L + tid, fb + t0 + tid);
    }
  };

  // C^T: rows c (2 m16 tiles), columns this warp's Dk slice (ND n8 tiles)
  float cf[2][ND][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cf[mi][j][e] = 0.f;
  for (int d = lane; d < DKW; d += 32) sN[d0 + d] = 0.f;
  float m = __int_as_float(0xff800000);  // -inf

  // ldmatrix row addresses (lane parts): A tiles of row-major operands;
  // B tiles of operands with n on rows (non-trans); B tiles of operands
  // with k on rows (.trans); A tiles of (w V)^T from rows s (.trans)
  const int a_row = lane % 16, a_col = lane / 16 * 8;
  const int b_row = lane % 8 + lane / 16 * 8, b_col = lane / 8 % 2 * 8;
  const int t_row = lane % 16, t_col = lane / 16 * 8;
  const int w_row = lane / 16 * 8 + lane % 8, w_col = lane / 8 % 2 * 8;

  const int nchunks = (s + L - 1) / L;
  if (nchunks > 0) {
    load_vg(0, 0);
    cp_async_commit();
    load_slice(sQ, qb, 0);
    cp_async_commit();
    load_slice(sK, kb, 0);
    cp_async_commit();
  }
  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = ci * L, steps = min(L, s - t0), buf = ci & 1;
    cp_async_wait<1>();  // V, the gates and Q of this chunk (K may fly)
    rt::barrier();
    if (ci + 1 < nchunks) load_vg(buf ^ 1, t0 + L);
    cp_async_commit();
    const float* si = sG + buf * 2 * L;
    const float* sf = si + L;
    const bf16* cV = sV + buf * L * LV;

    // the chunk's stabiliser, walked by warp 0 while the others start on
    // their products: lane t holds step t's gates, walks m to step t with
    // the others, then takes its own exponentials; F is the cumulative
    // log_sig(f) from the chunk's first step.  The results go to the
    // arena for every warp (read after the next barrier).
    if (warp == 0) {
      // past the last step f = 0 and i = -inf leave m and F as they are
      float my_i = __int_as_float(0xff800000), my_f = 0.f;
      if (lane < steps) {
        my_i = si[lane];
        my_f = log_sigmoid(sf[lane]);
      }
      const float m_in = m;
      float my_m = 0.f, my_F = 0.f, F = 0.f;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const float ft = __shfl_sync(FULL, my_f, t);
        const float it = __shfl_sync(FULL, my_i, t);
        const float mn = fmaxf(ft + m, it);
        F += ft;
        if (lane == t) {
          my_m = mn;
          my_F = F;
        }
        m = mn;
      }
      // g_t (0 at m_in = -inf) with q's scale, exp(-m_t), and w_t, which
      // carries k's scale; zeros past the last step
      if (lane < L) {
        const bool live = lane < steps;
        sT[lane] = my_m;
        sT[L + lane] = my_F;
        sT[2 * L + lane] = live ? my_i : 0.f;
        sT[3 * L + lane] = live ? expf(my_F + m_in - my_m) * scale : 0.f;
        sT[4 * L + lane] = live ? expf(-my_m) : 1.f;
        sT[5 * L + lane] = live ? expf(F - my_F + my_i - m) * scale : 0.f;
      }
      if (lane == 0) sT[6 * L] = expf(F + m_in - m);  // g_L
    }

    // (Q C)^T over this warp's slice: C^T's accumulators as A fragments
    {
      float acc[2][L / 8][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < L / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned a[2][2][4];  // [mi][half]
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float(&c0)[4] = cf[mi][2 * kk];
          const float(&c1)[4] = cf[mi][2 * kk + 1];
          split2(c0[0], c0[1], a[mi][0][0], a[mi][1][0]);
          split2(c0[2], c0[3], a[mi][0][1], a[mi][1][1]);
          split2(c1[0], c1[1], a[mi][0][2], a[mi][1][2]);
          split2(c1[2], c1[3], a[mi][0][3], a[mi][1][3]);
        }
#pragma unroll
        for (int j = 0; j < L / 16; ++j) {
          unsigned b[4];  // n tiles 2j and 2j + 1
          rt::load_matrix_x4(b, sQ + (16 * j + b_row) * LQ + d0 + 16 * kk +
                                    b_col);
          const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_halves(acc[mi][2 * j], a[mi], b0);
            mma_halves(acc[mi][2 * j + 1], a[mi], b1);
          }
        }
      }
      float* part = pQC + warp * BV * LS;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < L / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(part + (16 * mi + g + 8 * r) * LS +
                                       8 * j + 2 * qd) =
                make_float2(acc[mi][j][2 * r], acc[mi][j][2 * r + 1]);
    }
    // n . q_t over this warp's slice, f32, lane t, in two interleaved sums
    if (lane < L) {
      float nq[2] = {0.f, 0.f};
      const bf16* qr = sQ + lane * LQ + d0;
#pragma unroll
      for (int d = 0; d < DKW; d += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(qr + d);
        const float4 na = *reinterpret_cast<const float4*>(sN + d0 + d);
        const float4 nb = *reinterpret_cast<const float4*>(sN + d0 + d + 4);
        const unsigned xs[4] = {x.x, x.y, x.z, x.w};
        const float ns[8] = {na.x, na.y, na.z, na.w, nb.x, nb.y, nb.z, nb.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          nq[0] = fmaf(ns[2 * e], bf16_lo(xs[e]), nq[0]);
          nq[1] = fmaf(ns[2 * e + 1], bf16_hi(xs[e]), nq[1]);
        }
      }
      pNQ[warp * L + lane] = nq[0] + nq[1];
    }

    cp_async_wait<1>();  // this warp's K (the next V and gates may fly)
    __syncwarp();
    // the scores Q K^T over this warp's slice; tiles wholly above the
    // diagonal are skipped
    {
      float acc[KL][L / 8][4];
#pragma unroll
      for (int mi = 0; mi < KL; ++mi)
#pragma unroll
        for (int j = 0; j < L / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned a[KL][4];
#pragma unroll
        for (int mi = 0; mi < KL; ++mi)
          rt::load_matrix_x4(a[mi], sQ + (16 * mi + a_row) * LQ + d0 +
                                        16 * kk + a_col);
#pragma unroll
        for (int j = 0; j < L / 16; ++j) {
          unsigned b[4];
          rt::load_matrix_x4(b, sK + (16 * j + b_row) * LQ + d0 + 16 * kk +
                                    b_col);
          const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
          for (int mi = 0; mi < KL; ++mi) {
            if (j <= mi) {
              rt::mma_bf16_m16n8k16(acc[mi][2 * j], a[mi], b0);
              rt::mma_bf16_m16n8k16(acc[mi][2 * j + 1], a[mi], b1);
            }
          }
        }
      }
      float* part = pS + warp * L * LS;
#pragma unroll
      for (int mi = 0; mi < KL; ++mi)
#pragma unroll
        for (int j = 0; j < L / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(part + (16 * mi + g + 8 * r) * LS +
                                       8 * j + 2 * qd) =
                make_float2(acc[mi][j][2 * r], acc[mi][j][2 * r + 1]);
    }
    __syncwarp();  // every lane is done with this warp's Q
    if (ci + 1 < nchunks) load_slice(sQ, qb, t0 + L);
    cp_async_commit();
    rt::barrier();  // every warp's partials are in the arena

    // D o S (scaled twice) into its halves, row sums into the
    // denominators; the partials summed in warp order
    {
      constexpr int TPR = NT / L, CPT = L / TPR;  // threads a row, columns each
      constexpr int VW = CPT % 4 == 0 ? 4 : 1;    // columns a partial load
      const int t = tid / TPR, s0 = tid % TPR * CPT;
      const float Ft = sT[L + t], mt = sT[t];
      float rs = 0.f;
#pragma unroll
      for (int e = 0; e < CPT; e += VW) {
        float sum[VW];
#pragma unroll
        for (int o = 0; o < VW; ++o) sum[o] = 0.f;
        if (t < steps && s0 + e <= t) {
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const float* p = pS + (w * L + t) * LS + s0 + e;
            if constexpr (VW == 4) {
              const float4 x = *reinterpret_cast<const float4*>(p);
              sum[0] += x.x;
              sum[1] += x.y;
              sum[2] += x.z;
              sum[3] += x.w;
            } else {
              sum[0] += p[0];
            }
          }
        }
#pragma unroll
        for (int o = 0; o < VW; ++o) {
          const int sc = s0 + e + o;
          const float x = sc <= t && t < steps
                              ? expf(Ft - sT[L + sc] + sT[2 * L + sc] - mt) *
                                    sum[o] * scale2
                              : 0.f;
          rs += x;
          const bf16 hi = __float2bfloat16_rn(x);
          sP[t * LP + sc] = hi;
          sP[L * LP + t * LP + sc] =
              __float2bfloat16_rn(x - __bfloat162float(hi));
        }
      }
      rs = rt::warp_reduce_sum(rs, TPR);
      if (tid % TPR == 0) {
        float nq = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) nq += pNQ[w * L + t];
        sDen[t] = fmaxf(fabsf(rs + sT[3 * L + t] * nq), sT[4 * L + t]);
      }
    }
    // (Q C)^T summed over the warps (into warp 0's partial), four steps
    // a thread, and w V into its halves
    for (int e = 4 * tid; e < BV * L; e += 4 * NT) {
      const int c = e / L, t = e % L;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float4 x =
            *reinterpret_cast<const float4*>(pQC + (w * BV + c) * LS + t);
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
      *reinterpret_cast<float4*>(pQC + c * LS + t) = sum;
    }
#pragma unroll
    for (int i = 0; i < L * BV / (2 * NT); ++i) {
      const int e = 2 * (tid + i * NT), r = e / BV, c = e % BV;
      const float w = sT[5 * L + r];
      const float v0 = __bfloat162float(cV[r * LV + c]);
      const float v1 = __bfloat162float(cV[r * LV + c + 1]);
      unsigned hi, lo;
      split2(w * v0, w * v1, hi, lo);
      *reinterpret_cast<unsigned*>(sW + r * LV + c) = hi;
      *reinterpret_cast<unsigned*>(sW + L * LV + r * LV + c) = lo;
    }
    rt::barrier();

    // C^T <- g_L C^T + (w V)^T K over this warp's slice
    const float g_last = sT[6 * L];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cf[mi][j][e] *= g_last;
#pragma unroll
    for (int kk = 0; kk < KL; ++kk) {
      unsigned a[2][2][4];  // [mi][half]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          rt::load_matrix_x4_trans(a[mi][u], sW + u * L * LV +
                                                 (16 * kk + w_row) * LV +
                                                 16 * mi + w_col);
#pragma unroll
      for (int j = 0; j < KD; ++j) {
        unsigned b[4];
        rt::load_matrix_x4_trans(b, sK + (16 * kk + t_row) * LQ + d0 +
                                        16 * j + t_col);
        const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_halves(cf[mi][2 * j], a[mi], b0);
          mma_halves(cf[mi][2 * j + 1], a[mi], b1);
        }
      }
    }
    // n <- g_L n + sum_t w_t k_t over this warp's slice, f32, in step
    // order (rows past the last step hold w = 0 and k = 0); a lane holds
    // column pairs
    {
      constexpr int PAIRS = DKW / 2, NP = (PAIRS + 31) / 32;
      constexpr bool PARTIAL = PAIRS % 32 != 0;  // idle lanes (Dk 32)
      float n0[NP], n1[NP];
#pragma unroll
      for (int r = 0; r < NP; ++r) {
        const int d = d0 + 2 * (lane + 32 * r);
        n0[r] = n1[r] = 0.f;
        if (!PARTIAL || lane + 32 * r < PAIRS) {
          n0[r] = sN[d] * g_last;
          n1[r] = sN[d + 1] * g_last;
        }
      }
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const float w = sT[5 * L + t];
#pragma unroll
        for (int r = 0; r < NP; ++r) {
          if (PARTIAL && lane + 32 * r >= PAIRS) continue;
          const int d = d0 + 2 * (lane + 32 * r);
          const unsigned x = *reinterpret_cast<const unsigned*>(sK + t * LQ + d);
          n0[r] = fmaf(w, bf16_lo(x), n0[r]);
          n1[r] = fmaf(w, bf16_hi(x), n1[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < NP; ++r) {
        if (PARTIAL && lane + 32 * r >= PAIRS) continue;
        const int d = d0 + 2 * (lane + 32 * r);
        sN[d] = n0[r];
        sN[d + 1] = n1[r];
      }
    }
    __syncwarp();  // every lane is done with this warp's K
    if (ci + 1 < nchunks) load_slice(sK, kb, t0 + L);
    cp_async_commit();

    // h: (D o S) V, one m16 x n8 tile a warp, plus g_t (Q C)^T, over the
    // denominators
    for (int tile = warp; tile < KL * (BV / 8); tile += NW) {
      const int mi = tile / (BV / 8), nj = tile % (BV / 8);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KL; ++kk) {
        unsigned a[2][4], b[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          rt::load_matrix_x4(a[u], sP + u * L * LP + (16 * mi + a_row) * LP +
                                       16 * kk + a_col);
        rt::load_matrix_x2_trans(b, cV + (16 * kk + t_row) * LV + 8 * nj);
        mma_halves(acc, a, b);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = 16 * mi + g + 8 * r, c = 8 * nj + 2 * qd;
        if (t >= steps) continue;
        const float gs = sT[3 * L + t];
        const float den = sDen[t];
        const float o0 = (acc[2 * r] + gs * pQC[c * LS + t]) / den;
        const float o1 = (acc[2 * r + 1] + gs * pQC[(c + 1) * LS + t]) / den;
        *reinterpret_cast<unsigned*>(hb + static_cast<size_t>(t0 + t) * dv +
                                     c) = repro::pack_bf16(o0, o1);
      }
    }
  }
  cp_async_wait<0>();

  if (c_out != nullptr) {
    float* cb = c_out + bh * DK * dv + col0;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 16 * mi + g + 8 * (e >> 1);
          const int d = d0 + 8 * j + 2 * qd + (e & 1);
          cb[static_cast<size_t>(d) * dv + c] = cf[mi][j][e];
        }
    if (rt::team_id(0) == 0) {
      __syncwarp();
      for (int d = lane; d < DKW; d += 32) n_out[bh * DK + d0 + d] = sN[d0 + d];
      if (tid == 0) m_out[bh] = m;
    }
  }
}

// ------------------------------------------ f32: the recurrent body ----

namespace recurrent {

constexpr int NT = 256;            // threads per CTA
constexpr int WARPS = NT / 32;
constexpr int COLS = 4;            // value columns per warp (per lane)
static_assert(WARPS * COLS == BV, "a CTA's value columns");
constexpr int CHUNK = 8;           // time steps staged per pass

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// V consecutive floats of shared memory (16 bytes at once for runs of 4).
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

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Shared memory of one pipeline stage of the recurrent body: q and k
// rows (CHUNK x DK), the CTA's v columns (CHUNK x BV) and the two gates
// (CHUNK), all f32.
template <int DK>
struct Stage {
  static constexpr size_t QK = size_t(CHUNK) * DK * sizeof(float);
  static constexpr size_t V = size_t(CHUNK) * BV * sizeof(float);
  static constexpr size_t G = CHUNK * sizeof(float);
  static constexpr size_t BYTES = 2 * QK + V + 2 * G;
  static_assert(QK % 16 == 0 && V % 16 == 0, "stage alignment");
};

template <int DK>
__global__ void __launch_bounds__(NT, 1)
mlstm_recurrent_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ ig,
                       const float* __restrict__ fg, float* __restrict__ h,
                       float* __restrict__ c_out, float* __restrict__ n_out,
                       float* __restrict__ m_out, int s, int dv,
                       float scale) {
  using St = Stage<DK>;
  constexpr int VEC = DK >= 128 ? 4 : 1;   // rows per run
  constexpr int J = DK / (32 * VEC);        // runs per lane
  constexpr int QV = 4;                     // floats per 16-byte copy
  static_assert(DK % (32 * VEC) == 0, "Dk");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * BV;
  const size_t bh = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const float* qb = q + bh * s * DK;
  const float* kb = k + bh * s * DK;
  const float* vb = v + bh * s * dv + col0;
  const float* ib = ig + bh * s;
  const float* fb = fg + bh * s;

  // start the copies of the chunk at t0 into stage `st` (one commit
  // group per thread, empty for a thread with nothing to copy)
  auto load = [&](int st, int t0) {
    unsigned char* base = smem + st * St::BYTES;
    float* sq = reinterpret_cast<float*>(base);
    float* sk = reinterpret_cast<float*>(base + St::QK);
    float* sv = reinterpret_cast<float*>(base + 2 * St::QK);
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
  float* hb = h + bh * s * dv + col0 + warp * COLS;

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
    const float* sq = reinterpret_cast<const float*>(base);
    const float* sk = reinterpret_cast<const float*>(base + St::QK);
    const float* sv = reinterpret_cast<const float*>(base + 2 * St::QK);
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

}  // namespace recurrent

template <int DK>
cudaError_t launch_chunk(const void* q, const void* k, const void* v,
                         const void* ig, const void* fg, void* h, void* c_out,
                         void* n_out, void* m_out, int b, int nh, int s,
                         int dv, float scale, cudaStream_t stream) {
  using C = Cfg<DK>;
  static const cudaError_t attr =
      repro::allow_smem(mlstm_chunk_kernel<DK>, C::BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(dv / BV, nh, b);
  mlstm_chunk_kernel<DK><<<grid, C::NT, C::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<bf16*>(h),
      static_cast<float*>(c_out), static_cast<float*>(n_out),
      static_cast<float*>(m_out), s, dv, scale);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_recurrent(const void* q, const void* k, const void* v,
                             const void* ig, const void* fg, void* h,
                             void* c_out, void* n_out, void* m_out, int b,
                             int nh, int s, int dv, float scale,
                             cudaStream_t stream) {
  constexpr size_t smem = 2 * recurrent::Stage<DK>::BYTES;
  auto kernel = recurrent::mlstm_recurrent_kernel<DK>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(dv / BV, nh, b);
  kernel<<<grid, recurrent::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<float*>(h),
      static_cast<float*>(c_out), static_cast<float*>(n_out),
      static_cast<float*>(m_out), s, dv, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k (b, nh, s, dk) and v (b, nh, s, dv) of `dtype` (f32 or bf16);
// ig, fg (b, nh, s) f32; h (b, nh, s, dv) of `dtype`.  c_out (b, nh, dk,
// dv), n_out (b, nh, dk) and m_out (b, nh), all f32, receive the final
// state, or c_out is null and none is written.  dk is 32 or 1024, dv a
// multiple of 32; chunk is the tuning table's, the chunkwise body's L:
// this build holds it and refuses any other.
extern "C" int mlstm_scan_fwd(const void* q, const void* k, const void* v,
                              const void* ig, const void* fg, void* h,
                              void* c_out, void* n_out, void* m_out, int b,
                              int nh, int s, int dk, int dv, int chunk,
                              float scale, int dtype, void* stream) {
  const bool f32 = dtype == repro::DTYPE_F32;
  if (b < 0 || nh < 0 || s < 0 || dv <= 0 || dv % BV ||
      (!f32 && dtype != repro::DTYPE_BF16) ||
      chunk != L ||
      (dk != 32 && dk != 1024))
    return cudaErrorInvalidValue;
  if (b == 0 || nh == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return dk == 32 ? launch_recurrent<32>(q, k, v, ig, fg, h, c_out, n_out,
                                           m_out, b, nh, s, dv, scale, st)
                    : launch_recurrent<1024>(q, k, v, ig, fg, h, c_out, n_out,
                                             m_out, b, nh, s, dv, scale, st);
  return dk == 32 ? launch_chunk<32>(q, k, v, ig, fg, h, c_out, n_out, m_out,
                                     b, nh, s, dv, scale, st)
                  : launch_chunk<1024>(q, k, v, ig, fg, h, c_out, n_out, m_out,
                                       b, nh, s, dv, scale, st);
}
