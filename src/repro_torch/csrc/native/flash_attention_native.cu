// Flash attention forward written straight against CUDA, with no device
// runtime: the native member (B11b) of the twin pair whose portable
// member is flash_attention.cu.  It is the "CUDA original" of the
// paper's comparison, as src/repro/kernels/flash_attention/native.py is
// against pltpu: blockIdx, a hand-carved extern __shared__ buffer, the
// shuffle butterflies and inline mma.sync, ldmatrix and cp.async PTX are
// hard-coded where flash_attention.cu calls rt::team_id, rt::Arena,
// rt::warp_reduce_*, rt::mma_bf16_m16n8k16, rt::load_matrix_* and
// rt::make_async_copy.  Both divide by l exactly at the end
// (flash_attention.cu says why).  Like the reference's native kernel it
// takes equal q and kv lengths and no q offset, and equal key and value
// widths (64, 128, 256).  The arithmetic is the portable kernel's, in the
// same order, so the outputs are bit-identical
// (src/repro_torch/bench/parity.py holds them so and compares the two
// builds' SASS).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/native.py
// (flash_attention_native, body _fa_kernel_native).
//
// Bound on the H100: as flash_attention.cu, bytes for prompts up to
// about 740 tokens, then operations.  Design: flash_attention.cu's two
// bodies.  bf16: one 128-thread CTA of 4 warps per (batch, q head,
// 64-row q tile), the warp products on the tensor cores (m16n8k16, P as
// P_TERMS bf16 terms) over a two-stage cp.async ring of K and V tiles.
// f32: one 256-thread CTA per q tile, f32 FMA on the CUDA cores.
#include <type_traits>

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

// ------------------------------------------------ the bf16 body -------

using bf16 = __nv_bfloat16;
// P as bf16 terms, a product each: flash_attention.cu's value.
constexpr int P_TERMS = 2;
constexpr int NW = 4;         // warps per CTA, 16 q rows each
constexpr int NTM = NW * 32;  // threads per CTA

template <int D>
constexpr size_t mma_smem_bytes() {  // Q, then two K and two V tiles
  return (static_cast<size_t>(BQ) * (D + 8) + 2 * BK * (D + 8) +
          2 * BK * (D + 8)) * sizeof(bf16);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The first `rows` rows of a ROWS x D bf16 tile (row stride D) into
// shared memory at row stride D + 8 by cp.async; rows past `rows`
// become 0.
template <int ROWS, int D>
__device__ __forceinline__ void stage(const bf16* __restrict__ src,
                                      bf16* dst, int rows) {
  constexpr int PER_ROW = D / 8;  // 16-byte chunks a row
  static_assert(ROWS * PER_ROW % NTM == 0, "tile shape");
#pragma unroll
  for (int i = 0; i < ROWS * PER_ROW / NTM; ++i) {
    const int idx = threadIdx.x + i * NTM;
    const int r = idx / PER_ROW, c = idx % PER_ROW * 8;
    bf16* d = dst + r * (D + 8) + c;
    if (r < rows) {
      const unsigned sd = static_cast<unsigned>(__cvta_generic_to_shared(d));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sd),
                   "l"(src + static_cast<size_t>(r) * D + c)
                   : "memory");
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// A lane's keys and rows for the mask: key k0 + 8 j + (e & 1) (k0
// already holds the lane's 2 t) against row qp[e >> 1].
struct Bounds {
  int k0, skv, causal, window;
  int qp[2];
};

// x = scale * s, softcapped (CAP) and masked (EDGE) in place, and the
// rows' maxima taken, over a lane's S fragments.
template <bool CAP, bool EDGE, int NS>
__device__ __forceinline__ void scale_mask(float (&s)[NS][4], float (&mx)[2],
                                           float scale, float softcap,
                                           const Bounds& bd) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = bd.k0 + 8 * j + (e & 1);
      const int row = e >> 1;
      float x = s[j][e] * scale;
      if constexpr (CAP) x = softcap * tanhf(x / softcap);
      if constexpr (EDGE) {
        bool ok = kp < bd.skv;
        if (bd.causal) ok = ok && bd.qp[row] >= kp;
        if (bd.window > 0) ok = ok && bd.qp[row] - kp < bd.window;
        x = ok ? x : repro::NEG_INF;
      }
      s[j][e] = x;
      mx[row] = fmaxf(mx[row], x);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTM)
flash_native_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        int hq, int hkv, int s, float scale, int causal,
                        int window, float softcap) {
  constexpr int LD = D + 8;          // shared row stride
  constexpr int KQ = D / 16;         // k16 steps of Q K^T
  constexpr int NS = BK / 8;         // n8 tiles of S a warp
  constexpr int NO = D / 8;          // n8 tiles of O a warp
  constexpr bool Q_REGS = D <= 128;  // Q's fragments kept
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* sK = sQ + BQ * LD;                       // 2 x BK x LD
  bf16* sV = sK + 2 * BK * LD;                   // 2 x BK x LD

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and column pair
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * BQ;  // first q row
  const bf16* qb = q + static_cast<size_t>(b * hq + h) * s * D;
  const bf16* kb = k + static_cast<size_t>(b * hkv + kvh) * s * D;
  const bf16* vb = v + static_cast<size_t>(b * hkv + kvh) * s * D;

  // kv tiles that can hold an unmasked key for some row of this q tile
  int hi = (s + BK - 1) / BK;
  if (causal) hi = min(hi, (q0 + BQ - 1) / BK + 1);
  int lo = 0;
  if (window > 0) {
    const int t0 = q0 - window - (BK - 1);  // tiles with k_start <= t0 are dead
    lo = t0 >= 0 ? t0 / BK + 1 : 0;
  }

  stage<BQ, D>(qb + static_cast<size_t>(q0) * D, sQ, s - q0);
  if (lo < hi) {
    stage<BK, D>(kb + static_cast<size_t>(lo) * BK * D, sK, s - lo * BK);
    stage<BK, D>(vb + static_cast<size_t>(lo) * BK * D, sV, s - lo * BK);
  }
  copies_landed();
  __syncthreads();

  // this lane's rows of the warp's 16: r and r + 8
  const int r = warp * 16 + g;
  const int qp[2] = {q0 + r, q0 + r + 8};
  // ldmatrix row addresses: Q's A tiles, K's B tiles (keys on rows),
  // V's B tiles by .trans (keys on rows)
  const bf16* qa = sQ + (warp * 16 + lane % 16) * LD + lane / 16 * 8;
  const int krow = lane % 8 + lane / 16 * 8, kcol = lane / 8 % 2 * 8;
  const int vrow = lane % 16, vcol = lane / 16 * 8;
  unsigned qf[Q_REGS ? KQ : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) ldmatrix_x4(qf[kk], qa + kk * 16);
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {repro::NEG_INF, repro::NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = lo; it < hi; ++it) {
    const int st = (it - lo) & 1, k0 = it * BK;
    copies_landed();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < hi) {
      stage<BK, D>(kb + static_cast<size_t>(k0 + BK) * D,
                   sK + (st ^ 1) * BK * LD, s - k0 - BK);
      stage<BK, D>(vb + static_cast<size_t>(k0 + BK) * D,
                   sV + (st ^ 1) * BK * LD, s - k0 - BK);
    }
    const bf16* cK = sK + st * BK * LD;
    const bf16* cV = sV + st * BK * LD;

    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      unsigned a[4];
      if constexpr (Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qa + kk * 16);
      }
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        unsigned kf[4];
        ldmatrix_x4(kf, cK + (16 * j + krow) * LD + kk * 16 + kcol);
        const unsigned b0[2] = {kf[0], kf[1]}, b1[2] = {kf[2], kf[3]};
        mma16816(sc[2 * j], a, b0);
        mma16816(sc[2 * j + 1], a, b1);
      }
    }

    // scale, softcap and mask on the fragments; this tile's row maxima.
    // The mask is tested only where some key of the tile is out of some
    // row's bound (edge): elsewhere it would keep every score as it is.
    const int w0 = q0 + warp * 16;  // the warp's first row
    const bool edge = k0 + BK > s || (causal && k0 + BK - 1 > w0) ||
                      (window > 0 && w0 + 15 - k0 >= window);
    float mx[2] = {repro::NEG_INF, repro::NEG_INF};
    const Bounds bd{k0 + 2 * t, s, causal, window, {qp[0], qp[1]}};
    if (softcap > 0.f) {
      if (edge)
        scale_mask<true, true>(sc, mx, scale, softcap, bd);
      else
        scale_mask<true, false>(sc, mx, scale, softcap, bd);
    } else {
      if (edge)
        scale_mask<false, true>(sc, mx, scale, softcap, bd);
      else
        scale_mask<false, false>(sc, mx, scale, softcap, bd);
    }
    float alpha[2];
    bool live[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float rm = mx[i];  // over the row's quad
      for (int off = 2; off > 0; off >>= 1)
        rm = fmaxf(rm, __shfl_xor_sync(0xffffffffu, rm, off));
      const float m_new = fmaxf(m[i], rm);
      // a row with no live key so far keeps p = 0 (exp(0) would be 1)
      live[i] = m_new > repro::NEG_INF / 2;
      alpha[i] = live[i] ? expf(m[i] - m_new) : 0.f;
      m[i] = m_new;
    }
    // P as P_TERMS bf16 terms, the A fragments of the four k16 steps of
    // P V: the first rounds p, each next one what the earlier left (the
    // remainder is exact in f32); l sums p itself, in f32
    unsigned pf[P_TERMS][NS][2];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float r0 = live[i] ? expf(sc[j][2 * i] - m[i]) : 0.f;
        float r1 = live[i] ? expf(sc[j][2 * i + 1] - m[i]) : 0.f;
        sum[i] += r0;
        sum[i] += r1;
#pragma unroll
        for (int u = 0; u < P_TERMS; ++u) {
          pf[u][j][i] = repro::pack_bf16(r0, r1);
          r0 -= __uint_as_float(pf[u][j][i] << 16);
          r1 -= __uint_as_float(pf[u][j][i] & 0xffff0000u);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + sum[i];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NO / 2; ++j) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, cV + (16 * kk + vrow) * LD + 16 * j + vcol);
        const unsigned b0[2] = {vf[0], vf[1]}, b1[2] = {vf[2], vf[3]};
#pragma unroll
        for (int u = 0; u < P_TERMS; ++u) {
          const unsigned a[4] = {pf[u][2 * kk][0], pf[u][2 * kk][1],
                                 pf[u][2 * kk + 1][0], pf[u][2 * kk + 1][1]};
          mma16816(acc[2 * j], a, b0);
          mma16816(acc[2 * j + 1], a, b1);
        }
      }
    }
  }

  bf16* ob = o + static_cast<size_t>(b * hq + h) * s * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r + 8 * i;
    float li = l[i];  // over the row's quad
    for (int off = 2; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    if (row >= s) continue;
    li = li == 0.f ? 1.f : li;  // fully masked rows come out as 0
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<unsigned*>(ob + static_cast<size_t>(row) * D + 8 * j +
                                   2 * t) =
          repro::pack_bf16(acc[j][2 * i] / li, acc[j][2 * i + 1] / li);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int b, int hq, int hkv, int s, float scale, int causal,
                       int window, float softcap, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes<D>();
  if (bytes > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_native_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  flash_native_mma_kernel<D><<<grid, NTM, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), hq, hkv, s, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

// ------------------------------------------------------- dispatch -------

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

// f32 takes the CUDA-core body, bf16 the tensor-core one.
template <typename T, int D>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         void* o, int b, int hq, int hkv, int s, float scale,
                         int causal, int window, float softcap,
                         cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return launch<float, D>(q, k, v, o, b, hq, hkv, s, scale, causal, window,
                            softcap, stream);
  else
    return launch_mma<D>(q, k, v, o, b, hq, hkv, s, scale, causal, window,
                         softcap, stream);
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, int b, int hq, int hkv, int s, float scale,
                       int causal, int window, float softcap,
                       cudaStream_t stream) {
  if (d == 64)
    return launch_dtype<T, 64>(q, k, v, o, b, hq, hkv, s, scale, causal,
                               window, softcap, stream);
  if (d == 128)
    return launch_dtype<T, 128>(q, k, v, o, b, hq, hkv, s, scale, causal,
                                window, softcap, stream);
  if (d == 256)
    return launch_dtype<T, 256>(q, k, v, o, b, hq, hkv, s, scale, causal,
                                window, softcap, stream);
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
