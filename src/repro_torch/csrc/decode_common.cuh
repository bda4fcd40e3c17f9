// The flash-decode step shared by the decode kernels, as
// flash_decode_step (src/repro/kernels/decode_attention/
// decode_attention.py:37) is shared by the reference's kernels: they
// differ only in where a block of K/V rows comes from, what element
// type it is stored in, and how far each query row may see.
//
// One CTA serves one (batch row, kv head) and the G query rows stacked
// on that kv head, so each K/V row is read from memory once.  For the
// one-token kernels (B3, B4, B5) the rows are the group's Hq / Hkv
// query heads; for the speculative kernel (B6) they are the K1 window
// positions times the group, position-major (row r = qi * group + gi,
// `Rows` below).  Keys may be wider than values (MLA: DK = 192 query/
// key columns, DV = 128 value columns); the CTA has DV threads, and
// thread c owns output column c of every row, while the scores, a dot
// over DK columns per (row, token) pair, are shared out over all the
// threads.  Per block of up to BK_MAX tokens: stage K and V in
// shared memory as f32 (stage_tile: every thread's 16-byte loads in
// flight together, so a block pays about one memory latency; a
// quantized block is dequantized there, before any dot), score every
// (row, token) pair against the row's own causal horizon, run the
// online-softmax update (one warp per row), and accumulate P V in
// registers.  The outputs are the unnormalized residuals (acc, m, l) of
// the reference's contract.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int BK_MAX = 64;     // tokens per block
constexpr int G_DECODE = 8;    // rows of the one-token kernels: the group
constexpr int G_SPEC = 32;     // rows of the speculative kernel: K1 * group

// The speculative kernel's rows each see their own causal horizon, read
// from shared memory; the one-token kernels' rows all see the CTA's one
// length, kept in a register.
template <int G>
__host__ __device__ constexpr bool per_row_horizon() {
  return G == G_SPEC;
}

template <int DK, int DV, int G>
constexpr size_t decode_smem_floats() {
  return static_cast<size_t>(G) * DK + BK_MAX * (DK + 1) + BK_MAX * DV +
         G * BK_MAX + 4 * G;
}

template <int DK, int DV, int G>
struct DecodeSmem {
  float* q;   // G x DK, pre-scaled
  float* k;   // BK_MAX x (DK + 1)
  float* v;   // BK_MAX x DV
  float* s;   // G x BK_MAX: scores, then probabilities
  float* m;   // running max per row
  float* l;   // running sum per row
  float* a;   // this block's rescale factor per row
  int* hz;    // per-row horizons (per_row_horizon): tokens [0, hz) visible
  __device__ explicit DecodeSmem(float* base) {
    q = base;
    k = q + G * DK;
    v = k + BK_MAX * (DK + 1);
    s = v + BK_MAX * DV;
    m = s + G * BK_MAX;
    l = m + G;
    a = l + G;
    hz = reinterpret_cast<int*>(a + G);
  }
};

// Where the CTA's row r lives in the (B, K1, Hq) row space of q and of
// the outputs: query position r / group, head h * group + r % group.
// The one-token kernels' rows are consecutive heads (K1 = 1), so their
// index is row0 + r, with no division.
template <int G>
struct Rows {
  size_t row0;  // (b * K1) * Hq + h * group
  int group;    // query heads per kv head
  int hq;       // rows per query position
  int n;        // live rows: K1 * group (<= G)
  __device__ size_t operator()(int r) const {
    if (!per_row_horizon<G>()) return row0 + r;
    return row0 + static_cast<size_t>(r / group) * hq + r % group;
  }
};

// Load the CTA's query rows (scaled) and reset the running state.
template <typename T, int DK, int DV, int G>
__device__ void decode_init(const DecodeSmem<DK, DV, G>& sm, const T* q,
                            const Rows<G>& rows, float scale, float acc[G]) {
  for (int r = 0; r < rows.n; ++r) {
    if constexpr (DK == DV) {
      sm.q[r * DK + threadIdx.x] =
          to_f32(q[rows(r) * DK + threadIdx.x]) * scale;
    } else {  // a thread per value column: the key's wider row in turns
      for (int c = threadIdx.x; c < DK; c += DV)
        sm.q[r * DK + c] = to_f32(q[rows(r) * DK + c]) * scale;
    }
  }
  if (threadIdx.x < G) {
    sm.m[threadIdx.x] = NEG_INF;
    sm.l[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < G; ++i) acc[i] = 0.f;
}

// One block update.  `kblk`/`vblk` point at `rows` contiguous K/V rows
// holding tokens k_start .. k_start + rows - 1, stored as KV; a 1-byte
// KV is quantized storage, dequantized with `k_scale`/`v_scale`.  Row r
// masks tokens at or past its horizon (sm.hz[r], or `length` for every
// row of a one-token kernel), and outside the window measured back from
// that horizon (decode_attention.py:80-83).
template <typename KV, int DK, int DV, int G>
__device__ void decode_block(const DecodeSmem<DK, DV, G>& sm,
                             const KV* __restrict__ kblk,
                             const KV* __restrict__ vblk, int rows,
                             int k_start, int n, int length, int window,
                             float softcap, float k_scale, float v_scale,
                             float acc[G]) {
  constexpr int LD = DK + 1;
  constexpr int NW = DV / 32;
  constexpr bool kQuant = sizeof(KV) == 1;
  const int tid = threadIdx.x;
  __syncthreads();  // the previous block's readers are done
  stage_tile<KV, BK_MAX, DK, DV>(kblk, sm.k, LD, rows, kQuant ? k_scale : 1.f);
  stage_tile<KV, BK_MAX, DV, DV>(vblk, sm.v, DV, rows, kQuant ? v_scale : 1.f);
  __syncthreads();
  for (int i = tid; i < n * BK_MAX; i += DV) {
    const int gi = i / BK_MAX, t = i % BK_MAX;
    const float* qr = sm.q + gi * DK;
    const float* kr = sm.k + t * LD;
    float x = 0.f;
#pragma unroll 8
    for (int c = 0; c < DK; ++c) x = fmaf(qr[c], kr[c], x);
    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
    const int kp = k_start + t;
    const int horizon = per_row_horizon<G>() ? sm.hz[gi] : length;
    bool ok = t < rows && kp < horizon;
    if (window > 0) ok = ok && (horizon - 1 - kp) < window;
    sm.s[gi * BK_MAX + t] = ok ? x : NEG_INF;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int gi = warp; gi < n; gi += NW) {
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
  for (int gi = 0; gi < G; ++gi)
    if (gi < n) acc[gi] *= sm.a[gi];
  for (int t = 0; t < rows; ++t) {
    const float vv = sm.v[t * DV + tid];
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      if (gi < n) acc[gi] = fmaf(sm.s[gi * BK_MAX + t], vv, acc[gi]);
  }
}

// Write the residuals of the CTA's rows: acc (rows, DV), m/l (rows).
template <int DK, int DV, int G>
__device__ void decode_store(const DecodeSmem<DK, DV, G>& sm, const float acc[G],
                             const Rows<G>& rows, float* acc_out,
                             float* m_out, float* l_out) {
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    if (gi < rows.n) acc_out[rows(gi) * DV + threadIdx.x] = acc[gi];
  if (threadIdx.x < rows.n) {
    m_out[rows(threadIdx.x)] = sm.m[threadIdx.x];
    l_out[rows(threadIdx.x)] = sm.l[threadIdx.x];
  }
}

// The paged decode body of B4, B5 and B6: K/V gathered through per-row
// block tables from head-major page pools (Hkv, P, ps, DK|DV) of KV; a
// 1-byte KV is quantized storage, with (Hkv, P) f32 scale pools read at
// scales[h * P + page] for the page a block comes from.  Page 0 is
// the allocator's null page; a table entry outside the pool reads it
// instead of out-of-bounds memory.  Logical page ik / ps of row b maps
// to physical page bt[b, ik / ps], and its bk-token sub-block is a
// contiguous run of rows (bk divides ps; the wrapper clamps it).
//
// Horizons: a one-token kernel's rows all see row_len[b] tokens (its
// lengths already count the new token), capped at the table's reach;
// the speculative kernel's row r sees row_len[b * row_stride + r] (its
// wrapper computes base + 1 + r / group), and its block loop runs to
// the largest horizon, capped at the table's reach.
//
// RING (the sliding-window kernels B7, B7q): the table row is the
// slot's ring walk, its live window pages in timeline order
// (kernels/decode_attention/paged.py, ring_walk), and column 0 holds
// the token at start[b], the first token of the window's first live
// page.  The block loop runs from start[b] up to the slot's length,
// at most the row's reach past start[b]; the window mask trims the
// first page's tokens before length - window.
template <typename T, typename KV, int DK, int DV, int G, bool RING = false>
__global__ void __launch_bounds__(DV)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ bt,
                    const int* __restrict__ row_len,
                    const int* __restrict__ start, int row_stride,
                    float* acc_out, float* m_out, float* l_out, int k1,
                    int hq, int hkv, int n_pages, int page_size, int t_cols,
                    int bk, float scale, int window, float softcap) {
  static_assert(!RING || !per_row_horizon<G>(), "ring walks are one-token");
  extern __shared__ float smem[];
  const DecodeSmem<DK, DV, G> sm(smem);
  const int h = blockIdx.x, b = blockIdx.y, group = hq / hkv;
  constexpr bool kQuant = sizeof(KV) == 1;
  const Rows<G> rows{static_cast<size_t>(b) * k1 * hq + h * group, group, hq,
                     k1 * group};
  float acc[G];
  decode_init<T, DK, DV, G>(sm, q, rows, scale, acc);
  const int reach = t_cols * page_size;
  const int lo = RING ? start[b] : 0;
  int length = RING ? row_len[b]
                    : (per_row_horizon<G>() ? 0 : min(row_len[b], reach));
  int limit = RING ? min(length, lo + reach) : length;
  if (per_row_horizon<G>()) {
    if (threadIdx.x < rows.n)
      sm.hz[threadIdx.x] =
          row_len[static_cast<size_t>(b) * row_stride + threadIdx.x];
    __syncthreads();
    limit = 0;
    for (int r = 0; r < rows.n; ++r) limit = max(limit, sm.hz[r]);
    limit = min(limit, reach);
  }
  const int* row = bt + static_cast<size_t>(b) * t_cols;
  for (int k0 = lo; k0 < limit; k0 += bk) {
    // lo is a whole number of pages, so k0 - lo keeps k0's page offset
    int page = row[(k0 - lo) / page_size];
    if (page < 0 || page >= n_pages) page = 0;
    const size_t pg = static_cast<size_t>(h) * n_pages + page;
    const size_t row0 = pg * page_size + (k0 - lo) % page_size;
    const size_t off = row0 * DK;
    decode_block<KV, DK, DV, G>(sm, kp + off,
                                vp + (DK == DV ? off : row0 * DV), bk, k0,
                                rows.n, length, window, softcap,
                                kQuant ? ks[pg] : 1.f, kQuant ? vs[pg] : 1.f,
                                acc);
  }
  decode_store<DK, DV, G>(sm, acc, rows, acc_out, m_out, l_out);
}

// The arguments every paged entry point passes through, and their
// dispatch on the query's element type, the pools' and the head dims.
// `start` is read by the ring kernels only; `dv` is the value head dim
// where it differs from the key's `d` (MLA), else 0.
struct PagedArgs {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *bt, *row_len;
  int row_stride;
  float *acc, *m, *l;
  int b, k1, hq, hkv, n_pages, page_size, t_cols, d, bk;
  float scale;
  int window;
  float softcap;
  cudaStream_t stream;
  const int* start = nullptr;
  int dv = 0;
};

// Launch paged_decode_kernel<T, KV, DK, DV, G, RING> on a (Hkv, B) grid
// of DV-thread CTAs.
template <typename T, typename KV, int DK, int DV, int G, bool RING>
cudaError_t launch_paged(const PagedArgs& a) {
  const size_t bytes = decode_smem_floats<DK, DV, G>() * sizeof(float);
  static const cudaError_t attr =
      allow_smem(paged_decode_kernel<T, KV, DK, DV, G, RING>, bytes);
  if (attr != cudaSuccess) return attr;
  paged_decode_kernel<T, KV, DK, DV, G, RING>
      <<<dim3(a.hkv, a.b), DV, bytes, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const KV*>(a.kp),
          static_cast<const KV*>(a.vp), a.ks, a.vs, a.bt, a.row_len, a.start,
          a.row_stride, a.acc, a.m, a.l, a.k1, a.hq, a.hkv, a.n_pages,
          a.page_size, a.t_cols, a.bk, a.scale, a.window, a.softcap);
  return cudaGetLastError();
}

// Equal key and value head dims 64, 128 and 256 (gemma2); a CTA has D
// threads.
template <typename T, typename KV, int G, bool RING = false>
cudaError_t dispatch_paged_d(const PagedArgs& a) {
  if (a.dv != 0 && a.dv != a.d) return cudaErrorInvalidValue;
  if (a.d == 64) return launch_paged<T, KV, 64, 64, G, RING>(a);
  if (a.d == 128) return launch_paged<T, KV, 128, 128, G, RING>(a);
  if (a.d == 256) return launch_paged<T, KV, 256, 256, G, RING>(a);
  return cudaErrorInvalidValue;
}

// Shape checks shared by the paged entry points: whole groups, at most
// G rows per CTA, blocks that divide the page.
template <int G>
inline bool paged_args_ok(const PagedArgs& a) {
  return a.hkv > 0 && a.hq % a.hkv == 0 && a.k1 >= 1 &&
         a.k1 * (a.hq / a.hkv) <= G && a.bk >= 1 && a.bk <= BK_MAX &&
         a.page_size % a.bk == 0 && a.n_pages >= 1;
}

}  // namespace repro
