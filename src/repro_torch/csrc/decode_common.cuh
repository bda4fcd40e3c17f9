// The flash-decode step shared by the decode kernels, as
// flash_decode_step (src/repro/kernels/decode_attention/
// decode_attention.py:37) is shared by the reference's kernels: they
// differ only in where a block of K/V rows comes from, what element
// type it is stored in, and how far each query row may see.
//
// One CTA serves one (batch row, kv head), one split of its cache, and
// the G query rows stacked on that kv head, so each K/V row is read
// from memory once.  For the one-token kernels (B3, B4, B5, B7, B7q)
// the rows are the group's Hq / Hkv query heads; for the speculative
// kernel (B6) they are the K1 window positions times the group,
// position-major (row r = qi * group + gi, `Rows` below), each with its
// own causal horizon.  Keys may be wider than values (MLA: DK = 192
// query/key columns, DV = 128 value columns); the CTA has DV threads,
// and thread c owns output column c of every row, while the scores, a
// dot over DK columns per (row, token) pair, are shared out over all
// the threads.  Per block of up to BK_MAX tokens: score every (row,
// token) pair against the row's horizon, run the online-softmax update
// (one warp per row), and accumulate P V in registers.  The outputs are
// the unnormalized residuals (acc, m, l) of the reference's contract.
//
// Every kernel runs the split-KV helpers below: B3 over a dense cache
// (csrc/decode_attention.cu), and split_paged_decode_kernel over page
// pools, through a block table (B4, B5, B6) or a ring table walked from
// the window's first live page (RING: the sliding-window kernels B7 and
// B7q).  The cache is cut into chunks
// walked by CTAs of their own, K and V staged in their storage type
// with the next block in flight, the chunks' partials merged in split
// order.
#pragma once

#include <climits>

#include "common.cuh"

namespace repro {

constexpr int BK_MAX = 64;     // tokens per block
constexpr int G_DECODE = 8;    // rows of the one-token kernels: the group
constexpr int G_SPEC = 32;     // rows of the speculative kernel: K1 * group

// The speculative kernel's rows each see their own causal horizon, read
// from shared memory (SplitSmem::hz); the one-token kernels' rows all
// see the CTA's one length, kept in a register.
template <int G>
__host__ __device__ constexpr bool per_row_horizon() {
  return G == G_SPEC;
}

// Where the CTA's row r lives in the (B, K1, Hq) row space of q and of
// the outputs: query position r / group, head h * group + r % group.
// The one-token kernels' rows are consecutive heads (K1 = 1), so their
// offset from row0 is r, with no division.
template <int G>
struct Rows {
  size_t row0;  // (b * K1) * Hq + h * group
  int group;    // query heads per kv head
  int hq;       // rows per query position
  int n;        // live rows: K1 * group (<= G)
  __device__ size_t off(int r) const {
    if (!per_row_horizon<G>()) return r;
    return static_cast<size_t>(r / group) * hq + r % group;
  }
  __device__ size_t operator()(int r) const { return row0 + off(r); }
};

// The arguments every paged entry point passes through, and their
// dispatch on the query's element type, the pools' and the head dims.
// `dv` is the value head dim where it differs from the key's `d` (MLA),
// else 0.
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
  int dv = 0;
  // the split kernel's: rows a split, splits, and (with several) the
  // partials' scratch and the zeroed (B x Hkv) int32 counters
  int chunk = 0, nsplit = 1;
  float *part_acc = nullptr, *part_m = nullptr, *part_l = nullptr;
  int* counters = nullptr;
};

// Shape checks shared by the paged entry points: whole groups, at most
// G rows per CTA, blocks that divide the page.
template <int G>
inline bool paged_args_ok(const PagedArgs& a) {
  return a.hkv > 0 && a.hq % a.hkv == 0 && a.k1 >= 1 &&
         a.k1 * (a.hq / a.hkv) <= G && a.bk >= 1 && a.bk <= BK_MAX &&
         a.page_size % a.bk == 0 && a.n_pages >= 1;
}

// ---------------------------------------------------------------------
// Split-KV decode: B3 (csrc/decode_attention.cu) over dense caches, and
// split_paged_decode_kernel over page pools: B4 (csrc/paged_decode_
// attention.cu), B5 (its int8/fp8 pools, csrc/quant_paged_decode_
// attention.cu), B6 (the speculative rows, csrc/spec_paged_decode_
// attention.cu), and B7 and B7q over ring tables (csrc/window_paged_
// decode_attention.cu, csrc/quant_window_paged_decode_attention.cu).
//
// A CTA serves one (batch row, kv head) and one split of its cache: rows
// [j * chunk, (j + 1) * chunk), chunk a whole number of blocks.  Its
// per-block arithmetic is fixed term for term whatever the split (the
// scores' fmaf over the key columns in order, a 1-byte key dequantized
// first as to_f32(x) * scale, the softcap's tanhf, the warp softmax with
// the same lanes, P V in token order), so a split that is its rows' only
// live one gives the bits of a walk over the whole cache.  K and V are
// staged in their storage type by 16-byte cp.async copies, the next
// block's while this one computes (two stages when both fit), and the
// rows of a CTA (the group, or B6's K1 x group) size shared memory and
// acc[] through G.  Several live splits leave partials (acc, m, l), and
// the last of them to finish merges them in split order (split_merge).

// cp.async: 16 bytes global -> shared, through L2 only.
__device__ __forceinline__ void cp_async16(void* dst_shared,
                                           const void* src_global) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src_global)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for every copy group this thread committed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The most splits a row may have: the merge keeps one weight per (row,
// split) in the score tile (G x BK_MAX floats).
constexpr int MAX_SPLITS = BK_MAX;

// The split kernel's shared memory: the K and V stages in T (the key's
// 16-byte chunks swizzled by token, so that neighbouring tokens read one
// chunk column from distinct bank groups), the scaled query rows, the
// score tile, the rows' running (m, l), the block's rescale factors,
// the merge flag and, for the speculative rows, their horizons.  Two
// stages where they fit the 227 KB a CTA may take, else one (f32 at
// head dim 256).
template <typename T, int DK, int DV>
__host__ __device__ constexpr int split_stages() {
  return 2 * BK_MAX * (DK + DV) * sizeof(T) <= 200 * 1024 ? 2 : 1;
}

template <typename T, int DK, int DV, int G>
__host__ __device__ constexpr size_t split_smem_bytes() {
  return static_cast<size_t>(split_stages<T, DK, DV>()) * BK_MAX *
             (DK + DV) * sizeof(T) +
         sizeof(float) * (G * DK + G * BK_MAX + 3 * G) + 16 +
         (per_row_horizon<G>() ? sizeof(int) * G : 0);
}

template <typename T, int DK, int DV, int G>
struct SplitSmem {
  static constexpr int STAGES = split_stages<T, DK, DV>();
  // 16-byte chunks a key row, and the tokens whose chunk columns the
  // swizzle spreads: the largest power of two, at most 8, that divides
  // the row's chunks, so that c ^ (t & (SWIZZLE - 1)) stays in token t's
  // row (a 64-wide key of 1-byte storage has 4 chunks, a 192-wide one 12:
  // 4 each; every other build 8)
  static constexpr int KCH = DK * sizeof(T) / 16;
  static constexpr int SWIZZLE =
      KCH % 8 == 0 ? 8 : KCH % 4 == 0 ? 4 : KCH % 2 == 0 ? 2 : 1;
  static_assert(KCH % SWIZZLE == 0, "the swizzle stays in the key's row");
  T* k;       // STAGES x BK_MAX x DK, chunks swizzled (k_chunk)
  T* v;       // STAGES x BK_MAX x DV
  float* q;   // G x DK, pre-scaled
  float* s;   // G x BK_MAX: scores, then probabilities; merge weights
  float* m;   // running max per row
  float* l;   // running sum per row
  float* a;   // this block's rescale factor per row
  int* flag;  // this CTA merges
  int* hz;    // per-row horizons (per_row_horizon): tokens [0, hz) visible
  __device__ explicit SplitSmem(unsigned char* base) {
    k = reinterpret_cast<T*>(base);
    v = k + STAGES * BK_MAX * DK;
    q = reinterpret_cast<float*>(v + STAGES * BK_MAX * DV);
    s = q + G * DK;
    m = s + G * BK_MAX;
    l = m + G;
    a = l + G;
    flag = reinterpret_cast<int*>(a + G);
    hz = flag + 4;
  }
  // 16-byte chunk c of token t's key row in stage `st`
  __device__ uint4* k_chunk(int st, int t, int c) const {
    return reinterpret_cast<uint4*>(k + st * BK_MAX * DK) + t * KCH +
           (c ^ (t & (SWIZZLE - 1)));
  }
};

// Issue the copies of `rows` K/V rows (a block) into stage `st`.
template <typename T, int DK, int DV, int G>
__device__ __forceinline__ void split_stage(const SplitSmem<T, DK, DV, G>& sm,
                                            int st, const T* kblk,
                                            const T* vblk, int rows) {
  constexpr int KCH = DK * sizeof(T) / 16, VCH = DV * sizeof(T) / 16;
  constexpr int SW = SplitSmem<T, DK, DV, G>::SWIZZLE;
  static_assert(KCH % SW == 0 && (SW & (SW - 1)) == 0 && VCH >= 1,
                "16-byte rows, a whole number of swizzled chunk columns");
  const uint4* ks = reinterpret_cast<const uint4*>(kblk);
  const uint4* vs = reinterpret_cast<const uint4*>(vblk);
  uint4* vd = reinterpret_cast<uint4*>(sm.v + st * BK_MAX * DV);
  for (int i = threadIdx.x; i < rows * KCH; i += DV)
    cp_async16(sm.k_chunk(st, i / KCH, i % KCH), ks + i);
  for (int i = threadIdx.x; i < rows * VCH; i += DV)
    cp_async16(vd + i, vs + i);
  cp_async_commit();
}

// The CTA's scaled query rows (rows past n zeroed; Q the query's type,
// T the stages') and the reset running state.
template <typename T, int DK, int DV, int G, typename Q>
__device__ void split_init(const SplitSmem<T, DK, DV, G>& sm, const Q* q,
                           const Rows<G>& rows, float scale, float acc[G]) {
  for (int i = threadIdx.x; i < G * DK; i += DV) {
    const size_t src = per_row_horizon<G>()
                           ? rows(i / DK) * DK + i % DK
                           : rows.row0 * DK + i;
    sm.q[i] = i / DK < rows.n ? to_f32(q[src]) * scale : 0.f;
  }
  if (threadIdx.x < G) {
    sm.m[threadIdx.x] = NEG_INF;
    sm.l[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < G; ++i) acc[i] = 0.f;
}

// One block of stage `st`: tokens k_start .. k_start + rows - 1, masked
// at `length` (at sm.hz[r] for the speculative rows) and by the window
// measured back from it (decode_attention.py:80-83).  Scores: DV /
// BK_MAX threads a token, each over every (DV / BK_MAX)-th row, reading
// the key a 16-byte chunk at a time and the query rows as broadcasts.
// A 1-byte T is quantized storage, dequantized as `to_f32(x) * scale`
// with the block's page scales (decode_attention.py:69-72).
template <typename T, int DK, int DV, int G>
__device__ void split_block(const SplitSmem<T, DK, DV, G>& sm, int st,
                            int rows, int k_start, int n, int length,
                            int window, float softcap, float acc[G],
                            float k_scale = 1.f, float v_scale = 1.f) {
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int VEC = 16 / sizeof(T), CH = DK / VEC;
  constexpr int TPT = DV / BK_MAX;             // threads a token
  constexpr int RPT = (G + TPT - 1) / TPT;     // rows a thread
  constexpr int NW = DV / 32;
  static_assert(DV % BK_MAX == 0, "a whole number of threads a token");
  const int tid = threadIdx.x;
  const int t = tid % BK_MAX, r0 = tid / BK_MAX;
  // rows scored: G, or the live ones where they may be far fewer (B6)
  const int n_dot = per_row_horizon<G>() ? n : G;
  if (r0 < n) {
    float x[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) x[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < CH; ++c) {
      const uint4 raw = *sm.k_chunk(st, t, c);
      const T* e = reinterpret_cast<const T*>(&raw);
      float kv[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        kv[j] = kQuant ? to_f32(e[j]) * k_scale : to_f32(e[j]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (r0 + i * TPT >= n_dot) break;
        const float* qr = sm.q + (r0 + i * TPT) * DK + c * VEC;
#pragma unroll
        for (int j = 0; j < VEC; ++j) x[i] = fmaf(qr[j], kv[j], x[i]);
      }
    }
    const int kp = k_start + t;
    bool ok = t < rows && kp < length;
    if (window > 0) ok = ok && (length - 1 - kp) < window;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int gi = r0 + i * TPT;
      if (gi >= n) break;
      float y = x[i];
      if (softcap > 0.f) y = softcap * tanhf(y / softcap);
      if (per_row_horizon<G>()) {  // the row's own horizon
        const int hz = sm.hz[gi];
        ok = t < rows && kp < hz;
        if (window > 0) ok = ok && (hz - 1 - kp) < window;
      }
      sm.s[gi * BK_MAX + t] = ok ? y : NEG_INF;
    }
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int gi = warp; gi < n; gi += NW) {
    float* sr = sm.s + gi * BK_MAX;
    const float x0 = sr[lane], x1 = sr[lane + 32];
    const float m_old = sm.m[gi];
    // NaN-propagating: a NaN score (NaN in a K page or a K scale) makes
    // m NaN, p and l 0, and the row 0, as the plain versions leave it
    const float m_new = max_nan(m_old, warp_max(max_nan(x0, x1)));
    const bool live = m_new > NEG_INF / 2;
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
  const T* vs = sm.v + st * BK_MAX * DV + tid;
  int t4 = 0;
  for (; t4 + 4 <= rows; t4 += 4) {
    float vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      vv[u] = kQuant ? to_f32(vs[(t4 + u) * DV]) * v_scale
                     : to_f32(vs[(t4 + u) * DV]);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi < n) {
        const float4 p =
            *reinterpret_cast<const float4*>(sm.s + gi * BK_MAX + t4);
        acc[gi] = fmaf(p.x, vv[0], acc[gi]);
        acc[gi] = fmaf(p.y, vv[1], acc[gi]);
        acc[gi] = fmaf(p.z, vv[2], acc[gi]);
        acc[gi] = fmaf(p.w, vv[3], acc[gi]);
      }
    }
  }
  for (; t4 < rows; ++t4) {
    const float vv =
        kQuant ? to_f32(vs[t4 * DV]) * v_scale : to_f32(vs[t4 * DV]);
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      if (gi < n) acc[gi] = fmaf(sm.s[gi * BK_MAX + t4], vv, acc[gi]);
  }
}

// The live splits of a row group: [j_lo, j_hi), those holding a token
// that one of its rows sees.  None for an empty group.
struct SplitRange {
  int lo, hi;
  // splits covering tokens from `origin` on (a ring walk's first token,
  // else 0), of rows that see tokens [first, limit) between them
  __device__ SplitRange(int origin, int first, int limit, int chunk) {
    const int a = max(first, origin) - origin, e = limit - origin;
    lo = a / chunk;
    hi = e > a ? (e + chunk - 1) / chunk : 0;
  }
  // a dense cache's row: tokens [0, length), the window measured back
  __device__ SplitRange(int length, int window, int chunk)
      : SplitRange(0, window > 0 ? max(0, length - window) : 0, length,
                   chunk) {}
  __device__ int live() const { return max(0, hi - lo); }
};

// The merge of a row group's live partials (acc, m, l), stored by
// split j at part_*[(j * rows_total + row) ...], in ascending split
// order: m = max_j m_j, w_j = e^(m_j - m) (0 for every j where m is
// not live: an all-empty row stays acc 0, m NEG_INF, l 0; 0 too for a
// split where a speculative row saw nothing, m_j NEG_INF), acc = sum_j
// acc_j w_j, l = sum_j l_j w_j.  The weights go through the score tile.
// The partials were stored by other CTAs: read them through L2, with
// MERGE_BATCH splits' loads of 8 rows in flight before any is summed (a
// loop of dependent L2 round trips would cost more than the splits
// save).
constexpr int MERGE_BATCH = 8;

template <typename T, int DK, int DV, int G>
__device__ void split_merge(const SplitSmem<T, DK, DV, G>& sm,
                            const float* part_acc, const float* part_m,
                            const float* part_l, size_t rows_total,
                            const Rows<G>& rows, int j_lo, int nlive,
                            float* acc_out, float* m_out, float* l_out) {
  // splits a batch: MERGE_BATCH x 8 loads in flight at any G
  constexpr int B = MERGE_BATCH * 8 / (G > 8 ? G : 8);
  const int tid = threadIdx.x, n = rows.n;
  const float* pm = part_m + j_lo * rows_total + rows.row0;
  const float* pl = part_l + j_lo * rows_total + rows.row0;
  const float* pa = part_acc + (j_lo * rows_total + rows.row0) * DV + tid;
  for (int i = tid; i < n * nlive; i += DV)  // m_j into the score tile
    sm.s[(i / nlive) * BK_MAX + i % nlive] =
        __ldcg(pm + (i % nlive) * rows_total + rows.off(i / nlive));
  __syncthreads();
  if (tid < n) {
    float m = NEG_INF;
    for (int jj = 0; jj < nlive; ++jj) m = max_nan(m, sm.s[tid * BK_MAX + jj]);
    sm.m[tid] = m;
  }
  __syncthreads();
  for (int i = tid; i < n * nlive; i += DV) {
    const int gi = i / nlive, jj = i % nlive;
    const float m = sm.m[gi];
    float* w = sm.s + gi * BK_MAX + jj;
    *w = m > NEG_INF / 2 ? expf(*w - m) : 0.f;
  }
  __syncthreads();
  float acc[G], l = 0.f;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) acc[gi] = 0.f;
  for (int j0 = 0; j0 < nlive; j0 += B) {
    float v[G][B], lv[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const bool in = j0 + u < nlive;
      const size_t off = (j0 + u) * rows_total;
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        v[gi][u] = in && gi < n ? __ldcg(pa + (off + rows.off(gi)) * DV) : 0.f;
      lv[u] = in && tid < n ? __ldcg(pl + off + rows.off(tid)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (j0 + u >= nlive) break;
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        if (gi < n)
          acc[gi] = fmaf(v[gi][u], sm.s[gi * BK_MAX + j0 + u], acc[gi]);
      if (tid < n) l = fmaf(lv[u], sm.s[tid * BK_MAX + j0 + u], l);
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    if (gi < n) acc_out[rows(gi) * DV + tid] = acc[gi];
  if (tid < n) {
    m_out[rows(tid)] = sm.m[tid];
    l_out[rows(tid)] = l;
  }
}

// An empty row group (no live split): split 0 stores acc 0, m NEG_INF,
// l 0, what a walk over no token leaves; the other splits store
// nothing.
template <int DV, int G>
__device__ __forceinline__ void split_store_empty(int j, const Rows<G>& rows,
                                                  float* acc_out,
                                                  float* m_out,
                                                  float* l_out) {
  if (j != 0) return;
  for (int gi = 0; gi < rows.n; ++gi)
    acc_out[rows(gi) * DV + threadIdx.x] = 0.f;
  if (threadIdx.x < rows.n) {
    m_out[rows(threadIdx.x)] = NEG_INF;
    l_out[rows(threadIdx.x)] = 0.f;
  }
}

// The end of a live split's walk.  A row group with one live split
// stores its residuals directly, so it keeps the bits of one split.
// With several, each stores its partial at part_*[j], fences, and
// counts itself in `counter`; the last to arrive resets the counter to
// 0 for the next launch and merges the partials in split order
// (split_merge), so the result does not depend on which CTA finishes
// last.
template <typename T, int DK, int DV, int G>
__device__ __forceinline__ void split_finish(
    const SplitSmem<T, DK, DV, G>& sm, const float acc[G], int j,
    const Rows<G>& rows, size_t rows_total, const SplitRange& live,
    int* counter, float* acc_out, float* m_out, float* l_out,
    float* part_acc, float* part_m, float* part_l) {
  __syncthreads();
  const int nlive = live.live(), n = rows.n;
  float* a_out = acc_out;
  float *mo = m_out, *lo = l_out;
  if (nlive > 1) {  // store a partial instead
    a_out = part_acc + j * rows_total * DV;
    mo = part_m + j * rows_total;
    lo = part_l + j * rows_total;
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    if (gi < n) a_out[(rows.row0 + rows.off(gi)) * DV + threadIdx.x] = acc[gi];
  if (threadIdx.x < n) {
    mo[rows.row0 + rows.off(threadIdx.x)] = sm.m[threadIdx.x];
    lo[rows.row0 + rows.off(threadIdx.x)] = sm.l[threadIdx.x];
  }
  if (nlive == 1) return;
  __threadfence();  // the partial is visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    *sm.flag = atomicAdd(counter, 1) == nlive - 1;
    if (*sm.flag) *counter = 0;  // every live split has counted: reset
  }
  __syncthreads();
  if (!*sm.flag) return;
  __threadfence();
  split_merge<T, DK, DV, G>(sm, part_acc, part_m, part_l, rows_total, rows,
                            live.lo, nlive, acc_out, m_out, l_out);
}

// Split-KV paged decode (B4, B5, B6, B7, B7q): K/V gathered through
// per-row block tables from head-major page pools (Hkv, P, ps, DK|DV)
// of KV, cut into splits as B3 cuts a dense cache; a 1-byte KV is
// quantized storage, with (Hkv, P) f32 scale pools read at
// scales[h * P + page] for the page a block comes from.  The grid is
// (Hkv, B, nsplit); CTA (h, b, j) walks the slot's logical rows [lo + j
// * chunk, lo + (j + 1) * chunk), chunk a whole number of pages and so
// of bk-token blocks (bk divides the page; the wrapper clamps it), for
// the CTA's rows: logical page ik / ps of row b maps to physical page
// bt[b, ik / ps], and its bk-token sub-block is a contiguous run of
// rows.  Page 0 is the allocator's null page; a table entry outside the
// pool reads it instead of out-of-bounds memory.  The entry of block i
// + 2 is read while block i computes and the copy of block i + 1 is in
// flight (two stages where they fit), and a 1-byte KV's page scales of
// block i + 1 are read while block i computes.  The per-block
// arithmetic is split_block's, so one split gives the bits of one walk
// over the whole row.
//
// RING (the sliding-window kernels B7 and B7q): the table row is the
// slot's ring, global page g at column g % t_cols, and the CTA walks it
// in timeline order from the window's first live page, first = max(0,
// length - window) / page_size: the walk's column i is the ring's (first
// + i) % t_cols, as the reference's index maps read it (paged.py:
// 301-305; kernels/decode_attention/paged.py, ring_walk, lays the same
// walk out for the plain version), and its first token is lo = first *
// page_size.  The splits count from lo (SplitRange's origin), so split
// j holds tokens [lo + j * chunk, lo + (j + 1) * chunk) whatever lo is;
// the walk runs up to the slot's length, at most the row's reach past
// lo, so the stale or null columns a ring holds past the live window
// are never read, and the window mask trims the first page's tokens
// before length - window.
//
// Rows and horizons.  One-token (G <= 8): the group's rows all see
// `length` tokens (row_len[b], capped at the table's reach unless
// RING), the window measured back from it.  Speculative (G_SPEC): row r
// of the K1 x group (Rows) sees row_len[b * row_stride + r] tokens (its
// wrapper computes base + 1 + r / group), each masked at its own
// horizon and window (in shared memory, SplitSmem::hz); the CTA's live
// range runs from the earliest window start of its rows to their
// largest horizon, capped at the table's reach, so the walk, the live
// splits and the direct store are the CTA's, as one counter per (slot,
// kv head) is.  A split of that range where a row sees no token leaves
// it acc 0, m NEG_INF, l 0, which the merge weighs 0.
template <typename T, typename KV, int DK, int DV, int G, bool RING>
__global__ void __launch_bounds__(DV)
split_paged_decode_kernel(
    const T* __restrict__ q, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ bt,
    const int* __restrict__ row_len, int row_stride, float* acc_out, float* m_out, float* l_out,
    float* part_acc, float* part_m, float* part_l, int* counters, int k1,
    int hq, int hkv, int n_pages, int page_size, int t_cols, int bk,
    int chunk, float scale, int window, float softcap) {
  static_assert(!RING || !per_row_horizon<G>(), "ring walks are one-token");
  using Smem = SplitSmem<KV, DK, DV, G>;
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr bool kSpec = per_row_horizon<G>();
  extern __shared__ __align__(16) unsigned char split_smem[];
  const Smem sm(split_smem);
  const int h = blockIdx.x, b = blockIdx.y, j = blockIdx.z, g = hq / hkv;
  const int k = kSpec ? k1 : 1;  // query positions a slot
  const Rows<G> rows{static_cast<size_t>(b) * k * hq + h * g, g, hq, k * g};
  const int reach = t_cols * page_size;
  // RING: the window's first live page, whose first token heads the walk
  const int first_page = RING ? max(0, row_len[b] - window) / page_size : 0;
  const int lo = first_page * page_size;
  int length = 0, first, limit;
  if (kSpec) {
    if (threadIdx.x < rows.n)
      sm.hz[threadIdx.x] =
          row_len[static_cast<size_t>(b) * row_stride + threadIdx.x];
    __syncthreads();
    first = INT_MAX;
    limit = 0;
    for (int r = 0; r < rows.n; ++r) {
      const int hz = sm.hz[r];
      first = min(first, window > 0 ? max(0, hz - window) : 0);
      limit = max(limit, hz);
    }
    limit = min(limit, reach);
  } else {
    length = RING ? row_len[b] : min(row_len[b], reach);
    first = window > 0 ? max(0, length - window) : 0;
    limit = RING ? min(length, lo + reach) : length;
  }
  const SplitRange live(lo, first, limit, chunk);
  if (live.live() == 0) {
    split_store_empty<DV, G>(j, rows, acc_out, m_out, l_out);
    return;
  }
  if (j < live.lo || j >= live.hi) return;  // an empty split
  const int* row = bt + static_cast<size_t>(b) * t_cols;
  const int c_begin = j * chunk;  // the split's first row past lo
  const int nblk = (min(c_begin + chunk, limit - lo) - c_begin + bk - 1) / bk;
  auto page_of = [&](int ib) {  // block ib's physical page
    int col = (c_begin + ib * bk) / page_size;
    if (RING) col = (first_page + col) % t_cols;
    const int page = row[col];
    return page < 0 || page >= n_pages ? 0 : page;
  };
  auto stage = [&](int ib, int page) {
    const size_t r0 = (static_cast<size_t>(h) * n_pages + page) * page_size +
                      (c_begin + ib * bk) % page_size;
    split_stage<KV, DK, DV, G>(sm, ib % Smem::STAGES, kp + r0 * DK,
                               vp + r0 * DV, bk);
  };
  const int page0 = page_of(0);
  int nxt = nblk > 1 ? page_of(1) : 0;
  float k_sc = 1.f, v_sc = 1.f;  // the computing block's page scales
  if (kQuant) {
    k_sc = ks[static_cast<size_t>(h) * n_pages + page0];
    v_sc = vs[static_cast<size_t>(h) * n_pages + page0];
  }
  stage(0, page0);  // in flight while the query rows are staged
  float acc[G];
  split_init<KV, DK, DV, G>(sm, q, rows, scale, acc);
  for (int ib = 0; ib < nblk; ++ib) {
    cp_async_wait_all();
    __syncthreads();  // the block has landed; the last one's readers are done
    if (Smem::STAGES == 2 && ib + 1 < nblk) stage(ib + 1, nxt);
    const int after = ib + 2 < nblk ? page_of(ib + 2) : 0;
    float k_nx = 1.f, v_nx = 1.f;  // block ib + 1's, landing meanwhile
    if (kQuant) {
      k_nx = ks[static_cast<size_t>(h) * n_pages + nxt];
      v_nx = vs[static_cast<size_t>(h) * n_pages + nxt];
    }
    split_block<KV, DK, DV, G>(sm, ib % Smem::STAGES, bk,
                               lo + c_begin + ib * bk, rows.n, length,
                               window, softcap, acc, k_sc, v_sc);
    if (Smem::STAGES == 1 && ib + 1 < nblk) {
      __syncthreads();
      stage(ib + 1, nxt);
    }
    nxt = after;
    k_sc = k_nx;
    v_sc = v_nx;
  }
  split_finish<KV, DK, DV, G>(sm, acc, j, rows,
                              static_cast<size_t>(gridDim.y) * k * hq, live,
                              counters + b * hkv + h, acc_out, m_out, l_out,
                              part_acc, part_m, part_l);
}

// Launch split_paged_decode_kernel<T, KV, DK, DV, G, RING> on a (Hkv, B,
// nsplit) grid of DV-thread CTAs.
template <typename T, typename KV, int DK, int DV, int G, bool RING>
cudaError_t launch_split_paged(const PagedArgs& a) {
  const size_t bytes = split_smem_bytes<KV, DK, DV, G>();
  static const cudaError_t attr =
      allow_smem(split_paged_decode_kernel<T, KV, DK, DV, G, RING>, bytes);
  if (attr != cudaSuccess) return attr;
  split_paged_decode_kernel<T, KV, DK, DV, G, RING>
      <<<dim3(a.hkv, a.b, a.nsplit), DV, bytes, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const KV*>(a.kp),
          static_cast<const KV*>(a.vp), a.ks, a.vs, a.bt, a.row_len,
          a.row_stride, a.acc, a.m, a.l, a.part_acc, a.part_m, a.part_l,
          a.counters, a.k1, a.hq, a.hkv, a.n_pages, a.page_size, a.t_cols,
          a.bk, a.chunk, a.scale, a.window, a.softcap);
  return cudaGetLastError();
}

// The group's rows, rounded up to a build: 1, 2, 4 or 8; RING: the
// table rows are rings, walked from the window's first live page (B7,
// B7q).
template <typename T, typename KV, int DK, int DV, bool RING = false>
cudaError_t dispatch_split_paged_g(const PagedArgs& a) {
  const int g = a.hq / a.hkv;
  if (g <= 1) return launch_split_paged<T, KV, DK, DV, 1, RING>(a);
  if (g <= 2) return launch_split_paged<T, KV, DK, DV, 2, RING>(a);
  if (g <= 4) return launch_split_paged<T, KV, DK, DV, 4, RING>(a);
  return launch_split_paged<T, KV, DK, DV, 8, RING>(a);
}

// The group's build, or with SPEC the speculative kernel's G_SPEC rows
// (never RING).
template <typename T, typename KV, int DK, int DV, bool SPEC, bool RING>
cudaError_t dispatch_split_paged_rows(const PagedArgs& a) {
  static_assert(!(SPEC && RING), "ring walks are one-token");
  if constexpr (SPEC)
    return launch_split_paged<T, KV, DK, DV, G_SPEC, false>(a);
  else
    return dispatch_split_paged_g<T, KV, DK, DV, RING>(a);
}

// The head dims of B4, B5 and B6: equal key and value dims 64, 128 and
// 256, or MLA's 192 / 128 (`dv` set; not for RING: no window layer is
// MLA).
template <typename T, typename KV, bool SPEC = false, bool RING = false>
cudaError_t dispatch_split_paged_d(const PagedArgs& a) {
  if (a.dv != 0 && a.dv != a.d) {
    if constexpr (!RING) {
      if (a.d == 192 && a.dv == 128)
        return dispatch_split_paged_rows<T, KV, 192, 128, SPEC, RING>(a);
    }
    return cudaErrorInvalidValue;
  }
  if (a.d == 64)
    return dispatch_split_paged_rows<T, KV, 64, 64, SPEC, RING>(a);
  if (a.d == 128)
    return dispatch_split_paged_rows<T, KV, 128, 128, SPEC, RING>(a);
  if (a.d == 256)
    return dispatch_split_paged_rows<T, KV, 256, 256, SPEC, RING>(a);
  return cudaErrorInvalidValue;
}

// The split fields of a paged launch: `chunk` logical rows a split (a
// whole number of pages), nsplit = max(1, ceil(t_cols * page_size /
// chunk)) and, with several, the partials' scratch (nsplit, rows, DV),
// (nsplit, rows) twice, and the zeroed (B x Hkv) int32 counters.
inline void set_splits(PagedArgs& a, int chunk, void* part_acc,
                       void* part_m, void* part_l, void* counters) {
  a.chunk = chunk;
  a.nsplit = chunk > 0 ? (a.t_cols * a.page_size + chunk - 1) / chunk : 0;
  if (a.nsplit < 1) a.nsplit = 1;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.counters = static_cast<int*>(counters);
}

// Shape checks of the split paged launch beside paged_args_ok: chunks of
// whole pages, at most MAX_SPLITS of them, scratch where there are
// several.
inline bool split_paged_args_ok(const PagedArgs& a) {
  return a.chunk >= a.page_size && a.chunk % a.page_size == 0 &&
         a.nsplit >= 1 && a.nsplit <= MAX_SPLITS &&
         (a.nsplit == 1 || (a.part_acc != nullptr && a.part_m != nullptr &&
                            a.part_l != nullptr && a.counters != nullptr));
}
}  // namespace repro
