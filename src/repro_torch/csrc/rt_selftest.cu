// The device runtime's test kernel: the counterpart of the Pallas kernel
// of tests/test_runtime.py (test_kernel_call_scratch_and_teams), a
// kernel written against the runtime that uses teams, worksharing,
// shared memory, reductions and every atomic.  Unlike the TPU's
// sequential grid, the teams here run in parallel and in no order, so
// the atomics meet real contention; src/repro_torch/core/selftest.py
// holds the outcomes that do not depend on that order against the plain
// sequential semantics of src/repro_torch/core/atomics.py.
//
// Replaces the TPU kernel tests/test_runtime.py:43
// (test_kernel_call_scratch_and_teams, body kern); a test, on no model
// path.
//
// Bound on the H100: neither bytes nor operations; every item's seven
// contended seq_cst atomics on a handful of words serialize in L2.
// Design: team t takes items [lo, hi) of rt::static_partition(total,
// teams, t), one item per thread per pass; item i has key(i) in
// [0, 1000).  The team's sum and max are two reductions, each on its
// own carve-out (the runtime's contract), and every thread checks that
// it received what thread 0 stores.  Thread j of team t also takes rt::approx_reciprocal of
// t * NT + j + 1, an integer, so the host can hold it to 1/x.  Each warp
// then multiplies two 16 x 16 bf16 tiles of small integers (every
// product and sum exact in f32) with rt::mma_bf16_m16n8k16, B's
// fragments loaded three ways (x4 of B^T, x4.trans of B, and x2 / x2.trans
// for one n8 half each), and reduces its lanes over quads
// (rt::warp_reduce_sum / max with width 4); each output that differs
// from the exact one counts one in MMA_ERRS, each wrong quad result one
// in QUAD_ERRS.  Built
// twice from this source: with RT_SELFTEST_TARGET the target part's
// intrinsics (atomic_inc, make_async_copy) are exercised too, and that
// build fails to compile for the generic target; without it only the
// portable part is, which builds for both.
#include "common.cuh"
#include "rt/runtime.cuh"

namespace {

constexpr int NT = 128;

// counters[], in the order core/selftest.py names them
enum {
  ADD, MAX, MIN, CAS, WINS, EXCH, EXCH_OLDS, ARENA_ERRS, REDUCE_ERRS,
  MMA_ERRS, QUAD_ERRS, N_COUNTERS
};

// The warp product's tiles, A (16 x 16) and B (16 x 16): small integers.
__host__ __device__ constexpr int a_of(int i, int k) {
  return (3 * i + 5 * k) % 7 - 3;
}
__host__ __device__ constexpr int b_of(int k, int j) {
  return (2 * k + 3 * j) % 5 - 2;
}
constexpr int TILE = 16 * 16;  // bf16 elements of one tile

// Every warp: C = A B three ways, each of C's 256 outputs held to the
// exact sum; then a quad sum and max of each lane's index.
__device__ void warp_product_check(const __nv_bfloat16* sA,
                                   const __nv_bfloat16* sB,
                                   const __nv_bfloat16* sBt, int* counters) {
  const int lane = rt::thread_id() % 32, g = lane / 4, t = lane % 4;
  unsigned a[4];
  // A's tiles: lane l gives row l % 16, columns 8 (l / 16) ..
  rt::load_matrix_x4(a, sA + (lane % 16) * 16 + lane / 16 * 8);
  float d[3][2][4];
  for (int w = 0; w < 3; ++w)
    for (int j = 0; j < 2; ++j)
      for (int e = 0; e < 4; ++e) d[w][j][e] = 0.f;
  unsigned f[4], h[2];
  // 1: B^T row-major (n on rows): n = l % 8 + 8 (l / 16), k = 8 (l / 8 % 2)
  rt::load_matrix_x4(f, sBt + (lane % 8 + lane / 16 * 8) * 16 +
                            lane / 8 % 2 * 8);
  const unsigned f0[2] = {f[0], f[1]}, f1[2] = {f[2], f[3]};
  rt::mma_bf16_m16n8k16(d[0][0], a, f0);
  rt::mma_bf16_m16n8k16(d[0][1], a, f1);
  // 2: B row-major (k on rows) by .trans: k = l % 16, n = 8 (l / 16)
  rt::load_matrix_x4_trans(f, sB + (lane % 16) * 16 + lane / 16 * 8);
  const unsigned f2[2] = {f[0], f[1]}, f3[2] = {f[2], f[3]};
  rt::mma_bf16_m16n8k16(d[1][0], a, f2);
  rt::mma_bf16_m16n8k16(d[1][1], a, f3);
  // 3: the n8 halves by the two-tile loads, x2 of B^T and x2.trans of B
  rt::load_matrix_x2(h, sBt + (lane % 8) * 16 + lane / 8 % 2 * 8);
  rt::mma_bf16_m16n8k16(d[2][0], a, h);
  rt::load_matrix_x2_trans(h, sB + (lane % 16) * 16 + 8);
  rt::mma_bf16_m16n8k16(d[2][1], a, h);
  int bad = 0;
  for (int w = 0; w < 3; ++w)
    for (int j = 0; j < 2; ++j)
      for (int e = 0; e < 4; ++e) {
        const int i = g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
        int want = 0;
        for (int kk = 0; kk < 16; ++kk) want += a_of(i, kk) * b_of(kk, n);
        bad += d[w][j][e] != static_cast<float>(want);
      }
  if (bad) rt::atomic_add(&counters[MMA_ERRS], bad);
  const float x = static_cast<float>(lane);
  const float qs = rt::warp_reduce_sum(x, 4), qm = rt::warp_reduce_max(x, 4);
  if (qs != static_cast<float>(16 * g + 6) || qm != static_cast<float>(4 * g + 3))
    rt::atomic_add(&counters[QUAD_ERRS], 1);
}

__device__ __forceinline__ int key_of(int i) {
  return static_cast<int>(static_cast<unsigned>(i) * 2654435761u % 1000u);
}

__global__ void __launch_bounds__(NT)
selftest_kernel(int total, unsigned bound, int* __restrict__ parts,
                int* counters, unsigned* inc, unsigned* __restrict__ inc_olds,
                float* __restrict__ team_sums, float* __restrict__ team_maxes,
                float* __restrict__ recips, const int4* __restrict__ src,
                int4* __restrict__ copied) {
  rt::Arena arena;
  float* red_sum = arena.alloc_shared<float>(rt::reduce_scratch(NT));
  float* red_max = arena.alloc_shared<float>(rt::reduce_scratch(NT));
  float* seen = arena.alloc_shared<float>(4);  // 4: keeps 16-byte offsets
  int* ids = arena.alloc_shared<int>(NT);
  // A, B and B^T for the warp product: 16-byte aligned rows of 32 bytes
  __nv_bfloat16* sA = arena.alloc_shared<__nv_bfloat16>(3 * TILE);
  __nv_bfloat16* sB = sA + TILE;
  __nv_bfloat16* sBt = sB + TILE;
  const int team = rt::team_id(0), teams = rt::num_teams(0);
  const int tid = rt::thread_id();
  const rt::Range r = rt::static_partition(total, teams, team);
  if (tid == 0) {
    parts[2 * team] = r.lo;
    parts[2 * team + 1] = r.hi;
  }
  ids[tid] = team * NT + tid;
  recips[team * NT + tid] =
      rt::approx_reciprocal(static_cast<float>(team * NT + tid + 1));

  float sum = 0.f, mx = __int_as_float(static_cast<int>(0xff800000u));
  for (int i = r.lo + tid; i < r.hi; i += NT) {
    const int key = key_of(i);
    sum += key;
    mx = fmaxf(mx, static_cast<float>(key));
    rt::atomic_add(&counters[ADD], key);
    rt::atomic_max(&counters[MAX], key);
    rt::atomic_min(&counters[MIN], key);
    if (rt::atomic_cas(&counters[CAS], -1, i) == -1)
      rt::atomic_add(&counters[WINS], 1);
    rt::atomic_add(&counters[EXCH_OLDS],
                   rt::atomic_exchange(&counters[EXCH], key));
#if RT_SELFTEST_TARGET
    inc_olds[i] = rt::atomic_inc(inc, bound);
#endif
  }
  sum = rt::reduce_sum<NT>(sum, red_sum);
  mx = rt::reduce_max<NT>(mx, red_max);
  if (tid == 0) {
    team_sums[team] = sum;
    team_maxes[team] = mx;
    seen[0] = sum;
    seen[1] = mx;
  }
  rt::barrier();
  // every thread received the team's results, as thread 0 holds them
  if (sum != seen[0] || mx != seen[1])
    rt::atomic_add(&counters[REDUCE_ERRS], 1);
  // the reductions wrote their carve-out; this one must be untouched
  const int nb = (tid + 1) % NT;
  if (ids[nb] != team * NT + nb) rt::atomic_add(&counters[ARENA_ERRS], 1);
  for (int x = tid; x < TILE; x += NT) {
    const int i = x / 16, j = x % 16;
    sA[x] = __float2bfloat16(static_cast<float>(a_of(i, j)));
    sB[x] = __float2bfloat16(static_cast<float>(b_of(i, j)));
    sBt[x] = __float2bfloat16(static_cast<float>(b_of(j, i)));
  }
  rt::barrier();
  warp_product_check(sA, sB, sBt, counters);
#if RT_SELFTEST_TARGET
  // each thread stages its own 16 bytes and stores its neighbour's
  int4* stage = arena.alloc_shared<int4>(NT);
  rt::make_async_copy(&stage[tid], &src[team * NT + tid]);
  rt::wait_async_copies();
  rt::barrier();
  copied[team * NT + tid] = stage[nb];
#endif
}

}  // namespace

// Arena bytes: the two reductions' floats, 4 floats for thread 0's
// results, NT ids, the warp product's three bf16 tiles, then NT int4 of
// staging (16-byte aligned: 3 * 4 * 4 + 4 * 128 and 3 * 512 are
// multiples of 16).
extern "C" int rt_selftest(int teams, int total, unsigned bound, int* parts,
                           int* counters, unsigned* inc, unsigned* inc_olds,
                           float* team_sums, float* team_maxes,
                           float* recips, const void* src, void* copied,
                           void* stream) {
  if (teams <= 0) return cudaErrorInvalidValue;
  size_t bytes = (2 * rt::reduce_scratch(NT) + 4) * sizeof(float) +
                 NT * sizeof(int) + 3 * TILE * sizeof(__nv_bfloat16);
#if RT_SELFTEST_TARGET
  bytes += NT * sizeof(int4);
#endif
  selftest_kernel<<<teams, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      total, bound, parts, counters, inc, inc_olds, team_sums, team_maxes,
      recips, static_cast<const int4*>(src), static_cast<int4*>(copied));
  return cudaGetLastError();
}
