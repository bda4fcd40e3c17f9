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
// t * NT + j + 1, an integer, so the host can hold it to 1/x.  Built
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
  N_COUNTERS
};

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
// results, NT ids, then NT int4 of staging (16-byte aligned: 3 * 4 * 4
// + 4 * 128 is a multiple of 16).
extern "C" int rt_selftest(int teams, int total, unsigned bound, int* parts,
                           int* counters, unsigned* inc, unsigned* inc_olds,
                           float* team_sums, float* team_maxes,
                           float* recips, const void* src, void* copied,
                           void* stream) {
  if (teams <= 0) return cudaErrorInvalidValue;
  size_t bytes = (2 * rt::reduce_scratch(NT) + 4) * sizeof(float) +
                 NT * sizeof(int);
#if RT_SELFTEST_TARGET
  bytes += NT * sizeof(int4);
#endif
  selftest_kernel<<<teams, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      total, bound, parts, counters, inc, inc_olds, team_sums, team_maxes,
      recips, static_cast<const int4*>(src), static_cast<int4*>(copied));
  return cudaGetLastError();
}
