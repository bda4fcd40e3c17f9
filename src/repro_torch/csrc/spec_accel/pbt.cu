// 570.pbt (B17): batched tridiagonal solves by the Thomas algorithm.
// For each of nb systems of n unknowns (lower l, diagonal d, upper u,
// right-hand side r; rows of (nb, n) f32 arrays) the forward sweep
//   cp_0 = u_0 / d_0,  dp_0 = r_0 / d_0,
//   m = d_i - l_i cp_{i-1},  cp_i = u_i / m,  dp_i = (r_i - l_i dp_{i-1}) / m
// writes cp and dp to their (nb, n) outputs, as the reference's kernel
// does, and the back substitution x_{n-1} = dp_{n-1},
// x_i = dp_i - cp_i x_{i+1} reads them back.  The divisions are exact
// IEEE divisions, as the reference writes them: no __fdividef, no
// approximate reciprocal.
//
// Written once against the device runtime's facade and built twice
// (portable against rt/runtime.cuh, native with -DREPRO_RT_NATIVE
// against native/rt_native.cuh), as postencil.cu.
//
// Replaces the TPU kernel benchmarks/spec_accel.py:249 (pbt, body
// kern).  Its grid (1,) holds every system in one block, each sweep a
// loop over columns of the (nb, n) block; here a system is a thread.
//
// Bound on the H100: bytes, 28 an unknown (four inputs read, three
// outputs written) against about 8 flops and 2 divisions; this design
// moves 36 (cp and dp come back for the back substitution).  Design:
// one thread a system, NT systems a team, so the sweeps run in parallel
// over systems and in order along each, every system's arithmetic in
// the order of the formulas above.  A row's unknowns lie n floats from
// the next row's, so the team moves them through the arena in tiles of
// TC columns: a warp copies 128-byte runs of 4 rows (16 bytes a thread,
// rt::make_async_copy where the target has it), and each thread sweeps
// its own row of the tile, reading 4 columns of each operand at a time.
// A tile row's 16-byte chunks are swizzled by the row (tile_at), so the
// 8 threads of a quarter warp read 8 distinct bank groups.  The forward
// sweep writes cp and dp over u and r in the arena, and the team copies
// them out in 128-byte runs; the next tile's copies are in flight while
// a tile sweeps (two stages of the four operands, 64 KB a team, three
// teams an SM).  The back substitution walks the tiles from the last to
// the first, copying cp and dp back in while the tile after it sweeps,
// and writes x the same way.  Its steps are short, so each of its tiles
// waits about one round trip for its copies: tiles of 16 or 8 columns,
// with twice or four times the teams an SM, ran slower on the H100 at
// every number of systems (PERF.md §6, scripts/torch_pbt_scaling.py).  cp and dp go out and come back rather
// than stay in the arena: at n = 512 they take 4 KB a system, which
// would hold an SM to about 50 systems, two warps for a chain of 1,023
// dependent steps, and a system of any n would no longer fit.  Each
// thread reads back only the chunks it wrote out itself (the same
// mapping both ways), so no barrier orders another thread's global
// stores before its loads.  Rows that are not 16-byte aligned (n not a
// multiple of 4) take 4-byte loads and stores, 128 bytes of one row a
// warp, in the same tiles.
#include "common.cuh"
#if defined(REPRO_RT_NATIVE)
#include "native/rt_native.cuh"
#else
#include "rt/runtime.cuh"
#endif

namespace {

constexpr int NT = 64;             // systems a team, a thread each
constexpr int TC = 32;             // columns a tile: 128 bytes of a row
constexpr int CH = TC / 4;         // 16-byte chunks of a tile row
constexpr int RPL = 8 / CH;        // tile rows a 128-byte bank line holds
constexpr int SLOT = NT * TC;      // floats of one operand's tile
constexpr int STAGES = 2;          // the tile in use and the next one
constexpr size_t SMEM_BYTES = STAGES * 4 * SLOT * sizeof(float);
static_assert(CH * RPL == 8 && NT % 32 == 0, "whole bank lines, warps");

// The float offset of column c of row s in a tile: chunk c / 4 of the
// row sits at chunk position (c / 4) ^ ((s / RPL) % CH), so the 8 rows
// of a quarter warp's 16-byte reads of one chunk column hit 8 distinct
// bank groups.
__device__ __forceinline__ int tile_at(int s, int c) {
  return s * TC + (((c >> 2) ^ ((s / RPL) & (CH - 1))) << 2) + (c & 3);
}

// 16 bytes from global to the arena: asynchronously where the target
// has it, a plain load and store on the generic target.
template <typename E>
__device__ __forceinline__ void copy16(E* dst, const E* src) {
  if constexpr (rt::has_async_copy)
    rt::make_async_copy(dst, src);
  else
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

template <typename E>
__device__ __forceinline__ void copies_landed() {
  if constexpr (rt::has_async_copy) rt::wait_async_copies<E>();
}

// The rows and columns of one tile: rows [b0, b0 + NT) of nb, columns
// [c0, c0 + TC) of n.  Thread tid moves the same pieces whichever way
// it copies (VEC: 16-byte chunks, rows 16-byte aligned; else floats).
template <bool VEC>
struct TileMap {
  long long b0;
  int c0, nb, n;

  // global -> arena: `src` (nb, n) into `tile`
  __device__ __forceinline__ void in(float* tile, const float* src) const {
    const int tid = rt::thread_id();
    if constexpr (VEC) {
      for (int i = tid; i < NT * CH; i += NT) {
        const int s = i / CH, c = c0 + (i % CH) * 4;
        if (b0 + s < nb && c < n)
          copy16(tile + tile_at(s, c - c0),
                 src + static_cast<size_t>(b0 + s) * n + c);
      }
    } else {
      for (int i = tid; i < NT * TC; i += NT) {
        const int s = i / TC, c = c0 + i % TC;
        if (b0 + s < nb && c < n)
          tile[tile_at(s, c - c0)] = src[static_cast<size_t>(b0 + s) * n + c];
      }
    }
  }

  // arena -> global: `tile` into `dst` (nb, n)
  __device__ __forceinline__ void out(float* dst, const float* tile) const {
    const int tid = rt::thread_id();
    if constexpr (VEC) {
      for (int i = tid; i < NT * CH; i += NT) {
        const int s = i / CH, c = c0 + (i % CH) * 4;
        if (b0 + s < nb && c < n)
          *reinterpret_cast<float4*>(dst + static_cast<size_t>(b0 + s) * n +
                                     c) =
              *reinterpret_cast<const float4*>(tile + tile_at(s, c - c0));
      }
    } else {
      for (int i = tid; i < NT * TC; i += NT) {
        const int s = i / TC, c = c0 + i % TC;
        if (b0 + s < nb && c < n)
          dst[static_cast<size_t>(b0 + s) * n + c] = tile[tile_at(s, c - c0)];
      }
    }
  }
};

__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
pbt_kernel(const float* __restrict__ lo, const float* __restrict__ di,
           const float* __restrict__ up, const float* __restrict__ rh,
           float* __restrict__ x, float* __restrict__ cp,
           float* __restrict__ dp, int nb, int n) {
  rt::Arena arena;
  // stage st holds operand k's tile at tiles + (4 st + k) SLOT: l, d,
  // u (then cp), r (then dp); the back substitution writes x over l
  float* tiles = arena.alloc_shared<float>(STAGES * 4 * SLOT);
  auto slot = [&](int t, int k) { return tiles + ((t & 1) * 4 + k) * SLOT; };
  const int s = rt::thread_id();
  const long long b0 = static_cast<long long>(rt::team_id(0)) * NT;
  const bool live = b0 + s < nb;
  const int nt = (n + TC - 1) / TC;
  auto map = [&](int t) { return TileMap<VEC>{b0, t * TC, nb, n}; };

  // forward sweep: c, e are cp and dp of the previous column; column 0
  // takes l as 0, so m = d_0 and the numerators u_0, r_0, exactly
  float c = 0.f, e = 0.f;
  {
    const TileMap<VEC> m0 = map(0);
    m0.in(slot(0, 0), lo);
    m0.in(slot(0, 1), di);
    m0.in(slot(0, 2), up);
    m0.in(slot(0, 3), rh);
  }
  for (int t = 0; t < nt; ++t) {
    copies_landed<float>();
    rt::barrier();  // tile t landed; tile t - 1's stage is written out
    if (t + 1 < nt) {
      const TileMap<VEC> mn = map(t + 1);
      mn.in(slot(t + 1, 0), lo);
      mn.in(slot(t + 1, 1), di);
      mn.in(slot(t + 1, 2), up);
      mn.in(slot(t + 1, 3), rh);
    }
    const int cols = min(TC, n - t * TC);
    if (live) {
      for (int k = 0; 4 * k < cols; ++k) {
        const int at = tile_at(s, 4 * k);
        float lv[4], dv[4], uv[4], rv[4];
        load4(lv, slot(t, 0) + at);
        load4(dv, slot(t, 1) + at);
        load4(uv, slot(t, 2) + at);
        load4(rv, slot(t, 3) + at);
        if (t == 0 && k == 0) lv[0] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * k + j < cols) {
            const float m = dv[j] - lv[j] * c;
            c = uv[j] / m;
            e = (rv[j] - lv[j] * e) / m;
            uv[j] = c;
            rv[j] = e;
          }
        }
        store4(slot(t, 2) + at, uv);
        store4(slot(t, 3) + at, rv);
      }
    }
    rt::barrier();  // the tile's cp and dp are in the arena
    const TileMap<VEC> mt = map(t);
    mt.out(cp, slot(t, 2));
    mt.out(dp, slot(t, 3));
  }

  // back substitution: xv is x of the next column; column n - 1 takes
  // cp as 0, so x_{n-1} = dp_{n-1} exactly.  The last tile's cp and dp
  // are still in its stage.
  float xv = 0.f;
  for (int t = nt - 1; t >= 0; --t) {
    copies_landed<float>();
    rt::barrier();  // tile t landed; tile t + 1's x is written out
    if (t > 0) {
      const TileMap<VEC> mp = map(t - 1);
      mp.in(slot(t - 1, 2), cp);
      mp.in(slot(t - 1, 3), dp);
    }
    const int cols = min(TC, n - t * TC);
    if (live) {
      for (int k = (cols - 1) / 4; k >= 0; --k) {
        const int at = tile_at(s, 4 * k);
        float cv[4], ev[4], xs[4];
        load4(cv, slot(t, 2) + at);
        load4(ev, slot(t, 3) + at);
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          xs[j] = 0.f;
          if (4 * k + j < cols) {
            const float cj = t * TC + 4 * k + j == n - 1 ? 0.f : cv[j];
            xv = ev[j] - cj * xv;
            xs[j] = xv;
          }
        }
        store4(slot(t, 0) + at, xs);
      }
    }
    rt::barrier();  // the tile's x is in the arena
    map(t).out(x, slot(t, 0));
  }
}

template <bool VEC>
cudaError_t launch(const float* lo, const float* di, const float* up,
                   const float* rh, float* x, float* cp, float* dp, int nb,
                   int n, cudaStream_t stream) {
  static const cudaError_t attr =
      repro::allow_smem(pbt_kernel<VEC>, SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  pbt_kernel<VEC><<<(nb + NT - 1) / NT, NT, SMEM_BYTES, stream>>>(
      lo, di, up, rh, x, cp, dp, nb, n);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// nb systems of n unknowns, each row of (nb, n) f32 arrays; nb, n >= 1.
extern "C" int pbt_fwd(const float* lo, const float* di, const float* up,
                       const float* rh, float* x, float* cp, float* dp,
                       int nb, int n, void* stream) {
  if (nb <= 0 || n <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && aligned16(lo) && aligned16(di) &&
                   aligned16(up) && aligned16(rh) && aligned16(x) &&
                   aligned16(cp) && aligned16(dp);
  return vec ? launch<true>(lo, di, up, rh, x, cp, dp, nb, n, st)
             : launch<false>(lo, di, up, rh, x, cp, dp, nb, n, st);
}
