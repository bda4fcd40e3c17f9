// 504.polbm (B13): one D2Q9 lattice-Boltzmann step on an (h, w, 9) f32
// lattice: the BGK collision (tau = 0.6) of each cell, then streaming,
// periodic: the collided value of plane k at cell (i, j) lands at
// ((i + cx_k) mod h, (j + cy_k) mod w), cx moving axis 0.
//
// Written once against the device runtime's facade and built twice
// (portable against rt/runtime.cuh, native with -DREPRO_RT_NATIVE
// against native/rt_native.cuh), as postencil.cu.
//
// Replaces the TPU kernel benchmarks/spec_accel.py:101 (polbm, body
// kern), and the nine jnp.roll calls and the stack that follow it there:
// as separate passes they would be ten launches and two more trips over
// the lattice, more than the collision itself.
//
// Bound on the H100: bytes.  Each cell's 36 bytes are read once and
// written once for about 185 flops (11 of them divisions), below the f32
// ridge of 20 flops a byte.  Design: streaming as a pull, out(i, j, k) =
// collide(f)((i - cx_k) mod h, (j - cy_k) mod w)[k], so that both sides
// move whole rows.  A team owns a tile of R rows x C cells of the output.
// It copies the source cells the tile pulls from, the tile with a halo of
// one row above and below and HALO = 4 cells left and right (one is
// needed; four keep each staged row segment 16-byte aligned, since 4
// cells are 144 bytes), into the shared arena in the lattice's own
// layout, 9 floats a cell (9 is prime to the 32 banks, so a thread's
// reads of its own cell do not conflict): 16-byte copies
// (rt::make_async_copy where the target has it) where w is a multiple of
// 4, 4-byte ones otherwise.  Every cell the tile pulls from, (R + 2) x
// (C + 2) of them, collides in place in the arena, with the arithmetic
// of the reference (sums over k in order, a division by rho and by 0.6,
// no reciprocal).  Then the team writes the tile's output rows as
// contiguous 16-byte stores (4-byte ones where w is not a multiple of
// 4), each float gathered from its plane's source cell in the arena.
#include "common.cuh"
#if defined(REPRO_RT_NATIVE)
#include "native/rt_native.cuh"
#else
#include "rt/runtime.cuh"
#endif

namespace {

constexpr int Q = 9, NT = 256;
constexpr int R = 16, C = 64;        // output rows and cells of a tile
constexpr int HALO = 4;              // staged cells left and right
constexpr int SR = R + 2, SC = C + 2 * HALO;  // staged rows and cells
constexpr size_t SMEM_BYTES = SR * SC * Q * sizeof(float);
// The reference's _D2Q9 (cx, cy) + 1, two bits a velocity k at bit 2 k:
// cx {0, 1, -1, 0, 0, 1, -1, 1, -1}, cy {0, 0, 0, 1, -1, 1, -1, -1, 1}.
constexpr unsigned CX = 1u | 2u << 2 | 0u << 4 | 1u << 6 | 1u << 8 |
                        2u << 10 | 0u << 12 | 2u << 14 | 0u << 16;
constexpr unsigned CY = 1u | 1u << 2 | 1u << 4 | 2u << 6 | 0u << 8 |
                        2u << 10 | 0u << 12 | 0u << 14 | 2u << 16;
static_assert(64 % R == 0, "R divides h, a multiple of 64");
static_assert(C % 4 == 0, "whole 16-byte vectors of a staged row");

__device__ __forceinline__ int velocity(unsigned packed, int k) {
  return static_cast<int>((packed >> (2 * k)) & 3u) - 1;
}

// x in [-n, 2 n) to [0, n)
__device__ __forceinline__ int wrap(int x, int n) {
  return x < 0 ? x + n : x >= n ? x - n : x;
}

// The collided values of the cell's 9 floats, in place: rho, u_x, u_y
// and feq exactly as the reference writes them.
__device__ __forceinline__ void collide(float* cell) {
  // the reference's _D2Q9 and _W9 (f32 of 4/9, 1/9, 1/36)
  const int dx[Q] = {0, 1, -1, 0, 0, 1, -1, 1, -1};
  const int dy[Q] = {0, 0, 0, 1, -1, 1, -1, -1, 1};
  const float wq[Q] = {0.4444444477558136f, 0.1111111119389534f,
                       0.1111111119389534f, 0.1111111119389534f,
                       0.1111111119389534f, 0.02777777798473835f,
                       0.02777777798473835f, 0.02777777798473835f,
                       0.02777777798473835f};
  float fl[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) fl[k] = cell[k];

  float rho = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    rho += fl[k];
    sx += fl[k] * static_cast<float>(dx[k]);
    sy += fl[k] * static_cast<float>(dy[k]);
  }
  const float ux = sx / rho, uy = sy / rho;
  const float usq = ux * ux + uy * uy;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const float cu = static_cast<float>(dx[k]) * ux +
                     static_cast<float>(dy[k]) * uy;
    const float feq =
        rho * wq[k] * (1.f + 3.f * cu + 4.5f * cu * cu - 1.5f * usq);
    cell[k] = fl[k] - (fl[k] - feq) / 0.6f;
  }
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

// The arena float of plane k pulled into the tile's cell (r, c).
__device__ __forceinline__ float pulled(const float* tile, int r, int c,
                                        int k) {
  return tile[((r + 1 - velocity(CX, k)) * SC + HALO + c -
               velocity(CY, k)) * Q + k];
}

// VEC: w a multiple of 4, f and out 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(NT)
polbm_kernel(const float* __restrict__ f, float* __restrict__ out, int h,
             int w) {
  rt::Arena arena;
  // staged cell (sr, sc) at tile + (sr SC + sc) Q: the source cell
  // ((i0 - 1 + sr) mod h, (j0 - HALO + sc) mod w)
  float* tile = arena.alloc_shared<float>(SR * SC * Q);
  const int tid = rt::thread_id();
  const int tiles_w = (w + C - 1) / C;
  const int team = static_cast<int>(rt::team_id(0));
  const int i0 = team / tiles_w * R, j0 = team % tiles_w * C;
  const int cols = min(C, w - j0);  // a multiple of 4 where VEC

  if constexpr (VEC) {
    // 4-cell groups of a staged row, 9 vectors each; the groups that
    // hold the columns HALO - 1 .. HALO + cols
    constexpr int VR = Q * SC / 4;
    const int live = Q * (cols / 4 + 2);
    for (int v = tid; v < SR * VR; v += NT) {
      const int sr = v / VR, x = v - sr * VR;
      if (x < live) {
        const int g = x / Q, p = x - g * Q;
        const int i = wrap(i0 - 1 + sr, h), j = wrap(j0 - HALO + 4 * g, w);
        copy16(tile + (sr * SC + 4 * g) * Q + 4 * p,
               f + (static_cast<size_t>(i) * w + j) * Q + 4 * p);
      }
    }
    copies_landed<float>();
  } else {
    // the floats of the columns HALO - 1 .. HALO + cols of each row
    constexpr int FR = Q * (C + 2);
    for (int e = tid; e < SR * FR; e += NT) {
      const int sr = e / FR, x = e - sr * FR;
      const int c = x / Q, k = x - c * Q;
      if (c < cols + 2) {
        const int i = wrap(i0 - 1 + sr, h), j = wrap(j0 - 1 + c, w);
        tile[(sr * SC + HALO - 1 + c) * Q + k] =
            f[(static_cast<size_t>(i) * w + j) * Q + k];
      }
    }
  }
  rt::barrier();  // the source cells landed

  for (int e = tid; e < SR * (C + 2); e += NT) {
    const int sr = e / (C + 2), c = e - sr * (C + 2);
    if (c < cols + 2) collide(tile + (sr * SC + HALO - 1 + c) * Q);
  }
  rt::barrier();  // every source cell collided

  if constexpr (VEC) {
    // output row r of the tile: 9 cols floats from (i0 + r, j0), 16-byte
    // aligned since i w + j0 is a multiple of 4
    constexpr int VO = Q * C / 4;
    const int live = Q * cols / 4;
    for (int v = tid; v < R * VO; v += NT) {
      const int r = v / VO, x = v - r * VO;
      if (x < live) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 4 * x + e, c = q / Q;
          o[e] = pulled(tile, r, c, q - c * Q);
        }
        *reinterpret_cast<float4*>(
            out + (static_cast<size_t>(i0 + r) * w + j0) * Q + 4 * x) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  } else {
    constexpr int FO = Q * C;
    for (int e = tid; e < R * FO; e += NT) {
      const int r = e / FO, x = e - r * FO;
      if (x < Q * cols) {
        const int c = x / Q;
        out[(static_cast<size_t>(i0 + r) * w + j0) * Q + x] =
            pulled(tile, r, c, x - c * Q);
      }
    }
  }
}

template <bool VEC>
cudaError_t launch(const float* f, float* out, int h, int w,
                   cudaStream_t stream) {
  static const cudaError_t attr =
      repro::allow_smem(polbm_kernel<VEC>, SMEM_BYTES);
  if (attr != cudaSuccess) return attr;
  const long long teams = static_cast<long long>(h / R) * ((w + C - 1) / C);
  polbm_kernel<VEC><<<static_cast<unsigned>(teams), NT, SMEM_BYTES,
                      stream>>>(f, out, h, w);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One step of an (h, w, 9) lattice, h a multiple of 64; f and out must
// not overlap.
extern "C" int polbm_step(const float* f, float* out, int h, int w,
                          void* stream) {
  if (h <= 0 || w <= 0 || h % R != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w % 4 == 0 && aligned16(f) && aligned16(out)
             ? launch<true>(f, out, h, w, st)
             : launch<false>(f, out, h, w, st);
}
