// Dense flash decode: one new query token per batch row against a
// dense KV cache (B, Hkv, S, DK|DV); returns the unnormalized residuals
// (acc (B, Hq, DV), m, l) in f32.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/
// decode_attention.py (decode_attention_fwd, body _decode_kernel +
// flash_decode_step).
//
// Bound on the H100: bytes.  Every live K/V row is read once and used
// for G = Hq / Hkv dot products (about 1 flop per byte in bf16).
// Design: split-KV.  The grid is (Hkv, B, nsplit): CTA (h, b, j) walks
// rows [j * chunk, (j + 1) * chunk) of its slot's cache in 64-token
// blocks up to lengths[b] (decode_common.cuh, split_block), for all G
// query heads of the group, so each K/V row is read once.  The host
// picks nsplit from the cache's length alone (kernels/decode_attention/
// decode_attention.py, decode_splits), never from lengths, which live on
// the card; a split past lengths[b] or wholly outside the window is
// empty and returns at once.  A row with one live split stores its
// result directly, with the unsplit kernel's arithmetic, so a one-split
// launch gives that kernel's bits.  With several, each live split
// stores its partial (acc, m, l), fences, and counts itself in
// counters[b, h]; the last to arrive merges the partials in split order
// (split_merge: the reference's combine_partials in residual form) and
// resets the counter to 0 for the next launch.  So B3 stays one grid,
// one launch, whose result does not depend on which CTA finishes last;
// the counters belong to one stream at a time (the wrapper keeps one
// zeroed buffer per device, and the port launches on one stream).
// K and V are staged in their storage type by cp.async, the next
// block's copy in flight while this one computes.  Shared memory a CTA
// (split_smem_bytes), and CTAs it lets an SM hold: bf16 at 128, 71,792
// bytes at G 8 (jamba) and 68,672 at G 4 (granite): 3; bf16 at 256,
// 133,672 at G 2 (gemma2): 1; bf16 MLA 192/128, 82,972 at G 1
// (deepseek): 2; bf16 at 64, 36,976 at G 8: 6; f32 at 128, 137,328 at
// G 8: 1; f32 at 256 (one stage), 141,424 at G 8: 1.  Key and value
// head dims are equal (64, 128, 256) or, for MLA, 192 and 128: a CTA
// then has 128 threads that score over 192 columns.
#include "decode_common.cuh"

namespace {

template <typename T, int DK, int DV, int G>
__global__ void __launch_bounds__(DV)
split_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ lengths,
                    float* acc_out, float* m_out, float* l_out,
                    float* part_acc, float* part_m, float* part_l,
                    int* counters, int hq, int hkv, int s, int bk, int chunk,
                    float scale, int window, float softcap) {
  using Smem = repro::SplitSmem<T, DK, DV, G>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm(smem);
  const int h = blockIdx.x, b = blockIdx.y, j = blockIdx.z, g = hq / hkv;
  const repro::Rows<G> rows{static_cast<size_t>(b) * hq + h * g, g, hq, g};
  const int length = min(lengths[b], s);
  const repro::SplitRange live(length, window, chunk);
  if (live.live() == 0) {
    repro::split_store_empty<DV>(j, rows, acc_out, m_out, l_out);
    return;
  }
  if (j < live.lo || j >= live.hi) return;  // an empty split
  const size_t base = static_cast<size_t>(b * hkv + h) * s;  // row 0
  const int k_begin = j * chunk, k_end = min(k_begin + chunk, length);
  const int nblk = (k_end - k_begin + bk - 1) / bk;
  auto stage = [&](int ib) {
    const int k0 = k_begin + ib * bk;
    repro::split_stage<T, DK, DV, G>(sm, ib % Smem::STAGES,
                                     kc + (base + k0) * DK,
                                     vc + (base + k0) * DV, min(bk, s - k0));
  };
  stage(0);  // in flight while the query rows are staged
  float acc[G];
  repro::split_init<T, DK, DV, G>(sm, q, rows, scale, acc);
  for (int ib = 0; ib < nblk; ++ib) {
    repro::cp_async_wait_all();
    __syncthreads();  // the block has landed; the last one's readers are done
    if (Smem::STAGES == 2 && ib + 1 < nblk) stage(ib + 1);
    const int k0 = k_begin + ib * bk;
    repro::split_block<T, DK, DV, G>(sm, ib % Smem::STAGES, min(bk, s - k0),
                                     k0, g, length, window, softcap, acc);
    if (Smem::STAGES == 1 && ib + 1 < nblk) {
      __syncthreads();
      stage(ib + 1);
    }
  }
  repro::split_finish<T, DK, DV, G>(sm, acc, j, rows,
                                    static_cast<size_t>(gridDim.y) * hq,
                                    live, counters + b * hkv + h, acc_out,
                                    m_out, l_out, part_acc, part_m, part_l);
}

struct Args {
  const void *q, *kc, *vc;
  const int* lengths;
  float *acc, *m, *l, *part_acc, *part_m, *part_l;
  int* counters;
  int b, hq, hkv, s, bk, chunk, nsplit;
  float scale;
  int window;
  float softcap;
  cudaStream_t stream;
};

template <typename T, int DK, int DV, int G>
cudaError_t launch(const Args& a) {
  const size_t bytes = repro::split_smem_bytes<T, DK, DV, G>();
  static const cudaError_t attr =
      repro::allow_smem(split_decode_kernel<T, DK, DV, G>, bytes);
  if (attr != cudaSuccess) return attr;
  split_decode_kernel<T, DK, DV, G>
      <<<dim3(a.hkv, a.b, a.nsplit), DV, bytes, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.kc),
          static_cast<const T*>(a.vc), a.lengths, a.acc, a.m, a.l,
          a.part_acc, a.part_m, a.part_l, a.counters, a.hq, a.hkv, a.s, a.bk,
          a.chunk, a.scale, a.window, a.softcap);
  return cudaGetLastError();
}

// The group's rows, rounded up to a build: 1, 2, 4 or 8.
template <typename T, int DK, int DV>
cudaError_t dispatch_g(const Args& a) {
  const int g = a.hq / a.hkv;
  if (g <= 1) return launch<T, DK, DV, 1>(a);
  if (g <= 2) return launch<T, DK, DV, 2>(a);
  if (g <= 4) return launch<T, DK, DV, 4>(a);
  return launch<T, DK, DV, 8>(a);
}

template <typename T>
cudaError_t dispatch_d(int d, int dv, const Args& a) {
  if (d == 192 && dv == 128) return dispatch_g<T, 192, 128>(a);  // MLA
  if (dv != d) return cudaErrorInvalidValue;
  if (d == 64) return dispatch_g<T, 64, 64>(a);
  if (d == 128) return dispatch_g<T, 128, 128>(a);
  if (d == 256) return dispatch_g<T, 256, 256>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// chunk: cache rows a split, a whole number of bk-token blocks; nsplit
// = ceil(s / chunk) <= MAX_SPLITS.  With nsplit > 1, part_acc (nsplit,
// B, Hq, DV), part_m and part_l (nsplit, B, Hq) are scratch and
// counters (B, Hkv) int32 must hold 0 (the kernel leaves them so).
extern "C" int decode_attention_fwd(const void* q, const void* kc,
                                    const void* vc, const void* lengths,
                                    void* acc, void* m, void* l,
                                    void* part_acc, void* part_m,
                                    void* part_l, void* counters, int b,
                                    int hq, int hkv, int s, int d, int dv,
                                    int bk, int chunk, float scale,
                                    int window, float softcap, int dtype,
                                    void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > repro::G_DECODE || bk < 1 ||
      bk > repro::BK_MAX || s < 1 || chunk < bk || chunk % bk != 0)
    return cudaErrorInvalidValue;
  const int nsplit = (s + chunk - 1) / chunk;
  if (nsplit > repro::MAX_SPLITS ||
      (nsplit > 1 && (part_acc == nullptr || part_m == nullptr ||
                      part_l == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const Args a{q, kc, vc, static_cast<const int*>(lengths),
               static_cast<float*>(acc), static_cast<float*>(m),
               static_cast<float*>(l), static_cast<float*>(part_acc),
               static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<int*>(counters), b, hq, hkv, s, bk, chunk, nsplit,
               scale, window, softcap, static_cast<cudaStream_t>(stream)};
  if (dtype == repro::DTYPE_F32) return dispatch_d<float>(d, dv, a);
  if (dtype == repro::DTYPE_BF16) return dispatch_d<__nv_bfloat16>(d, dv, a);
  return cudaErrorInvalidValue;
}
