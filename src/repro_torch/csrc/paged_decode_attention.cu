// Paged flash decode: as the dense decode kernel, with K/V gathered
// through per-row block tables from head-major page pools
// (Hkv, P, page_size, D); page 0 is the allocator's null page.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/paged.py
// (paged_decode_attention_fwd, body _paged_decode_kernel).
//
// Bound on the H100: bytes, as for dense decode, plus one table entry
// per page.  Design: the reference prefetches the block table as a
// scalar operand so the DMA engine can resolve pool[bt[b, page]]; here
// the CTA reads its own table row.  Logical page ik // spp of row b maps
// to physical page bt[b, ik // spp], and its block_kv-token sub-block is
// a contiguous run of rows, so the block update of decode_common.cuh
// runs unchanged.  block_kv divides page_size (the wrapper clamps it), so
// no block spans two pages.  A table entry outside the pool reads the
// null page instead of out-of-bounds memory.
#include "decode_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ lengths, float* acc_out,
                    float* m_out, float* l_out, int hq, int hkv, int n_pages,
                    int page_size, int t_cols, int bk, float scale,
                    int window, float softcap) {
  extern __shared__ float smem[];
  const repro::DecodeSmem<D> sm(smem);
  const int h = blockIdx.x, b = blockIdx.y, g = hq / hkv;
  const size_t row0 = static_cast<size_t>(b) * hq + h * g;
  float acc[repro::G_MAX];
  repro::decode_init<T, D>(sm, q + row0 * D, g, scale, acc);
  const int length = min(lengths[b], t_cols * page_size);
  const int* row = bt + static_cast<size_t>(b) * t_cols;
  for (int k0 = 0; k0 < length; k0 += bk) {
    int page = row[k0 / page_size];
    if (page < 0 || page >= n_pages) page = 0;
    const size_t off =
        ((static_cast<size_t>(h) * n_pages + page) * page_size + k0 % page_size) * D;
    repro::decode_block<T, D>(sm, kp + off, vp + off, bk, k0, length, g,
                              window, softcap, acc);
  }
  repro::decode_store<D>(sm, acc, g, row0, acc_out, m_out, l_out);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* lengths, float* acc, float* m,
                   float* l, int b, int hq, int hkv, int n_pages,
                   int page_size, int t_cols, int bk, float scale, int window,
                   float softcap, cudaStream_t stream) {
  const size_t bytes = repro::decode_smem_floats<D>() * sizeof(float);
  static const cudaError_t attr =
      repro::allow_smem(paged_decode_kernel<T, D>, bytes);
  if (attr != cudaSuccess) return attr;
  paged_decode_kernel<T, D><<<dim3(hkv, b), D, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, lengths, acc, m, l, hq, hkv, n_pages,
      page_size, t_cols, bk, scale, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* kp, const void* vp,
                       const int* bt, const int* lengths, float* acc,
                       float* m, float* l, int b, int hq, int hkv,
                       int n_pages, int page_size, int t_cols, int bk,
                       float scale, int window, float softcap,
                       cudaStream_t stream) {
  if (d == 64)
    return launch<T, 64>(q, kp, vp, bt, lengths, acc, m, l, b, hq, hkv,
                         n_pages, page_size, t_cols, bk, scale, window,
                         softcap, stream);
  if (d == 128)
    return launch<T, 128>(q, kp, vp, bt, lengths, acc, m, l, b, hq, hkv,
                          n_pages, page_size, t_cols, bk, scale, window,
                          softcap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_decode_attention_fwd(
    const void* q, const void* kp, const void* vp, const void* bt,
    const void* lengths, void* acc, void* m, void* l, int b, int hq, int hkv,
    int n_pages, int page_size, int t_cols, int d, int bk, float scale,
    int window, float softcap, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > repro::G_MAX || bk < 1 ||
      bk > repro::BK_MAX || page_size % bk != 0 || n_pages < 1)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* table = static_cast<const int*>(bt);
  const int* len = static_cast<const int*>(lengths);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (dtype == repro::DTYPE_F32)
    return dispatch_d<float>(d, q, kp, vp, table, len, a, mm, ll, b, hq, hkv,
                             n_pages, page_size, t_cols, bk, scale, window,
                             softcap, st);
  if (dtype == repro::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(d, q, kp, vp, table, len, a, mm, ll, b,
                                     hq, hkv, n_pages, page_size, t_cols, bk,
                                     scale, window, softcap, st);
  return cudaErrorInvalidValue;
}
