// Paged flash decode: as the dense decode kernel, with K/V gathered
// through per-row block tables from head-major page pools
// (Hkv, P, page_size, DK|DV); page 0 is the allocator's null page.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/paged.py
// (paged_decode_attention_fwd, body _paged_decode_kernel).
//
// Bound on the H100: bytes, as for dense decode, plus one table entry
// per page.  Design: the reference prefetches the block table as a
// scalar operand so the DMA engine can resolve pool[bt[b, page]]; here
// the CTA reads its own table row (paged_decode_kernel in
// decode_common.cuh, shared with the quantized and the speculative
// kernels).  Every row of a CTA sees lengths[b] tokens.  Key and value
// head dims are equal (64, 128, 256), or 192 / 128 for MLA, whose 16
// query heads sit one per kv head: 8 slots make 128 CTAs of 128
// threads, each scoring over 192 columns and writing 128.
#include "decode_common.cuh"

namespace {

template <typename T>
cudaError_t dispatch(const repro::PagedArgs& a) {
  constexpr int G = repro::G_DECODE;
  if (a.dv == a.d) return repro::dispatch_paged_d<T, T, G>(a);
  if (a.d == 192 && a.dv == 128)
    return repro::launch_paged<T, T, 192, 128, G, false>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_decode_attention_fwd(
    const void* q, const void* kp, const void* vp, const void* bt,
    const void* lengths, void* acc, void* m, void* l, int b, int hq, int hkv,
    int n_pages, int page_size, int t_cols, int d, int dv, int bk,
    float scale, int window, float softcap, int dtype, void* stream) {
  constexpr int G = repro::G_DECODE;
  repro::PagedArgs a{
      q, kp, vp, nullptr, nullptr, static_cast<const int*>(bt),
      static_cast<const int*>(lengths), 0, static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), b, 1, hq, hkv, n_pages,
      page_size, t_cols, d, bk, scale, window, softcap,
      static_cast<cudaStream_t>(stream)};
  a.dv = dv;
  if (!repro::paged_args_ok<G>(a)) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (dtype == repro::DTYPE_F32) return dispatch<float>(a);
  if (dtype == repro::DTYPE_BF16) return dispatch<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}
