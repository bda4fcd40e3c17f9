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
// the CTA reads its own table row (paged_decode_kernel in
// decode_common.cuh, shared with the quantized and the speculative
// kernels).  Every row of a CTA sees lengths[b] tokens.
#include "decode_common.cuh"

extern "C" int paged_decode_attention_fwd(
    const void* q, const void* kp, const void* vp, const void* bt,
    const void* lengths, void* acc, void* m, void* l, int b, int hq, int hkv,
    int n_pages, int page_size, int t_cols, int d, int bk, float scale,
    int window, float softcap, int dtype, void* stream) {
  constexpr int G = repro::G_DECODE;
  const repro::PagedArgs a{
      q, kp, vp, nullptr, nullptr, static_cast<const int*>(bt),
      static_cast<const int*>(lengths), 0, static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), b, 1, hq, hkv, n_pages,
      page_size, t_cols, d, bk, scale, window, softcap,
      static_cast<cudaStream_t>(stream)};
  if (!repro::paged_args_ok<G>(a)) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (dtype == repro::DTYPE_F32)
    return repro::dispatch_paged_d<float, float, G>(a);
  if (dtype == repro::DTYPE_BF16)
    return repro::dispatch_paged_d<__nv_bfloat16, __nv_bfloat16, G>(a);
  return cudaErrorInvalidValue;
}
