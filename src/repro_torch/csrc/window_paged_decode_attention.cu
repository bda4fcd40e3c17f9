// Sliding-window paged flash decode: one new query token per slot
// against the live window of a head-major page pool (Hkv, P, ps, D),
// gathered through the slot's ring block table, whose width T_w =
// (window - 1) // ps + 2 stays O(window) however long the context ran.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/paged.py
// (window_paged_decode_attention_fwd, body _window_paged_decode_kernel).
//
// Bound on the H100: bytes, as for the prefix-table kernel, but only
// the window's live rows are read: at most `window` tokens per slot and
// kv head, plus one table entry per live page.  Design: the reference's
// index maps read column (first + ik // spp) % T_w of the ring table,
// with first = max(L - window, 0) // ps.  Here the wrapper lays the
// ring out once per launch in timeline order (ring_walk in
// kernels/decode_attention/paged.py, the helper the CPU tests check
// against the reference's index map) and hands the kernel that walk
// and start = first * ps; the body is the paged decode template
// (decode_common.cuh) in its RING mode: one CTA per (slot, kv head)
// walks its pages from start up to L, the window mask trims the first
// page, and blocks at or past L are never read.  The unnormalized
// residuals (acc, m, l) are B4's.
#include "decode_common.cuh"

// The entry point takes the quantized window kernel's arguments (the
// wrapper launches either through one call); the scale pools must be
// null and the pools of the query's type here.
extern "C" int window_paged_decode_attention_fwd(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* walk, const void* start, const void* lengths,
    void* acc, void* m, void* l, int b, int hq, int hkv, int n_pages,
    int page_size, int t_cols, int d, int bk, float scale, int window,
    float softcap, int dtype, int kv_dtype, void* stream) {
  constexpr int G = repro::G_DECODE;
  repro::PagedArgs a{
      q, kp, vp, nullptr, nullptr, static_cast<const int*>(walk),
      static_cast<const int*>(lengths), 0, static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), b, 1, hq, hkv, n_pages,
      page_size, t_cols, d, bk, scale, window, softcap,
      static_cast<cudaStream_t>(stream)};
  a.start = static_cast<const int*>(start);
  if (!repro::paged_args_ok<G>(a) || window <= 0 || a.start == nullptr ||
      ks != nullptr || vs != nullptr || kv_dtype != dtype)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (dtype == repro::DTYPE_F32)
    return repro::dispatch_paged_d<float, float, G, true>(a);
  if (dtype == repro::DTYPE_BF16)
    return repro::dispatch_paged_d<__nv_bfloat16, __nv_bfloat16, G, true>(a);
  return cudaErrorInvalidValue;
}
