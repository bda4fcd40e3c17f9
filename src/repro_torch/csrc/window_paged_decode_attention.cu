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
// with first = max(L - window, 0) // ps; here each CTA reads its ring
// row the same way, in timeline order from the window's first live page
// (kernels/decode_attention/paged.py, ring_walk, lays the same walk out
// for the plain version and the CPU tests check it against the
// reference's index map), so the wrapper launches nothing but the
// kernel.  The body is B4's split-KV kernel (split_paged_decode_kernel
// in decode_common.cuh) in its RING form: the grid is (Hkv, B, nsplit),
// and CTA (h, b, j) walks tokens [lo + j * chunk, lo + (j + 1) * chunk)
// of its slot's walk, lo = first * ps the walk's first token and chunk a
// whole number of pages, for all Hq / Hkv query heads of the group,
// staging K and V in their storage type with the next block's copy in
// flight.  The host picks nsplit from the ring's width (T_w x ps) alone
// (paged.split_plan), never from lengths, which live on the card; a
// split wholly before the window or at or past L returns at once, so
// the stale or null columns past the live window are never read, and
// the window mask trims the first page.  A row with one live split
// stores its result directly (a one-split launch is one walk over the
// whole window); with several, the last live split to arrive merges the
// partials in split order.  The unnormalized residuals (acc, m, l) are
// B4's.
#include "decode_common.cuh"

// The entry point takes the quantized window kernel's arguments (the
// wrapper launches either through one call); the scale pools must be
// null and the pools of the query's type here.  bt: the ring tables (B,
// t_cols).  chunk: logical rows a split from the walk's first token, a
// whole number of pages; nsplit = max(1, ceil(t_cols * page_size /
// chunk)) <= MAX_SPLITS.  With nsplit > 1, part_acc (nsplit, B, Hq, D),
// part_m and part_l (nsplit, B, Hq) are scratch and counters (B, Hkv)
// int32 must hold 0 (the kernel leaves them so).
extern "C" int window_paged_decode_attention_fwd(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* bt, const void* lengths, void* acc, void* m,
    void* l, void* part_acc, void* part_m, void* part_l, void* counters,
    int b, int hq, int hkv, int n_pages, int page_size,
    int t_cols, int d, int bk, int chunk, float scale, int window,
    float softcap, int dtype, int kv_dtype, void* stream) {
  repro::PagedArgs a{
      q, kp, vp, nullptr, nullptr, static_cast<const int*>(bt),
      static_cast<const int*>(lengths), 0, static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), b, 1, hq, hkv, n_pages,
      page_size, t_cols, d, bk, scale, window, softcap,
      static_cast<cudaStream_t>(stream)};
  repro::set_splits(a, chunk, part_acc, part_m, part_l, counters);
  if (!repro::paged_args_ok<repro::G_DECODE>(a) ||
      !repro::split_paged_args_ok(a) || window <= 0 ||
      ks != nullptr || vs != nullptr || kv_dtype != dtype)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (dtype == repro::DTYPE_F32)
    return repro::dispatch_split_paged_d<float, float, false, true>(a);
  if (dtype == repro::DTYPE_BF16)
    return repro::dispatch_split_paged_d<__nv_bfloat16, __nv_bfloat16, false,
                                         true>(a);
  return cudaErrorInvalidValue;
}
