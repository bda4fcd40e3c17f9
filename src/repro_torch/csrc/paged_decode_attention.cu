// Paged flash decode: as the dense decode kernel, with K/V gathered
// through per-row block tables from head-major page pools
// (Hkv, P, page_size, DK|DV); page 0 is the allocator's null page.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/paged.py
// (paged_decode_attention_fwd, body _paged_decode_kernel).
//
// Bound on the H100: bytes, as for dense decode, plus one table entry
// per page.  Design: split-KV, as B3's (split_paged_decode_kernel in
// decode_common.cuh).  The grid is (Hkv, B, nsplit): CTA (h, b, j)
// walks logical rows [j * chunk, (j + 1) * chunk) of its slot's table,
// chunk a whole number of pages, for all G = Hq / Hkv query heads of
// the group, so each K/V row is read once.  The reference prefetches
// the block table as a scalar operand so the DMA engine can resolve
// pool[bt[b, page]]; here the CTA reads its own table row, a block's
// entry two blocks ahead, and cp.async stages K and V in their storage
// type, the next block's copy in flight while this one computes.  The
// host picks nsplit from the table's reach (t_cols x page_size) alone
// (kernels/decode_attention/decode_attention.py, paged_splits), never
// from lengths, which live on the card; a split past lengths[b] or
// wholly outside the window returns at once.  A row with one live split
// stores its result directly, so a one-split launch is one walk over
// the whole row; with several, the last live split to arrive merges the
// partials in split order and resets its counter, inside the same
// launch.  The quantized (B5), speculative (B6) and sliding-window (B7,
// B7q: ring walks) kernels run the same body over their pools and rows.
// Key and value head dims are equal (64, 128, 256), or 192 / 128 for
// MLA, whose 16 query heads sit one per kv head: 8 slots make 128 CTAs a
// split of 128 threads, each scoring over 192 columns and writing 128.
#include "decode_common.cuh"

// chunk: logical rows a split, a whole number of pages; nsplit =
// max(1, ceil(t_cols * page_size / chunk)) <= MAX_SPLITS.  With nsplit
// > 1, part_acc (nsplit, B, Hq, DV), part_m and part_l (nsplit, B, Hq)
// are scratch and counters (B, Hkv) int32 must hold 0 (the kernel
// leaves them so).
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* kp, const void* vp, const void* bt,
    const void* lengths, void* acc, void* m, void* l, void* part_acc,
    void* part_m, void* part_l, void* counters, int b, int hq, int hkv,
    int n_pages, int page_size, int t_cols, int d, int dv, int bk,
    int chunk, float scale, int window, float softcap, int dtype,
    void* stream) {
  constexpr int G = repro::G_DECODE;
  repro::PagedArgs a{
      q, kp, vp, nullptr, nullptr, static_cast<const int*>(bt),
      static_cast<const int*>(lengths), 0, static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), b, 1, hq, hkv, n_pages,
      page_size, t_cols, d, bk, scale, window, softcap,
      static_cast<cudaStream_t>(stream)};
  a.dv = dv;
  repro::set_splits(a, chunk, part_acc, part_m, part_l, counters);
  if (!repro::paged_args_ok<G>(a) || !repro::split_paged_args_ok(a))
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (dtype == repro::DTYPE_F32)
    return repro::dispatch_split_paged_d<float, float>(a);
  if (dtype == repro::DTYPE_BF16)
    return repro::dispatch_split_paged_d<__nv_bfloat16, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}
