// Speculative paged flash decode: the K1 = k+1 query positions of each
// slot (the committed token and k drafts) verified against the paged
// cache in one launch, over bf16/f32 pools or quantized (int8, fp8-e4m3)
// pools with (Hkv, P) f32 scale pools.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/spec.py
// (spec_paged_decode_attention_fwd, body _spec_paged_decode_kernel, and
// its quantized mode).
//
// Bound on the H100: bytes.  Every live K/V row is read once for all
// K1 x group query rows of its kv head (20 rows at k = 4, group 4), so
// the work per byte is K1 times the one-token kernel's and still far
// below the tensor cores' ridge.  Design: as in the reference, the
// window positions are stacked into the group rows position-major
// (row r = qi * group + gi, decode_common.cuh `Rows`), so one CTA per
// (slot, kv head) and split reads each block once for every position:
// B4's split-KV kernel (split_paged_decode_kernel) at G_SPEC = 32 rows.
// Row r sees its own causal horizon base + 1 + r / group, which the
// wrapper computes (kernels/decode_attention/spec.py, spec_row_lengths)
// and the kernel keeps in shared memory; a CTA's live splits run from
// its rows' earliest window start to their largest horizon, and a split
// where a row sees nothing leaves it a partial the merge weighs 0.  The
// split count comes from the table's reach alone (spec.py), and one
// split keeps the unsplit kernel's arithmetic and bits.  KV is q's type
// (no scale pools) or a 1-byte type, dequantized with its page scales as
// B5 does.  Key and value head dims are equal (64, 128, 256), or MLA's
// 192 / 128: deepseek's group of 1 at K1 5 fills 5 of the G_SPEC rows.
#include "decode_common.cuh"

namespace {

template <typename T>
cudaError_t dispatch_kv(const repro::PagedArgs& a, int kv_dtype,
                        int q_dtype) {
  if (kv_dtype == q_dtype) {
    if (a.ks != nullptr) return cudaErrorInvalidValue;
    return repro::dispatch_split_paged_d<T, T, true>(a);
  }
  if (a.ks == nullptr) return cudaErrorInvalidValue;
  if (kv_dtype == repro::DTYPE_I8)
    return repro::dispatch_split_paged_d<T, int8_t, true>(a);
  if (kv_dtype == repro::DTYPE_FP8)
    return repro::dispatch_split_paged_d<T, __nv_fp8_e4m3, true>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// row_len (B, K1 * Hq / Hkv) int32: each stacked row's horizon.  chunk:
// logical rows a split, a whole number of pages; nsplit = max(1,
// ceil(t_cols * page_size / chunk)) <= MAX_SPLITS.  With nsplit > 1,
// part_acc (nsplit, B, K1, Hq, DV), part_m and part_l (nsplit, B, K1,
// Hq) are scratch and counters (B, Hkv) int32 must hold 0 (the kernel
// leaves them so).  dv: the value head dim (d where they are equal).
extern "C" int spec_paged_decode_attention_fwd(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* bt, const void* row_len, void* acc, void* m,
    void* l, void* part_acc, void* part_m, void* part_l, void* counters,
    int b, int k1, int hq, int hkv, int n_pages, int page_size, int t_cols,
    int d, int dv, int bk, int chunk, float scale, int window,
    float softcap, int q_dtype, int kv_dtype, void* stream) {
  const int n_rows = hkv > 0 ? k1 * (hq / hkv) : 0;
  repro::PagedArgs a{
      q, kp, vp, static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(bt), static_cast<const int*>(row_len), n_rows,
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), b, k1, hq, hkv, n_pages, page_size, t_cols, d,
      bk, scale, window, softcap, static_cast<cudaStream_t>(stream)};
  a.dv = dv;
  repro::set_splits(a, chunk, part_acc, part_m, part_l, counters);
  if (!repro::paged_args_ok<repro::G_SPEC>(a) ||
      !repro::split_paged_args_ok(a) || (ks == nullptr) != (vs == nullptr))
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (q_dtype == repro::DTYPE_F32)
    return dispatch_kv<float>(a, kv_dtype, q_dtype);
  if (q_dtype == repro::DTYPE_BF16)
    return dispatch_kv<__nv_bfloat16>(a, kv_dtype, q_dtype);
  return cudaErrorInvalidValue;
}
