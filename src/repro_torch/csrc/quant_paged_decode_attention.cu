// Quantized paged flash decode: the paged decode kernel over int8 or
// fp8-e4m3 page pools (Hkv, P, page_size, D), each (head, page) block
// scaled by one f32 from the (Hkv, P) scale pools.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/paged.py
// (paged_decode_attention_fwd with k_scales / v_scales, wrapped as
// quant.py:27 quant_paged_decode_attention_fwd).
//
// Bound on the H100: bytes, half of the bf16 kernel's: one byte per K/V
// element plus one f32 scale per (head, page) for each pool.  Design:
// B4's split-KV kernel (split_paged_decode_kernel in decode_common.cuh)
// with KV the pool's 1-byte type.  The grid is (Hkv, B, nsplit), chunks
// of whole pages of each slot's table picked from the table's reach
// alone (kernels/decode_attention/decode_attention.py, paged_splits);
// a one-split launch keeps the unsplit kernel's arithmetic and bits,
// and several merge in split order inside the launch.  The reference
// rides the scale block on the same block-table index map as its K/V
// block and multiplies after the DMA; here the CTA reads scales[h * P +
// page] of the next block with its table entry, while this block
// computes, and cp.async stages the bytes as they are stored, 16
// elements a copy (half the copies of bf16).  split_block dequantizes
// each element as to_f32(x) * scale before any dot or P V product
// (decode_attention.py:69-72).  A 64-wide key of 1-byte storage is four
// 16-byte chunks, and MLA's 192-wide one twelve, so the stage's swizzle
// spreads 4 tokens, not 8.  Key and value head dims are equal (64, 128,
// 256), or MLA's 192 / 128 (deepseek's 16 heads, one query head a kv
// head).
#include "decode_common.cuh"

namespace {

template <typename T>
cudaError_t dispatch_kv(const repro::PagedArgs& a, int kv_dtype) {
  if (kv_dtype == repro::DTYPE_I8)
    return repro::dispatch_split_paged_d<T, int8_t>(a);
  if (kv_dtype == repro::DTYPE_FP8)
    return repro::dispatch_split_paged_d<T, __nv_fp8_e4m3>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// chunk: logical rows a split, a whole number of pages; nsplit =
// max(1, ceil(t_cols * page_size / chunk)) <= MAX_SPLITS.  With nsplit
// > 1, part_acc (nsplit, B, Hq, DV), part_m and part_l (nsplit, B, Hq)
// are scratch and counters (B, Hkv) int32 must hold 0 (the kernel
// leaves them so).  dv: the value head dim (d where they are equal).
extern "C" int quant_paged_decode_attention_fwd(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* bt, const void* lengths, void* acc, void* m,
    void* l, void* part_acc, void* part_m, void* part_l, void* counters,
    int b, int hq, int hkv, int n_pages, int page_size, int t_cols, int d,
    int dv, int bk, int chunk, float scale, int window, float softcap,
    int q_dtype, int kv_dtype, void* stream) {
  repro::PagedArgs a{
      q, kp, vp, static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(bt), static_cast<const int*>(lengths), 0,
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), b, 1, hq, hkv, n_pages, page_size, t_cols, d,
      bk, scale, window, softcap, static_cast<cudaStream_t>(stream)};
  a.dv = dv;
  repro::set_splits(a, chunk, part_acc, part_m, part_l, counters);
  if (!repro::paged_args_ok<repro::G_DECODE>(a) ||
      !repro::split_paged_args_ok(a) || ks == nullptr || vs == nullptr)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (q_dtype == repro::DTYPE_F32) return dispatch_kv<float>(a, kv_dtype);
  if (q_dtype == repro::DTYPE_BF16)
    return dispatch_kv<__nv_bfloat16>(a, kv_dtype);
  return cudaErrorInvalidValue;
}
