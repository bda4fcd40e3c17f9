// Quantized sliding-window paged flash decode: the window kernel over
// int8 or fp8-e4m3 page pools (Hkv, P, ps, D), each (head, page) block
// scaled by one f32 from the (Hkv, P) scale pools.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/quant.py
// (quant_window_paged_decode_attention_fwd: paged.py's
// window_paged_decode_attention_fwd with k_scales / v_scales).
//
// Bound on the H100: bytes, half of the bf16 window kernel's: one byte
// per live K/V element plus one f32 scale per (head, live page) for
// each pool.  Design: the reference's scale blocks ride the same ring
// index map as its K/V blocks; here the CTAs walk each ring row from the
// window's first live page as the bf16 window kernel does: B4's
// split-KV kernel in its RING form (split_paged_decode_kernel in
// decode_common.cuh) with KV the pool's 1-byte type, chunks of whole
// pages counted from the walk's first token and picked from the ring's
// width alone.  The CTA reads scales[h * P + page] of the next block
// with its ring entry, while this block computes, cp.async stages the
// bytes as they are stored, 16 elements a copy, and split_block
// dequantizes each element as to_f32(x) * scale before any dot or P V
// product (decode_attention.py:69-72).  A one-split launch is one walk
// over the whole window; several merge in split order inside the
// launch.
#include "decode_common.cuh"

namespace {

template <typename T>
cudaError_t dispatch_kv(const repro::PagedArgs& a, int kv_dtype) {
  if (kv_dtype == repro::DTYPE_I8)
    return repro::dispatch_split_paged_d<T, int8_t, false, true>(a);
  if (kv_dtype == repro::DTYPE_FP8)
    return repro::dispatch_split_paged_d<T, __nv_fp8_e4m3, false, true>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// The split arguments as window_paged_decode_attention_fwd's.
extern "C" int quant_window_paged_decode_attention_fwd(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* bt, const void* lengths, void* acc, void* m,
    void* l, void* part_acc, void* part_m, void* part_l, void* counters,
    int b, int hq, int hkv, int n_pages, int page_size,
    int t_cols, int d, int bk, int chunk, float scale, int window,
    float softcap, int q_dtype, int kv_dtype, void* stream) {
  repro::PagedArgs a{
      q, kp, vp, static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(bt), static_cast<const int*>(lengths), 0,
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), b, 1, hq, hkv, n_pages, page_size, t_cols, d,
      bk, scale, window, softcap, static_cast<cudaStream_t>(stream)};
  repro::set_splits(a, chunk, part_acc, part_m, part_l, counters);
  if (!repro::paged_args_ok<repro::G_DECODE>(a) ||
      !repro::split_paged_args_ok(a) || window <= 0 ||
      ks == nullptr || vs == nullptr)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (q_dtype == repro::DTYPE_F32) return dispatch_kv<float>(a, kv_dtype);
  if (q_dtype == repro::DTYPE_BF16)
    return dispatch_kv<__nv_bfloat16>(a, kv_dtype);
  return cudaErrorInvalidValue;
}
