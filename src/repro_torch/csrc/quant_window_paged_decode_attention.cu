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
// index map as its K/V blocks; here the CTA follows the wrapper's ring
// walk (kernels/decode_attention/paged.py, ring_walk) as the bf16
// window kernel does and reads scales[h * P + page] for each page it
// gathers; stage_tile dequantizes every element as to_f32(x) * scale
// while staging it, before any dot (decode_common.cuh).
#include "decode_common.cuh"

namespace {

template <typename T>
cudaError_t dispatch_kv(const repro::PagedArgs& a, int kv_dtype) {
  constexpr int G = repro::G_DECODE;
  if (kv_dtype == repro::DTYPE_I8)
    return repro::dispatch_paged_d<T, int8_t, G, true>(a);
  if (kv_dtype == repro::DTYPE_FP8)
    return repro::dispatch_paged_d<T, __nv_fp8_e4m3, G, true>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int quant_window_paged_decode_attention_fwd(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* walk, const void* start, const void* lengths,
    void* acc, void* m, void* l, int b, int hq, int hkv, int n_pages,
    int page_size, int t_cols, int d, int bk, float scale, int window,
    float softcap, int q_dtype, int kv_dtype, void* stream) {
  repro::PagedArgs a{
      q, kp, vp, static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(walk), static_cast<const int*>(lengths), 0,
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), b, 1, hq, hkv, n_pages, page_size, t_cols, d,
      bk, scale, window, softcap, static_cast<cudaStream_t>(stream)};
  a.start = static_cast<const int*>(start);
  if (!repro::paged_args_ok<repro::G_DECODE>(a) || window <= 0 ||
      a.start == nullptr || ks == nullptr || vs == nullptr)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (q_dtype == repro::DTYPE_F32) return dispatch_kv<float>(a, kv_dtype);
  if (q_dtype == repro::DTYPE_BF16)
    return dispatch_kv<__nv_bfloat16>(a, kv_dtype);
  return cudaErrorInvalidValue;
}
