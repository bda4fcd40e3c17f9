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
// the reference rides the scale block on the same block-table index map
// as its K/V block and multiplies after the DMA; here the CTA reads
// scales[h * P + page] for the page it gathers and stage_tile
// dequantizes every element to f32 as to_f32(x) * scale while staging
// it, before any dot (decode_attention.py:69-72).  A 16-byte load
// carries 16 elements, so a block's staging issues half the loads of
// bf16.
#include "decode_common.cuh"

namespace {

template <typename T>
cudaError_t dispatch_kv(const repro::PagedArgs& a, int kv_dtype) {
  constexpr int G = repro::G_DECODE;
  if (kv_dtype == repro::DTYPE_I8)
    return repro::dispatch_paged_d<T, int8_t, G>(a);
  if (kv_dtype == repro::DTYPE_FP8)
    return repro::dispatch_paged_d<T, __nv_fp8_e4m3, G>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int quant_paged_decode_attention_fwd(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* bt, const void* lengths, void* acc, void* m,
    void* l, int b, int hq, int hkv, int n_pages, int page_size, int t_cols,
    int d, int bk, float scale, int window, float softcap, int q_dtype,
    int kv_dtype, void* stream) {
  const repro::PagedArgs a{
      q, kp, vp, static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(bt), static_cast<const int*>(lengths), 0,
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), b, 1, hq, hkv, n_pages, page_size, t_cols, d,
      bk, scale, window, softcap, static_cast<cudaStream_t>(stream)};
  if (!repro::paged_args_ok<repro::G_DECODE>(a) || ks == nullptr ||
      vs == nullptr)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (q_dtype == repro::DTYPE_F32) return dispatch_kv<float>(a, kv_dtype);
  if (q_dtype == repro::DTYPE_BF16)
    return dispatch_kv<__nv_bfloat16>(a, kv_dtype);
  return cudaErrorInvalidValue;
}
