// Dense flash decode: one new query token per batch row against a
// dense KV cache (B, Hkv, S, DK|DV); returns the unnormalized residuals
// (acc (B, Hq, DV), m, l) in f32.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/
// decode_attention.py (decode_attention_fwd, body _decode_kernel +
// flash_decode_step).
//
// Bound on the H100: bytes.  Every live K/V row is read once and used
// for G = Hq / Hkv dot products (about 1 flop per byte in bf16).
// Design: one CTA per (batch row, kv head) walks its cache in 64-token
// blocks up to lengths[b] (decode_common.cuh), so all G query heads of
// a group share each K/V read.  B x Hkv CTAs under-fill the card at
// small batch (8 slots x 8 heads = 64 CTAs on 132 SMs); splitting the
// sequence across CTAs with an LSE combine is a later PR's design.
// Key and value head dims are equal (64, 128, 256) or, for MLA, 192 and
// 128: a CTA then has 128 threads that score over 192 columns.
#include "decode_common.cuh"

namespace {

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(DV)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              float* acc_out, float* m_out, float* l_out, int hq, int hkv,
              int s, int bk, float scale, int window, float softcap) {
  constexpr int G = repro::G_DECODE;
  extern __shared__ float smem[];
  const repro::DecodeSmem<DK, DV, G> sm(smem);
  const int h = blockIdx.x, b = blockIdx.y, g = hq / hkv;
  const repro::Rows<G> rows{static_cast<size_t>(b) * hq + h * g, g, hq, g};
  const int length = min(lengths[b], s);
  float acc[G];
  repro::decode_init<T, DK, DV, G>(sm, q, rows, scale, acc);
  const size_t base = static_cast<size_t>(b * hkv + h) * s;  // row 0
  for (int k0 = 0; k0 < length; k0 += bk)
    repro::decode_block<T, DK, DV, G>(
        sm, kc + (base + k0) * DK, vc + (base + k0) * DV, min(bk, s - k0),
        k0, g, length, window, softcap, 1.f, 1.f, acc);
  repro::decode_store<DK, DV, G>(sm, acc, rows, acc_out, m_out, l_out);
}

template <typename T, int DK, int DV>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* lengths, float* acc, float* m, float* l,
                   int b, int hq, int hkv, int s, int bk, float scale,
                   int window, float softcap, cudaStream_t stream) {
  const size_t bytes =
      repro::decode_smem_floats<DK, DV, repro::G_DECODE>() * sizeof(float);
  static const cudaError_t attr =
      repro::allow_smem(decode_kernel<T, DK, DV>, bytes);
  if (attr != cudaSuccess) return attr;
  decode_kernel<T, DK, DV><<<dim3(hkv, b), DV, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, acc, m, l, hq, hkv, s, bk, scale,
      window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, int dv, const void* q, const void* kc, const void* vc,
                       const int* lengths, float* acc, float* m, float* l,
                       int b, int hq, int hkv, int s, int bk, float scale,
                       int window, float softcap, cudaStream_t stream) {
  if (d == 192 && dv == 128)  // MLA
    return launch<T, 192, 128>(q, kc, vc, lengths, acc, m, l, b, hq, hkv, s,
                               bk, scale, window, softcap, stream);
  if (dv != d) return cudaErrorInvalidValue;
  if (d == 64)
    return launch<T, 64, 64>(q, kc, vc, lengths, acc, m, l, b, hq, hkv, s, bk,
                             scale, window, softcap, stream);
  if (d == 128)
    return launch<T, 128, 128>(q, kc, vc, lengths, acc, m, l, b, hq, hkv, s,
                               bk, scale, window, softcap, stream);
  if (d == 256)
    return launch<T, 256, 256>(q, kc, vc, lengths, acc, m, l, b, hq, hkv, s,
                               bk, scale, window, softcap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int decode_attention_fwd(const void* q, const void* kc,
                                    const void* vc, const void* lengths,
                                    void* acc, void* m, void* l, int b,
                                    int hq, int hkv, int s, int d, int dv,
                                    int bk, float scale, int window,
                                    float softcap, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > repro::G_DECODE || bk < 1 ||
      bk > repro::BK_MAX)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (dtype == repro::DTYPE_F32)
    return dispatch_d<float>(d, dv, q, kc, vc, len, a, mm, ll, b, hq, hkv, s,
                             bk, scale, window, softcap, st);
  if (dtype == repro::DTYPE_BF16)
    return dispatch_d<__nv_bfloat16>(d, dv, q, kc, vc, len, a, mm, ll, b, hq,
                                     hkv, s, bk, scale, window, softcap, st);
  return cudaErrorInvalidValue;
}
