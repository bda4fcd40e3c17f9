"""Quantized KV storage (``repro.quant``): the absmax law, the device
rule for KV dtypes, and the storage spec the paged pools follow."""
from repro_torch.quant.blockwise import (FP8_E4M3_MAX, QMAX_INT8,
                                         absmax_scale, dequantize_absmax,
                                         quantize_absmax)
from repro_torch.quant.capability import (FALLBACK, KV_DTYPES,
                                          dtypes_for_capability,
                                          kv_cache_dtypes)
from repro_torch.quant.spec import (DECODE_TOL, KVQuantSpec, resolve_kv_spec,
                                    spec_for_storage)

__all__ = ["FP8_E4M3_MAX", "QMAX_INT8", "absmax_scale", "dequantize_absmax",
           "quantize_absmax", "FALLBACK", "KV_DTYPES", "dtypes_for_capability",
           "kv_cache_dtypes", "DECODE_TOL", "KVQuantSpec",
           "resolve_kv_spec", "spec_for_storage"]
