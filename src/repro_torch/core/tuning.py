"""Static schedule table of the port's kernels, keyed ``(op, param)``.

The counterpart of ``repro.core.tuning`` without targets or the
autotuner (ROADMAP.md queue A, item 14): one card, one table.  The
flash kernel's tile sizes are compiled in (``csrc/flash_attention.cu``
refuses others); the decode kernels take ``block_kv`` at run time, up
to 64 tokens.  The grouped matmul keeps the reference's parameter
names; its N and K tiles are compiled in, and its capacity tile has a
second build of 8 rows for decode (``kernels/gmm/gmm.py``).  The
selective scan's and the mLSTM scan's time chunks (the steps staged in
shared memory per pass) are compiled in too; the mLSTM scan's is its
bf16 body's chunkwise L.
"""
from __future__ import annotations

TABLE = {
    ("flash_attention", "block_q"): 64,
    ("flash_attention", "block_kv"): 64,
    ("decode_attention", "block_kv"): 64,
    ("paged_decode_attention", "page_size"): 64,
    ("paged_decode_attention", "block_kv"): 64,
    ("quant_paged_decode_attention", "page_size"): 64,
    ("quant_paged_decode_attention", "block_kv"): 64,
    ("window_paged_decode_attention", "page_size"): 64,
    ("window_paged_decode_attention", "block_kv"): 64,
    ("quant_window_paged_decode_attention", "page_size"): 64,
    ("quant_window_paged_decode_attention", "block_kv"): 64,
    ("spec_paged_decode_attention", "page_size"): 64,
    ("spec_paged_decode_attention", "block_kv"): 64,
    ("quant_spec_paged_decode_attention", "page_size"): 64,
    ("quant_spec_paged_decode_attention", "block_kv"): 64,
    ("gmm", "block_c"): 64,
    ("gmm", "block_n"): 128,
    ("gmm", "block_k"): 32,
    ("mamba_scan", "chunk"): 32,
    ("mlstm_scan", "chunk"): 32,
}


def block_size(op: str, param: str) -> int:
    try:
        return TABLE[(op, param)]
    except KeyError:
        raise KeyError(f"no tuning entry for ({op!r}, {param!r}); known: "
                       f"{sorted(TABLE)}") from None
