"""The port's hand-written kernels against their plain PyTorch versions
on the card, and the port's engine on the card against itself on the
CPU.  Every test here is marked ``gpu`` and skips where no CUDA card is
present.

This file imports no JAX, unlike the port's other test files: the
machine with the card has none, and nothing here needs the reference
(the plain versions are held against ``repro`` by the CPU tests).
Run it there with ``python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.bench import miniqmc as mq
from repro_torch.bench import miniqmc_ref as mq_ref
from repro_torch.bench import spec_accel as sa
from repro_torch.bench import spec_accel_ref as sa_ref
from repro_torch.bench.standin import outputs
from repro_torch.configs.base import MLAConfig
from repro_torch.configs.smoke import smoke_config
from repro_torch.core import selftest
from repro_torch.core.context import target
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import native as fa_native
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.gmm import gmm as gmm_kern
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.gmm import ref as gmm_ref
from repro_torch.kernels.mamba_scan import mamba_scan as scan_kern
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan import ref as scan_ref
from repro_torch.kernels.mlstm_scan import mlstm_scan as mlstm_kern
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.kernels.mlstm_scan import ref as mlstm_ref
from repro_torch.kernels.rmsnorm import native as rms_native
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.rmsnorm import rmsnorm as rms_kern
from repro_torch.kernels.decode_attention import paged as paged_kern
from repro_torch.kernels.decode_attention import quant as quant_kern
from repro_torch.kernels.decode_attention import spec as spec_kern
from repro_torch.models.registry import build_model
from repro_torch.quant import DECODE_TOL, resolve_kv_spec
from repro_torch.serve.engine import Engine, Request, ServeConfig
from repro_torch.serve.paging import live_window_pages, window_table_width

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, out_dtype=None):
    """f32: another summation order; bf16: outputs rounded to 8 bits.
    f32 outputs of bf16 inputs (the decode residuals) are held at 1e-4:
    no rounding to bf16 stands between the two sides."""
    if dtype == torch.float32:
        return dict(atol=2e-5, rtol=2e-5)
    if out_dtype == torch.float32:
        return dict(atol=1e-4, rtol=1e-4)
    return dict(atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(37, 4096), (3, 100)])
def test_rmsnorm_kernel(cuda, dtype, rows, d):
    x = torch.randn(rows, d, device=cuda).to(dtype)
    w = (0.1 * torch.randn(d, device=cuda)).to(dtype)
    before = rms_kern.KERNEL.launches
    got = rms_ops.rmsnorm(x, w, eps=1e-6, weight_offset=1.0)
    assert rms_kern.KERNEL.launches == before + 1
    want = rms_ref.rmsnorm_ref(x, w, eps=1e-6, weight_offset=1.0)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,d,window,softcap", [
    (200, 128, None, None), (64, 128, None, None), (130, 64, 32, 30.0),
    (300, 256, None, 50.0), (300, 256, 128, 50.0)])
def test_flash_kernel(cuda, dtype, sq, d, window, softcap):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 8, sq, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, 2, sq, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, 2, sq, d, device=cuda, generator=g).to(dtype)
    kw = dict(causal=True, window=window, softcap=softcap)
    got = fa_ops.flash_attention(q, k, v, **kw)
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def _pools_from_caches(kc, vc, ps, gen):
    """Scatter dense caches into scrambled pages; slot 0 is freed (all
    null page), slot 1 holds one page and a null tail."""
    b, hkv, s, d = kc.shape
    t = -(-s // ps)
    bt = (torch.randperm(b * t, generator=gen).reshape(b, t) + 1).to(
        torch.int32)
    bt[0] = 0
    bt[1, 1:] = 0
    pools = []
    for cache in (kc, vc):
        pool = torch.zeros(hkv, 1 + b * t, ps, d, device=kc.device,
                           dtype=kc.dtype)
        blocks = torch.nn.functional.pad(cache, (0, 0, 0, t * ps - s))
        pool[:, bt.long().to(kc.device)] = blocks.reshape(
            b, hkv, t, ps, d).transpose(0, 1)
        pools.append(pool)
    return pools, bt.to(kc.device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,window,softcap", [
    (128, None, None), (128, 50, 20.0), (64, None, None), (256, None, 50.0)])
def test_decode_kernels(cuda, dtype, d, window, softcap):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, hq, hkv, s, ps = 4, 32, 8, 300, 64
    q = torch.randn(b, hq, d, device=cuda, generator=g).to(dtype)
    kc = torch.randn(b, hkv, s, d, device=cuda, generator=g).to(dtype)
    vc = torch.randn(b, hkv, s, d, device=cuda, generator=g).to(dtype)
    lengths = torch.tensor([0, 1, 299, 300], dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=softcap)
    got = dec_ops.decode_attention(q, kc, vc, lengths, return_residuals=True,
                                   **kw)
    want = dec_ref.decode_attention_ref(q, kc, vc, lengths,
                                        return_residuals=True, **kw)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **_tol(dtype, a.dtype))
    (kp, vp), bt = _pools_from_caches(kc, vc, ps,
                                      torch.Generator().manual_seed(0))
    for page_size in (None, 16):
        got = dec_ops.paged_decode_attention(
            q, kp, vp, bt, lengths, page_size=page_size,
            return_residuals=True, **kw)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **_tol(dtype, a.dtype))


def _quantized(pool, dtype):
    """(q, scales) of a pool at per-(head, page) absmax."""
    spec = resolve_kv_spec(dtype, pool.device, strict=True)
    return spec.quantize_pages(pool)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("d,window,softcap", [(128, None, None),
                                              (64, 50, 20.0),
                                              (256, None, 50.0)])
def test_quant_paged_decode_kernel(cuda, kv_dtype, d, window, softcap):
    """B5 against its plain version on the same quantized bytes (f32
    residuals, 1e-4), and against bf16 B4 on the unquantized data within
    the documented DECODE_TOL."""
    g = torch.Generator(device=cuda).manual_seed(1)
    b, hq, hkv, s, ps = 4, 32, 8, 300, 64
    q = torch.randn(b, hq, d, device=cuda, generator=g).bfloat16()
    kc = torch.randn(b, hkv, s, d, device=cuda, generator=g).bfloat16()
    vc = torch.randn(b, hkv, s, d, device=cuda, generator=g).bfloat16()
    lengths = torch.tensor([0, 1, 299, 300], dtype=torch.int32, device=cuda)
    (kp, vp), bt = _pools_from_caches(kc, vc, ps,
                                      torch.Generator().manual_seed(0))
    (kq, ks), (vq, vs) = _quantized(kp, kv_dtype), _quantized(vp, kv_dtype)
    kw = dict(window=window, softcap=softcap)
    want = dec_ref.quant_paged_decode_attention_ref(
        q, kq, vq, ks, vs, bt, lengths, return_residuals=True, **kw)
    for page_size in (None, 16):
        before = quant_kern.KERNEL.launches
        got = dec_ops.quant_paged_decode_attention(
            q, kq, vq, ks, vs, bt, lengths, page_size=page_size,
            return_residuals=True, **kw)
        assert quant_kern.KERNEL.launches == before + 1
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)
    out = dec_ops.quant_paged_decode_attention(q, kq, vq, ks, vs, bt,
                                               lengths, **kw)
    bf16 = dec_ops.paged_decode_attention(q, kp, vp, bt, lengths, **kw)
    assert float((out.float() - bf16.float()).abs().max()) <= \
        DECODE_TOL[kv_dtype]


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
@pytest.mark.parametrize("k1,d,window", [(5, 128, None), (1, 128, None),
                                         (3, 64, 40)])
def test_spec_paged_decode_kernel(cuda, kv_dtype, k1, d, window):
    """B6 (bf16 pools and its int8 mode) against its plain version, f32
    residuals at 1e-4; slot 0 is empty, slot 3's window runs past the
    table's last page."""
    g = torch.Generator(device=cuda).manual_seed(2)
    b, hq, hkv, s, ps = 4, 32, 8, 320, 64
    q = torch.randn(b, k1, hq, d, device=cuda, generator=g).bfloat16()
    kc = torch.randn(b, hkv, s, d, device=cuda, generator=g).bfloat16()
    vc = torch.randn(b, hkv, s, d, device=cuda, generator=g).bfloat16()
    base = torch.tensor([0, 1, 200, s - k1 + 1], dtype=torch.int32,
                        device=cuda)
    (kp, vp), bt = _pools_from_caches(kc, vc, ps,
                                      torch.Generator().manual_seed(0))
    bt[0, 0] = bt[3, 0]                # slot 0 reads one page
    before = spec_kern.KERNEL.launches
    if kv_dtype is None:
        got = dec_ops.spec_paged_decode_attention(
            q, kp, vp, bt, base, window=window, return_residuals=True)
        want = dec_ref.spec_paged_decode_attention_ref(
            q, kp, vp, bt, base, window=window, return_residuals=True)
    else:
        (kq, ks), (vq, vs) = _quantized(kp, kv_dtype), _quantized(vp,
                                                                  kv_dtype)
        got = dec_ops.quant_spec_paged_decode_attention(
            q, kq, vq, ks, vs, bt, base, window=window,
            return_residuals=True)
        want = dec_ref.quant_spec_paged_decode_attention_ref(
            q, kq, vq, ks, vs, bt, base, window=window,
            return_residuals=True)
    assert spec_kern.KERNEL.launches == before + 1
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)


def _ring_tables(lengths, window, ps, gen):
    """Ring tables (B, T_w) mapping each slot's live window pages to
    distinct scrambled pool pages, global page g at column g % T_w."""
    tw = window_table_width(window, ps)
    perm = (torch.randperm(len(lengths) * tw, generator=gen) + 1).tolist()
    bt = torch.zeros(len(lengths), tw, dtype=torch.int32)
    for i, n in enumerate(lengths):
        for g in live_window_pages(n, window, ps):
            bt[i, g % tw] = perm.pop()
    return bt, 1 + len(lengths) * tw


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
@pytest.mark.parametrize("d", [128, 256])
def test_window_paged_decode_kernel(cuda, kv_dtype, d):
    """B7 (bf16 pools) and B7q (int8, fp8) against their plain versions,
    f32 residuals at 1e-4, at the physical page and a logical one below
    it: an empty slot, one inside the window, one at its edge, and
    rings that have wrapped (lengths up to 5x the window)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    window, ps, hq, hkv = 96, 32, 8, 4
    lengths = [0, 1, 96, 130, 481]
    bt, n_pages = _ring_tables(lengths, window, ps,
                               torch.Generator().manual_seed(1))
    bt = bt.to(cuda)
    q = torch.randn(len(lengths), hq, d, device=cuda, generator=g).bfloat16()
    kp, vp = (torch.randn(hkv, n_pages, ps, d, device=cuda,
                          generator=g).bfloat16() for _ in range(2))
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=50.0)
    if kv_dtype is None:
        args, kern = (q, kp, vp, bt, ln), paged_kern.WINDOW_KERNEL
        fn = dec_ops.window_paged_decode_attention
        plain = dec_ref.window_paged_decode_attention_ref
    else:
        (kq, ks), (vq, vs) = _quantized(kp, kv_dtype), _quantized(vp,
                                                                  kv_dtype)
        args = (q, kq, vq, ks, vs, bt, ln)
        kern = paged_kern.QUANT_WINDOW_KERNEL
        fn = dec_ops.quant_window_paged_decode_attention
        plain = dec_ref.quant_window_paged_decode_attention_ref
    want = plain(*args, return_residuals=True, **kw)
    for page_size in (None, 16):
        before = kern.launches
        got = fn(*args, page_size=page_size, return_residuals=True, **kw)
        assert kern.launches == before + 1
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)
    assert not got[2][0].any()                  # the empty slot: l = 0


def test_quant_kernel_refuses_a_pool_type_it_lacks(cuda):
    q = torch.zeros(1, 4, 64, device=cuda, dtype=torch.bfloat16)
    pool = torch.zeros(2, 3, 8, 64, device=cuda, dtype=torch.float16)
    sc = torch.ones(2, 3, device=cuda)
    bt = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    ln = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="quantized pools"):
        dec_ops.quant_paged_decode_attention(q, pool, pool, sc, sc, bt, ln)


def test_kernels_refuse_misaligned_operands(cuda):
    """The kernels load 16 bytes at a time: a view that starts off a
    16-byte boundary is refused, not read crooked."""
    x = torch.zeros(4097, device=cuda, dtype=torch.bfloat16)[1:]
    w = torch.zeros(4096, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rms_ops.rmsnorm(x.view(1, 4096), w)


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return [_to(v, dev) for v in tree]


@pytest.mark.parametrize("mode", [
    dict(paged=False), dict(paged=True), dict(paged=True, kv_dtype="int8"),
    dict(paged=True, spec_mode="ngram", spec_k=3),
    dict(paged=True, spec_mode="ngram", spec_k=3, kv_dtype="int8")],
    ids=["dense", "paged", "int8", "spec", "spec-int8"])
def test_engine_on_card_matches_cpu(cuda, mode):
    """A float32 model narrow enough for the CPU, with a head dim the
    kernels take: the same greedy tokens on the card (kernels) and on
    the CPU (plain versions), in every serving mode."""
    cfg = dataclasses.replace(smoke_config("granite-8b", num_layers=2),
                              d_model=256, num_heads=8, num_kv_heads=2,
                              head_dim=64, d_ff=512, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        sc = ServeConfig(slots=2, cache_len=48, max_new_tokens=12,
                         page_size=8, **mode)
        eng = Engine(model, _to(params, dev), sc, device=dev)
        reqs = [Request(rid=i, tokens=[1 + i] * (3 + 5 * i))
                for i in range(3)]
        eng.run_to_completion(reqs)
        assert all(r.done and len(r.out) == 12 for r in reqs)
        outs[dev] = [r.out for r in reqs]
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("mode", [
    dict(paged=False), dict(paged=True), dict(paged=True, kv_dtype="int8")],
    ids=["dense-ring", "paged-window", "int8-window"])
def test_gemma2_engine_on_card_matches_cpu(cuda, mode):
    """The gemma2 smoke pattern (local window 16 / global, softcaps,
    post norms) at head dim 256, float32: the same greedy tokens on the
    card and on the CPU past the window, with prefix frees."""
    cfg = dataclasses.replace(smoke_config("gemma2-2b", num_layers=2),
                              d_model=256, num_heads=4, num_kv_heads=2,
                              head_dim=256, d_ff=512, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        sc = ServeConfig(slots=2, cache_len=48, max_new_tokens=12,
                         page_size=8, **mode)
        eng = Engine(model, _to(params, dev), sc, device=dev)
        reqs = [Request(rid=i, tokens=[1 + i] * (3 + 9 * i))
                for i in range(3)]
        eng.run_to_completion(reqs)
        assert all(r.done and len(r.out) == 12 for r in reqs)
        if eng.paged:
            assert eng.stats()["window_prefix_frees"] > 0
        outs[dev] = [r.out for r in reqs]
    assert outs["cuda"] == outs["cpu"]


# ------------------------------------------ deepseek: B8 and MLA builds --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,k,n,sizes", [
    (4, 64, 128, 128, "registry"),        # repro's example: masked rows
    (3, 24, 96, 136, "edges"),            # sizes 0, C and between; ragged
    (8, 8, 256, 192, "full"),             # the decode tile (C <= 8)
    (2, 184, 64, 128, "full")])           # the largest prefill's C
def test_gmm_kernel(cuda, dtype, e, c, k, n, sizes):
    """B8 against its plain version: f32 at the op's 2e-4, bf16 outputs
    at 2e-2; rows at or past each expert's size are exact zeros."""
    g = torch.Generator(device=cuda).manual_seed(4)
    lhs = torch.randn(e, c, k, device=cuda, generator=g).to(dtype)
    rhs = torch.randn(e, k, n, device=cuda, generator=g).to(dtype)
    gs = {"registry": torch.arange(e) * (c // (e - 1)),
          "edges": torch.tensor([0, c, 7]),
          "full": torch.full((e,), c)}[sizes]
    gs = gs.to(torch.int32).to(cuda)
    before = gmm_kern.KERNEL.launches
    got = gmm_ops.gmm(lhs, rhs, gs)
    assert gmm_kern.KERNEL.launches == before + 1
    want = gmm_ref.gmm_ref(lhs, rhs, gs)
    tol = dict(atol=2e-4, rtol=2e-4) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    for i, size in enumerate(gs.tolist()):
        assert not got[i, size:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_attention_kernels(cuda, dtype):
    """B2, B3 and B4 at Dk 192 / Dv 128 over 16 query heads on 16 kv
    heads, against their plain versions."""
    g = torch.Generator(device=cuda).manual_seed(5)
    h, dk, dv = 16, 192, 128
    q = torch.randn(2, h, 130, dk, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, h, 130, dk, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, h, 130, dv, device=cuda, generator=g).to(dtype)
    got = fa_ops.flash_attention(q, k, v, scale=dk ** -0.5)
    want = fa_ref.flash_attention_ref(q, k, v, scale=dk ** -0.5)
    assert got.shape == (2, h, 130, dv)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    b, s, ps = 4, 300, 64
    qd = torch.randn(b, h, dk, device=cuda, generator=g).to(dtype)
    kc = torch.randn(b, h, s, dk, device=cuda, generator=g).to(dtype)
    vc = torch.randn(b, h, s, dv, device=cuda, generator=g).to(dtype)
    lengths = torch.tensor([0, 1, 299, 300], dtype=torch.int32, device=cuda)
    want = dec_ref.decode_attention_ref(qd, kc, vc, lengths,
                                        return_residuals=True)
    got = dec_ops.decode_attention(qd, kc, vc, lengths,
                                   return_residuals=True)
    assert got[0].shape == (b, h, dv)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **_tol(dtype, a.dtype))
    (kp, _), bt = _pools_from_caches(kc, kc, ps,
                                     torch.Generator().manual_seed(0))
    (vp, _), _ = _pools_from_caches(vc, vc, ps,
                                    torch.Generator().manual_seed(0))
    for page_size in (None, 16):
        got = dec_ops.paged_decode_attention(
            qd, kp, vp, bt, lengths, page_size=page_size,
            return_residuals=True)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **_tol(dtype, a.dtype))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_deepseek_engine_on_card_matches_cpu(cuda, paged):
    """The deepseek smoke pattern (dense first layer, then MoE layers of
    8 experts top 2 with shared experts) at MLA's head dims 192/128,
    float32: the same greedy tokens on the card (B2, B3/B4, B8) and on
    the CPU (plain versions)."""
    base = smoke_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(
        base, d_model=256, num_heads=2, num_kv_heads=2, head_dim=128,
        d_ff=512, dtype="float32",
        mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        sc = ServeConfig(slots=2, cache_len=48, max_new_tokens=12,
                         page_size=8, paged=paged)
        eng = Engine(model, _to(params, dev), sc, device=dev)
        reqs = [Request(rid=i, tokens=[1 + i] * (3 + 9 * i))
                for i in range(3)]
        before = gmm_kern.KERNEL.launches
        eng.run_to_completion(reqs)
        assert all(r.done and len(r.out) == 12 for r in reqs)
        assert (gmm_kern.KERNEL.launches > before) == (dev == "cuda")
        outs[dev] = [r.out for r in reqs]
    assert outs["cuda"] == outs["cpu"]


# -------------------------------------------------- jamba: B9 (the scan) --

@pytest.mark.parametrize("b,s,d,n,dtype", [
    (2, 64, 32, 8, torch.float32),          # repro's registry example
    (1, 17, 16384, 16, torch.bfloat16),     # jamba: S below the chunk
    (2, 64, 16384, 16, torch.bfloat16),     # S a multiple of the chunk
    (1, 200, 16384, 16, torch.bfloat16),    # S off a multiple
    (2, 511, 16384, 16, torch.bfloat16)])   # the largest prefill group
def test_mamba_scan_kernel(cuda, b, s, d, n, dtype):
    """B9 against its plain version: f32 outputs (h_T, and y for f32
    inputs) at the op's 1e-4, bf16 y at 2e-2; x/dt/Bm/Cm in ``dtype``,
    A and D in f32, as the mamba layer hands them over."""
    g = torch.Generator(device=cuda).manual_seed(6)

    def rnd(*shape):
        return torch.randn(*shape, device=cuda, generator=g)

    x, bm, cm = rnd(b, s, d).to(dtype), rnd(b, s, n).to(dtype), \
        rnd(b, s, n).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, s, d) - 2.0).to(dtype)
    a = -torch.exp(0.5 * rnd(d, n))
    dsk = rnd(d)
    before = scan_kern.KERNEL.launches
    y, h = scan_ops.mamba_scan(x, dt, a, bm, cm, dsk)
    assert scan_kern.KERNEL.launches == before + 1
    wy, wh = scan_ref.mamba_scan_ref(x, dt, a, bm, cm, dsk)
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = scan_ops.TOL if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(y.float(), wy.float(), **tol)
    torch.testing.assert_close(h, wh, **scan_ops.TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_jamba_engine_on_card_matches_cpu(cuda, paged):
    """The jamba smoke pattern cut to 4 layers (attention, then mamba
    layers with 8 experts top 2 on every other one) at widths the
    kernels take, float32: the same greedy tokens on the card (B1, B2,
    B3/B4, B8, B9 at every prefill) and on the CPU (plain versions)."""
    cfg = dataclasses.replace(
        smoke_config("jamba-1.5-large-398b"), num_layers=4, d_model=256,
        num_heads=2, num_kv_heads=2, head_dim=128, d_ff=512,
        dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        sc = ServeConfig(slots=2, cache_len=48, max_new_tokens=12,
                         page_size=8, paged=paged)
        eng = Engine(model, _to(params, dev), sc, device=dev)
        reqs = [Request(rid=i, tokens=[1 + i] * (3 + 9 * i))
                for i in range(3)]
        before = scan_kern.KERNEL.launches
        eng.run_to_completion(reqs)
        assert all(r.done and len(r.out) == 12 for r in reqs)
        assert (scan_kern.KERNEL.launches > before) == (dev == "cuda")
        outs[dev] = [r.out for r in reqs]
    assert outs["cuda"] == outs["cpu"]


# ------------------------------------------------ xlstm: B10 (mLSTM scan) --

@pytest.mark.parametrize("b,h,s,dk,dtype", [
    (1, 2, 64, 32, torch.float32),          # repro's registry example
    (1, 4, 1, 1024, torch.bfloat16),        # one step
    (1, 4, 17, 1024, torch.bfloat16),       # S off a multiple of the chunk
    (2, 4, 64, 1024, torch.bfloat16),       # S a multiple of the chunk
    (1, 4, 200, 1024, torch.float32),
    (2, 4, 511, 1024, torch.bfloat16)])     # the largest prefill group
def test_mlstm_scan_kernel(cuda, b, h, s, dk, dtype):
    """B10 against its plain version, h and the final state (C, n, m):
    f32 outputs (the state, and h of f32 inputs) at the op's 2e-4, bf16
    h at 2e-2; q/k/v in ``dtype``, the gates in f32, as the mLSTM layer
    hands them over; one launch with the state and one without."""
    g = torch.Generator(device=cuda).manual_seed(7)

    def rnd(*shape):
        return torch.randn(*shape, device=cuda, generator=g)

    q, k, v = (rnd(b, h, s, dk).to(dtype) for _ in range(3))
    ig, fg = rnd(b, h, s), rnd(b, h, s) + 2.0
    before = mlstm_kern.KERNEL.launches
    out, (c, n, m) = mlstm_ops.mlstm_scan(q, k, v, ig, fg, return_state=True)
    alone = mlstm_ops.mlstm_scan(q, k, v, ig, fg)
    assert mlstm_kern.KERNEL.launches == before + 2
    want, (wc, wn, wm) = mlstm_ref.mlstm_scan_ref(q, k, v, ig, fg,
                                                  return_state=True)
    assert out.dtype == dtype and c.dtype == torch.float32
    tol = mlstm_ops.TOL if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(alone, out, atol=0, rtol=0)
    for got, ref in ((c, wc), (n, wn), (m, wm)):
        torch.testing.assert_close(got, ref, **mlstm_ops.TOL)


def _xlstm_card_config():
    """The xlstm smoke pattern (seven mLSTM layers, then an sLSTM one)
    at widths the kernels take: d_model 32 and 2 heads give mLSTM heads
    of 32, a build of B10; float32."""
    return dataclasses.replace(smoke_config("xlstm-1.3b"), num_layers=8,
                               d_model=32, dtype="float32")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_xlstm_engine_on_card_matches_cpu(cuda, paged):
    """The same greedy tokens on the card (B1, and B10 at every prefill
    with its state output) and on the CPU (plain versions)."""
    model = build_model(_xlstm_card_config())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        sc = ServeConfig(slots=2, cache_len=48, max_new_tokens=12,
                         page_size=8, paged=paged)
        eng = Engine(model, _to(params, dev), sc, device=dev)
        reqs = [Request(rid=i, tokens=[1 + i] * (3 + 9 * i))
                for i in range(3)]
        before = mlstm_kern.KERNEL.launches
        eng.run_to_completion(reqs)
        assert all(r.done and len(r.out) == 12 for r in reqs)
        assert (mlstm_kern.KERNEL.launches > before) == (dev == "cuda")
        outs[dev] = [r.out for r in reqs]
    assert outs["cuda"] == outs["cpu"]


def test_xlstm_loss_on_card_matches_its_plain_version(cuda):
    """``Model.loss`` through B1 and B10 (without its state output) and
    through the plain versions, on the card, float32."""
    model = build_model(_xlstm_card_config())
    params = _to(model.init(torch.Generator().manual_seed(0), device="cpu"),
                 "cuda")
    g = torch.Generator(device=cuda).manual_seed(3)
    batch = {name: torch.randint(0, 256, (2, 40), device=cuda, generator=g)
             for name in ("tokens", "labels")}
    before = mlstm_kern.KERNEL.launches
    _, got = model.loss(params, batch)
    assert mlstm_kern.KERNEL.launches == before + 7
    _, want = model.loss(params, batch, plain=True)
    assert mlstm_kern.KERNEL.launches == before + 7
    for name in want:
        torch.testing.assert_close(got[name], want[name], **mlstm_ops.TOL)


# ------------------------------------- the device runtime and B11 -----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(37, 4096), (3, 100), (256, 512)])
def test_rmsnorm_twins_are_bit_identical(cuda, dtype, rows, d):
    """B11a (hard-coded CUDA) against B1 (written against the device
    runtime): the same arithmetic in the same order, so equal bits."""
    x = torch.randn(rows, d, device=cuda).to(dtype)
    w = (0.1 * torch.randn(d, device=cuda)).to(dtype)
    kw = dict(eps=1e-6, weight_offset=1.0)
    before = rms_native.KERNEL.launches
    got = rms_native.rmsnorm_native(x, w, **kw)
    assert rms_native.KERNEL.launches == before + 1
    assert torch.equal(got, rms_ops.rmsnorm(x, w, **kw))
    torch.testing.assert_close(got.float(),
                               rms_ref.rmsnorm_ref(x, w, **kw).float(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d,window,softcap", [
    (130, 64, None, None), (200, 128, 32, 30.0), (77, 256, None, 50.0),
    (300, 256, 128, 50.0)])
def test_flash_twins_are_bit_identical(cuda, dtype, s, d, window, softcap):
    """B11b against B2: GQA 8/2, causal, window and softcap; the native
    twin hard-codes the approximate reciprocal that B2 takes from the
    runtime."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, h, s, d, device=cuda, generator=g).to(dtype)
               for h in (8, 2, 2))
    kw = dict(causal=True, window=window, softcap=softcap)
    before = fa_native.KERNEL.launches
    got = fa_native.flash_attention_native(q, k, v, **kw)
    assert fa_native.KERNEL.launches == before + 1
    assert torch.equal(got, fa_ops.flash_attention(q, k, v, **kw))
    torch.testing.assert_close(
        got.float(), fa_ref.flash_attention_ref(q, k, v, **kw).float(),
        **_tol(dtype))


@pytest.mark.parametrize("teams,total,bound", [
    (7, 1000, 6), (132, 8192, 254), (40, 100, 0)])
def test_runtime_test_kernel_outcomes(cuda, teams, total, bound):
    """Teams, static_partition, arena carve-outs, block reductions and
    every atomic under contention, held to the plain atomics by the
    outcomes that do not depend on the order; the portable part also
    on the generic target."""
    want = selftest.plain(teams, total, bound)
    for portable in (False, True):
        got = selftest.launch(teams, total, bound, portable=portable,
                              device=cuda)
        assert selftest.mismatches(got, want, total, bound) == []
    with target("generic"):
        got = selftest.launch(teams, total, bound, portable=True,
                              device=cuda)
    assert selftest.mismatches(got, want, total, bound) == []


def test_generic_build_of_atomic_inc_fails_to_compile(cuda):
    """Listing 4: the generic target provides no atomic_inc, so a source
    that calls it does not build, and says why."""
    with target("generic"):
        with pytest.raises(RuntimeError,
                           match="target dependent implementation missing"):
            selftest.KERNEL.build()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generic_builds_of_b1_and_b2(cuda, dtype):
    """B1 and B2 built for the generic target (reductions through shared
    memory, an exact reciprocal) against their plain versions."""
    x = torch.randn(37, 4096, device=cuda).to(dtype)
    w = (0.1 * torch.randn(4096, device=cuda)).to(dtype)
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, h, 200, 128, device=cuda, generator=g).to(dtype)
               for h in (8, 2, 2))
    kw = dict(causal=True, window=64, softcap=30.0)
    with target("generic"):
        rms_before = rms_kern.KERNEL.launches
        got_rms = rms_ops.rmsnorm(x, w, eps=1e-6, weight_offset=1.0)
        got_fa = fa_ops.flash_attention(q, k, v, **kw)
        assert rms_kern.KERNEL.launches == rms_before + 1
    torch.testing.assert_close(
        got_rms.float(),
        rms_ref.rmsnorm_ref(x, w, eps=1e-6, weight_offset=1.0).float(),
        **_tol(dtype))
    torch.testing.assert_close(
        got_fa.float(), fa_ref.flash_attention_ref(q, k, v, **kw).float(),
        **_tol(dtype))


@pytest.mark.parametrize("label", ["reference", "card"])
@pytest.mark.parametrize("name", sa_ref.NAMES)
def test_spec_accel_twins_and_generic_build(cuda, name, label):
    """A SPEC ACCEL stand-in's two builds of one source bit for bit, and
    each of them and the generic build within the stated tolerance of
    the plain version, at the reference's and the card's shapes."""
    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in sa_ref.inputs(name, label, seed=1))
    fn, plain = sa.FUNCS[name]
    portable, native = sa.TWINS[name]
    before = (portable.launches, native.launches)
    got, got_native = fn(*args), fn(*args, native=True)
    with target("generic"):
        got_generic = fn(*args)
    n = sa.LAUNCHES[name]
    assert (portable.launches, native.launches) == (before[0] + 2 * n,
                                                    before[1] + n)
    want = plain(*args)
    assert torch.equal(got, got_native)
    atol, rtol = sa.tolerance(name, args, want)
    for out in (got, got_native, got_generic):
        torch.testing.assert_close(out, want, atol=atol, rtol=rtol)


def test_pbt_sweeps_on_the_card(cuda):
    """pbt's kernel writes the forward sweep's cp and dp as the
    reference's does: each within the stated tolerance of the plain
    sweeps at the reference's shape, the native build bit for bit."""
    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in sa_ref.inputs("570.pbt", "reference", seed=2))
    got = sa.pbt_sweeps(*args)
    assert all(torch.equal(a, b)
               for a, b in zip(got, sa.pbt_sweeps(*args, native=True)))
    for g, w in zip(got, sa_ref.pbt_sweeps(*args)):
        torch.testing.assert_close(g, w, atol=1e-5 * float(w.abs().max()),
                                   rtol=1e-5)


@pytest.mark.parametrize("label", ["reference", "card"])
@pytest.mark.parametrize("name", mq_ref.NAMES)
def test_miniqmc_twins_and_generic_build(cuda, name, label):
    """A miniQMC region's two builds of one source bit for bit, and each
    of them and the generic build within the stated tolerance of the
    plain version, at the reference's and the card's shapes."""
    args = tuple(torch.from_numpy(a).to(cuda)
                 for a in mq_ref.inputs(name, label, seed=1))
    fn, plain = mq.FUNCS[name]
    portable, native = mq.TWINS[name]
    before = (portable.launches, native.launches)
    got, got_native = fn(*args), fn(*args, native=True)
    with target("generic"):
        got_generic = fn(*args)
    assert (portable.launches, native.launches) == (before[0] + 2,
                                                    before[1] + 1)
    want = outputs(plain(*args))
    atol, rtol = mq.tolerance(name, args, want)
    assert all(torch.equal(a, b)
               for a, b in zip(outputs(got), outputs(got_native)))
    for out in (got, got_native, got_generic):
        assert len(outputs(out)) == len(want)
        for o, w in zip(outputs(out), want):
            torch.testing.assert_close(o, w, atol=atol, rtol=rtol)
