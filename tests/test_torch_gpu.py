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

import numpy as np
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
from repro_torch.kernels.decode_attention import decode_attention as dec_kern
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


#: B2's cases: (Sq, Skv, Dk, Dv, window, softcap, q_offset), all causal
FLASH_CASES = [
    (200, 200, 128, 128, None, None, 0), (64, 64, 128, 128, None, None, 0),
    (130, 130, 64, 64, 32, 30.0, 0), (300, 300, 256, 256, None, 50.0, 0),
    (300, 300, 256, 256, 128, 50.0, 0), (130, 130, 192, 128, None, None, 0),
    (77, 200, 128, 128, None, None, 123), (37, 100, 192, 128, 40, None, 63)]
#: B2's bf16 body against its operand-rounding model (kernels/
#: flash_attention/ref.py): the two round the same operands, so they part
#: by a bf16 output rounding that a few f32 ulps flip and, rarely, by a p
#: whose bf16 rounding flips: half of TOL_BF16, where a misplaced
#: fragment moves outputs by far more
TOL_OPERANDS = dict(atol=1e-2, rtol=1e-2)


def _flash_operands(cuda, dtype, sq, skv, dk, dv, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(2, 8, sq, dk, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, 2, skv, dk, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, 2, skv, dv, device=cuda, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,dk,dv,window,softcap,q_offset",
                         FLASH_CASES)
def test_flash_kernel(cuda, dtype, sq, skv, dk, dv, window, softcap,
                      q_offset):
    q, k, v = _flash_operands(cuda, dtype, sq, skv, dk, dv)
    kw = dict(causal=True, window=window, softcap=softcap,
              scale=dk ** -0.5, q_offset=q_offset)
    got = fa_ops.flash_attention(q, k, v, **kw)
    want = fa_ref.flash_attention_ref(q, k, v, **kw)
    assert got.shape == (2, 8, sq, dv)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("sq,skv,dk,dv,window,softcap,q_offset",
                         FLASH_CASES)
def test_flash_kernel_matches_rounding_model(cuda, sq, skv, dk, dv, window,
                                             softcap, q_offset):
    """The tensor-core body (bf16) against the plain model of what it
    rounds, at TOL_OPERANDS, and with at most MODEL_MISMATCH of its
    outputs differing from the model's (one P term fewer changes about a
    third of them: tests/test_torch_flash_rounding.py)."""
    q, k, v = _flash_operands(cuda, torch.bfloat16, sq, skv, dk, dv)
    kw = dict(causal=True, window=window, softcap=softcap,
              scale=dk ** -0.5, q_offset=q_offset)
    got = fa_ops.flash_attention(q, k, v, **kw)
    want = fa_ref.flash_attention_bf16_operands(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL_OPERANDS)
    assert fa_ref.model_mismatch(got, want) <= fa_ref.MODEL_MISMATCH


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


@pytest.mark.parametrize("splits", [1, 3, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,window,softcap", [
    (128, None, None), (128, 50, 20.0), (64, None, None), (256, None, 50.0)])
def test_decode_kernels(cuda, dtype, d, window, softcap, splits):
    """B3 with one split, three and the served count, against its split
    plain version (``chunk=``) and the unsplit one, and against its own
    one-split launch: m bit for bit (the scores are computed alike
    whatever the split), acc and l within f32 tol; then B4."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b, hq, hkv, s, ps = 4, 32, 8, 300, 64
    q = torch.randn(b, hq, d, device=cuda, generator=g).to(dtype)
    kc = torch.randn(b, hkv, s, d, device=cuda, generator=g).to(dtype)
    vc = torch.randn(b, hkv, s, d, device=cuda, generator=g).to(dtype)
    lengths = torch.tensor([0, 1, 299, 300], dtype=torch.int32, device=cuda)
    kw = dict(window=window, softcap=softcap)
    n = splits or dec_kern.decode_splits(s)
    got = dec_ops.decode_attention(q, kc, vc, lengths, return_residuals=True,
                                   splits=splits, **kw)
    want = dec_ref.decode_attention_ref(q, kc, vc, lengths,
                                        return_residuals=True, **kw)
    split_want = dec_ref.decode_attention_ref(
        q, kc, vc, lengths, return_residuals=True,
        chunk=dec_kern.split_chunk(s, n), **kw)
    for a, w, sw in zip(got, want, split_want):
        torch.testing.assert_close(a, w, **_tol(dtype, a.dtype))
        torch.testing.assert_close(a, sw, **_tol(dtype, a.dtype))
    one = dec_ops.decode_attention(q, kc, vc, lengths, return_residuals=True,
                                   splits=1, **kw)
    assert torch.equal(got[1], one[1])
    for a, o in zip(got, one):
        torch.testing.assert_close(a, o, **_tol(torch.float32))
    (kp, vp), bt = _pools_from_caches(kc, vc, ps,
                                      torch.Generator().manual_seed(0))
    for page_size in (None, 16):
        got = dec_ops.paged_decode_attention(
            q, kp, vp, bt, lengths, page_size=page_size,
            return_residuals=True, **kw)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **_tol(dtype, a.dtype))


#: B4's shapes: (label, Hq, Hkv, D, cache rows, lengths, kw): chip_smoke's
#: check_paged (granite-8b) and gemma2-2b's table of 128 pages of 64
SPLIT_PAGED_CASES = [
    ("granite", 32, 8, 128, 1024, (1, 64, 200, 333, 511, 700, 900, 1024),
     {}),
    ("granite window", 32, 8, 128, 1024, (0, 5, 1024, 63),
     dict(window=100, softcap=30.0)),
    ("gemma2", 8, 4, 256, 8192, (1, 17, 1001, 4096, 4151, 6001, 6032, 8192),
     dict(softcap=50.0))]


@pytest.mark.parametrize("page_size", [None, 16])
@pytest.mark.parametrize("case", SPLIT_PAGED_CASES,
                         ids=[c[0] for c in SPLIT_PAGED_CASES])
def test_split_paged_decode_kernel(cuda, case, page_size):
    """B4 at one split, at 8 and at its served count, each in one
    launch: against its split plain version (``chunk=``, its rounding
    model) and the unsplit one within f32 tol, and m bit for bit with
    its one-split launch (the scores are computed alike whatever the
    split); at a logical page of 16 as at the pool's 64."""
    label, hq, hkv, d, s, lengths, kw = case
    g = torch.Generator(device=cuda).manual_seed(5)
    b = len(lengths)
    q = torch.randn(b, hq, d, device=cuda, generator=g).bfloat16()
    kc = torch.randn(b, hkv, s, d, device=cuda, generator=g).bfloat16()
    vc = torch.randn(b, hkv, s, d, device=cuda, generator=g).bfloat16()
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    (kp, vp), bt = _pools_from_caches(kc, vc, 64,
                                      torch.Generator().manual_seed(1))
    reach = bt.shape[1] * 64
    page = page_size or 64
    want = dec_ref.paged_decode_attention_ref(q, kp, vp, bt, ln,
                                              return_residuals=True, **kw)
    one = None
    for splits in (1, 8, None):
        n = splits or dec_kern.paged_splits(reach, page)
        before = paged_kern.KERNEL.launches
        got = dec_ops.paged_decode_attention(
            q, kp, vp, bt, ln, page_size=page_size, splits=splits,
            return_residuals=True, **kw)
        assert paged_kern.KERNEL.launches == before + 1
        split_want = dec_ref.paged_decode_attention_ref(
            q, kp, vp, bt, ln, return_residuals=True,
            chunk=dec_kern.split_chunk(reach, n, page), **kw)
        for a, w, sw in zip(got, want, split_want):
            torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(a, sw, atol=1e-4, rtol=1e-4)
        one = got if one is None else one
        assert torch.equal(got[1], one[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(4096, 4096), (18000, 2304), (1022, 8192),
                                    (64, 16384), (5, 100)],
                         ids=["granite", "gemma2", "jamba", "wide", "narrow"])
def test_rmsnorm_schedules_are_bit_identical(cuda, dtype, rows, d):
    """B1 at the served shapes and a wide row (a warp a row) and at rows
    that are not whole 16-byte vectors (a team a row, in bf16): B1, its
    native twin B11a and B1's generic build bit for bit, each in one
    launch, within tol of the plain version."""
    x = torch.randn(rows, d, device=cuda).to(dtype)
    w = (0.1 * torch.randn(d, device=cuda)).to(dtype)
    kw = dict(eps=1e-6, weight_offset=1.0)
    before = rms_kern.KERNEL.launches
    got = rms_ops.rmsnorm(x, w, **kw)
    assert rms_kern.KERNEL.launches == before + 1
    assert torch.equal(got, rms_native.rmsnorm_native(x, w, **kw))
    with target("generic"):
        assert torch.equal(got, rms_ops.rmsnorm(x, w, **kw))
    torch.testing.assert_close(got.float(),
                               rms_ref.rmsnorm_ref(x, w, **kw).float(),
                               **_tol(dtype))


def _quantized(pool, dtype):
    """(q, scales) of a pool at per-(head, page) absmax."""
    spec = resolve_kv_spec(dtype, pool.device, strict=True)
    return spec.quantize_pages(pool)


def _check_split_counts(kern, run, plain, reach, page):
    """A split-KV paged kernel (B5, B6) at one split, at 8 and at its
    served count, each in one launch: against its split plain version
    (``plain(chunk)``, its rounding model) and the unsplit one
    (``plain(None)``) within 1e-4 (f32 residuals), and m bit for bit with
    its one-split launch."""
    want = plain(None)
    one = None
    for splits in (1, 8, None):
        n = splits or dec_kern.paged_splits(reach, page)
        before = kern.launches
        got = run(splits)
        assert kern.launches == before + 1
        split_want = plain(dec_kern.split_chunk(reach, n, page))
        for a, w, sw in zip(got, want, split_want):
            torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(a, sw, atol=1e-4, rtol=1e-4)
        one = got if one is None else one
        assert torch.equal(got[1], one[1])
    return one


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("d,window,softcap", [(128, None, None),
                                              (64, 50, 20.0),
                                              (256, None, 50.0)])
def test_quant_paged_decode_kernel(cuda, kv_dtype, d, window, softcap):
    """B5 at one split, 8 and its served count against its split plain
    version and the unsplit one on the same quantized bytes (f32
    residuals, 1e-4), at the pool's page and a logical page of 16; and
    against bf16 B4 on the unquantized data within the documented
    DECODE_TOL."""
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
    args = (q, kq, vq, ks, vs, bt, lengths)
    for page_size in (None, 16):
        _check_split_counts(
            quant_kern.KERNEL, lambda n: dec_ops.quant_paged_decode_attention(
                *args, page_size=page_size, splits=n, return_residuals=True,
                **kw),
            lambda chunk: dec_ref.quant_paged_decode_attention_ref(
                *args, chunk=chunk, return_residuals=True, **kw),
            bt.shape[1] * ps, page_size or ps)
    out = dec_ops.quant_paged_decode_attention(*args, **kw)
    bf16 = dec_ops.paged_decode_attention(q, kp, vp, bt, lengths, **kw)
    assert float((out.float() - bf16.float()).abs().max()) <= \
        DECODE_TOL[kv_dtype]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quant_paged_decode_kernel_at_gemma2_table(cuda, kv_dtype):
    """B5 at gemma2-2b's global layers: 8 slots, 8/4 heads of 256, tables
    of 128 pages of 64 (8,192 rows), softcap 50, lengths 1..8192; one
    split, 8 and the served 32, as above."""
    label, hq, hkv, d, s, lengths, kw = SPLIT_PAGED_CASES[2]
    g = torch.Generator(device=cuda).manual_seed(6)
    b = len(lengths)
    q = torch.randn(b, hq, d, device=cuda, generator=g).bfloat16()
    kc = torch.randn(b, hkv, s, d, device=cuda, generator=g).bfloat16()
    vc = torch.randn(b, hkv, s, d, device=cuda, generator=g).bfloat16()
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    (kp, vp), bt = _pools_from_caches(kc, vc, 64,
                                      torch.Generator().manual_seed(1))
    (kq, ks), (vq, vs) = _quantized(kp, kv_dtype), _quantized(vp, kv_dtype)
    args = (q, kq, vq, ks, vs, bt, ln)
    _check_split_counts(
        quant_kern.KERNEL, lambda n: dec_ops.quant_paged_decode_attention(
            *args, splits=n, return_residuals=True, **kw),
        lambda chunk: dec_ref.quant_paged_decode_attention_ref(
            *args, chunk=chunk, return_residuals=True, **kw),
        bt.shape[1] * 64, 64)


@pytest.mark.parametrize("kv_dtype", [None, "float32", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("k1,d,window", [(5, 128, None), (1, 128, None),
                                         (3, 64, 40), (5, 256, None),
                                         (5, 256, 100)])
def test_spec_paged_decode_kernel(cuda, kv_dtype, k1, d, window):
    """B6 (bf16 and f32 pools and its int8/fp8 mode) at one split, 8 and
    its served count against its split plain version and the unsplit
    one, f32 residuals at 1e-4, m bit for bit; slot 0 reads one page,
    slot 2's horizons straddle a page (and with 8 splits a chunk) edge,
    slot 3's window runs past the table's last page."""
    g = torch.Generator(device=cuda).manual_seed(2)
    b, hq, hkv, s, ps = 4, 32, 8, 320, 64
    dt = torch.float32 if kv_dtype == "float32" else torch.bfloat16
    q = torch.randn(b, k1, hq, d, device=cuda, generator=g).to(dt)
    kc = torch.randn(b, hkv, s, d, device=cuda, generator=g).to(dt)
    vc = torch.randn(b, hkv, s, d, device=cuda, generator=g).to(dt)
    base = torch.tensor([0, 1, 126, s - k1 + 1], dtype=torch.int32,
                        device=cuda)
    (kp, vp), bt = _pools_from_caches(kc, vc, ps,
                                      torch.Generator().manual_seed(0))
    bt[0, 0] = bt[3, 0]                # slot 0 reads one page
    if kv_dtype in (None, "float32"):
        args = (q, kp, vp, bt, base)
        fn = dec_ops.spec_paged_decode_attention
        plain = dec_ref.spec_paged_decode_attention_ref
    else:
        (kq, ks), (vq, vs) = _quantized(kp, kv_dtype), _quantized(vp,
                                                                  kv_dtype)
        args = (q, kq, vq, ks, vs, bt, base)
        fn = dec_ops.quant_spec_paged_decode_attention
        plain = dec_ref.quant_spec_paged_decode_attention_ref
    _check_split_counts(
        spec_kern.KERNEL, lambda n: fn(*args, window=window, splits=n,
                                       return_residuals=True),
        lambda chunk: plain(*args, window=window, chunk=chunk,
                            return_residuals=True),
        bt.shape[1] * ps, ps)


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


def _logical_window_args(args, page_size):
    """The window operands (q, pools, [scales,] ring tables, lengths)
    re-viewed at a logical page, as the launcher hands them to the
    kernel: its ring walk then starts on a logical page."""
    if page_size is None:
        return args
    q, kp, vp, *rest = args
    ps = kp.shape[2]
    kp_l, bt_l = paged_kern.repage(kp, rest[-2], page_size)
    vp_l, _ = paged_kern.repage(vp, rest[-2], page_size)
    scales = [paged_kern.repage_scales(sc, page_size, ps).contiguous()
              for sc in rest[:-2]]
    return (q, kp_l, vp_l, *scales, bt_l.to(torch.int32).contiguous(),
            rest[-1])


#: ring geometries of the window kernel checks: (window, page, lengths):
#: an empty slot, one inside the window, one at its edge, and rings that
#: have wrapped (lengths up to 5x the window), one split at the served
#: chunks, then five
WINDOW_RINGS = [(96, 32, (0, 1, 96, 130, 481)),
                (1000, 64, (0, 1, 1000, 1301, 4811))]


@pytest.mark.parametrize("splits", [1, None, 8],
                         ids=["one split", "served", "8 splits"])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("ring", WINDOW_RINGS,
                         ids=[f"window {r[0]}" for r in WINDOW_RINGS])
def test_window_paged_decode_kernel(cuda, ring, d, kv_dtype, splits):
    """B7 (bf16 pools) and B7q (int8, fp8) at one split, at their served
    count and at 8, each in one launch: against their split plain
    versions (``chunk=``, counted from the ring walk's start) and the
    unsplit ones, f32 residuals at 1e-4, m bit for bit with a one-split
    launch, at the physical page and a logical one below it."""
    g = torch.Generator(device=cuda).manual_seed(3)
    window, ps, lengths = ring
    hq, hkv = 8, 4
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
    reach = bt.shape[1] * ps
    for page_size in (None, 16):
        page = page_size or ps
        n = splits or dec_kern.paged_splits(reach, page)
        before = kern.launches
        got = fn(*args, page_size=page_size, splits=splits,
                 return_residuals=True, **kw)
        assert kern.launches == before + 1
        split_want = plain(*_logical_window_args(args, page_size),
                           chunk=dec_kern.split_chunk(reach, n, page),
                           return_residuals=True, **kw)
        for a, w, sw in zip(got, want, split_want):
            torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(a, sw, atol=1e-4, rtol=1e-4)
        one = fn(*args, page_size=page_size, splits=1, return_residuals=True,
                 **kw)
        assert torch.equal(got[1], one[1])
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
    (4, 8, 520, 200, "registry"),         # jamba-like decode: N % 128, K % 16
    (3, 3, 96, 136, "edges"),             # decode, C 3: sizes 0, C, 7
    (2, 184, 64, 128, "full"),            # the largest prefill's C
    (3, 160, 264, 392, "full")])          # jamba's prefill C, N % 128
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
    (1, 2, 7, 32, torch.bfloat16),          # fewer steps than a chunk
    (1, 4, 1, 1024, torch.bfloat16),        # one step
    (1, 4, 17, 1024, torch.bfloat16),       # S off a multiple of the chunk
    (2, 4, 64, 1024, torch.bfloat16),       # S a multiple of the chunk
    (1, 4, 200, 1024, torch.float32),
    (1, 4, 45, 1024, torch.float32),        # f32, a short last chunk
    (2, 4, 511, 1024, torch.bfloat16)])     # the largest prefill group
def test_mlstm_scan_kernel(cuda, b, h, s, dk, dtype):
    """B10 against its plain versions, h and the final state (C, n, m):
    against the recurrent one, f32 outputs (the state, and h of f32
    inputs) at the op's 2e-4, bf16 h at 2e-2; against the plain version
    of the body that ran (``plain_chunk``: the chunkwise form at the
    bf16 body's chunk, all in f32; the recurrence for the f32 body) more
    tightly, f32 outputs at 1e-4, which holds the bf16 kernel's rounding
    of C, D o S and w V to bf16 high and low halves, and bf16 h at one
    bf16 rounding, 1e-2; q/k/v in ``dtype``,
    the gates in f32, as the mLSTM layer hands them over; one launch
    with the state and one without."""
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
    ch, (cc, cn, cm) = mlstm_ref.mlstm_scan_ref(
        q, k, v, ig, fg, return_state=True,
        chunk=mlstm_kern.plain_chunk(dtype))
    tight = dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out.float(), ch.float(), **(
        tight if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)))
    for got, ref in ((c, cc), (n, cn), (m, cm)):
        torch.testing.assert_close(got, ref, **tight)


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


def test_runtime_warp_product_on_both_targets(cuda):
    """The test kernel's tensor-core product (rt::mma_bf16_m16n8k16 over
    every rt::load_matrix_* form) and quad reductions count no wrong
    output on the card's target nor on the generic one, whose product
    and loads go through shared memory."""
    got = selftest.launch(7, 1000, 6, portable=True, device=cuda)
    with target("generic"):
        got_generic = selftest.launch(7, 1000, 6, portable=True, device=cuda)
    for arch, res in (("cuda", got), ("generic", got_generic)):
        assert res["counters"]["mma_errs"] == 0, arch
        assert res["counters"]["quad_errs"] == 0, arch


def test_tensor_core_builds_hold_hmma(cuda):
    """B2's bf16 builds (all four head dims), B11b's and B8's hold HMMA
    instructions in their SASS; B2's generic build holds none."""
    from repro_torch.bench import parity
    counts = parity.hmma_counts()
    mma = {(r["build"], r["target"]): r for r in counts}
    for build, n_inst in (("flash_attention", 4),
                          ("flash_attention_native", 3), ("gmm", 2)):
        r = mma[(build, "cuda")]
        assert len(r["bf16"]) == n_inst, r
        assert all(n > 0 for n in r["bf16"].values()), r
    generic = mma[("flash_attention", "generic")]
    assert len(generic["bf16"]) == 4
    assert sum(generic["bf16"].values()) == 0, generic


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


@pytest.mark.parametrize("n", [1, 5, 127, 200, 300, 1024])
def test_det_ratios_at_every_orbital_count(cuda, n):
    """B19 at N not a multiple of 4 (4-byte loads, a ragged last group of
    columns) and at multiples (16-byte loads), with 8, 4, 2 and 1 row
    slices a team: both builds bit for bit, each within the stated
    tolerance of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(n)
    nw = 8
    a_inv = torch.randn(nw, n, n, device=cuda, generator=g)
    phi = torch.randn(nw, n, device=cuda, generator=g)
    got = mq.evaluate_det_ratios(a_inv, phi)
    assert torch.equal(got, mq.evaluate_det_ratios(a_inv, phi, native=True))
    want = mq_ref.evaluate_det_ratios_ref(a_inv, phi)
    atol, rtol = mq.tolerance("evaluateDetRatios", (a_inv, phi), want)
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


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


@pytest.mark.parametrize("n", [1, 7, 64, 513, 520])
@pytest.mark.parametrize("nb", [1, 33, 1000])
def test_pbt_tiles_at_ragged_shapes(cuda, nb, n):
    """pbt's arena tiles (64 systems a team, 32 columns a tile) at shapes
    that are not whole teams or tiles, with rows 16-byte aligned (n 64,
    520) and not (n 1, 7, 513: 4-byte copies): x, cp and dp of the
    portable, native and generic builds, native = portable bit for bit,
    each within the stated tolerance of the plain sweeps."""
    rng = np.random.default_rng(nb * 1000 + n)
    lo, up, di = (rng.random((nb, n), dtype=np.float32) for _ in "lud")
    args = tuple(torch.from_numpy(a).to(cuda) for a in (
        0.4 * lo, 2.0 + di, 0.4 * up,
        rng.standard_normal((nb, n), dtype=np.float32)))
    got = sa.pbt_sweeps(*args)
    assert all(torch.equal(a, b)
               for a, b in zip(got, sa.pbt_sweeps(*args, native=True)))
    with target("generic"):
        generic = sa.pbt_sweeps(*args)
    want = sa_ref.pbt_sweeps(*args)
    for out in (got, generic):
        for g, w in zip(out, want):
            atol, rtol = sa.tolerance("570.pbt", args, w)
            torch.testing.assert_close(g, w, atol=atol, rtol=rtol)


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
