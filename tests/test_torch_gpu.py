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
from repro_torch.bench.standin import check_builds, outputs
from repro_torch.configs.base import MLAConfig
from repro_torch.configs.smoke import smoke_config
from repro_torch.core import selftest
from repro_torch.core.context import target
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import flash_attention as fa_kern
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


# ------------------------------------------ gemma3: qk-norm, 5:1, RoPE bases --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 300, 256), (2, 16, 300, 128),
                                   (8, 8, 1, 256), (8, 32, 1, 128)],
                         ids=["4b-prefill", "27b-prefill", "4b-decode",
                              "27b-decode"])
def test_rmsnorm_kernel_at_qk_norm_rows(cuda, dtype, shape):
    """B1 over (B, H, S, head_dim) heads, as qk-norm runs it: rows of 256
    (gemma3-4b) and 128 (gemma3-27b), in one launch, against its plain
    version; the staged schedule and the streaming one bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    w = (0.5 * torch.randn(shape[-1], device=cuda, generator=g)).to(dtype)
    before = rms_kern.KERNEL.launches
    got = rms_ops.rmsnorm(x, w, eps=1e-6, weight_offset=1.0)
    assert rms_kern.KERNEL.launches == before + 1
    want = rms_ref.rmsnorm_ref(x, w, eps=1e-6, weight_offset=1.0)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    twin = rms_native.rmsnorm_native(x, w, eps=1e-6, weight_offset=1.0)
    assert torch.equal(got, twin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 256])
def test_flash_kernel_at_gemma3_windows(cuda, dtype, d):
    """B2 at gemma3's heads (no softcap) over a window shorter than the
    prompt (its local layers) and over none (its global ones)."""
    q, k, v = _flash_operands(cuda, dtype, 300, 300, d, d, seed=5)
    for window in (64, None):
        kw = dict(causal=True, window=window, scale=d ** -0.5)
        got = fa_ops.flash_attention(q, k, v, **kw)
        want = fa_ref.flash_attention_ref(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
        if dtype == torch.bfloat16:
            model = fa_ref.flash_attention_bf16_operands(q, k, v, **kw)
            assert fa_ref.model_mismatch(got, model) <= fa_ref.MODEL_MISMATCH


def _gemma3_card_model(head_dim, pattern=None):
    """The gemma3 smoke pattern cut to 7 layers (five local of window
    16, one global, one local) at a head dim the kernels take, float32,
    its qk-norm weights drawn from a seed so that they matter."""
    cfg = dataclasses.replace(smoke_config("gemma3-4b", num_layers=7),
                              d_model=256, num_heads=4, num_kv_heads=2,
                              head_dim=head_dim, d_ff=512, dtype="float32")
    if pattern is not None:
        cfg = dataclasses.replace(cfg, layer_pattern=pattern)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    for layer in params["layers"]:
        for name in ("q_norm", "k_norm"):
            layer["attn"][name] = 0.5 * torch.randn(head_dim, generator=g)
    return model, params


@pytest.mark.parametrize("head_dim", [128, 256])
@pytest.mark.parametrize("mode", [
    dict(paged=False), dict(paged=True), dict(paged=True, kv_dtype="int8")],
    ids=["dense-ring", "paged-window", "int8-window"])
def test_gemma3_engine_on_card_matches_cpu(cuda, mode, head_dim):
    """qk-norm (B1 at rows of the head), two RoPE bases and the 5:1
    pattern at window 16, mid-cycle: the same greedy tokens on the card
    (B1, B2, B3 over rings, B4 and B7, or B5 and B7q) and on the CPU,
    past the window, with prefix frees."""
    model, params = _gemma3_card_model(head_dim)
    outs = {}
    for dev in ("cpu", "cuda"):
        sc = ServeConfig(slots=2, cache_len=48, max_new_tokens=12,
                         page_size=8, **mode)
        eng = Engine(model, _to(params, dev), sc, device=dev)
        reqs = [Request(rid=i, tokens=[1 + i] * (3 + 9 * i))
                for i in range(3)]
        before = rms_kern.KERNEL.launches
        eng.run_to_completion(reqs)
        assert all(r.done and len(r.out) == 12 for r in reqs)
        assert (rms_kern.KERNEL.launches > before) == (dev == "cuda")
        if eng.paged:
            assert eng.stats()["window_prefix_frees"] > 0
        outs[dev] = [r.out for r in reqs]
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_gemma3_global_spec_engine_on_card_matches_cpu(cuda, kv_dtype):
    """qk-norm under speculation (a global-only pattern: the engine
    refuses speculation over local layers), k = 3: B6 on the card."""
    model, params = _gemma3_card_model(128, pattern=("global",))
    outs = {}
    for dev in ("cpu", "cuda"):
        sc = ServeConfig(slots=2, cache_len=48, max_new_tokens=12,
                         page_size=8, paged=True, spec_mode="ngram",
                         spec_k=3, kv_dtype=kv_dtype)
        eng = Engine(model, _to(params, dev), sc, device=dev)
        reqs = [Request(rid=i, tokens=[1 + i] * (3 + 9 * i))
                for i in range(3)]
        eng.run_to_completion(reqs)
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


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_jamba_quantized_engine_on_card_matches_cpu(cuda, kv_dtype):
    """jamba's 4-layer cut from int8 and fp8 pools (B5 at the attention
    layer, the mamba state dense): the same greedy tokens on the card
    and on the CPU."""
    cfg = dataclasses.replace(
        smoke_config("jamba-1.5-large-398b"), num_layers=4, d_model=256,
        num_heads=2, num_kv_heads=2, head_dim=128, d_ff=512,
        dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        sc = ServeConfig(slots=2, cache_len=48, max_new_tokens=12,
                         page_size=8, paged=True, kv_dtype=kv_dtype)
        eng = Engine(model, _to(params, dev), sc, device=dev)
        reqs = [Request(rid=i, tokens=[1 + i] * (3 + 9 * i))
                for i in range(3)]
        before = quant_kern.KERNEL.launches
        eng.run_to_completion(reqs)
        assert all(r.done and len(r.out) == 12 for r in reqs)
        assert (quant_kern.KERNEL.launches > before) == (dev == "cuda")
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


@pytest.mark.parametrize("mode", [
    dict(paged=False), dict(paged=True), dict(paged=True, kv_dtype="int8")],
    ids=["dense", "paged", "int8"])
def test_xlstm_engine_on_card_matches_cpu(cuda, mode):
    """The same greedy tokens on the card (B1, and B10 at every prefill
    with its state output) and on the CPU (plain versions); with an int8
    ``kv_dtype`` there is no pool to quantize."""
    model = build_model(_xlstm_card_config())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        sc = ServeConfig(slots=2, cache_len=48, max_new_tokens=12,
                         page_size=8, **mode)
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


def _standin_builds_agree(name, args):
    """A SPEC ACCEL stand-in's native and portable builds bit for bit on
    ``args``, and each of them and the generic build finite, of the
    plain shape and within the stated tolerance of the plain version."""
    fn, plain = sa.FUNCS[name]
    res = check_builds(fn, plain, args,
                       lambda want: sa.tolerance(name, args, want))
    assert res["bit_identical"], res
    for side in ("native", "portable", "generic"):
        assert res[f"ok_{side}"], (side, res)


@pytest.mark.parametrize("n", [256, 768, (1 << 14) + 256])
def test_pep_at_ragged_teams(cuda, n):
    """pep's teams of 8 warps, a block of 256 seeds a warp, where the
    last team holds 1 block (n 256), 3 (768) or 1 after whole teams
    (2^14 + 256), on seeds over the whole int32 range."""
    seeds = np.random.default_rng(n).integers(
        -2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    _standin_builds_agree("552.pep", (torch.from_numpy(seeds).to(cuda),))


def test_pep_at_the_ends_of_the_uniforms(cuda):
    """A block holding the seeds of u1 = 1 - 2^-24 (log u1 about -6e-8,
    where an approximate logarithm could make -2 log u1 negative), u1 =
    1 and 2^-32, and u2 = 1, 1/2 (a tie of the phase's rint), just past
    1/2 and 2^-32, between two random blocks: no NaN, max z finite."""
    seeds = np.concatenate([sa_ref.pep_edge_block(s) for s in (1, 2, 3)])
    seeds[:256] = np.random.default_rng(4).integers(
        -2 ** 31, 2 ** 31, 256, dtype=np.int64).astype(np.int32)
    args = (torch.from_numpy(seeds).to(cuda),)
    _standin_builds_agree("552.pep", args)
    got = sa.pep(*args)
    assert bool(torch.isfinite(got).all()), got
    # a = 0 gives b = 0: u1 = u2 = 2^-32, the largest r (6.6604), cos 1
    assert float(got[1:, 2].min()) > 6.66


@pytest.mark.parametrize("h,w", [(64, 1), (64, 2), (64, 3), (64, 4),
                                 (64, 5), (64, 130), (64, 196), (64, 2048),
                                 (128, 128)])
def test_polbm_tiles_at_every_width(cuda, h, w):
    """polbm's tiles of 16 rows x 64 cells at widths narrower than the
    halo (w 1, 2, 3 wrap onto themselves), not whole 16-byte vectors of
    cells (1, 2, 3, 5, 130: 4-byte copies), whole vectors with a ragged
    last tile (4, 196) and whole tiles (2048, 128)."""
    f = np.random.default_rng(h * w).random((h, w, 9), dtype=np.float32)
    _standin_builds_agree("504.polbm",
                          (torch.from_numpy(f + np.float32(0.5)).to(cuda),))


@pytest.mark.parametrize("w", [1, 3, 4, 130, 2048])
def test_polbm_streams_periodically_on_the_card(cuda, w):
    """The card's counterpart of the CPU test of streaming: a lattice at
    rest collides to itself, so each plane k of every build's output is
    the input's moved by (cx_k, cy_k), across the tiles' edges (rows 16
    apart, cells 64 apart) and wrapping at the lattice's; a bump of
    density 3 at each tile corner moves with its planes.  Held at the
    stand-in's 1e-5 (the collision rounds rho; a plane moved wrong is
    off by 0.1 or more)."""
    f = torch.from_numpy(sa_ref.polbm_rest_lattice(64, w))
    for i, j in ((0, 0), (15, 63), (16, 64), (63, w - 1), (31, 127)):
        f[i, j % w] *= 3.0
    f = f.to(cuda)
    outs = (sa.polbm(f), sa.polbm(f, native=True))
    with target("generic"):
        outs += (sa.polbm(f),)
    assert torch.equal(outs[0], outs[1])
    for out in outs:
        for k, (cx, cy) in enumerate(sa_ref.D2Q9):
            torch.testing.assert_close(
                out[..., k],
                torch.roll(f[..., k], (int(cx), int(cy)), (0, 1)),
                atol=1e-5, rtol=0)


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


# ------------------------------------- faults: the K/V NaN law, B3-B7q --

def _nan_same(got, want):
    """The residuals (acc, m, l) and the normalised output: the same
    finiteness mask, finite values within the f32 residuals' 1e-4."""
    def norm(res):
        return res[0] / torch.where(res[2] == 0, 1.0, res[2])[..., None]
    for a, w in zip(tuple(got) + (norm(got),), tuple(want) + (norm(want),)):
        fa, fw = torch.isfinite(a), torch.isfinite(w)
        assert torch.equal(fa, fw)
        torch.testing.assert_close(a[fa], w[fw], atol=1e-4, rtol=1e-4)
    return norm(got)


def _nan_splits(kern, run, plain, served, chunk_of, slot, kside):
    """A split-KV kernel at one split, at 4 and at its served count, each
    in one launch, against its plain version (split, or unsplit at one
    split) on operands with NaN in one K-side or V-side page of ``slot``
    that is neither its first nor its last: a K-side NaN leaves the slot
    exactly 0 (m NaN, l 0), a V-side one makes it NaN, nothing else."""
    for splits in (1, 4, served):
        before = kern.launches
        got = run(splits)
        assert kern.launches == before + 1
        out = _nan_same(got, plain(None if splits == 1
                                   else chunk_of(splits)))
        others = torch.ones(out.shape[0], dtype=torch.bool)
        others[slot] = False
        assert torch.isfinite(out[others.to(out.device)]).all()
        if kside:
            assert (out[slot] == 0).all() and torch.isnan(got[1][slot]).all()
        else:
            assert torch.isnan(out[slot]).all()


def _nan_operands(cuda, d=128, s=320, ps=64, k1=None, seed=7):
    """q and K/V pools of scrambled pages, each slot's table row whole
    (5 pages of 64); slot 2's third page (rows 128..191) is a middle one
    for the lengths used (200 to 300)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    b, hq, hkv, t = 4, 32, 8, s // ps
    qshape = (b, hq, d) if k1 is None else (b, k1, hq, d)
    q = torch.randn(*qshape, device=cuda, generator=g).bfloat16()
    kp, vp = (torch.randn(hkv, 1 + b * t, ps, d, device=cuda,
                          generator=g).bfloat16() for _ in range(2))
    bt = (torch.randperm(b * t, generator=torch.Generator().manual_seed(2))
          .reshape(b, t) + 1).to(torch.int32).to(cuda)
    return q, kp, vp, bt


@pytest.mark.parametrize("side", ["k", "v"])
def test_dense_decode_kernel_nan_law(cuda, side):
    """B3: NaN in rows 128..191 of slot 2's K or V cache."""
    g = torch.Generator(device=cuda).manual_seed(7)
    b, hq, hkv, s, d = 4, 32, 8, 300, 128
    q = torch.randn(b, hq, d, device=cuda, generator=g).bfloat16()
    kc, vc = (torch.randn(b, hkv, s, d, device=cuda, generator=g).bfloat16()
              for _ in range(2))
    (kc if side == "k" else vc)[2, :, 128:192] = float("nan")
    ln = torch.tensor([64, 200, 299, 300], dtype=torch.int32, device=cuda)
    _nan_splits(
        dec_kern.KERNEL, lambda n: dec_ops.decode_attention(
            q, kc, vc, ln, splits=n, return_residuals=True),
        lambda chunk: dec_ref.decode_attention_ref(
            q, kc, vc, ln, chunk=chunk, return_residuals=True),
        max(2, dec_kern.decode_splits(s)),
        lambda n: dec_kern.split_chunk(s, n), 2, side == "k")


@pytest.mark.parametrize("side", ["k", "v"])
def test_paged_decode_kernel_nan_law(cuda, side):
    """B4: NaN in slot 2's third page of the K or V pool."""
    q, kp, vp, bt = _nan_operands(cuda)
    ln = torch.tensor([64, 200, 299, 300], dtype=torch.int32, device=cuda)
    (kp if side == "k" else vp)[:, int(bt[2, 2])] = float("nan")
    reach = bt.shape[1] * 64
    _nan_splits(
        paged_kern.KERNEL, lambda n: dec_ops.paged_decode_attention(
            q, kp, vp, bt, ln, splits=n, return_residuals=True),
        lambda chunk: dec_ref.paged_decode_attention_ref(
            q, kp, vp, bt, ln, chunk=chunk, return_residuals=True),
        max(2, dec_kern.paged_splits(reach, 64)),
        lambda n: dec_kern.split_chunk(reach, n, 64), 2, side == "k")


@pytest.mark.parametrize("side", ["k", "v"])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quant_paged_decode_kernel_nan_law(cuda, kv_dtype, side):
    """B5: NaN in the K or V scale of slot 2's third page."""
    q, kp, vp, bt = _nan_operands(cuda)
    (kq, ks), (vq, vs) = _quantized(kp, kv_dtype), _quantized(vp, kv_dtype)
    (ks if side == "k" else vs)[:, int(bt[2, 2])] = float("nan")
    ln = torch.tensor([64, 200, 299, 300], dtype=torch.int32, device=cuda)
    args = (q, kq, vq, ks, vs, bt, ln)
    reach = bt.shape[1] * 64
    _nan_splits(
        quant_kern.KERNEL, lambda n: dec_ops.quant_paged_decode_attention(
            *args, splits=n, return_residuals=True),
        lambda chunk: dec_ref.quant_paged_decode_attention_ref(
            *args, chunk=chunk, return_residuals=True),
        max(2, dec_kern.paged_splits(reach, 64)),
        lambda n: dec_kern.split_chunk(reach, n, 64), 2, side == "k")


@pytest.mark.parametrize("side", ["k", "v"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_spec_paged_decode_kernel_nan_law(cuda, kv_dtype, side):
    """B6 (K1 = 5, bf16 and int8 pools): every row of slot 2 sees the
    poisoned third page."""
    q, kp, vp, bt = _nan_operands(cuda, k1=5)
    page = int(bt[2, 2])
    base = torch.tensor([40, 150, 250, 300], dtype=torch.int32, device=cuda)
    if kv_dtype is None:
        (kp if side == "k" else vp)[:, page] = float("nan")
        args = (q, kp, vp, bt, base)
        fn = dec_ops.spec_paged_decode_attention
        plain = dec_ref.spec_paged_decode_attention_ref
    else:
        (kq, ks), (vq, vs) = _quantized(kp, kv_dtype), _quantized(vp,
                                                                  kv_dtype)
        (ks if side == "k" else vs)[:, page] = float("nan")
        args = (q, kq, vq, ks, vs, bt, base)
        fn = dec_ops.quant_spec_paged_decode_attention
        plain = dec_ref.quant_spec_paged_decode_attention_ref
    reach = bt.shape[1] * 64
    _nan_splits(
        spec_kern.KERNEL, lambda n: fn(*args, splits=n,
                                       return_residuals=True),
        lambda chunk: plain(*args, chunk=chunk, return_residuals=True),
        max(2, dec_kern.paged_splits(reach, 64)),
        lambda n: dec_kern.split_chunk(reach, n, 64), 2, side == "k")


@pytest.mark.parametrize("side", ["k", "v"])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
def test_window_paged_decode_kernel_nan_law(cuda, kv_dtype, side):
    """B7 and B7q over rings of window 1000 (pages of 64): NaN in the
    middle page of slot 3's live window (length 1301, 17 live pages)."""
    window, ps, lengths = 1000, 64, (1, 1000, 1301, 1301)
    g = torch.Generator(device=cuda).manual_seed(8)
    bt, n_pages = _ring_tables(lengths, window, ps,
                               torch.Generator().manual_seed(3))
    live = list(live_window_pages(1301, window, ps))
    page = int(bt[2, live[len(live) // 2] % bt.shape[1]])
    bt = bt.to(cuda)
    q = torch.randn(len(lengths), 8, 128, device=cuda, generator=g).bfloat16()
    kp, vp = (torch.randn(4, n_pages, ps, 128, device=cuda,
                          generator=g).bfloat16() for _ in range(2))
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if kv_dtype is None:
        (kp if side == "k" else vp)[:, page] = float("nan")
        args, kern = (q, kp, vp, bt, ln), paged_kern.WINDOW_KERNEL
        fn = dec_ops.window_paged_decode_attention
        plain = dec_ref.window_paged_decode_attention_ref
    else:
        (kq, ks), (vq, vs) = _quantized(kp, kv_dtype), _quantized(vp,
                                                                  kv_dtype)
        (ks if side == "k" else vs)[:, page] = float("nan")
        args = (q, kq, vq, ks, vs, bt, ln)
        kern = paged_kern.QUANT_WINDOW_KERNEL
        fn = dec_ops.quant_window_paged_decode_attention
        plain = dec_ref.quant_window_paged_decode_attention_ref
    reach = bt.shape[1] * ps
    _nan_splits(
        kern, lambda n: fn(*args, window=window, splits=n,
                           return_residuals=True),
        lambda chunk: plain(*args, window=window, chunk=chunk,
                            return_residuals=True),
        max(2, dec_kern.paged_splits(reach, ps)),
        lambda n: dec_kern.split_chunk(reach, n, ps), 2, side == "k")


@pytest.mark.parametrize("mode", [dict(), dict(kv_dtype="int8")],
                         ids=["bf16", "int8"])
def test_engine_on_card_recovers_from_faults(cuda, mode):
    """A small paged engine on the card under a scheduled kv_corrupt and
    nan_logits: audit-clean after every step, every request done, a page
    quarantined, and the tokens of the same run on the CPU."""
    from repro_torch.serve.faults import FaultPlan
    cfg = dataclasses.replace(smoke_config("granite-8b", num_layers=2),
                              d_model=256, num_heads=8, num_kv_heads=2,
                              head_dim=64, d_ff=512, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        plan = FaultPlan().at(3, "kv_corrupt").at(5, "nan_logits")
        sc = ServeConfig(slots=2, cache_len=48, max_new_tokens=12,
                         page_size=8, paged=True, retry_backoff=1, **mode)
        eng = Engine(model, _to(params, dev), sc, device=dev,
                     fault_plan=plan)
        reqs = [Request(rid=i, tokens=[1 + i] * (3 + 5 * i))
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        for _ in range(500):
            busy = eng.step()
            assert eng.audit() == []
            if not busy and not eng.queue and not eng.requeue:
                break
        assert all(r.done and len(r.out) == 12 for r in reqs)
        st = eng.stats()
        assert st["quarantined"] >= 1
        assert st["recoveries"]["kv_corrupt"] >= 1
        assert st["recoveries"]["nan_logits"] >= 1
        assert st["available"] == st["total_pages"] - 1 - st["quarantined"]
        outs[dev] = ([r.out for r in reqs], st["recoveries"],
                     st["quarantined"])
    assert outs["cuda"] == outs["cpu"]


def test_sampler_follows_softmax_on_card(cuda):
    """The engine's Gumbel-max sampler on the card: 2^18 draws from one
    fixed 32-way row at T = 0.8 with a generator seeded 0, each class's
    frequency within 5 standard errors of softmax(logits / T); the same
    seed draws the same tokens."""
    from repro_torch.serve.engine import sample
    rng = np.random.default_rng(0)
    row = torch.from_numpy(rng.standard_normal(32).astype(np.float32) * 2)
    n = 1 << 18
    logits = row.to(cuda).expand(n, 32).contiguous()
    got = sample(logits, 0.8, torch.Generator(device=cuda).manual_seed(0))
    again = sample(logits, 0.8, torch.Generator(device=cuda).manual_seed(0))
    assert torch.equal(got, again)
    freq = torch.bincount(got.long(), minlength=32).double().cpu() / n
    p = torch.softmax(row.double() / 0.8, dim=0)
    se = torch.sqrt(p * (1 - p) / n)
    assert bool(((freq - p).abs() <= 5 * se).all()), \
        float(((freq - p).abs() / se).max())


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "t0.8"])
def test_engine_on_card_replays_trace_like_cpu(cuda, temperature):
    """A small paged engine replaying the committed bursty trace on the
    card, priority policy over an oversubscribed pool, telemetry on:
    audit-clean after every step, every request done with its budget,
    one host copy per decode step and per admitted group, and every
    decision (kind, request, slot, step) of the same engine on the
    CPU."""
    import pathlib
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve import workload
    from repro_torch.serve.telemetry import ServeTelemetry
    path = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
            / "traces" / "bursty_smoke.jsonl")
    cfg = dataclasses.replace(smoke_config("granite-8b", num_layers=2),
                              d_model=256, num_heads=8, num_kv_heads=2,
                              head_dim=64, d_ff=512, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    decisions = {}
    for dev in ("cpu", "cuda"):
        tel = ServeTelemetry()
        sc = ServeConfig(slots=4, cache_len=64, max_new_tokens=16,
                         page_size=8, paged=True, total_pages=1 + 15,
                         preempt_policy="priority", temperature=temperature)
        eng = Engine(model, _to(params, dev), sc, device=dev, telemetry=tel)
        copies, groups = [0], [0]
        real_get, real_admit = engine_mod._device_get, eng._admit_group

        def counted_get(t, _real=real_get, _copies=copies):
            _copies[0] += 1
            return _real(t)

        def counted_admit(reqs, plen, _real=real_admit, _groups=groups):
            n = _real(reqs, plen)
            _groups[0] += n > 0
            return n

        engine_mod._device_get, eng._admit_group = counted_get, counted_admit
        try:
            reqs = workload.replay(eng, workload.load_trace(str(path)),
                                   audit=True)
        finally:
            engine_mod._device_get = real_get
            del eng._admit_group
        steps = sum(1 for e in tel.trace.events if e.kind == "step")
        assert all(r.done and len(r.out) == min(r.max_new, 16)
                   for r in reqs)
        assert copies[0] == steps + groups[0], (copies, steps, groups)
        assert eng.preemptions > 0
        assert tel.trace.validate() == []
        decisions[dev] = [(e.kind, e.rid, e.slot, e.step)
                          for e in tel.trace.events]
    assert decisions["cuda"] == decisions["cpu"]


# ------------------- MLA over int8/fp8 pools and speculation (192/128) --

def _mla_pools(cuda, dtype=torch.bfloat16, b=4, s=320, ps=64, seed=11,
               distinct=False):
    """deepseek's decode heads (16 of 192 / 128, one per kv head) over
    scrambled pages of 64 (slot 0 freed, slot 1 one page); with
    ``distinct`` every 16-element chunk of a K row holds its own value
    (token, chunk and head apart), so that a chunk the stage misplaced
    changes the scores."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    h, dk, dv = 16, 192, 128
    kc = torch.randn(b, h, s, dk, device=cuda, generator=g)
    vc = torch.randn(b, h, s, dv, device=cuda, generator=g)
    if distinct:
        t = torch.arange(s, device=cuda)[:, None]
        c = torch.arange(dk // 16, device=cuda)[None, :]
        hh = torch.arange(h, device=cuda)[:, None, None]
        val = ((t * (dk // 16) + c)[None] * 7 + hh * 3) % 251 - 125.0
        kc = (val[None].repeat_interleave(16, -1) / 125.0).expand(
            b, -1, -1, -1).contiguous()
    (kp, _), bt = _pools_from_caches(kc.to(dtype), kc.to(dtype), ps,
                                     torch.Generator().manual_seed(0))
    (vp, _), _ = _pools_from_caches(vc.to(dtype), vc.to(dtype), ps,
                                    torch.Generator().manual_seed(0))
    return kp, vp, bt


@pytest.mark.parametrize("distinct", [False, True], ids=["random",
                                                         "distinct"])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_mla_quant_paged_decode_kernel(cuda, kv_dtype, qdtype, distinct):
    """B5 at Dk 192 / Dv 128 (twelve 16-byte chunks a 1-byte key row:
    the stage's swizzle spreads 4 tokens) at one split, 8 and its served
    count against its split plain version and the unsplit one (f32
    residuals, 1e-4), at the pool's page and a logical page of 16; and
    against bf16 B4 on the unquantized data within DECODE_TOL."""
    kp, vp, bt = _mla_pools(cuda, distinct=distinct)
    g = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn(4, 16, 192, device=cuda, generator=g).to(qdtype)
    ln = torch.tensor([0, 1, 299, 320], dtype=torch.int32, device=cuda)
    (kq, ks), (vq, vs) = _quantized(kp, kv_dtype), _quantized(vp, kv_dtype)
    args = (q, kq, vq, ks, vs, bt, ln)
    kw = dict(scale=192 ** -0.5)
    for page_size in (None, 16):
        one = _check_split_counts(
            quant_kern.KERNEL, lambda n: dec_ops.quant_paged_decode_attention(
                *args, page_size=page_size, splits=n, return_residuals=True,
                **kw),
            lambda chunk: dec_ref.quant_paged_decode_attention_ref(
                *args, chunk=chunk, return_residuals=True, **kw),
            bt.shape[1] * 64, page_size or 64)
        assert one[0].shape == (4, 16, 128)
    out = dec_ops.quant_paged_decode_attention(*args, **kw)
    bf16 = dec_ops.paged_decode_attention(q.bfloat16(), kp, vp, bt, ln, **kw)
    assert float((out.float() - bf16.float()).abs().max()) <= \
        DECODE_TOL[kv_dtype]


@pytest.mark.parametrize("distinct", [False, True], ids=["random",
                                                         "distinct"])
@pytest.mark.parametrize("kv_dtype", [None, "float32", "int8", "fp8_e4m3"])
def test_mla_spec_paged_decode_kernel(cuda, kv_dtype, distinct):
    """B6 at Dk 192 / Dv 128 with K1 5 (a group of 1: 5 live rows of its
    G_SPEC build), bf16 and f32 pools and its int8/fp8 mode, at one
    split, 8 and its served count against its plain versions; slot 0
    reads one page, slot 3's window runs past the table's last page."""
    dt = torch.float32 if kv_dtype == "float32" else torch.bfloat16
    kp, vp, bt = _mla_pools(cuda, dtype=dt, seed=13, distinct=distinct)
    bt[0, 0] = bt[3, 0]
    g = torch.Generator(device=cuda).manual_seed(14)
    q = torch.randn(4, 5, 16, 192, device=cuda, generator=g).to(dt)
    base = torch.tensor([0, 1, 126, 316], dtype=torch.int32, device=cuda)
    kw = dict(scale=192 ** -0.5)
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
    one = _check_split_counts(
        spec_kern.KERNEL, lambda n: fn(*args, splits=n,
                                       return_residuals=True, **kw),
        lambda chunk: plain(*args, chunk=chunk, return_residuals=True,
                            **kw),
        bt.shape[1] * 64, 64)
    assert one[0].shape == (4, 5, 16, 128)


@pytest.mark.parametrize("side", ["k", "v"])
@pytest.mark.parametrize("kind", ["int8", "fp8_e4m3", "spec", "spec-int8"])
def test_mla_decode_kernels_nan_law(cuda, kind, side):
    """B5 (int8, fp8) and B6 (bf16, int8 pools; K1 5) at 192 / 128: NaN
    in slot 2's third page (its K or V pool, or a quantized pool's
    scale) leaves that slot exactly 0 (K) or NaN (V), the others
    finite, as the plain versions."""
    kp, vp, bt = _mla_pools(cuda, seed=15)
    bt = (torch.randperm(4 * 5, generator=torch.Generator().manual_seed(2))
          .reshape(4, 5) + 1).to(torch.int32).to(cuda)
    page = int(bt[2, 2])
    g = torch.Generator(device=cuda).manual_seed(16)
    spec = kind.startswith("spec")
    q = torch.randn(*((4, 5, 16, 192) if spec else (4, 16, 192)),
                    device=cuda, generator=g).bfloat16()
    kv_dtype = {"spec": None, "spec-int8": "int8"}.get(kind, kind)
    if kv_dtype is None:
        (kp if side == "k" else vp)[:, page] = float("nan")
        args = (q, kp, vp, bt)
    else:
        (kq, ks), (vq, vs) = _quantized(kp, kv_dtype), _quantized(vp,
                                                                  kv_dtype)
        (ks if side == "k" else vs)[:, page] = float("nan")
        args = (q, kq, vq, ks, vs, bt)
    if spec:
        ln = torch.tensor([40, 150, 250, 300], dtype=torch.int32,
                          device=cuda)
        kern = spec_kern.KERNEL
        fn, plain = ((dec_ops.spec_paged_decode_attention,
                      dec_ref.spec_paged_decode_attention_ref)
                     if kv_dtype is None else
                     (dec_ops.quant_spec_paged_decode_attention,
                      dec_ref.quant_spec_paged_decode_attention_ref))
    else:
        ln = torch.tensor([64, 200, 299, 300], dtype=torch.int32,
                          device=cuda)
        kern = quant_kern.KERNEL
        fn, plain = (dec_ops.quant_paged_decode_attention,
                     dec_ref.quant_paged_decode_attention_ref)
    reach = bt.shape[1] * 64
    _nan_splits(
        kern, lambda n: fn(*args, ln, splits=n, return_residuals=True),
        lambda chunk: plain(*args, ln, chunk=chunk, return_residuals=True),
        max(2, dec_kern.paged_splits(reach, 64)),
        lambda n: dec_kern.split_chunk(reach, n, 64), 2, side == "k")


# ------------------------------------------- arctic: GQA group 7 ------

@pytest.mark.parametrize("splits", [1, 8, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_7_attention_kernels(cuda, dtype, splits):
    """B2, B3 and B4 at arctic's 56 query heads over 8 KV heads of 128
    (a group of 7 through the group-8 builds of B3 and B4, their eighth
    row masked): every head against the plain versions, so a write of
    the eighth row into the next group's first head would show; B3 and
    B4 at one split, 8 and the served count, each in one launch."""
    g = torch.Generator(device=cuda).manual_seed(17)
    hq, hkv, d = 56, 8, 128
    q = torch.randn(2, hq, 130, d, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(2, hkv, 130, d, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    got = fa_ops.flash_attention(q, k, v)
    want = fa_ref.flash_attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    b, s = 4, 320
    qd = torch.randn(b, hq, d, device=cuda, generator=g).to(dtype)
    kc, vc = (torch.randn(b, hkv, s, d, device=cuda, generator=g).to(dtype)
              for _ in range(2))
    ln = torch.tensor([0, 1, 299, 320], dtype=torch.int32, device=cuda)
    want = dec_ref.decode_attention_ref(qd, kc, vc, ln,
                                        return_residuals=True)
    before = dec_kern.KERNEL.launches
    got = dec_ops.decode_attention(qd, kc, vc, ln, splits=splits,
                                   return_residuals=True)
    assert dec_kern.KERNEL.launches == before + 1
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **_tol(dtype, a.dtype))
    (kp, vp), bt = _pools_from_caches(kc, vc, 64,
                                      torch.Generator().manual_seed(3))
    want = dec_ref.paged_decode_attention_ref(qd, kp, vp, bt, ln,
                                              return_residuals=True)
    before = paged_kern.KERNEL.launches
    got = dec_ops.paged_decode_attention(qd, kp, vp, bt, ln, splits=splits,
                                         return_residuals=True)
    assert paged_kern.KERNEL.launches == before + 1
    assert got[0].shape == (b, hq, d)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **_tol(dtype, a.dtype))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_arctic_engine_on_card_matches_cpu(cuda, paged):
    """The arctic smoke pattern (every layer MoE of 8 experts top 2 plus
    the dense residual MLP) at 14 query heads over 2 (group 7), float32:
    the same greedy tokens on the card (B2, B3/B4, B8) and on the CPU
    (plain versions)."""
    cfg = dataclasses.replace(smoke_config("arctic-480b"), num_heads=14,
                              num_kv_heads=2, head_dim=64, dtype="float32")
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


@pytest.mark.parametrize("mode", [dict(kv_dtype="int8"),
                                  dict(spec_mode="ngram", spec_k=4)],
                         ids=["int8", "spec"])
def test_deepseek_quant_and_spec_engines_on_card(cuda, mode):
    """The deepseek smoke pattern at MLA's 192/128 from int8 pools (B5)
    and speculating k 4 (B6), float32: every request done; speculation
    gives the plain paged engine's tokens on the card; int8 matches
    itself on the CPU."""
    base = smoke_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(
        base, d_model=256, num_heads=2, num_kv_heads=2, head_dim=128,
        d_ff=512, dtype="float32",
        mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    outs = {}
    for dev, m in (("cpu", mode), ("cuda", mode), ("cuda", {})):
        sc = ServeConfig(slots=2, cache_len=48, max_new_tokens=12,
                         page_size=8, paged=True, **m)
        eng = Engine(model, _to(params, dev), sc, device=dev)
        reqs = [Request(rid=i, tokens=[1 + i] * (3 + 9 * i))
                for i in range(3)]
        kern = quant_kern.KERNEL if "kv_dtype" in mode else spec_kern.KERNEL
        before = kern.launches
        eng.run_to_completion(reqs)
        assert all(r.done and len(r.out) == 12 for r in reqs)
        assert (kern.launches > before) == (dev == "cuda" and bool(m))
        outs[(dev, bool(m))] = [r.out for r in reqs]
    assert outs[("cuda", True)] == outs[("cpu", True)]
    if "spec_mode" in mode:
        assert outs[("cuda", True)] == outs[("cuda", False)]


# ----------------------- whisper: the encoder, cross-attention; internvl2 --

#: (Sq, Skv) of B2 non-causal at whisper's head dim 64 and group 1: the
#: encoder's self-attention, cross-attention from a prompt and from one
#: decode query, over a short encoder and over 1,500 frames
CROSS_CASES = [(300, 300), (77, 300), (1, 300), (1, 1500)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv", CROSS_CASES)
def test_flash_kernel_non_causal_at_head_dim_64(cuda, dtype, sq, skv):
    """B2 non-causal with Sq != Skv at 8/8 heads of 64, against its plain
    version; the bf16 body also against its rounding model."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn(2, 8, sq, 64, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, 8, skv, 64, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, 8, skv, 64, device=cuda, generator=g).to(dtype)
    before = fa_kern.KERNEL.launches
    got = fa_ops.flash_attention(q, k, v, causal=False)
    assert fa_kern.KERNEL.launches == before + 1
    want = fa_ref.flash_attention_ref(q, k, v, causal=False)
    assert got.shape == (2, 8, sq, 64)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    if dtype == torch.bfloat16:
        model = fa_ref.flash_attention_bf16_operands(q, k, v, causal=False)
        torch.testing.assert_close(got.float(), model.float(), **TOL_OPERANDS)
        assert fa_ref.model_mismatch(got, model) <= fa_ref.MODEL_MISMATCH


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_internvl2_group_6(cuda, dtype):
    """B2 causal at internvl2's 48 query heads over 8 of 128."""
    g = torch.Generator(device=cuda).manual_seed(14)
    q = torch.randn(2, 48, 200, 128, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, 8, 200, 128, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, 8, 200, 128, device=cuda, generator=g).to(dtype)
    got = fa_ops.flash_attention(q, k, v)
    want = fa_ref.flash_attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


#: (label, Hq, Hkv, D, cache rows, lengths): whisper's dense caches
#: (group 1 at head dim 64) and internvl2's (group 6 at 128)
WH_IV_DECODE = [
    ("whisper", 8, 8, 64, 448, (1, 17, 64, 100, 200, 300, 416, 448)),
    ("internvl2", 48, 8, 128, 1024, (1, 64, 200, 333, 511, 700, 900, 1024))]


@pytest.mark.parametrize("splits", [1, None])
@pytest.mark.parametrize("case", WH_IV_DECODE,
                         ids=[c[0] for c in WH_IV_DECODE])
def test_decode_kernels_at_whisper_and_internvl2_heads(cuda, case, splits):
    """B3 at one split and at its served count against its split plain
    version and the unsplit one, then B4 over the same rows in
    scrambled pages, at each model's group."""
    label, hq, hkv, d, s, lengths = case
    g = torch.Generator(device=cuda).manual_seed(15)
    b = len(lengths)
    q = torch.randn(b, hq, d, device=cuda, generator=g).bfloat16()
    kc = torch.randn(b, hkv, s, d, device=cuda, generator=g).bfloat16()
    vc = torch.randn(b, hkv, s, d, device=cuda, generator=g).bfloat16()
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n = splits or dec_kern.decode_splits(s)
    got = dec_ops.decode_attention(q, kc, vc, ln, return_residuals=True,
                                   splits=splits)
    want = dec_ref.decode_attention_ref(q, kc, vc, ln, return_residuals=True)
    split_want = dec_ref.decode_attention_ref(
        q, kc, vc, ln, return_residuals=True,
        chunk=dec_kern.split_chunk(s, n))
    for a, w, sw in zip(got, want, split_want):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(a, sw, atol=1e-4, rtol=1e-4)
    (kp, vp), bt = _pools_from_caches(kc, vc, 64,
                                      torch.Generator().manual_seed(2))
    got = dec_ops.paged_decode_attention(q, kp, vp, bt, ln, splits=splits,
                                         return_residuals=True)
    want = dec_ref.paged_decode_attention_ref(q, kp, vp, bt, ln,
                                              return_residuals=True)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(3000, 512), (1022, 6144)],
                         ids=["whisper", "internvl2"])
def test_rmsnorm_kernel_at_whisper_and_internvl2_rows(cuda, dtype, rows, d):
    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    w = (0.1 * torch.randn(d, device=cuda, generator=g)).to(dtype)
    got = rms_ops.rmsnorm(x, w, eps=1e-6, weight_offset=1.0)
    want = rms_ref.rmsnorm_ref(x, w, eps=1e-6, weight_offset=1.0)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    twin = rms_native.rmsnorm_native(x, w, eps=1e-6, weight_offset=1.0)
    assert torch.equal(got, twin)


def _greedy(model, params, tokens, extras, dev, steps=6, cache_len=32):
    """Prefill with the stub inputs, then ``steps`` greedy decode steps
    over the prefill's dense caches: the tokens and every call's
    logits."""
    params = _to(params, dev)
    extras = {k: v.to(dev) for k, v in extras.items()}
    logits, caches = model.prefill(params, tokens.to(dev), cache_len, extras)
    seen, out = [logits.cpu()], [logits.argmax(-1)]
    lengths = torch.full((tokens.shape[0],), tokens.shape[1],
                         dtype=torch.int32, device=dev)
    for _ in range(steps):
        logits = model.decode_step(params, caches, out[-1], lengths)
        lengths += 1
        seen.append(logits.cpu())
        out.append(logits.argmax(-1))
    return torch.stack([t.cpu() for t in out], 1), seen


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-26b"])
def test_stub_inputs_on_card_match_cpu(cuda, arch):
    """whisper's encoder and cross-attention (B2 non-causal at head dim
    64, the decode step's one-token cross query) and internvl2's splice,
    float32 at head dim 64: the same greedy tokens on the card (kernels)
    and on the CPU (plain versions), every call's logits within 1e-3."""
    cfg = dataclasses.replace(smoke_config(arch), d_model=256, num_heads=4,
                              num_kv_heads=4 if arch == "whisper-base"
                              else 2, head_dim=64, d_ff=512,
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 11), generator=g)
    extras = ({"encoder_embeds": torch.randn(2, 40, 256, generator=g)}
              if arch == "whisper-base" else
              {"vision_embeds": torch.randn(2, cfg.frontend_tokens, 256,
                                            generator=g)})
    cpu, cpu_logits = _greedy(model, params, tokens, extras, "cpu")
    card, card_logits = _greedy(model, params, tokens, extras, "cuda")
    assert torch.equal(card, cpu)
    for a, b in zip(card_logits, cpu_logits):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_repeated_null_page_targets_on_card_match_cpu(cuda, kv_dtype):
    """Dead slots' speculative rows all in the null page, at rows that
    overlap: the card's pools end as the CPU's (every row written in
    index order), on every one of 10 repeats."""
    from repro_torch.sharding.kernel_sharding import (pool_write,
                                                      requant_page_write)
    b, k1, h, d, p, ps = 64, 5, 8, 192, 4, 16
    g = torch.Generator().manual_seed(5)
    base = torch.randint(0, 1024, (b,), generator=g)
    pos = base[:, None] + torch.arange(k1)[None, :]
    page, off = torch.zeros_like(pos), pos % ps
    rows = torch.randn(h, b, k1, d, generator=g).bfloat16()
    if kv_dtype is None:
        pool = torch.randn(h, p, ps, d, generator=g).bfloat16()
        want = pool.clone()
        pool_write(page, off, (want, rows))
        for _ in range(10):
            got = pool.to(cuda)
            pool_write(page.to(cuda), off.to(cuda), (got, rows.to(cuda)))
            assert torch.equal(got.cpu(), want)
        return
    pool = torch.zeros((h, p, ps, d), dtype=torch.int8)
    want = (pool.clone(), torch.ones((h, p)))
    requant_page_write(*want, rows[:, :, 0].transpose(0, 1).float(),
                       page[:, 0], off[:, 0])
    for _ in range(10):
        got = (pool.to(cuda), torch.ones((h, p), device=cuda))
        requant_page_write(*got, rows[:, :, 0].transpose(0, 1).float().to(
            cuda), page[:, 0].to(cuda), off[:, 0].to(cuda))
        for a, w in zip(got, want):
            assert torch.equal(a.cpu(), w)
