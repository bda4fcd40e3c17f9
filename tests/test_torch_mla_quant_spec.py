"""MLA over int8/fp8 pools and MLA speculation through the port, against
``repro`` on the CPU.

B5's and B6's plain versions at Dk 24 / Dv 16 (V narrower than K, as
MLA's 192 / 128), unsplit and split; the launchers taking the MLA pair
and refusing any other; ``decode_mla`` over int8 and fp8 pools
(outputs, written pages and scales); ``spec_decode_mla`` over bf16 and
int8 pools; the quantizing prefill scatter of MLA pools; and the
deepseek smoke engine (a dense first layer, then two MoE layers of 8
experts, top 2, with 2 shared experts; float32) from int8 pools
token-identical to ``repro.serve.Engine``, from fp8 pools within
``DECODE_TOL``, speculating (k 2) token-identical to the port's plain
paged run and to the reference, and speculating over int8 pools
token-identical to the reference.  Inputs come from a numpy seed; the
JAX side runs under ``target("generic")``.
"""
from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.kernels.decode_attention import ref as jdec_ref
from repro.models import attention as jattn
from repro.models.registry import build_model
from repro.quant import blockwise as jblock
from repro.serve import Engine, Request, ServeConfig
from repro.serve import paging as jpaging
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.decode_attention import decode_attention as dec_kern
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import paged as paged_kern
from repro_torch.kernels.decode_attention import quant as quant_kern
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.decode_attention import spec as spec_kern
from repro_torch.models import attention as pattn
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.quant import DECODE_TOL, resolve_kv_spec
from repro_torch.serve import paging
from repro_torch.serve.engine import Engine as PortEngine
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.serve.engine import ServeConfig as PortServeConfig

ARCH = "deepseek-v2-lite-16b"
TOL = dict(atol=1e-4, rtol=1e-4)        # float32, another summation order
DK, DV = 24, 16                         # the smoke config's MLA widths
_JAX_DTYPE = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}


def _t(x):
    """JAX or numpy array -> CPU torch tensor (fp8 through its bytes)."""
    a = np.asarray(x)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _bytes(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), _np(w), **tol)


def _jit(fn, **static):
    """``fn`` with ``static`` bound, compiled whole: one compile of the
    reference is far cheaper than dispatching its small ops one by one
    (each compiled on its first call)."""
    return jax.jit(lambda *args: fn(*args, **static))


def _quantize(x, kv_dtype):
    return jblock.quantize_absmax(jnp.asarray(x), dtype=_JAX_DTYPE[kv_dtype],
                                  axis=(-2, -1))


def _pools(kv_dtype, seed, h=4, p=10, ps=8):
    """K (h, p, ps, 24) and V (h, p, ps, 16) pools: float32, or
    quantized per (head, page) with their scales."""
    k, v = _rand((h, p, ps, DK), seed), _rand((h, p, ps, DV), seed + 1)
    if kv_dtype is None:
        return k, v
    (kq, ks), (vq, vs) = _quantize(k, kv_dtype), _quantize(v, kv_dtype)
    return kq, vq, ks, vs


# ------------------------------------- B5 and B6 plain at Dk 24 / Dv 16 --

@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("window,softcap", [(None, None), (10, 20.0)])
def test_quant_paged_plain_at_dk_24_dv_16(kv_dtype, window, softcap):
    """Slots of length 0, mid-page and at the table's last row."""
    kq, vq, ks, vs = _pools(kv_dtype, 3)
    q = _rand((3, 4, DK), 5)
    bt = np.array([[0, 0, 0], [4, 2, 0], [1, 7, 8]], np.int32)
    lengths = np.array([0, 11, 24], np.int32)
    args = (q, kq, vq, ks, vs, bt, lengths)
    kw = dict(window=window, softcap=softcap, scale=DK ** -0.5)
    with ctx.target("generic"):
        want = _jit(jdec_ref.quant_paged_decode_attention_ref,
                    return_residuals=True, **kw)(
            *(jnp.asarray(a) for a in args))
    got = dec_ops.quant_paged_decode_attention(
        *(_t(a) for a in args), return_residuals=True, **kw)
    assert got[0].shape == (3, 4, DV)
    _close(got, want, dec_ops.TOL)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
@pytest.mark.parametrize("k1", [1, 3, 5])
def test_spec_paged_plain_at_dk_24_dv_16(kv_dtype, k1):
    """Three slots over pages of 8: one at length 0, one mid-page, and
    one whose window runs past the table's last row; bf16-shaped pools
    (float32 here) or quantized ones."""
    q = _rand((3, k1, 4, DK), 6)
    bt = np.array([[5, 0, 0], [2, 9, 0], [1, 7, 8]], np.int32)
    base = np.array([0, 9, 24 - k1 + 1], np.int32)
    pools = _pools(kv_dtype, 7)
    if kv_dtype is None:
        args, jfn, fn = ((q, *pools, bt, base),
                         jdec_ref.spec_paged_decode_attention_ref,
                         dec_ops.spec_paged_decode_attention)
    else:
        args, jfn, fn = ((q, *pools, bt, base),
                         jdec_ref.quant_spec_paged_decode_attention_ref,
                         dec_ops.quant_spec_paged_decode_attention)
    with ctx.target("generic"):
        want = _jit(jfn, return_residuals=True)(
            *(jnp.asarray(a) for a in args))
    got = fn(*(_t(a) for a in args), return_residuals=True)
    assert got[0].shape == (3, k1, 4, DV)
    _close(got, want, dec_ops.TOL)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
@pytest.mark.parametrize("chunk", [8, 16])
def test_split_plain_versions_at_dk_24_dv_16(kv_dtype, chunk):
    """The split rounding models (``chunk=``) of B5 and B6 (bf16 and
    quantized) at V narrower than K: within f32 tolerance of the unsplit
    ones, m bit for bit (each score is computed once)."""
    q = _rand((3, 4, DK), 8)
    qs = _rand((3, 3, 4, DK), 9)
    bt = np.array([[5, 0, 0], [2, 9, 0], [1, 7, 8]], np.int32)
    lengths = np.array([1, 13, 24], np.int32)
    base = np.array([0, 9, 22], np.int32)
    pools = [_t(a) for a in _pools(kv_dtype, 10)]
    if kv_dtype is None:
        cases = ((dec_ref.paged_decode_attention_ref, _t(q), _t(lengths)),
                 (dec_ref.spec_paged_decode_attention_ref, _t(qs),
                  _t(base)))
    else:
        cases = ((dec_ref.quant_paged_decode_attention_ref, _t(q),
                  _t(lengths)),
                 (dec_ref.quant_spec_paged_decode_attention_ref, _t(qs),
                  _t(base)))
    for fn, qq, ln in cases:
        whole = fn(qq, *pools, _t(bt), ln, return_residuals=True)
        split = fn(qq, *pools, _t(bt), ln, return_residuals=True,
                   chunk=chunk)
        assert split[0].shape[-1] == DV
        for g, w in zip(split, whole):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
        assert torch.equal(split[1], whole[1])


def test_quant_and_spec_launchers_take_the_mla_pair_and_refuse_others():
    """(192, 128) passes B5's and B6's shape checks and reaches the
    device check; (192, 64) and (128, 64) are refused as B4's launcher
    refuses them; no launch happens on the CPU."""
    ln = torch.zeros(2, dtype=torch.int32)
    bt = torch.ones(2, 2, dtype=torch.int32)
    i8 = dict(dtype=torch.int8)
    sc = torch.ones(4, 3)
    common = dict(window=None, softcap=None, scale=None, page_size=None,
                  block_kv=64)
    for dv, exc, match in ((128, ValueError, "CUDA"),
                           (64, NotImplementedError, r"\(192, 64\)")):
        with pytest.raises(exc, match=match):
            quant_kern.quant_paged_decode_attention_fwd(
                torch.zeros(2, 4, 192), torch.zeros(4, 3, 16, 192, **i8),
                torch.zeros(4, 3, 16, dv, **i8), sc, sc, bt, ln, **common)
        with pytest.raises(exc, match=match):
            spec_kern.spec_paged_decode_attention_fwd(
                torch.zeros(2, 5, 4, 192), torch.zeros(4, 3, 16, 192),
                torch.zeros(4, 3, 16, dv), bt, ln, **common)
        with pytest.raises(exc, match=match):
            spec_kern.spec_paged_decode_attention_fwd(
                torch.zeros(2, 5, 4, 192), torch.zeros(4, 3, 16, 192, **i8),
                torch.zeros(4, 3, 16, dv, **i8), bt, ln, k_scales=sc,
                v_scales=sc, **common)
    with pytest.raises(NotImplementedError, match=r"\(128, 64\)"):
        quant_kern.quant_paged_decode_attention_fwd(
            torch.zeros(2, 4, 128), torch.zeros(4, 3, 16, 128, **i8),
            torch.zeros(4, 3, 16, 64, **i8), sc, sc, bt, ln, **common)
    assert (192, 128) in dec_kern.MLA_DIMS
    assert quant_kern.KERNEL.launches == spec_kern.KERNEL.launches == 0


@pytest.mark.parametrize("kv,k1", [("int8", None), ("fp8_e4m3", None),
                                   ("bf16", 5), ("int8", 5),
                                   ("fp8_e4m3", 5)])
def test_launchers_size_outputs_and_scratch_by_dv(monkeypatch, kv, k1):
    """At deepseek's served decode shapes (8 slots, 16 heads of 192 /
    128 over tables of 16 pages of 64), B5 (``k1`` None) and B6 (K1 5)
    hand the kernel d 192 and dv 128, and size acc and the split
    scratch by dv: (B, [K1,] Hq, 128) and (n, B, [K1,] Hq, 128)."""
    launches = []
    mod = quant_kern if k1 is None else spec_kern
    monkeypatch.setattr(mod, "check_cuda", lambda *a: None)
    monkeypatch.setattr(mod, "stream_of", lambda t: None)
    monkeypatch.setattr(mod.KERNEL, "launch", lambda *a: launches.append(a))
    monkeypatch.setattr(mod, "ptr", lambda t: t)
    monkeypatch.setattr(paged_kern, "ptr", lambda t: t)
    storage = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn,
               "bf16": torch.bfloat16}[kv]
    rows = (8, 16) if k1 is None else (8, k1, 16)
    q = torch.zeros(rows + (192,), dtype=torch.bfloat16)
    kp = torch.zeros(16, 1 + 8 * 16, 64, 192, dtype=storage)
    vp = torch.zeros(16, 1 + 8 * 16, 64, 128, dtype=storage)
    sc = None if kv == "bf16" else torch.ones(16, 1 + 8 * 16)
    table = torch.arange(1, 1 + 8 * 16, dtype=torch.int32).reshape(8, 16)
    ln = torch.full((8,), 1000, dtype=torch.int32)
    kw = dict(window=None, softcap=None, scale=None, page_size=None,
              block_kv=64)
    if k1 is None:
        acc, m, _ = quant_kern.quant_paged_decode_attention_fwd(
            q, kp, vp, sc, sc, table, ln, **kw)
        d_at = 20                   # ..., t_cols, d, dv, bk, chunk
    else:
        acc, m, _ = spec_kern.spec_paged_decode_attention_fwd(
            q, kp, vp, table, ln, k_scales=sc, v_scales=sc, **kw)
        d_at = 21
    (args,) = launches
    assert args[d_at:d_at + 2] == (192, 128)
    assert acc.shape == rows + (128,) and m.shape == rows
    n = 1024 // dec_kern.PAGED_SPLIT_ROWS
    assert tuple(args[10].shape) == (n,) + rows + (128,)
    assert tuple(args[11].shape) == (n,) + rows


# ------------------------------------------------- the MLA layer -----

def _cfgs():
    return (dataclasses.replace(smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(port_smoke_config(ARCH), dtype="float32"))


def _mla_params(jcfg):
    jp = jattn.init_mla(jax.random.PRNGKey(1), jcfg)
    d, lora = jcfg.d_model, jcfg.mla.kv_lora_rank
    shapes = {"wq_mla": (d, -1), "wkv_a": None, "wkv_b": (lora, -1),
              "wo_mla": (-1, d)}
    pp = {}
    for name, shape in shapes.items():
        a = np.array(jp[name], np.float32)
        pp[name] = torch.from_numpy(a if shape is None else a.reshape(shape))
    return jp, pp


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_decode_mla_over_quantized_pools_matches_reference(kv_dtype):
    """One token per slot re-quantized into its page of 4 (slot 0 at
    its page's last row, slot 1 starting a fresh page, slot 2 dead at
    length 0 over a null row), then attended by B5's plain version: the
    output, the live pages' bytes and their scales as the reference's."""
    jcfg, pcfg = _cfgs()
    jp, pp = _mla_params(jcfg)
    b, h, ps = 3, 4, 4
    x = _rand((b, 1, jcfg.d_model), 0)
    kq, vq, ks, vs = _pools(kv_dtype, 11, h=h, p=8, ps=ps)
    rows = np.array([[3, 5, 0], [6, 2, 7], [0, 0, 0]], np.int32)
    ln = np.array([7, 8, 0], np.int32)
    with ctx.target("generic"):
        y, ck, cv, cks, cvs = _jit(
            lambda *a: jattn.decode_mla(*a[:5], jcfg, block_tables=a[5],
                                        cache_scales=a[6]))(
            jp, jnp.asarray(x), jnp.asarray(kq), jnp.asarray(vq),
            jnp.asarray(ln), jnp.asarray(rows),
            (jnp.asarray(ks), jnp.asarray(vs)))
    pk, pv, pks, pvs = _t(kq), _t(vq), _t(ks), _t(vs)
    cos, sin = L.rope_cache(_t(ln), pcfg.mla.qk_rope_head_dim,
                            pcfg.rope_theta)
    py = pattn.decode_mla(pp, _t(x), pk, pv, _t(ln), pcfg,
                          (cos[:, None], sin[:, None]),
                          block_tables=_t(rows), cache_scales=(pks, pvs))
    np.testing.assert_allclose(py.numpy(), _np(y), **TOL)
    _same_pages((pk, pv, pks, pvs), (ck, cv, cks, cvs), [2, 3, 5, 6, 7])
    assert pk.shape[-1] == DK and pv.shape[-1] == DV


def _same_pages(got, want, live):
    """Quantized pools (K, V, their scales) written in place against the
    reference's, on the ``live`` pages: the new rows come out of
    projections summed in another order, so a page's absmax may move by
    an f32 ulp and a value round to its neighbouring step; the scales
    are held at 1e-6 and the dequantized pages within one step."""
    for pool, sc, jpool, jsc in ((got[0], got[2], want[0], want[2]),
                                 (got[1], got[3], want[1], want[3])):
        sc, jsc = sc.numpy()[:, live], np.asarray(jsc)[:, live]
        np.testing.assert_allclose(sc, jsc, rtol=1e-6, atol=0)
        deq = pool.float().numpy()[:, live] * sc[:, :, None, None]
        jdeq = _np(_t(jpool).float().numpy()[:, live]) \
            * jsc[:, :, None, None]
        assert (np.abs(deq - jdeq) <= 1.01 * sc[:, :, None, None]).all()
        assert (_bytes(pool)[:, live] != _bytes(_t(jpool))[:, live]).mean() \
            < 0.01


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_spec_decode_mla_matches_reference(kv_dtype):
    """A K1 = 3 window per slot written into pages of 4 (slot 0 crossing
    into its next page, slot 1 dead over a null row, slot 2 running
    past its table's reach into the null page), then verified: the
    output and the live pages (and scales) as the reference's."""
    jcfg, pcfg = _cfgs()
    jp, pp = _mla_params(jcfg)
    b, h, ps, k1 = 3, 4, 4, 3
    x = _rand((b, k1, jcfg.d_model), 1)
    pools = _pools(kv_dtype, 12, h=h, p=8, ps=ps)
    rows = np.array([[3, 5, 0], [0, 0, 0], [6, 2, 7]], np.int32)
    ln = np.array([3, 0, 11], np.int32)
    scales = None if kv_dtype is None else pools[2:]
    with ctx.target("generic"):
        res = _jit(
            lambda *a: jattn.spec_decode_mla(*a[:5], jcfg, block_tables=a[5],
                                             cache_scales=a[6]))(
            jp, jnp.asarray(x), jnp.asarray(pools[0]),
            jnp.asarray(pools[1]), jnp.asarray(ln), jnp.asarray(rows),
            None if scales is None
            else tuple(jnp.asarray(s) for s in scales))
    tp = [_t(a) for a in pools]
    pos = _t(ln)[:, None] + torch.arange(k1, dtype=torch.int32)[None, :]
    cos, sin = L.rope_cache(pos, pcfg.mla.qk_rope_head_dim, pcfg.rope_theta)
    py = pattn.spec_decode_mla(
        pp, _t(x), tp[0], tp[1], _t(ln), pcfg,
        (cos[:, :, None], sin[:, :, None]), block_tables=_t(rows),
        cache_scales=None if scales is None else (tp[2], tp[3]))
    assert py.shape == (b, k1, jcfg.d_model)
    np.testing.assert_allclose(py.numpy(), _np(res[0]), **TOL)
    live = [2, 3, 5, 6, 7]
    if kv_dtype is None:                                   # in place
        for got, want in zip(tp, res[1:]):
            np.testing.assert_allclose(got.numpy()[:, live],
                                       _np(want)[:, live], **TOL)
    else:
        _same_pages(tp, res[1:], live)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quantizing_prefill_scatter_of_mla_pools(kv_dtype):
    """A batch-2 MLA prefill (K 24, V 16 wide per head) scattered into
    quantized pools of pages of 4, one scale per (head, page): bytes and
    scales as ``repro``'s quantizing scatter."""
    k, s, h, ps, total = 2, 11, 4, 4, 9
    leaf_k, leaf_v = _rand((k, h, s, DK), 1), _rand((k, h, s, DV), 2)
    rows = np.array([[3, 1, 7], [2, 8, 0]], np.int32)
    caches = paging.init_paged_caches(
        1, h, DK, total, ps, device="cpu", dtype=torch.float32,
        kv_spec=resolve_kv_spec(kv_dtype, "cpu"), v_head_dim=DV)
    assert caches[0]["kp"].shape[-1] == DK
    assert caches[0]["vp"].shape[-1] == DV
    assert caches[0]["vs"].shape == (h, total)
    paging.scatter_prefill(caches, [{"k": torch.from_numpy(leaf_k),
                                     "v": torch.from_numpy(leaf_v)}],
                           torch.tensor([0, 1]), torch.from_numpy(rows))
    live = [1, 2, 3, 7, 8]
    for name, leaf, d in (("k", leaf_k, DK), ("v", leaf_v, DV)):
        pool = jnp.zeros((1, h, total, ps, d), _JAX_DTYPE[kv_dtype])
        # eager: compiled whole, XLA may fuse the scale's division and
        # move a scale by an ulp against the port's bit-exact one
        jp, js = jpaging._scatter_pages_quant(
            pool, jnp.ones((1, h, total), jnp.float32),
            jnp.asarray(leaf)[None], jnp.asarray(rows))
        np.testing.assert_array_equal(_bytes(caches[0][f"{name}p"])[:, live],
                                      _bytes(_t(jp[0]))[:, live])
        np.testing.assert_array_equal(caches[0][f"{name}s"].numpy()[:, live],
                                      np.asarray(js[0])[:, live])


# ----------------------------------------------------------- engines -----

_STATE = {}


def _models():
    if "m" not in _STATE:
        jcfg, pcfg = _cfgs()
        model = build_model(jcfg)
        params = model.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE["m"] = (model, params, port_build_model(pcfg),
                       from_jax_params(tree, pcfg, device="cpu"))
    return _STATE["m"]


# four requests over two slots, 10 new tokens each, pages of 4: pages
# are crossed and drafts rejected
_PROMPTS = [[1 + i] * (3 + 2 * i) for i in range(4)]
_SC = dict(slots=2, cache_len=32, max_new_tokens=10, paged=True,
           page_size=4)


def _run_jax(**sc):
    model, params, _, _ = _models()
    with ctx.target("generic"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = Engine(model, params, ServeConfig(**_SC, **sc))
        reqs = [Request(rid=i, tokens=list(p)) for i, p in
                enumerate(_PROMPTS)]
        eng.run_to_completion(reqs)
    return eng, reqs


def _port_engine(**sc):
    _, _, pmodel, pparams = _models()
    return PortEngine(pmodel, pparams, PortServeConfig(**_SC, **sc),
                      device="cpu")


def _run_port(**sc):
    eng = _port_engine(**sc)
    reqs = [PortRequest(rid=i, tokens=list(p))
            for i, p in enumerate(_PROMPTS)]
    eng.run_to_completion(reqs)
    assert all(r.done and len(r.out) == 10 for r in reqs)
    assert eng.allocator.in_use == 0 and eng.audit() == []
    return eng, reqs


def test_int8_engine_token_identical_to_reference():
    jeng, jreqs = _run_jax(kv_dtype="int8")
    peng, preqs = _run_port(kv_dtype="int8")
    assert jeng.kv_spec.dtype == peng.kv_spec.dtype == "int8"
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    c = peng.caches[1]
    assert c["kp"].dtype == torch.int8 and c["kp"].shape[-1] == DK
    assert c["vp"].shape[-1] == DV and c["ks"].shape == c["kp"].shape[:2]


def test_fp8_engine_completes_within_decode_tol():
    """The reference falls back to int8 under ``generic``, so the fp8
    engine is held to completion and to DECODE_TOL: one B5 call (plain
    here) over each layer's admitted pools against B4's over the
    float32 engine's, same tables."""
    engines, reqs = {}, {}
    for kv in ("fp8_e4m3", None):
        eng = _port_engine(kv_dtype=kv)
        reqs[kv] = [PortRequest(rid=i, tokens=list(p))
                    for i, p in enumerate(_PROMPTS)]
        for r in reqs[kv]:
            eng.submit(r)
        eng._admit()
        engines[kv] = eng
    fp8, f32 = engines["fp8_e4m3"], engines[None]
    assert fp8.kv_spec.dtype == "fp8_e4m3"
    assert (fp8.block_tables == f32.block_tables).all()
    q = torch.from_numpy(_rand((2, 4, DK), 3))
    bt = torch.from_numpy(fp8.block_tables)
    lengths = torch.from_numpy(fp8._len_h.astype(np.int32))
    for cq, cf in zip(fp8.caches, f32.caches):
        got = dec_ops.quant_paged_decode_attention(
            q, cq["kp"], cq["vp"], cq["ks"], cq["vs"], bt, lengths)
        want = dec_ops.paged_decode_attention(q, cf["kp"], cf["vp"], bt,
                                              lengths)
        assert got.shape == (2, 4, DV)
        assert float((got - want).abs().max()) <= DECODE_TOL["fp8_e4m3"]
    fp8.run_to_completion([])
    assert all(r.done and len(r.out) == 10 for r in reqs["fp8_e4m3"])
    assert fp8.allocator.in_use == 0 and fp8.audit() == []


def test_spec_engine_token_identical_to_plain_and_reference():
    """Accepted drafts are the argmax chain's tokens, so speculating
    over MLA + MoE layers changes no output: the port's spec engine (k
    2) equals its plain paged engine and the reference's spec engine,
    with real rejections."""
    _, plain = _run_port()
    jeng, jreqs = _run_jax(spec_mode="ngram", spec_k=2)
    peng, preqs = _run_port(spec_mode="ngram", spec_k=2)
    assert [r.out for r in preqs] == [r.out for r in plain]
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    assert peng.spec_rejections == jeng.spec_rejections > 0
    assert peng.spec_steps == jeng.spec_steps


def test_spec_int8_engine_token_identical_to_reference():
    jeng, jreqs = _run_jax(spec_mode="ngram", spec_k=2, kv_dtype="int8")
    peng, preqs = _run_port(spec_mode="ngram", spec_k=2, kv_dtype="int8")
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    assert peng.spec_rejections == jeng.spec_rejections > 0


def test_spec_keeps_the_reference_rules_for_mla():
    """Greedy only; dense caches refused: the reference's rules hold
    for MLA + MoE as for GQA."""
    with pytest.raises(ValueError, match="greedy"):
        _port_engine(spec_mode="ngram", temperature=0.8)
    _, _, pmodel, pparams = _models()
    with pytest.raises(ValueError, match="paged"):
        PortEngine(pmodel, pparams,
                   PortServeConfig(**dict(_SC, paged=False),
                                   spec_mode="ngram"), device="cpu")


def test_launcher_serves_deepseek_int8_speculatively_on_cpu(capsys):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", ARCH, "--smoke", "--prompts", "3",
                       "--prompt-len", "6", "--max-new", "6", "--paged",
                       "--page-size", "4", "--device", "cpu",
                       "--kv-dtype", "int8", "--spec-mode", "ngram",
                       "--spec-k", "2"])
    assert all(r.done and len(r.out) == 6 for r in reqs)
    out = capsys.readouterr().out
    assert '"all_done": true' in out and '"moe_dropped"' in out
