"""The port's quantized-KV plane (``repro_torch.quant``, the quantized
paged op, the scale pools and the re-quantizing page write, the int8
and fp8 engines) against ``repro`` on the same inputs.

Inputs come from a numpy seed; the JAX side runs under
``target("generic")``; the port runs on the CPU, where every kernel
wrapper takes its plain version.  The quantized kernel itself runs only
on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import context as ctx
from repro.kernels import registry as R
from repro.kernels.decode_attention import paged as jpaged
from repro.kernels.decode_attention import ref as jdec_ref
from repro.quant import blockwise as jblock
from repro.serve import paging as jpaging
from repro.sharding.kernel_sharding import \
    sharded_quant_paged_decode_update_attend
from repro_torch.core import build, tuning
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import paged as paged_kern
from repro_torch.kernels.decode_attention import quant as quant_kern
from repro_torch.quant import (DECODE_TOL, FALLBACK, KV_DTYPES,
                               dequantize_absmax, dtypes_for_capability,
                               kv_cache_dtypes, quantize_absmax,
                               resolve_kv_spec, spec_for_storage)
from repro_torch.quant import spec as spec_mod
from repro_torch.serve import paging
from repro_torch.sharding.kernel_sharding import \
    quant_paged_decode_update_attend

_JAX_DTYPE = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}
_TORCH_DTYPE = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}


def _t(x):
    """JAX or numpy array -> CPU torch tensor (fp8 through its bytes)."""
    a = np.asarray(x)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's stored bytes, for bitwise comparison."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


# ------------------------------------------------------------ blockwise ----

def _absmax_inputs():
    """(4, 3, 8, 16) blocks: random, an all-zero block, and blocks whose
    values land exactly half-way between two codes after the division
    (int8: amax 127 gives scale 1, values k + .5; fp8: amax 448 gives
    scale 1, values half-way between e4m3 neighbours)."""
    x = _rand((4, 3, 8, 16), 0) * 3.0
    x[1, 2] = 0.0
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0],
                      np.float32)
    x[2, 0] = np.resize(halves, (8, 16))
    x[2, 0, 0, 0] = 127.0
    fp8_halves = np.array([17.0, 19.0, 35.0, -37.0, 0.0078125 * 3, 300.0,
                           -416.0, 448.0], np.float32)
    x[3, 1] = np.resize(fp8_halves, (8, 16))
    return x


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quantize_absmax_bitwise_equal_to_jax(kv_dtype):
    x = _absmax_inputs()
    jq, js = jblock.quantize_absmax(jnp.asarray(x),
                                    dtype=_JAX_DTYPE[kv_dtype],
                                    axis=(-2, -1))
    q, s = quantize_absmax(torch.from_numpy(x), dtype=_TORCH_DTYPE[kv_dtype],
                           axis=(-2, -1))
    assert q.dtype == _TORCH_DTYPE[kv_dtype] and s.shape == (4, 3)
    np.testing.assert_array_equal(_bytes(q), _bytes(_t(jq)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[1, 2]) == 1.0 and not _bytes(q[1, 2]).any()
    jd = jblock.dequantize_absmax(jq, js, axis=(-2, -1))
    np.testing.assert_array_equal(dequantize_absmax(q, s, (-2, -1)).numpy(),
                                  np.asarray(jd))


def test_quantize_int8_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 3.5]])
    q, s = quantize_absmax(x, dtype=torch.int8)
    assert float(s[0]) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, 126, 4]]


def test_quantize_keepdims_and_bad_dtype():
    x = torch.from_numpy(_rand((2, 5, 6), 1))
    q, s = quantize_absmax(x, dtype=torch.int8, axis=-1, keepdims=True)
    assert s.shape == (2, 5, 1)
    torch.testing.assert_close(dequantize_absmax(q, s[..., 0], -1),
                               q.float() * s)
    with pytest.raises(ValueError, match="unsupported"):
        quantize_absmax(x, dtype=torch.float16)


# ------------------------------------------------------- capability / spec --

@pytest.mark.parametrize("cap,want", [
    ((9, 0), KV_DTYPES), ((8, 9), KV_DTYPES), ((8, 0), ("bf16", "int8")),
    ((7, 5), ("bf16", "int8"))])
def test_kv_cache_dtypes_rule_on_cuda(cap, want):
    assert dtypes_for_capability(cap) == want


def test_kv_cache_dtypes_on_cpu_hold_fp8():
    assert kv_cache_dtypes("cpu") == ("bf16", "int8", "fp8_e4m3")
    assert FALLBACK == {"fp8_e4m3": "int8", "int8": "bf16"}


def test_resolve_kv_spec_names_and_aliases():
    assert resolve_kv_spec(None, "cpu") is None
    for name, want in (("int8", "int8"), ("fp8", "fp8_e4m3"),
                       ("FP8-E4M3", "fp8_e4m3"), ("bfloat16", "bf16")):
        spec = resolve_kv_spec(name, "cpu", strict=True)
        assert spec.dtype == want
    spec = resolve_kv_spec("fp8_e4m3", "cpu")
    assert spec.storage == torch.float8_e4m3fn and spec.qmax == 448.0
    assert spec.decode_tol == DECODE_TOL["fp8_e4m3"] == 0.25
    assert resolve_kv_spec("int8", "cpu").decode_tol == 0.05
    assert not resolve_kv_spec("bf16", "cpu").quantized
    with pytest.raises(ValueError, match="unknown kv dtype"):
        resolve_kv_spec("int4", "cpu")
    assert spec_for_storage(torch.int8).dtype == "int8"
    with pytest.raises(ValueError, match="no KV quant spec"):
        spec_for_storage(torch.float16)


def test_resolve_kv_spec_falls_back_with_warning_or_raises(monkeypatch):
    """A device without fp8 (an older card) degrades fp8 -> int8 with a
    warning, and refuses under ``strict``."""
    monkeypatch.setattr(spec_mod, "kv_cache_dtypes",
                        lambda device=None: ("bf16", "int8"))
    with pytest.warns(UserWarning, match="falling back to 'int8'"):
        assert resolve_kv_spec("fp8_e4m3", "cuda").dtype == "int8"
    with pytest.raises(ValueError, match="not supported"):
        resolve_kv_spec("fp8_e4m3", "cuda", strict=True)
    monkeypatch.setattr(spec_mod, "kv_cache_dtypes",
                        lambda device=None: ("int8",))
    with pytest.raises(ValueError, match="no supported fallback"):
        resolve_kv_spec("bf16", "cuda")


# ----------------------------------------------------------- the op (CPU) --

def test_registry_example_matches_reference():
    op = R.get_op("quant_paged_decode_attention")
    operands, params = op.example_inputs(jax.random.PRNGKey(0))
    with ctx.target("generic"):
        want = op.ref_call(operands, params)
    got = dec_ops.quant_paged_decode_attention(
        *(_t(a) for a in operands), window=params["window"],
        softcap=params["softcap"], scale=params["scale"],
        page_size=params["page_size"], return_residuals=True)
    _close(got, want, op.tol)
    assert op.tol == dec_ops.TOL


def _quant_pools(kv_dtype, seed, h=2, p=9, ps=8, d=32):
    k, v = _rand((h, p, ps, d), seed), _rand((h, p, ps, d), seed + 1)
    out = []
    for x in (k, v):
        q, s = jblock.quantize_absmax(jnp.asarray(x),
                                      dtype=_JAX_DTYPE[kv_dtype],
                                      axis=(-2, -1))
        out += [q, s]
    return out                               # kq, ks, vq, vs


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("window,softcap", [(None, None), (10, 20.0)])
def test_quant_paged_plain_matches_reference(kv_dtype, window, softcap):
    """Slots of length 0, mid-page and at the table's last row."""
    kq, ks, vq, vs = _quant_pools(kv_dtype, 3)
    q = _rand((3, 8, 32), 5)
    bt = np.array([[0, 0, 0], [4, 2, 0], [1, 7, 8]], np.int32)
    lengths = np.array([0, 11, 24], np.int32)
    args = (q, kq, vq, ks, vs, bt, lengths)
    with ctx.target("generic"):
        want = jdec_ref.quant_paged_decode_attention_ref(
            *(jnp.asarray(a) for a in args), window=window, softcap=softcap,
            return_residuals=True)
    got = dec_ops.quant_paged_decode_attention(
        *(_t(a) for a in args), window=window, softcap=softcap,
        return_residuals=True)
    _close(got, want, dec_ops.TOL)
    out = dec_ops.quant_paged_decode_attention(*(_t(a) for a in args),
                                               window=window,
                                               softcap=softcap)
    assert float(out[0].abs().max()) == 0.0        # the l == 0 guard


def test_repage_scales_matches_reference():
    s = _rand((3, 5), 2)
    for page_size, phys in ((8, 8), (4, 8), (2, 8)):
        got = paged_kern.repage_scales(torch.from_numpy(s), page_size, phys)
        want = jpaged.repage_scales(jnp.asarray(s), page_size, phys)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quant_launcher_refuses_cpu_tensors_and_bad_pools():
    q = torch.zeros(1, 4, 64)
    pool = torch.zeros(2, 3, 8, 64, dtype=torch.int8)
    sc = torch.ones(2, 3)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    kw = dict(window=None, softcap=None, scale=None, page_size=None,
              block_kv=64)
    with pytest.raises(ValueError, match="CUDA device"):
        quant_kern.quant_paged_decode_attention_fwd(q, pool, pool, sc, sc,
                                                    bt, ln, **kw)
    with pytest.raises(TypeError, match="quantized pools"):
        quant_kern.quant_paged_decode_attention_fwd(
            q, pool.float(), pool.float(), sc, sc, bt, ln, **kw)
    with pytest.raises(ValueError, match="scale pools"):
        quant_kern.quant_paged_decode_attention_fwd(
            q, pool, pool, torch.ones(2, 4), sc, bt, ln, **kw)
    with pytest.raises(ValueError, match="both scale pools"):
        quant_kern.quant_paged_decode_attention_fwd(q, pool, pool, None,
                                                    None, bt, ln, **kw)
    assert build.dtype_code(pool) == 2
    assert build.dtype_code(pool.to(torch.float8_e4m3fn)) == 3


def test_tuning_rows_of_the_quantized_and_speculative_ops():
    for op in ("quant_paged_decode_attention", "spec_paged_decode_attention",
               "quant_spec_paged_decode_attention"):
        assert tuning.block_size(op, "page_size") == 64
        assert tuning.block_size(op, "block_kv") == 64


# ------------------------------------------------- paging + the write path --

@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_requantizing_write_matches_reference(kv_dtype):
    """One decode step's page write + attend against
    ``sharded_quant_paged_decode_update_attend``: the same pools and
    scales after the write, the same output, and the stale rows past
    each write offset zeroed."""
    kq, ks, vq, vs = _quant_pools(kv_dtype, 7)
    b, hq, d = 4, 8, 32
    q = _rand((b, hq, d), 9)
    kn, vn = _rand((b, 2, d), 10) * 4.0, _rand((b, 2, d), 11) * 0.25
    bt = np.array([[3, 0, 0], [5, 6, 0], [0, 0, 0], [1, 2, 4]], np.int32)
    lengths = np.array([2, 13, 0, 23], np.int32)   # slot 2 is dead
    page = bt[np.arange(b), lengths // 8].astype(np.int32)
    off = (lengths % 8).astype(np.int32)
    eff = lengths + 1
    args = (q, kn, vn, kq, vq, ks, vs, bt, page, off, eff)
    with ctx.target("generic"):
        j_out, jkp, jvp, jks, jvs = sharded_quant_paged_decode_update_attend(
            *(jnp.asarray(a) for a in args))
    t = [_t(a) for a in args]
    out = quant_paged_decode_update_attend(*t)
    _, _, _, kp, vp, kss, vss = t[:7]
    live = [1, 3, 5, 6, 2, 4]                       # pages of live slots
    for got, want in ((kp, jkp), (vp, jvp)):
        np.testing.assert_array_equal(_bytes(got)[:, live],
                                      _bytes(_t(want))[:, live])
    for got, want in ((kss, jks), (vss, jvs)):
        np.testing.assert_array_equal(got.numpy()[:, live],
                                      np.asarray(want)[:, live])
    _close((out,), (j_out,), dec_ops.TOL)
    for slot in (0, 1, 3):                          # rows past off are 0
        p, o = int(page[slot]), int(off[slot])
        assert not _bytes(kp[:, p, o + 1:]).any()
        assert not _bytes(vp[:, p, o + 1:]).any()


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quantizing_prefill_scatter_matches_reference(kv_dtype):
    k, s, h, d, ps, total = 2, 11, 2, 16, 4, 9
    leaf_k, leaf_v = _rand((k, h, s, d), 1), _rand((k, h, s, d), 2)
    rows = np.array([[3, 1, 7], [2, 8, 0]], np.int32)
    spec = resolve_kv_spec(kv_dtype, "cpu")
    caches = paging.init_paged_caches(1, h, d, total, ps, device="cpu",
                                      dtype=torch.float32, kv_spec=spec)
    assert caches[0]["kp"].dtype == spec.storage
    assert caches[0]["ks"].shape == (h, total)
    assert float(caches[0]["ks"].min()) == 1.0
    paging.scatter_prefill(caches, [{"k": torch.from_numpy(leaf_k),
                                     "v": torch.from_numpy(leaf_v)}],
                           torch.tensor([0, 1]), torch.from_numpy(rows))
    pool = jnp.zeros((1, h, total, ps, d), _JAX_DTYPE[kv_dtype])
    scales = jnp.ones((1, h, total), jnp.float32)
    for name, leaf in (("k", leaf_k), ("v", leaf_v)):
        jp, js = jpaging._scatter_pages_quant(pool, scales,
                                              jnp.asarray(leaf)[None],
                                              jnp.asarray(rows))
        live = [1, 2, 3, 7, 8]
        np.testing.assert_array_equal(
            _bytes(caches[0][f"{name}p"])[:, live],
            _bytes(_t(jp[0]))[:, live])
        np.testing.assert_array_equal(
            caches[0][f"{name}s"].numpy()[:, live], np.asarray(js[0])[:, live])


def test_int8_pool_bytes_per_slot_about_half_of_bf16():
    kw = dict(device="cpu", dtype=torch.bfloat16)
    sizes = {}
    for name in ("bf16", "int8", "fp8_e4m3"):
        c = paging.init_paged_caches(2, 8, 128, 5, 64,
                                     kv_spec=resolve_kv_spec(name, "cpu"),
                                     **kw)
        sizes[name] = paging.paged_bytes_per_slot(c, 5, 16)
    assert sizes["bf16"] == 2 * 2 * 8 * 64 * 128 * 2 * 16
    assert sizes["int8"] == sizes["fp8_e4m3"] == \
        (2 * 2 * 8 * 64 * 128 + 2 * 2 * 8 * 4) * 16
    assert 1.9 < sizes["bf16"] / sizes["int8"] < 2.0


# -------------------------------------------------------------- engines ----

_STATE = {}


def _models():
    from repro.configs.smoke import smoke_config
    from repro.models.registry import build_model
    from repro_torch.configs.smoke import smoke_config as port_smoke
    from repro_torch.convert import from_jax_params
    from repro_torch.models.registry import build_model as port_build
    if "m" not in _STATE:
        cfg = dataclasses.replace(smoke_config("granite-8b", num_layers=2),
                                  dtype="float32")
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        pcfg = dataclasses.replace(port_smoke("granite-8b", num_layers=2),
                                   dtype="float32")
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE["m"] = (model, params, port_build(pcfg),
                       from_jax_params(tree, pcfg, device="cpu"))
    return _STATE["m"]


def _prompts():
    # tests/test_serve.py:523: mixed lengths, drafts cross pages
    return [[1 + i] * (3 + i) for i in range(4)]


_SC = dict(slots=2, cache_len=32, max_new_tokens=12, paged=True, page_size=8)


def _run_jax(**sc):
    from repro.serve import Engine, Request, ServeConfig
    model, params, _, _ = _models()
    with ctx.target("generic"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = Engine(model, params, ServeConfig(**sc))
        reqs = [Request(rid=i, tokens=p) for i, p in enumerate(_prompts())]
        eng.run_to_completion(reqs)
    return eng, reqs


def _port_engine(**sc):
    from repro_torch.serve.engine import Engine, ServeConfig
    _, _, pmodel, pparams = _models()
    return Engine(pmodel, pparams, ServeConfig(**sc), device="cpu")


def _run_port(**sc):
    from repro_torch.serve.engine import Request
    eng = _port_engine(**sc)
    reqs = [Request(rid=i, tokens=p) for i, p in enumerate(_prompts())]
    eng.run_to_completion(reqs)
    return eng, reqs


def test_int8_engine_token_identical_to_reference():
    jeng, jreqs = _run_jax(kv_dtype="int8", **_SC)
    peng, preqs = _run_port(kv_dtype="int8", **_SC)
    assert jeng.kv_spec.dtype == peng.kv_spec.dtype == "int8"
    assert all(r.done and len(r.out) == 12 for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    st = peng.stats()
    assert st["available"] == st["total_pages"] - 1 and peng.audit() == []
    assert st["kv_dtype"] == "int8"
    assert peng.caches[0]["kp"].dtype == torch.int8


def test_fp8_engine_completes_within_decode_tol():
    """The reference falls back to int8 under ``generic``, so the fp8
    engine is held to completion and to DECODE_TOL: one decode-attention
    call over its admitted pools against the same call over the float32
    engine's pools, same tables."""
    from repro_torch.serve.engine import Request
    engines, reqs = {}, {}
    for kv in ("fp8_e4m3", None):
        eng = _port_engine(kv_dtype=kv, **_SC)
        reqs[kv] = [Request(rid=i, tokens=p)
                    for i, p in enumerate(_prompts())]
        for r in reqs[kv]:
            eng.submit(r)
        eng._admit()
        engines[kv] = eng
    fp8, f32 = engines["fp8_e4m3"], engines[None]
    assert fp8.kv_spec.dtype == "fp8_e4m3"
    assert (fp8.block_tables == f32.block_tables).all()
    q = torch.from_numpy(_rand((2, 4, 16), 3))
    bt = torch.from_numpy(fp8.block_tables)
    lengths = torch.from_numpy(fp8._len_h.astype(np.int32))
    for cq, cf in zip(fp8.caches, f32.caches):
        got = dec_ops.quant_paged_decode_attention(
            q, cq["kp"], cq["vp"], cq["ks"], cq["vs"], bt, lengths)
        want = dec_ops.paged_decode_attention(q, cf["kp"], cf["vp"], bt,
                                              lengths)
        assert float((got - want).abs().max()) <= DECODE_TOL["fp8_e4m3"]
    fp8.run_to_completion([])
    assert all(r.done and len(r.out) == 12 for r in reqs["fp8_e4m3"])
    assert fp8.allocator.in_use == 0 and fp8.audit() == []


def test_engine_kv_dtype_requires_paged():
    with pytest.raises(ValueError, match="requires paged"):
        _port_engine(slots=2, cache_len=32, paged=False, kv_dtype="int8")


def test_engine_bf16_pool_is_a_bf16_passthrough():
    eng = _port_engine(kv_dtype="bf16", **_SC)
    assert eng.caches[0]["kp"].dtype == torch.bfloat16
    assert "ks" not in eng.caches[0]
    assert eng.kv_spec.dtype == "bf16" and not eng.kv_spec.quantized


def test_engine_int8_pool_bytes_halve():
    eng = {kv: _port_engine(kv_dtype=kv, **_SC) for kv in ("bf16", "int8")}
    b = {kv: paging.paged_bytes_per_slot(e.caches, e.allocator.total_pages,
                                         e.pages_per_slot)
         for kv, e in eng.items()}
    assert b["bf16"] / b["int8"] >= 1.9


def test_launcher_serves_int8_and_fp8_on_cpu(capsys):
    from repro_torch.launch import serve
    for kv in ("int8", "fp8_e4m3"):
        reqs = serve.main(["--arch", "granite-8b", "--smoke", "--prompts",
                           "3", "--prompt-len", "5", "--max-new", "4",
                           "--paged", "--page-size", "4", "--kv-dtype", kv,
                           "--device", "cpu"])
        assert all(r.done and len(r.out) == 4 for r in reqs)
        assert f'"kv_dtype": "{kv}"' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "granite-8b", "--smoke", "--kv-dtype", "int8",
                    "--device", "cpu"])
