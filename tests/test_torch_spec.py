"""The port's self-speculative decoding (``spec_mode="ngram"``): the
speculative paged ops, their index helpers, the window write, the
rollback, and the engine, against ``repro`` on the same inputs.

Inputs come from a numpy seed; the JAX side runs under
``target("generic")``; the port runs on the CPU, where every kernel
wrapper takes its plain version.  The speculative kernel itself runs
only on the card (tests/test_torch_gpu.py, chip_smoke.py).
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
from repro.kernels.decode_attention import ref as jdec_ref
from repro.models import attention as jattn
from repro.quant import blockwise as jblock
from repro.serve import paging as jpaging
from repro.sharding.kernel_sharding import (
    sharded_quant_spec_paged_decode_update_attend,
    sharded_spec_paged_decode_update_attend)
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.decode_attention import spec as spec_kern
from repro_torch.models import attention as attn
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import paging
from repro_torch.sharding.kernel_sharding import (
    pool_write, quant_spec_paged_decode_update_attend, requant_page_write,
    spec_paged_decode_update_attend)

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


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


# --------------------------------------------------------- the ops (CPU) --

@pytest.mark.parametrize("name", ["spec_paged_decode_attention",
                                  "quant_spec_paged_decode_attention"])
def test_registry_example_matches_reference(name):
    op = R.get_op(name)
    operands, params = op.example_inputs(jax.random.PRNGKey(0))
    with ctx.target("generic"):
        want = op.ref_call(operands, params)
    fn = getattr(dec_ops, name)
    got = fn(*(_t(a) for a in operands), window=params["window"],
             softcap=params["softcap"], scale=params["scale"],
             page_size=params["page_size"], return_residuals=True)
    _close(got, want, op.tol)
    assert op.tol == dec_ops.TOL


def _spec_case(k1, seed=0):
    """Three slots over pages of 8: one at length 0, one mid-page, and
    one whose window runs past the table's last row."""
    hkv, p, ps, d = 2, 10, 8, 32
    q = _rand((3, k1, 8, d), seed)
    kp, vp = _rand((hkv, p, ps, d), seed + 1), _rand((hkv, p, ps, d),
                                                      seed + 2)
    bt = np.array([[5, 0, 0], [2, 9, 0], [1, 7, 8]], np.int32)
    base = np.array([0, 9, 24 - k1 + 1], np.int32)
    return q, kp, vp, bt, base


@pytest.mark.parametrize("k1", [1, 3, 5])
@pytest.mark.parametrize("window,softcap", [(None, None), (6, 25.0)])
def test_spec_plain_matches_reference(k1, window, softcap):
    q, kp, vp, bt, base = _spec_case(k1)
    kw = dict(window=window, softcap=softcap)
    with ctx.target("generic"):
        want = jdec_ref.spec_paged_decode_attention_ref(
            *(jnp.asarray(a) for a in (q, kp, vp, bt, base)),
            return_residuals=True, **kw)
    got = dec_ops.spec_paged_decode_attention(
        *(_t(a) for a in (q, kp, vp, bt, base)), return_residuals=True, **kw)
    _close(got, want, dec_ops.TOL)
    out = dec_ops.spec_paged_decode_attention(
        *(_t(a) for a in (q, kp, vp, bt, base)), **kw)
    assert out.shape == (3, k1, 8, 32)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("k1", [1, 3, 5])
def test_quant_spec_plain_matches_reference(kv_dtype, k1):
    q, kp, vp, bt, base = _spec_case(k1, seed=4)
    kq, ks = jblock.quantize_absmax(jnp.asarray(kp),
                                    dtype=_JAX_DTYPE[kv_dtype], axis=(-2, -1))
    vq, vs = jblock.quantize_absmax(jnp.asarray(vp),
                                    dtype=_JAX_DTYPE[kv_dtype], axis=(-2, -1))
    args = (q, kq, vq, ks, vs, bt, base)
    with ctx.target("generic"):
        want = jdec_ref.quant_spec_paged_decode_attention_ref(
            *(jnp.asarray(a) for a in args), return_residuals=True)
    got = dec_ops.quant_spec_paged_decode_attention(
        *(_t(a) for a in args), return_residuals=True)
    _close(got, want, dec_ops.TOL)


@pytest.mark.parametrize("k1,group", [(1, 4), (5, 4), (3, 2), (4, 8)])
def test_stacked_rows_and_horizons(k1, group):
    """The helpers the launcher hands the kernel: row r is head r %
    group of window position r // group and sees base + 1 + r // group
    tokens (``repro`` spec.py:70-71 and :125-128)."""
    base = torch.tensor([0, 7, 30], dtype=torch.int32)
    got = spec_kern.spec_row_lengths(base, k1, group)
    r = np.arange(k1 * group)
    want = np.asarray(base)[:, None] + 1 + r[None, :] // group
    assert got.dtype == torch.int32 and (got.numpy() == want).all()
    # the reference's position-major stacking of q (B, K1, Hkv, group, D)
    jq = jnp.arange(3 * k1 * 2 * group).reshape(3, k1, 2, group, 1)
    stacked = np.asarray(jq.transpose(0, 2, 1, 3, 4).reshape(3, 2, -1))
    for rr in r:
        qi, gi = spec_kern.row_position(int(rr), group)
        assert qi * group + gi == rr
        assert (stacked[:, :, rr] == np.asarray(jq)[:, qi, :, gi, 0]).all()


def test_stacked_rows_reproduce_the_plain_version():
    """One-token plain decode per stacked row, each with the horizon
    ``spec_row_lengths`` gives it, equals the speculative plain version:
    the index math the kernel relies on, checked on the CPU."""
    k1, group = 4, 4
    q, kp, vp, bt, base = (_t(a) for a in _spec_case(k1, seed=8))
    q = q[:, :, :2 * group]                         # Hq = Hkv * group
    rl = spec_kern.spec_row_lengths(base, k1, group)
    want = dec_ref.spec_paged_decode_attention_ref(q, kp, vp, bt, base)
    kc, vc = dec_ref.gather_pages(kp, bt), dec_ref.gather_pages(vp, bt)
    for r in range(k1 * group):
        qi, gi = spec_kern.row_position(r, group)
        heads = [h * group + gi for h in range(2)]
        one = dec_ref.decode_attention_ref(q[:, qi, heads], kc, vc, rl[:, r])
        torch.testing.assert_close(one, want[:, qi, heads], atol=2e-5,
                                   rtol=2e-5)


def test_spec_launcher_refuses_cpu_tensors_and_too_many_rows():
    q = torch.zeros(1, 2, 8, 64)
    pool = torch.zeros(2, 3, 8, 64)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    kw = dict(window=None, softcap=None, scale=None, page_size=None,
              block_kv=64)
    with pytest.raises(ValueError, match="CUDA device"):
        spec_kern.spec_paged_decode_attention_fwd(q, pool, pool, bt, ln, **kw)
    with pytest.raises(ValueError, match="K1 \\* group"):
        spec_kern.spec_paged_decode_attention_fwd(
            torch.zeros(1, 5, 8, 64), pool[:1], pool[:1], bt, ln, **kw)
    with pytest.raises(TypeError, match="quantized pools"):
        spec_kern.spec_paged_decode_attention_fwd(
            q, pool, pool, bt, ln, k_scales=torch.ones(2, 3),
            v_scales=torch.ones(2, 3), **kw)


# ------------------------------------------------- paging + write path ----

def test_spec_page_coords_match_reference():
    bt = np.array([[3, 4, 0], [0, 0, 0], [6, 1, 2]], np.int32)
    lengths = np.array([5, 0, 21], np.int32)
    for k1 in (1, 3, 5):
        want = jattn._spec_page_coords(jnp.asarray(bt), jnp.asarray(lengths),
                                       k1, 8)
        got = attn._spec_page_coords(_t(bt), _t(lengths), k1, 8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    page, _ = attn._spec_page_coords(_t(bt), _t(lengths), 5, 8)
    assert page[2].tolist() == [2, 2, 2, 0, 0]      # past the table: null


def test_truncate_suffix_frees_exact_tail():
    a = paging.PageAllocator(8)
    row = np.array(a.alloc_many(4) + [paging.NULL_PAGE] * 2, np.int32)
    ja = jpaging.PageAllocator(8)
    jrow = np.array(ja.alloc_many(4) + [0] * 2, np.int32)
    assert paging.truncate_suffix(a, row, 2, 4) == 2
    assert jpaging.truncate_suffix(ja, jrow, 2, 4) == 2
    assert (row == jrow).all() and list(row[2:]) == [0] * 4
    assert a.available == ja.available == 5 and a.in_use == 2


def test_truncate_suffix_empty_tail_is_a_noop():
    a = paging.PageAllocator(6)
    row = np.array(a.alloc_many(2) + [0, 0], np.int32)
    before = row.copy()
    assert paging.truncate_suffix(a, row, 2, 2) == 0
    assert (row == before).all() and a.in_use == 2


def test_truncate_suffix_double_truncation_raises():
    a = paging.PageAllocator(6)
    row = np.array(a.alloc_many(3) + [0], np.int32)
    paging.truncate_suffix(a, row, 1, 3)
    with pytest.raises(ValueError, match="already truncated"):
        paging.truncate_suffix(a, row, 1, 3)
    assert a.in_use == 1


def _window_write_case(k1, seed):
    b, hkv, hq, d, p, ps = 3, 2, 8, 32, 10, 8
    q = _rand((b, k1, hq, d), seed)
    kn, vn = _rand((b, hkv, k1, d), seed + 1), _rand((b, hkv, k1, d),
                                                      seed + 2)
    bt = np.array([[4, 5, 0], [0, 0, 0], [1, 7, 8]], np.int32)
    base = np.array([6, 0, 21], np.int32)         # slot 1 is dead
    page, off = jattn._spec_page_coords(jnp.asarray(bt), jnp.asarray(base),
                                        k1, ps)
    return q, kn, vn, (hkv, p, ps, d), bt, np.asarray(page), \
        np.asarray(off), base


def test_spec_window_write_matches_reference():
    k1 = 4
    q, kn, vn, shape, bt, page, off, base = _window_write_case(k1, 1)
    kp, vp = _rand(shape, 5), _rand(shape, 6)
    args = (q, kn, vn, kp, vp, bt, page, off, base)
    with ctx.target("generic"):
        j_out, jkp, jvp = sharded_spec_paged_decode_update_attend(
            *(jnp.asarray(a) for a in args))
    t = [_t(a) for a in args]
    out = spec_paged_decode_update_attend(*t)
    live = [1, 4, 5, 7, 8]
    np.testing.assert_array_equal(t[3].numpy()[:, live],
                                  np.asarray(jkp)[:, live])
    np.testing.assert_array_equal(t[4].numpy()[:, live],
                                  np.asarray(jvp)[:, live])
    _close((out,), (j_out,), dec_ops.TOL)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quant_spec_window_write_matches_reference(kv_dtype):
    """The window's rows re-quantized one after another in token order:
    pools and scales as the reference's, stale rows past the window
    zeroed in its last page."""
    k1 = 5
    q, kn, vn, shape, bt, page, off, base = _window_write_case(k1, 2)
    pools = []
    for seed in (7, 8):
        pq, ps_ = jblock.quantize_absmax(jnp.asarray(_rand(shape, seed)),
                                         dtype=_JAX_DTYPE[kv_dtype],
                                         axis=(-2, -1))
        pools += [pq, ps_]
    kq, ks, vq, vs = pools
    args = (q, kn, vn, kq, vq, ks, vs, bt, page, off, base)
    with ctx.target("generic"):
        j_out, jkp, jvp, jks, jvs = \
            sharded_quant_spec_paged_decode_update_attend(
                *(jnp.asarray(a) for a in args))
    t = [_t(a) for a in args]
    out = quant_spec_paged_decode_update_attend(*t)
    live = [1, 4, 5, 7, 8]
    for got, want in ((t[3], jkp), (t[4], jvp)):
        np.testing.assert_array_equal(_bytes(got)[:, live],
                                      _bytes(_t(want))[:, live])
    for got, want in ((t[5], jks), (t[6], jvs)):
        np.testing.assert_array_equal(got.numpy()[:, live],
                                      np.asarray(want)[:, live])
    _close((out,), (j_out,), dec_ops.TOL)
    # slot 0 writes rows 6..10: page 5 holds rows 8..10, stale after 10
    assert not _bytes(t[3][:, 5, 3:]).any()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_repeated_null_page_targets_keep_the_last_row(kv_dtype):
    """Dead slots' rows (stale lengths over all-null tables) land in the
    null page at overlapping rows: the pool ends as a write of every row
    in index order leaves it, whatever order the device writes in."""
    b, k1, h, d, p, ps = 4, 5, 2, 16, 3, 8
    base = torch.tensor([3, 6, 5, 9])
    pos = base[:, None] + torch.arange(k1)[None, :]
    page = torch.where(torch.tensor([True, False, False, True])[:, None],
                       torch.zeros_like(pos), torch.full_like(pos, 2))
    off = pos % ps
    rows = torch.from_numpy(_rand((h, b, k1, d), 11))
    if kv_dtype is None:
        got = torch.from_numpy(_rand((h, p, ps, d), 12))
        want = got.clone()
        pool_write(page, off, (got, rows))
        for i in range(b):
            for j in range(k1):
                want[:, page[i, j], off[i, j]] = rows[:, i, j]
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        return
    pool = torch.zeros((h, p, ps, d), dtype=torch.int8)
    got = (pool, torch.ones((h, p)))
    want = (pool.clone(), torch.ones((h, p)))
    for j in range(k1):
        requant_page_write(*got, rows[:, :, j].transpose(0, 1), page[:, j],
                           off[:, j])
        # each slot re-quantizes its page as the write found it; the
        # pages are stored in slot order
        snap = [t.clone() for t in want]
        for i in range(b):
            one = [t.clone() for t in snap]
            requant_page_write(*one, rows[:, i:i + 1, j].transpose(0, 1),
                               page[i:i + 1, j], off[i:i + 1, j])
            for w, o in zip(want, one):
                w[:, page[i, j]] = o[:, page[i, j]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


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


def _spec_requests(cls, n=4):
    # tests/test_serve.py:523: mixed lengths, drafts cross pages
    return [cls(rid=i, tokens=[1 + i] * (3 + i)) for i in range(n)]


def _oversub_requests(cls):
    # tests/test_serve.py `_oversub_requests`: 4 x 6-token prompts
    return [cls(rid=i, tokens=[1 + i] * 6) for i in range(4)]


_SC = dict(slots=2, cache_len=32, max_new_tokens=12, paged=True, page_size=8)


def _run_jax(reqs_fn=_spec_requests, **sc):
    from repro.serve import Engine, Request, ServeConfig
    model, params, _, _ = _models()
    with ctx.target("generic"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = Engine(model, params, ServeConfig(**sc))
        reqs = reqs_fn(Request)
        eng.run_to_completion(reqs)
    return eng, reqs


def _port_engine(**sc):
    _, _, pmodel, pparams = _models()
    return engine_mod.Engine(pmodel, pparams, engine_mod.ServeConfig(**sc),
                             device="cpu")


def _run_port(reqs_fn=_spec_requests, **sc):
    eng = _port_engine(**sc)
    reqs = reqs_fn(engine_mod.Request)
    eng.run_to_completion(reqs)
    return eng, reqs


@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_token_identical_to_plain_and_reference(k):
    """Accepted drafts are the argmax chain's tokens, so speculation
    changes no output: the port's spec engine equals its plain paged
    engine and the reference's spec engine, with real rejections."""
    _, plain = _run_port(**_SC)
    jeng, jreqs = _run_jax(spec_mode="ngram", spec_k=k, **_SC)
    peng, preqs = _run_port(spec_mode="ngram", spec_k=k, **_SC)
    assert all(r.done for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in plain]
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    assert peng.spec_rejections > 0, f"k={k} never rejected a draft"
    assert peng.spec_rejections == jeng.spec_rejections
    assert peng.spec_steps == jeng.spec_steps
    assert peng.spec_emitted == sum(len(r.out) - 1 for r in preqs)
    st = peng.stats()
    assert st["available"] == st["total_pages"] - 1      # no leak
    assert st["spec_rejections"] == peng.spec_rejections


def test_spec_int8_token_identical_to_reference():
    jeng, jreqs = _run_jax(spec_mode="ngram", spec_k=4, kv_dtype="int8",
                           **_SC)
    peng, preqs = _run_port(spec_mode="ngram", spec_k=4, kv_dtype="int8",
                            **_SC)
    assert all(r.done for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    assert peng.spec_rejections == jeng.spec_rejections > 0
    assert peng.allocator.in_use == 0 and peng.audit() == []


def test_spec_rollback_holds_the_page_watermark():
    """After every step the pool holds exactly the pages the accepted
    lengths need: rejected drafts' pages are truncated, never leaked."""
    eng = _port_engine(spec_mode="ngram", spec_k=4, **_SC)
    for r in _spec_requests(engine_mod.Request):
        eng.submit(r)
    eng._admit()
    steps = 0
    while eng.step():
        steps += 1
        want = sum(paging.pages_per_slot(int(eng._len_h[s]), eng.page_size)
                   for s in range(eng.sc.slots) if eng.active[s] is not None)
        assert eng.allocator.in_use == want, steps
        assert eng.audit() == [], steps
        eng._admit()
    assert eng.spec_rejections > 0 and eng.allocator.in_use == 0


def test_spec_one_device_get_per_step(monkeypatch):
    eng = _port_engine(spec_mode="ngram", spec_k=4, **_SC)
    for r in _spec_requests(engine_mod.Request):
        eng.submit(r)
    eng._admit()
    calls = []
    real = engine_mod._device_get
    monkeypatch.setattr(engine_mod, "_device_get",
                        lambda t: (calls.append(1), real(t))[1])
    for n in range(1, 4):
        assert eng.step()
        assert len(calls) == n, f"{len(calls)} host syncs in {n} spec steps"


def test_preempt_mid_speculation_checkpoints_accepted_prefix():
    """A victim checkpointed between speculative steps resumes from its
    accepted prefix only, so an oversubscribed spec run stays
    token-identical to the unconstrained plain run (port of
    tests/test_serve.py)."""
    sc = dict(slots=2, cache_len=32, max_new_tokens=24, paged=True,
              page_size=8)
    _, ref = _run_port(_oversub_requests, **sc)
    jeng, _ = _run_jax(_oversub_requests, total_pages=5,
                       preempt_policy="lru", spec_mode="ngram", spec_k=4,
                       **sc)
    eng, reqs = _run_port(_oversub_requests, total_pages=5,
                          preempt_policy="lru", spec_mode="ngram", spec_k=4,
                          **sc)
    assert all(r.done for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in ref]
    assert eng.preemptions > 0, "spec oversub run never preempted"
    assert eng.preemptions == jeng.preemptions
    assert eng.spec_rejections > 0
    st = eng.stats()
    assert st["available"] == st["total_pages"] - 1


def test_spec_config_validation():
    with pytest.raises(ValueError, match="temperature"):
        _port_engine(spec_mode="ngram", temperature=0.8, **_SC)
    with pytest.raises(ValueError, match="paged"):
        _port_engine(spec_mode="ngram", slots=2, cache_len=32)
    with pytest.raises(ValueError, match="spec_mode"):
        _port_engine(paged=True, spec_mode="draft-model")
    with pytest.raises(ValueError, match="spec_k"):
        _port_engine(spec_mode="ngram", spec_k=0, **_SC)


def test_launcher_serves_speculatively_on_cpu(capsys):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", "granite-8b", "--smoke", "--prompts", "3",
                       "--prompt-len", "5", "--max-new", "6", "--paged",
                       "--page-size", "4", "--spec-mode", "ngram",
                       "--spec-k", "3", "--kv-dtype", "int8",
                       "--device", "cpu"])
    assert all(r.done and len(r.out) == 6 for r in reqs)
    out = capsys.readouterr().out
    assert '"spec_mode": "ngram"' in out and "accepted_tokens_per_step" in out
