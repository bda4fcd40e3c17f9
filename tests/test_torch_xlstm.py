"""xlstm-1.3b through the port: the mLSTM scan's plain version, the
mLSTM and sLSTM blocks, the recurrent model and both serving engines,
against ``repro`` on the CPU.

The scan against the reference op at its registry example and with
bf16 inputs, h and the final state; the mLSTM and sLSTM blocks over
the full sequence, as prefill with their decode state, and one-token
steps, on the reference's weights; the model
(``smoke_config("xlstm-1.3b")``: 16 layers, seven mLSTM and one sLSTM
per period, d_model 64, 2 heads) through prefill and decode; the paged
and the dense engine token-identical to ``repro.serve.Engine`` in
float32, under preemption too; a reused slot against a fresh engine,
bit for bit; the refusals.  The JAX side runs under
``target("generic")``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.kernels.mlstm_scan import ref as jscan_ref
from repro.models import transformer as JT
from repro.models import xlstm as jx
from repro.models.registry import build_model
from repro.serve import Engine, Request, ServeConfig
from repro_torch import configs as port_configs
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.mlstm_scan import mlstm_scan as scan_kern
from repro_torch.kernels.mlstm_scan import ops as scan_ops
from repro_torch.models import transformer as PT
from repro_torch.models import xlstm as px
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.serve import paging as port_paging
from repro_torch.serve.engine import Engine as PortEngine
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.serve.engine import ServeConfig as PortServeConfig

ARCH = "xlstm-1.3b"
TOL = dict(atol=1e-4, rtol=1e-4)        # float32, another summation order
# bf16 h of the scan: both sides compute the same f32 value from the
# same bf16 inputs, then round it to 8 mantissa bits
TOL_BF16_OUT = dict(atol=1e-2, rtol=1e-2)
# five prompts over two slots, 12 new tokens each: pages of 4 crossed
# several times per request
PROMPTS = [[1 + i] * (3 + 2 * i) for i in range(5)]
ENGINE = dict(slots=2, cache_len=32, max_new_tokens=12, page_size=4)
MLSTM_LEAVES, SLSTM_LEAVES = ("C", "n", "m", "conv"), ("c", "n", "m", "h",
                                                        "conv")

_STATE = {}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(port_smoke_config(ARCH), dtype=dtype))


def _models(dtype="float32"):
    """(jax model, jax params, port model, port params)."""
    if dtype not in _STATE:
        jcfg, pcfg = _cfgs(dtype)
        model = build_model(jcfg)
        params = model.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE[dtype] = (model, params, port_build_model(pcfg),
                         from_jax_params(tree, pcfg, device="cpu"))
    return _STATE[dtype]


def _block_params(kind, jcfg):
    """The reference's init of one block, and the same weights as f32
    port tensors (an sLSTM's ``ffn`` is a dict of its own)."""
    init = jx.init_mlstm if kind == "mlstm" else jx.init_slstm
    jp = init(jax.random.PRNGKey(1), jcfg)

    def conv(tree):
        return {k: conv(v) if isinstance(v, dict)
                else _t(np.asarray(v, np.float32)) for k, v in tree.items()}
    return jp, conv(jp)


def _scan_inputs(b, h, s, dk, dv, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, s, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    ig = rng.standard_normal((b, h, s)).astype(np.float32)
    fg = (rng.standard_normal((b, h, s)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


# ------------------------------------------------------------- scan -----

def test_scan_plain_matches_reference_op_at_its_example():
    """h at the registry example (f32, Dk = Dv = 32), with the op's own
    tolerance, and the final state against the reference's plain scan
    with ``return_state``."""
    from repro.kernels import registry as R
    op = R.get_op("mlstm_scan")
    operands, params = op.example_inputs(jax.random.PRNGKey(0))
    with ctx.target("generic"):
        want = op.ref_call(operands, params)
        _, (c, n, m) = jscan_ref.mlstm_scan_ref(*operands, return_state=True)
    got, (pc, pn, pm) = scan_ops.mlstm_scan(*(_t(a) for a in operands),
                                            return_state=True)
    assert scan_ops.TOL == op.tol
    np.testing.assert_allclose(got.numpy(), _np(want), **op.tol)
    for g, w in ((pc, c), (pn, n), (pm, m)):
        np.testing.assert_allclose(g.numpy(), _np(w), **op.tol)
    torch.testing.assert_close(scan_ops.mlstm_scan(
        *(_t(a) for a in operands)), got, atol=0, rtol=0)


@pytest.mark.parametrize("s", [1, 17, 100])
def test_scan_plain_with_bf16_inputs_matches_reference(s):
    """q/k/v in bf16 and the gates in f32, as the mLSTM layer hands them
    over: one step, and S below and off a multiple of the reference's
    chunk; h in bf16, the state in f32."""
    q, k, v, ig, fg = _scan_inputs(2, 2, s, 32, 64, s)
    bf = jnp.bfloat16
    h, (c, n, m) = jscan_ref.mlstm_scan_ref(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
        jnp.asarray(ig), jnp.asarray(fg), return_state=True)
    ph, (pc, pn, pm) = scan_ops.mlstm_scan(
        _t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(), _t(ig),
        _t(fg), return_state=True)
    assert ph.dtype == torch.bfloat16 and pc.dtype == torch.float32
    assert pc.shape == (2, 2, 32, 64) and pn.shape == (2, 2, 32)
    assert pm.shape == (2, 2)
    np.testing.assert_allclose(ph.float().numpy(), _np(h), **TOL_BF16_OUT)
    for g, w in ((pc, c), (pn, n), (pm, m)):
        np.testing.assert_allclose(g.numpy(), _np(w), **scan_ops.TOL)


def test_scan_from_an_empty_cache_is_one_scan_step():
    """The scan starts at m = -inf, a decode cache at -1e30: both give
    the first step f' = 0 and i' = 1, so one decode step from an empty
    cache equals a one-step scan (h and state)."""
    q, k, v, ig, fg = (_t(a) for a in _scan_inputs(1, 2, 1, 32, 32, 4))
    h, (c, n, m) = scan_ops.mlstm_scan(q, k, v, ig, fg, return_state=True)
    scale = 32 ** -0.5
    m0 = torch.full((1, 2), px.M_EMPTY)
    ft = torch.nn.functional.logsigmoid(fg[:, :, 0])
    m1 = torch.maximum(ft + m0, ig[:, :, 0])
    assert torch.equal(m1, m[:, :]) and torch.equal(
        torch.exp(ft + m0 - m1), torch.zeros(1, 2))
    kt = k[:, :, 0] * scale
    want_c = kt[..., :, None] * v[:, :, 0, None, :]
    torch.testing.assert_close(c, want_c, **TOL)
    torch.testing.assert_close(n, kt, **TOL)


def test_scan_launcher_refuses_what_the_kernel_does_not_take():
    b, h, s = 2, 2, 5
    bf = torch.bfloat16
    ok = dict(q=torch.zeros(b, h, s, 32, dtype=bf),
              k=torch.zeros(b, h, s, 32, dtype=bf),
              v=torch.zeros(b, h, s, 64, dtype=bf),
              i_gate=torch.zeros(b, h, s), f_gate=torch.zeros(b, h, s))
    with pytest.raises(ValueError, match="CUDA"):
        scan_kern.mlstm_scan_fwd(**ok)
    with pytest.raises(ValueError, match="CUDA"):
        scan_kern.mlstm_scan_fwd(**ok, return_state=True)
    for change, err, match in (
            (dict(k=ok["k"].float()), TypeError, "share"),
            (dict(i_gate=ok["i_gate"].to(bf)), TypeError, "gates"),
            (dict(v=torch.zeros(b, h, s + 1, 64, dtype=bf)), ValueError,
             "v must be"),
            (dict(f_gate=torch.zeros(b, h)), ValueError, "f_gate"),
            (dict(q=torch.zeros(b, h, s, 64, dtype=bf),
                  k=torch.zeros(b, h, s, 64, dtype=bf)), NotImplementedError,
             "key head dim 64"),
            (dict(v=torch.zeros(b, h, s, 48, dtype=bf)), NotImplementedError,
             "value head dim 48"),
            (dict(q=ok["q"].half(), k=ok["k"].half(), v=ok["v"].half()),
             TypeError, "float32 or")):
        with pytest.raises(err, match=match):
            scan_kern.mlstm_scan_fwd(**dict(ok, **change))
    assert scan_kern.KERNEL.launches == 0


# ----------------------------------------------------------- blocks -----

@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("s,with_cache", [(2, False), (2, True), (11, True)])
def test_block_full_sequence_matches_reference(kind, s, with_cache):
    """The block over the whole sequence; as prefill also its decode
    state, with the conv tail padded on the left when the prompt is
    shorter than the conv's context."""
    jcfg, pcfg = _cfgs()
    jp, pp = _block_params(kind, jcfg)
    x = _rand((2, s, jcfg.d_model), 0)
    japply = jx.apply_mlstm if kind == "mlstm" else jx.apply_slstm
    papply = px.apply_mlstm if kind == "mlstm" else px.apply_slstm
    with ctx.target("generic"):
        want = japply(jp, jnp.asarray(x), jcfg, return_cache=with_cache)
    got = papply(pp, _t(x), pcfg, return_cache=with_cache)
    if not with_cache:
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        return
    (y, cache), (py, pcache) = want, got
    np.testing.assert_allclose(py.numpy(), _np(y), **TOL)
    assert set(pcache) == set(MLSTM_LEAVES if kind == "mlstm"
                              else SLSTM_LEAVES) == set(cache)
    for name in pcache:
        np.testing.assert_allclose(pcache[name].numpy(), _np(cache[name]),
                                   **TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("empty", [True, False])
def test_block_decode_step_matches_reference(kind, empty):
    """One-token steps from an empty cache and from a random state; the
    port writes the new state into the cache in place."""
    jcfg, pcfg = _cfgs()
    jp, pp = _block_params(kind, jcfg)
    jcache_fn = jx.mlstm_cache if kind == "mlstm" else jx.slstm_cache
    jc = jcache_fn(jcfg, 3, jnp.float32)
    if not empty:
        jc = {name: jnp.asarray(_rand(leaf.shape, i) if name != "m"
                                else 0.5 * _rand(leaf.shape, i))
              for i, (name, leaf) in enumerate(sorted(jc.items()))}
        if kind == "slstm":        # the normaliser stays positive
            jc["n"] = jnp.abs(jc["n"]) + 0.5
    cache = {name: _t(np.asarray(leaf)) for name, leaf in jc.items()}
    pempty = PT.recurrent_cache(pcfg, kind, 3, torch.float32, "cpu")
    assert {n: (t.shape, t.dtype) for n, t in pempty.items()} == {
        n: (t.shape, t.dtype) for n, t in cache.items()}
    if empty:
        for name, leaf in pempty.items():
            torch.testing.assert_close(leaf, cache[name], atol=0, rtol=0)
    jdecode = jx.decode_mlstm if kind == "mlstm" else jx.decode_slstm
    pdecode = px.decode_mlstm if kind == "mlstm" else px.decode_slstm
    for step in range(3):
        x = _rand((3, 1, jcfg.d_model), 10 + step)
        with ctx.target("generic"):
            out, jc = jdecode(jp, jnp.asarray(x), jc, jcfg)
        pout = pdecode(pp, _t(x), cache, pcfg)
        np.testing.assert_allclose(pout.numpy(), _np(out), **TOL)
        for name in cache:
            np.testing.assert_allclose(cache[name].numpy(), _np(jc[name]),
                                       **TOL)


# ------------------------------------------------------------ model -----

@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_and_segments_match_reference(which):
    """The config's fields (the xLSTM sub-config's ``slstm_every``
    included) and ``plan_segments``: 6 repeats of the 8-layer block,
    and its 2 at smoke size."""
    want, got = {"full": (get_config(ARCH), port_configs.get_config(ARCH)),
                 "smoke": (smoke_config(ARCH), port_smoke_config(ARCH))}[which]
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    assert {f.name for f in dataclasses.fields(got.xlstm)} == {
        f.name for f in dataclasses.fields(want.xlstm)}
    plans = [(p.block, p.reps) for p in PT.plan_segments(got)]
    assert plans == [(p.block, p.reps) for p in JT.plan_segments(want)]
    assert plans[0][1] == (6 if which == "full" else 2)


def test_check_supported_takes_xlstm_and_refuses_what_is_left():
    cfg = port_smoke_config(ARCH)
    PT.check_supported(cfg)
    for change in (dict(xlstm=None),
                   dict(layer_pattern=("mlstm", "global"))):
        with pytest.raises(NotImplementedError):
            PT.check_supported(dataclasses.replace(cfg, **change))


def test_prefill_and_decode_step_match_reference():
    model, params, pmodel, pparams = _models()
    toks = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(np.int32)
    with ctx.target("generic"):
        logits, caches = model.prefill(params, jnp.asarray(toks), 16, {})
    plogits, pcaches = pmodel.prefill(pparams, _t(toks).long(), 16)
    np.testing.assert_allclose(plogits.numpy(), _np(logits), **TOL)
    # layer r * 8 + j is block position j at repeat r
    assert set(pcaches[1]) == set(MLSTM_LEAVES)
    assert set(pcaches[15]) == set(SLSTM_LEAVES)
    np.testing.assert_allclose(pcaches[11]["C"].numpy(),
                               _np(caches[0][3]["C"][1]), **TOL)
    np.testing.assert_allclose(pcaches[7]["h"].numpy(),
                               _np(caches[0][7]["h"][0]), **TOL)
    cur = np.array([3, 250], np.int32)
    lengths = np.array([9, 9], np.int32)
    with ctx.target("generic"):
        logits, new = model.decode_step(params, caches, jnp.asarray(cur),
                                        jnp.asarray(lengths))
    plogits = pmodel.decode_step(pparams, pcaches, _t(cur), _t(lengths))
    np.testing.assert_allclose(plogits.numpy(), _np(logits), **TOL)
    np.testing.assert_allclose(pcaches[2]["m"].numpy(),
                               _np(new[0][2]["m"][0]), **TOL)
    np.testing.assert_allclose(pcaches[15]["c"].numpy(),
                               _np(new[0][7]["c"][1]), **TOL)


def test_prefill_then_decode_is_the_longer_prefill():
    """Decoding token 8 over a 7-token prefill reproduces the 8-token
    prefill's logits (float32), dense and paged (the states stay dense,
    and the pool list holds no pool at all), and the plain replay of the
    step and the forward's logits agree too."""
    _, _, pmodel, pparams = _models()
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 8))).long()
    full, _ = pmodel.prefill(pparams, toks, 16)
    torch.testing.assert_close(pmodel.forward_logits(pparams, toks)[:, -1],
                               full, **TOL)
    _, caches = pmodel.prefill(pparams, toks[:, :7], 16)
    lengths = torch.tensor([7, 7], dtype=torch.int32)
    rows = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    cfg = pmodel.cfg
    h, dk, dv = PT.kv_dims(cfg)
    pools = port_paging.init_paged_caches(
        cfg.num_layers, h, dk, 9, 4, device="cpu", dtype=torch.float32,
        v_head_dim=dv, recurrent={
            i: PT.recurrent_cache(cfg, k, 2, torch.float32, "cpu")
            for i, k in enumerate(cfg.layer_kinds())})
    assert all(not {"kp", "vp"} & set(c) for c in pools)
    assert port_paging.paged_bytes_per_slot(pools, 9, 4) == 0
    port_paging.scatter_prefill(pools, caches, torch.arange(2), rows)
    plain_caches = [{k: v.clone() for k, v in c.items()} for c in caches]
    dense = pmodel.decode_step(pparams, caches, toks[:, 7], lengths)
    pg = pmodel.decode_step(pparams, pools, toks[:, 7], lengths,
                            block_tables=rows)
    torch.testing.assert_close(dense, full, **TOL)
    torch.testing.assert_close(pg, dense, atol=0, rtol=0)
    plain = pmodel.decode_step(pparams, plain_caches, toks[:, 7], lengths,
                               plain=True)
    torch.testing.assert_close(plain, dense, atol=0, rtol=0)


def test_convert_carries_the_xlstm_tree():
    _, params, _, pparams = _models()
    tree = jax.tree_util.tree_map(np.asarray, params)
    layers = pparams["layers"]
    kinds = port_smoke_config(ARCH).layer_kinds()
    for p, kind in zip(layers, kinds):
        assert set(p) == {"ln1", kind}
    blk = tree["segments"][0][3]                  # layer 11: repeat 1
    for name, leaf in blk["mlstm"].items():
        np.testing.assert_array_equal(layers[11]["mlstm"][name].numpy(),
                                      leaf[1])
    blk = tree["segments"][0][7]                  # layer 7: repeat 0
    for name in ("w_gates", "r_gates", "b_gates", "conv_w"):
        np.testing.assert_array_equal(layers[7]["slstm"][name].numpy(),
                                      blk["slstm"][name][0])
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            layers[7]["slstm"]["ffn"][name].numpy(),
            blk["slstm"]["ffn"][name][0])


@pytest.mark.parametrize("source", ["init", "convert"])
def test_xlstm_keeps_its_f32_parameters_in_bf16(source):
    """The reference computes with the mLSTM gates' w_i, w_f, b_i, b_f
    and the sLSTM's w_gates, r_gates, b_gates in f32: the port keeps
    them in f32 in a bf16 model, and everything else in bf16."""
    if source == "init":
        pmodel = port_build_model(_cfgs("bfloat16")[1])
        pparams = pmodel.init(torch.Generator().manual_seed(0), device="cpu")
    else:
        pparams = _models(dtype="bfloat16")[3]
    assert sorted(px.F32_PARAMS) == ["b_f", "b_gates", "b_i", "r_gates",
                                     "w_f", "w_gates", "w_i"]
    for i in (0, 7):
        kind = "slstm" if i == 7 else "mlstm"
        for name, w in pparams["layers"][i][kind].items():
            if name == "ffn":
                assert {t.dtype for t in w.values()} == {torch.bfloat16}
                continue
            want = torch.float32 if name in px.F32_PARAMS else torch.bfloat16
            assert w.dtype == want, name
    if source == "init":          # the reference's laws
        ml, sl = pparams["layers"][0]["mlstm"], pparams["layers"][7]["slstm"]
        assert not (ml["b_f"] - 3.0).any() and not ml["b_i"].any()
        assert not (sl["b_gates"][1] - 3.0).any()
        assert not sl["b_gates"][[0, 2, 3]].any()
        # w_gates' fan-in is its leading axis (4): std 0.5
        assert abs(float(sl["w_gates"].float().std()) - 0.5) < 0.02


# ----------------------------------------------------------- engine -----

def _reference(**sc):
    """repro.serve.Engine's outputs and preemptions on PROMPTS (cached:
    a reference engine takes seconds here)."""
    key = tuple(sorted(sc.items()))
    if key not in _STATE:
        model, params, _, _ = _models()
        with ctx.target("generic"):
            eng = Engine(model, params, ServeConfig(**sc))
            reqs = [Request(rid=i, tokens=list(p))
                    for i, p in enumerate(PROMPTS)]
            eng.run_to_completion(reqs)
        assert all(r.done for r in reqs)
        _STATE[key] = ([r.out for r in reqs], eng.preemptions)
    return _STATE[key]


def _port(prompts=PROMPTS, **sc):
    _, _, pmodel, pparams = _models()
    eng = PortEngine(pmodel, pparams, PortServeConfig(**sc), device="cpu")
    reqs = [PortRequest(rid=i, tokens=list(p)) for i, p in enumerate(prompts)]
    eng.run_to_completion(reqs)
    assert all(r.done for r in reqs)
    return eng, [r.out for r in reqs]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_token_identical_to_reference(paged):
    want, _ = _reference(paged=paged, **ENGINE)
    eng, got = _port(paged=paged, **ENGINE)
    assert got == want
    assert all(len(o) == 12 for o in got)
    assert eng.audit() == []
    if paged:             # no pool, yet the tables and allocator run
        assert eng.allocator.alloc_count > 0
        assert eng.allocator.in_use == 0


def test_engine_preemption_is_token_identical_to_reference():
    """A pool of 5 pages of 8 for two slots growing to 24 new tokens:
    the re-prefill after each preemption must rebuild the slot's mLSTM
    and sLSTM states, as the reference's does, with the same victims."""
    sc = dict(ENGINE, max_new_tokens=24, paged=True, page_size=8,
              total_pages=5)
    want, preempts = _reference(**sc)
    eng, got = _port(**sc)
    assert got == want
    assert eng.preemptions > 0 and eng.preemptions == preempts
    assert eng.audit() == []


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_reused_slot_is_a_fresh_engine(paged):
    """One slot serves two requests in turn: the second is admitted into
    the state the first left (and that every decode step kept updating)
    and must see nothing of it, in its tokens and, bit for bit, in every
    leaf of every layer's state."""
    a, b = [7, 8, 9, 10, 11], [200, 3, 3, 90]
    sc = dict(ENGINE, slots=1, paged=paged)
    eng, outs = _port([a, b], **sc)
    fresh, alone = _port([b], **sc)
    assert outs[1] == alone[0]
    for c, f in zip(eng.caches, fresh.caches):
        assert set(c) == set(f) and set(c) in (set(MLSTM_LEAVES),
                                               set(SLSTM_LEAVES))
        for name in c:
            torch.testing.assert_close(c[name], f[name], atol=0, rtol=0)


@pytest.mark.parametrize("mode", [dict(kv_dtype="int8"),
                                  dict(kv_dtype="fp8_e4m3")])
def test_engine_with_a_quantized_kv_dtype_keeps_the_dense_state(mode):
    """xlstm has no attention layer, so an int8/fp8 ``kv_dtype`` has no
    pool to quantize: every layer keeps its dense slot-major state in
    the model's dtype, and the engine reports the spec (the engines
    against ``repro.serve.Engine``: tests/test_torch_hybrid_quant.py)."""
    _, _, pmodel, pparams = _models()
    eng = PortEngine(pmodel, pparams, PortServeConfig(paged=True, **mode),
                     device="cpu")
    for c in eng.caches:
        assert set(c) in (set(MLSTM_LEAVES), set(SLSTM_LEAVES))
        assert all(v.dtype == torch.float32 for v in c.values())
    assert eng.stats()["kv_dtype"] == mode["kv_dtype"]


def test_engine_refuses_speculation_over_xlstm_layers():
    _, _, pmodel, pparams = _models()
    with pytest.raises(ValueError, match="cannot roll back"):
        PortEngine(pmodel, pparams,
                   PortServeConfig(paged=True, spec_mode="ngram", spec_k=2),
                   device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_launcher_serves_xlstm_on_cpu(capsys, paged):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", ARCH, "--smoke", "--prompts", "3",
                       "--prompt-len", "6", "--max-new", "4",
                       "--page-size", "4", "--device", "cpu"]
                      + (["--paged"] if paged else []))
    assert all(r.done and len(r.out) == 4 for r in reqs)
    out = capsys.readouterr().out
    assert '"all_done": true' in out and '"mlstm_scan": 0' in out
