"""jamba-1.5-large-398b through the port: the selective scan's plain
version, the mamba block, the hybrid model and both serving engines,
against ``repro`` on the CPU.

The scan against the reference op at its registry example and with
bf16 inputs; the causal conv, the mamba mixer (prefill with its decode
state) and its one-token step on the reference's weights; the hybrid
model (``smoke_config("jamba-1.5-large-398b")``: 16 layers, an
attention layer and seven mamba layers per period, 8 experts top-2 on
every other layer) through prefill and decode; the paged and the dense
engine token-identical to ``repro.serve.Engine`` in float32, under
preemption too; a reused slot against a fresh engine; the refusals.
The JAX side runs under ``target("generic")``.
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
from repro.kernels.mamba_scan import ref as jscan_ref
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.models.registry import build_model
from repro.serve import Engine, Request, ServeConfig
from repro_torch import configs as port_configs
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.mamba_scan import mamba_scan as scan_kern
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import ssm as pssm
from repro_torch.models import transformer as PT
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.serve import paging as port_paging
from repro_torch.serve.engine import Engine as PortEngine
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.serve.engine import ServeConfig as PortServeConfig

ARCH = "jamba-1.5-large-398b"
TOL = dict(atol=1e-4, rtol=1e-4)        # float32, another summation order
# bf16 outputs of the scan: both sides compute the same f32 value from
# the same bf16 inputs, then round it to 8 mantissa bits (1 ulp is
# 2^-8 of the value)
TOL_BF16_OUT = dict(atol=1e-2, rtol=1e-2)
# five prompts over two slots, 12 new tokens each: pages of 4 crossed
# several times per request
PROMPTS = [[1 + i] * (3 + 2 * i) for i in range(5)]
ENGINE = dict(slots=2, cache_len=32, max_new_tokens=12, page_size=4)

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


def _models(cf=None, dtype="float32"):
    """(jax model, jax params, port model, port params); ``cf``
    overrides the MoE capacity factor on both sides."""
    key = (cf, dtype)
    if key not in _STATE:
        cfgs = []
        for c in _cfgs(dtype):
            if cf is not None:
                c = dataclasses.replace(
                    c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
            cfgs.append(c)
        model = build_model(cfgs[0])
        params = model.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE[key] = (model, params, port_build_model(cfgs[1]),
                       from_jax_params(tree, cfgs[1], device="cpu"))
    return _STATE[key]


def _mamba_params(jcfg):
    """The reference's init of one mamba block, and the same weights as
    f32 port tensors."""
    jp = jssm.init_mamba(jax.random.PRNGKey(1), jcfg)
    return jp, {name: _t(np.asarray(v, np.float32)) for name, v in jp.items()}


# ------------------------------------------------------------- scan -----

def test_scan_plain_matches_reference_op_at_its_example():
    from repro.kernels import registry as R
    op = R.get_op("mamba_scan")
    operands, params = op.example_inputs(jax.random.PRNGKey(0))
    with ctx.target("generic"):
        y, h = op.ref_call(operands, params)
    py, ph = scan_ops.mamba_scan(*(_t(a) for a in operands))
    assert scan_ops.TOL == op.tol
    np.testing.assert_allclose(py.numpy(), _np(y), **op.tol)
    np.testing.assert_allclose(ph.numpy(), _np(h), **op.tol)


@pytest.mark.parametrize("s", [17, 100, 128])
def test_scan_plain_with_bf16_inputs_matches_reference(s):
    """x/dt/Bm/Cm in bf16 and A/D in f32, as the mamba layer hands them
    over: S below, at and off a multiple of the reference's chunk."""
    b, d, n = 2, 32, 16
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d)) - 2.0)).astype(
        np.float32)
    a = -np.exp(0.5 * rng.standard_normal((d, n))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    dsk = rng.standard_normal((d,)).astype(np.float32)
    bf = jnp.bfloat16
    y, h = jscan_ref.mamba_scan_ref(jnp.asarray(x, bf), jnp.asarray(dt, bf),
                                    jnp.asarray(a), jnp.asarray(bm, bf),
                                    jnp.asarray(cm, bf), jnp.asarray(dsk))
    py, ph = scan_ops.mamba_scan(
        _t(x).bfloat16(), _t(dt).bfloat16(), _t(a), _t(bm).bfloat16(),
        _t(cm).bfloat16(), _t(dsk))
    assert py.dtype == torch.bfloat16 and ph.dtype == torch.float32
    assert py.shape == (b, s, d) and ph.shape == (b, d, n)
    np.testing.assert_allclose(py.float().numpy(), _np(y), **TOL_BF16_OUT)
    np.testing.assert_allclose(ph.numpy(), _np(h), **scan_ops.TOL)


def test_scan_launcher_refuses_what_the_kernel_does_not_take():
    b, s, d, n = 2, 5, 16, 8
    bf = torch.bfloat16
    ok = dict(x=torch.zeros(b, s, d, dtype=bf), dt=torch.zeros(b, s, d,
                                                               dtype=bf),
              A=torch.zeros(d, n), Bm=torch.zeros(b, s, n, dtype=bf),
              Cm=torch.zeros(b, s, n, dtype=bf), D=torch.zeros(d))
    with pytest.raises(ValueError, match="CUDA"):
        scan_kern.mamba_scan_fwd(**ok)
    for change, err, match in (
            (dict(dt=ok["dt"].float()), TypeError, "share"),
            (dict(A=ok["A"].to(bf)), TypeError, "float32"),
            (dict(Bm=torch.zeros(b, s + 1, n, dtype=bf)), ValueError, "Bm"),
            (dict(D=torch.zeros(d + 8)), ValueError, "D must be"),
            (dict(A=torch.zeros(d, 4), Bm=torch.zeros(b, s, 4, dtype=bf),
                  Cm=torch.zeros(b, s, 4, dtype=bf)), NotImplementedError,
             "d_state 4"),
            (dict(x=torch.zeros(b, s, 12, dtype=bf),
                  dt=torch.zeros(b, s, 12, dtype=bf), A=torch.zeros(12, n),
                  D=torch.zeros(12)), ValueError, "multiple of 8")):
        with pytest.raises(err, match=match):
            scan_kern.mamba_scan_fwd(**dict(ok, **change))
    assert scan_kern.KERNEL.launches == 0


# ------------------------------------------------------------ block -----

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    x, w = _rand((2, 5, 16), 0), _rand((16, 4), 1)
    bias = _rand((16,), 2)
    state = _rand((2, 3, 16), 3) if with_state else None
    y, new = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(bias),
                               state=None if state is None
                               else jnp.asarray(state))
    py, pnew = pssm._causal_conv(_t(x), _t(w), _t(bias),
                                 state=None if state is None else _t(state))
    np.testing.assert_allclose(py.numpy(), _np(y), **TOL)
    np.testing.assert_allclose(pnew.numpy(), _np(new), **TOL)


@pytest.mark.parametrize("s", [2, 11])
def test_apply_mamba_with_its_decode_state_matches_reference(s):
    """y, the final state h and the conv tail (padded on the left when
    the prompt is shorter than the conv's context)."""
    jcfg, pcfg = _cfgs()
    jp, pp = _mamba_params(jcfg)
    x = _rand((2, s, jcfg.d_model), 0)
    with ctx.target("generic"):
        y, cache = jssm.apply_mamba(jp, jnp.asarray(x), jcfg,
                                    return_cache=True)
    py, pcache = pssm.apply_mamba(pp, _t(x), pcfg, return_cache=True)
    assert pcache["h"].shape == (2, 128, 8) and pcache["conv"].shape == (
        2, 3, 128)
    np.testing.assert_allclose(py.numpy(), _np(y), **TOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(pcache[name].numpy(), _np(cache[name]),
                                   **TOL)


def test_decode_mamba_matches_reference():
    jcfg, pcfg = _cfgs()
    jp, pp = _mamba_params(jcfg)
    x = _rand((3, 1, jcfg.d_model), 0)
    h, conv = _rand((3, 128, 8), 1), _rand((3, 3, 128), 2)
    out, new = jssm.decode_mamba(jp, jnp.asarray(x),
                                 {"h": jnp.asarray(h),
                                  "conv": jnp.asarray(conv)}, jcfg)
    cache = {"h": _t(h), "conv": _t(conv)}
    pout = pssm.decode_mamba(pp, _t(x), cache, pcfg)
    np.testing.assert_allclose(pout.numpy(), _np(out), **TOL)
    for name in ("h", "conv"):                    # written in place
        np.testing.assert_allclose(cache[name].numpy(), _np(new[name]),
                                   **TOL)


# ------------------------------------------------------------ model -----

@pytest.mark.parametrize("which", ["full", "smoke", "four", "odd"])
def test_config_and_segments_match_reference(which):
    """The config's fields and ``plan_segments``: the full 72 layers,
    the smoke twin, the 4-layer cut the chip check serves, and an odd
    pattern under ``every_2`` (the period doubles)."""
    want, got = {"full": (get_config(ARCH), port_configs.get_config(ARCH)),
                 "smoke": (smoke_config(ARCH), port_smoke_config(ARCH)),
                 "four": (get_config(ARCH), port_configs.get_config(ARCH)),
                 "odd": _cfgs()}[which]
    if which == "four":
        want, got = (dataclasses.replace(c, num_layers=4)
                     for c in (want, got))
    if which == "odd":
        want, got = (dataclasses.replace(
            c, layer_pattern=("attn", "mamba", "mamba"), num_layers=14)
            for c in (want, got))
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    plans = [(p.block, p.reps) for p in PT.plan_segments(got)]
    assert plans == [(p.block, p.reps) for p in JT.plan_segments(want)]
    if which == "odd":
        assert plans[0][1] == 2 and len(plans[0][0]) == 6


def test_prefill_and_decode_step_match_reference():
    model, params, pmodel, pparams = _models()
    toks = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(np.int32)
    with ctx.target("generic"):
        logits, caches = model.prefill(params, jnp.asarray(toks), 16, {})
    plogits, pcaches = pmodel.prefill(pparams, _t(toks).long(), 16)
    np.testing.assert_allclose(plogits.numpy(), _np(logits), **TOL)
    # layer r * 8 + j is block position j at repeat r
    assert set(pcaches[1]) == {"h", "conv"} and set(pcaches[8]) == {"k", "v"}
    np.testing.assert_allclose(pcaches[11]["h"].numpy(),
                               _np(caches[0][3]["h"][1]), **TOL)
    np.testing.assert_allclose(pcaches[5]["conv"].numpy(),
                               _np(caches[0][5]["conv"][0]), **TOL)
    cur = np.array([3, 250], np.int32)
    lengths = np.array([9, 9], np.int32)
    with ctx.target("generic"):
        logits, new = model.decode_step(params, caches, jnp.asarray(cur),
                                        jnp.asarray(lengths))
    plogits = pmodel.decode_step(pparams, pcaches, _t(cur), _t(lengths))
    np.testing.assert_allclose(plogits.numpy(), _np(logits), **TOL)
    np.testing.assert_allclose(pcaches[2]["h"].numpy(),
                               _np(new[0][2]["h"][0]), **TOL)


def test_prefill_then_decode_is_the_longer_prefill():
    """Decoding token 8 over a 7-token prefill reproduces the 8-token
    prefill's logits (float32), dense and paged (the mamba state stays
    dense beside the pools), at a capacity no call can overflow; the
    plain replay of the step, and the forward's logits, agree too."""
    _, _, pmodel, pparams = _models(cf=16.0)
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
    kinds = cfg.layer_kinds()
    pools = port_paging.init_paged_caches(
        cfg.num_layers, h, dk, 9, 4, device="cpu", dtype=torch.float32,
        v_head_dim=dv, recurrent={
            i: pssm.mamba_cache(cfg, 2, torch.float32, "cpu")
            for i, k in enumerate(kinds) if k == "mamba"})
    assert set(pools[0]) == {"kp", "vp"} and set(pools[1]) == {"h", "conv"}
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


def test_convert_carries_the_mamba_tree():
    _, params, _, pparams = _models()
    tree = jax.tree_util.tree_map(np.asarray, params)
    layers = pparams["layers"]
    kinds = port_smoke_config(ARCH).layer_kinds()
    for i, (p, kind) in enumerate(zip(layers, kinds)):
        assert ("mamba" in p) == (kind == "mamba") and ("attn" in p) == (
            kind == "global")
        assert ("moe" in p) == (i % 2 == 1) and ("mlp" in p) == (i % 2 == 0)
    blk = tree["segments"][0][3]                  # layer 11: repeat 1
    for name, leaf in blk["mamba"].items():
        np.testing.assert_array_equal(layers[11]["mamba"][name].numpy(),
                                      leaf[1])
    np.testing.assert_array_equal(layers[11]["moe"]["we_up"].numpy(),
                                  blk["moe"]["we_up"][1])


@pytest.mark.parametrize("source", ["init", "convert"])
def test_mamba_keeps_its_f32_parameters_in_bf16(source):
    """The reference computes with a_log, dt_bias, dt_proj and d_skip in
    f32 (and the MoE router): the port keeps them in f32 in a bf16
    model, and everything else in bf16."""
    if source == "init":
        pmodel = port_build_model(_cfgs("bfloat16")[1])
        pparams = pmodel.init(torch.Generator().manual_seed(0), device="cpu")
    else:
        pparams = _models(dtype="bfloat16")[3]
    mamba = pparams["layers"][1]["mamba"]
    assert sorted(pssm.F32_PARAMS) == ["a_log", "d_skip", "dt_bias",
                                       "dt_proj"]
    for name, w in mamba.items():
        want = torch.float32 if name in pssm.F32_PARAMS else torch.bfloat16
        assert w.dtype == want, name
    assert pparams["layers"][1]["moe"]["router"].dtype == torch.float32
    assert pparams["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    if source == "init":          # the reference's laws
        torch.testing.assert_close(
            mamba["a_log"][5], torch.log(torch.arange(1.0, 9.0)))
        dt = torch.nn.functional.softplus(mamba["dt_bias"])
        assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1
        assert not (mamba["d_skip"] - 1).any()


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


def test_engine_preemption_is_token_identical_to_reference():
    """A pool of 5 pages of 8 for two slots growing to 24 new tokens:
    the re-prefill after each preemption must rebuild the slot's mamba
    state, as the reference's does, with the same victims."""
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
    and must see nothing of it, in its tokens and in its state."""
    a, b = [7, 8, 9, 10, 11], [200, 3, 3, 90]
    sc = dict(ENGINE, slots=1, paged=paged)
    eng, outs = _port([a, b], **sc)
    fresh, alone = _port([b], **sc)
    assert outs[1] == alone[0]
    for c, f in zip(eng.caches, fresh.caches):
        if "h" in c:
            torch.testing.assert_close(c["h"], f["h"], atol=0, rtol=0)
            torch.testing.assert_close(c["conv"], f["conv"], atol=0, rtol=0)


@pytest.mark.parametrize("mode", [dict(kv_dtype="int8"),
                                  dict(kv_dtype="fp8_e4m3")])
def test_engine_quantizes_attention_pools_beside_dense_mamba_state(mode):
    """int8/fp8 pools for jamba: the attention layers' pools take the
    spec's storage with scale pools, every mamba layer keeps its dense
    slot-major state in the model's dtype (the engines against
    ``repro.serve.Engine``: tests/test_torch_hybrid_quant.py)."""
    _, _, pmodel, pparams = _models()
    eng = PortEngine(pmodel, pparams, PortServeConfig(paged=True, **mode),
                     device="cpu")
    storage = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}
    for c, kind in zip(eng.caches, pmodel.cfg.layer_kinds()):
        if kind == "mamba":
            assert set(c) == {"h", "conv"}
            assert c["h"].dtype == torch.float32
            assert c["h"].shape[0] == eng.sc.slots
        else:
            assert c["kp"].dtype == storage[mode["kv_dtype"]]
            assert c["ks"].shape == c["kp"].shape[:2]
    assert eng.stats()["kv_dtype"] == mode["kv_dtype"]


def test_engine_refuses_speculation_over_mamba_layers():
    _, _, pmodel, pparams = _models()
    with pytest.raises(ValueError, match="cannot roll back"):
        PortEngine(pmodel, pparams,
                   PortServeConfig(paged=True, spec_mode="ngram", spec_k=2),
                   device="cpu")


def test_launcher_serves_jamba_on_cpu(capsys):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", ARCH, "--smoke", "--prompts", "3",
                       "--prompt-len", "6", "--max-new", "4", "--paged",
                       "--page-size", "4", "--device", "cpu"])
    assert all(r.done and len(r.out) == 4 for r in reqs)
    out = capsys.readouterr().out
    assert '"all_done": true' in out and '"mamba_scan": 0' in out
