"""The port's fault plane (``repro_torch.serve.faults`` and the engine's
recovery ladder) against ``repro.serve``, mirrored on
tests/test_faults.py: the seeded plan, the K/V NaN law of the decode
plain versions, the NaN write and the page scan, and every rung of the
ladder (detect, requeue, quarantine, watchdog, retry budget, spec
degrade, backoff), the two engines on the same float32 granite smoke
model and the same plan.

The reference runs under ``target("generic")`` (ROADMAP.md queue C,
note 0); the port on the CPU, where every kernel wrapper takes its plain
version.  The kernels' own NaN law is held on the card
(tests/test_torch_gpu.py).
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.kernels.decode_attention import ops as jops
from repro.models.registry import build_model
from repro.serve import Engine as JEngine
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import paging
from repro_torch.serve.engine import Engine, Request, ServeConfig
from repro_torch.serve.faults import (FAULT_KINDS, FaultPlan, corrupt_page,
                                      nonfinite_pages)

_STATE = {}


def _models():
    """(jax model, jax params, port model, port params): granite smoke,
    one layer, float32."""
    if "m" not in _STATE:
        cfg = dataclasses.replace(smoke_config("granite-8b", num_layers=1),
                                  dtype="float32")
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        pcfg = dataclasses.replace(
            port_smoke_config("granite-8b", num_layers=1), dtype="float32")
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE["m"] = (model, params, port_build_model(pcfg),
                       from_jax_params(tree, pcfg, device="cpu"))
    return _STATE["m"]


def _sc(**kw):
    base = dict(slots=2, cache_len=32, max_new_tokens=8, paged=True,
                page_size=4, max_retries=6, retry_backoff=1)
    base.update(kw)
    return base


def _reqs(cls, n=4):
    return [cls(rid=i, tokens=[3 + i, 5, 7, 11][:3 + (i % 2)])
            for i in range(n)]


def _drive(eng, reqs, arm_watchdog_s=None, max_steps=500):
    """Submit and step to drain, auditing every step.  The reference
    engine's watchdog is armed here after the first step, as its
    launcher does; the port's engine arms ServeConfig.watchdog_s itself
    after its first step."""
    for r in reqs:
        eng.submit(r)
    for i in range(max_steps):
        busy = eng.step()
        if i == 0 and arm_watchdog_s is not None:
            eng.watchdog_s = arm_watchdog_s
        assert eng.audit() == [], eng.audit()
        if not busy and not eng.queue and not eng.requeue:
            return reqs
    raise AssertionError(f"engine did not drain: {eng.stats()}")


def _plans(schedule=(), **kw):
    """The same plan in both packages: ``schedule`` of (step, kind,
    slot) entries, ``kw`` the FaultPlan arguments."""
    plans = []
    for cls in (JFaultPlan, FaultPlan):
        plan = cls(**kw)
        for step, kind, slot in schedule:
            plan.at(step, kind, slot)
        plans.append(plan)
    return plans


def _pair(schedule=(), plan_kw=None, n=4, watchdog_s=None, **sc):
    """Drive both engines over the same requests and plan; returns
    (reference engine, its requests, port engine, its requests)."""
    model, params, pmodel, pparams = _models()
    jplan, pplan = (_plans(schedule, **(plan_kw or {}))
                    if schedule or plan_kw else (None, None))
    with ctx.target("generic"):
        jeng = JEngine(model, params, JServeConfig(**_sc(**sc)),
                       fault_plan=jplan)
        jreqs = _drive(jeng, _reqs(JRequest, n), watchdog_s)
    peng = Engine(pmodel, pparams,
                  ServeConfig(**_sc(**sc), watchdog_s=watchdog_s),
                  device="cpu", fault_plan=pplan)
    preqs = _drive(peng, _reqs(Request, n))
    return jeng, jreqs, peng, preqs


def _same_run(jeng, jreqs, peng, preqs):
    """Outputs, statuses, retries, failed set and the recovery, quarantine
    and step counters equal the reference's."""
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    assert [r.status for r in preqs] == [r.status for r in jreqs]
    assert [r.retries for r in preqs] == [r.retries for r in jreqs]
    assert [r.spec_disabled for r in preqs] == \
        [r.spec_disabled for r in jreqs]
    js, ps = jeng.stats(), peng.stats()
    for key in ("recoveries", "recoveries_total", "failed_requests",
                "watchdog_trips", "steps", "quarantined", "available",
                "total_pages", "preemptions", "requeue_peak_depth"):
        assert ps[key] == js[key], (key, ps[key], js[key])
    assert ps.get("faults_injected") == js.get("faults_injected")
    assert peng.allocator.usable == jeng.allocator.usable


def _unfaulted(**sc):
    key = ("want", tuple(sorted(sc.items())))
    if key not in _STATE:
        _STATE[key] = _pair(**sc)
    return _STATE[key]


# ------------------------------------------------------------ FaultPlan ----

def test_fault_plan_validates_inputs():
    with pytest.raises(ValueError, match="rate"):
        FaultPlan(rate=1.5)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan().at(3, "bogus")


@pytest.mark.parametrize("rate,seed", [(0.5, 42), (0.05, 0), (0.3, 7)])
def test_fault_plan_draws_match_reference(rate, seed):
    """One seed, one schedule in both packages, over changing active
    sets; memoized, so re-querying a step (out of order too) is stable."""
    jplan, pplan = _plans(rate=rate, seed=seed)
    actives = [list(range(s % 5)) for s in range(60)]
    want = [jplan.faults_for(s, a) for s, a in enumerate(actives)]
    got = [pplan.faults_for(s, a) for s, a in enumerate(actives)]
    assert got == want
    assert pplan.injected == jplan.injected
    assert list(pplan.injection_log) == list(jplan.injection_log)
    again = [pplan.faults_for(s, actives[s]) for s in reversed(range(60))]
    assert got == list(reversed(again))
    if rate >= 0.3:
        assert any(got), f"rate={rate} over 60 steps never fired"


def test_fault_plan_scheduled_entries_resolve_slots():
    plan = (FaultPlan().at(3, "kv_corrupt")
            .at(3, "nan_logits", slot=5).at(4, "alloc_fail"))
    assert plan.faults_for(3, [2, 5]) == [("kv_corrupt", 2),
                                          ("nan_logits", 5)]
    assert plan.faults_for(5, []) == []
    plan2 = FaultPlan().at(7, "kv_corrupt").at(7, "alloc_fail")
    assert plan2.faults_for(7, []) == [("alloc_fail", None)]
    assert plan2.injected["alloc_fail"] == 1
    assert plan2.injected["kv_corrupt"] == 0      # dropped != injected
    jplan = (JFaultPlan().at(3, "kv_corrupt")
             .at(3, "nan_logits", slot=5).at(4, "alloc_fail"))
    assert jplan.faults_for(3, [2, 5]) == [("kv_corrupt", 2),
                                           ("nan_logits", 5)]


# -------------------------------------------------- NaN-propagation law ----

_B, _HQ, _HKV, _D, _PS, _T = 3, 4, 2, 16, 4, 5
_LENGTHS = (17, 18, 20)           # 5 pages each; page 2 is a middle one


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _paged_operands(k1=None):
    q = _np((_B, _HQ, _D) if k1 is None else (_B, k1, _HQ, _D), 0)
    n_pages = 1 + _B * _T
    kp, vp = _np((_HKV, n_pages, _PS, _D), 1), _np((_HKV, n_pages, _PS, _D), 2)
    bt = (np.random.default_rng(3).permutation(_B * _T).reshape(_B, _T)
          + 1).astype(np.int32)
    return q, kp, vp, bt


def _quantized(pool):
    """int8 pages and (Hkv, P) f32 scales at per-(head, page) absmax."""
    amax = np.abs(pool).max(axis=(2, 3))
    sc = np.maximum(amax, 1e-6) / 127.0
    q = np.clip(np.rint(pool / sc[:, :, None, None]), -127, 127)
    return q.astype(np.int8), sc.astype(np.float32)


def _ring_operands():
    """Ring tables of window 8 over pages of 4: each slot's 3 live window
    pages at column g % T_w of scrambled pages (lengths 17, 18, 20)."""
    window = 8
    tw = paging.window_table_width(window, _PS)
    n_pages = 1 + _B * tw
    perm = list(np.random.default_rng(4).permutation(np.arange(1, n_pages)))
    bt = np.zeros((_B, tw), np.int32)
    middle = []
    for i, n in enumerate(_LENGTHS):
        live = list(paging.live_window_pages(n, window, _PS))
        for g in live:
            bt[i, g % tw] = perm.pop()
        middle.append(int(bt[i, live[1] % tw]))
    q = _np((_B, _HQ, _D), 0)
    kp, vp = _np((_HKV, n_pages, _PS, _D), 1), _np((_HKV, n_pages, _PS, _D), 2)
    return q, kp, vp, bt, middle, window


def _poison(pool, page):
    pool = pool.copy()
    pool[:, page] = np.nan
    return pool


def _law(port_out, ref_out, kside):
    """Slot 1 was poisoned: finiteness masks equal, finite values within
    f32 tolerance; a K-side NaN leaves slot 1 exactly 0 (the reference's
    value), a V-side one makes it NaN and no other slot."""
    port_out, ref_out = np.asarray(port_out), np.asarray(ref_out)
    fin = np.isfinite(ref_out)
    np.testing.assert_array_equal(np.isfinite(port_out), fin)
    np.testing.assert_allclose(port_out[fin], ref_out[fin], atol=1e-5,
                               rtol=1e-5)
    if kside:
        assert fin.all()
        assert (ref_out[1] == 0).all() and (port_out[1] == 0).all()
    else:
        assert not fin[1].any() and fin[0].all() and fin[2].all()


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _ln():
    return np.array(_LENGTHS, np.int32)


@pytest.mark.parametrize("side", ["k", "v"])
def test_nan_law_dense(side):
    """B3's plain version, unsplit and at chunks of 8 rows: NaN in rows
    8..11 of slot 1's cache."""
    q = _np((_B, _HQ, _D), 0)
    kc, vc = _np((_B, _HKV, 24, _D), 1), _np((_B, _HKV, 24, _D), 2)
    (kc if side == "k" else vc)[1, :, 8:12] = np.nan
    with ctx.target("generic"):
        want = jops.decode_attention(*map(jnp.asarray, (q, kc, vc, _ln())))
    _law(dec_ops.decode_attention(*_t(q, kc, vc, _ln())).numpy(), want,
         side == "k")
    acc, _, l = dec_ref.decode_attention_ref(*_t(q, kc, vc, _ln()), chunk=8,
                                             return_residuals=True)
    _law(dec_ref.normalize(acc, l, torch.float32).numpy(), want,
         side == "k")


@pytest.mark.parametrize("side", ["k", "v"])
def test_nan_law_paged(side):
    """B4's plain version, unsplit and at its chunks of 8 rows."""
    q, kp, vp, bt = _paged_operands()
    page = int(bt[1, 2])
    kp, vp = (_poison(kp, page), vp) if side == "k" else (kp,
                                                          _poison(vp, page))
    with ctx.target("generic"):
        want = jops.paged_decode_attention(
            *map(jnp.asarray, (q, kp, vp, bt, _ln())))
    _law(dec_ops.paged_decode_attention(*_t(q, kp, vp, bt, _ln())).numpy(),
         want, side == "k")
    acc, _, l = dec_ref.paged_decode_attention_ref(
        *_t(q, kp, vp, bt, _ln()), chunk=8, return_residuals=True)
    _law(dec_ref.normalize(acc, l, torch.float32).numpy(), want,
         side == "k")


@pytest.mark.parametrize("side", ["k", "v"])
def test_nan_law_quant_scales(side):
    """B5's plain version with NaN in a middle page's K or V scale."""
    q, kp, vp, bt = _paged_operands()
    (kq, ks), (vq, vs) = _quantized(kp), _quantized(vp)
    page = int(bt[1, 2])
    if side == "k":
        ks = ks.copy()
        ks[:, page] = np.nan
    else:
        vs = vs.copy()
        vs[:, page] = np.nan
    args = (q, kq, vq, ks, vs, bt, _ln())
    with ctx.target("generic"):
        want = jops.quant_paged_decode_attention(*map(jnp.asarray, args))
    _law(dec_ops.quant_paged_decode_attention(*_t(*args)).numpy(), want,
         side == "k")


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("side", ["k", "v"])
def test_nan_law_spec(side, quant):
    """B6's plain version (K1 = 3), over a float pool and an int8 one:
    every one of slot 1's rows sees the poisoned page."""
    q, kp, vp, bt = _paged_operands(k1=3)
    page = int(bt[1, 2])
    base = np.array([14, 15, 16], np.int32)
    if quant:
        (kq, ks), (vq, vs) = _quantized(kp), _quantized(vp)
        (ks if side == "k" else vs)[:, page] = np.nan
        args = (q, kq, vq, ks, vs, bt, base)
        jfn, fn = (jops.quant_spec_paged_decode_attention,
                   dec_ops.quant_spec_paged_decode_attention)
    else:
        kp, vp = (_poison(kp, page), vp) if side == "k" else (
            kp, _poison(vp, page))
        args = (q, kp, vp, bt, base)
        jfn, fn = (jops.spec_paged_decode_attention,
                   dec_ops.spec_paged_decode_attention)
    with ctx.target("generic"):
        want = jfn(*map(jnp.asarray, args))
    _law(fn(*_t(*args)).numpy(), want, side == "k")


@pytest.mark.parametrize("quant", [False, True], ids=["B7", "B7q"])
@pytest.mark.parametrize("side", ["k", "v"])
def test_nan_law_window(side, quant):
    """B7's and B7q's plain versions over ring tables: NaN in the middle
    page of slot 1's live window (its K or V page, or scale)."""
    q, kp, vp, bt, middle, window = _ring_operands()
    page = middle[1]
    if quant:
        (kq, ks), (vq, vs) = _quantized(kp), _quantized(vp)
        (ks if side == "k" else vs)[:, page] = np.nan
        args = (q, kq, vq, ks, vs, bt, _ln())
        jfn, fn = (jops.quant_window_paged_decode_attention,
                   dec_ops.quant_window_paged_decode_attention)
    else:
        kp, vp = (_poison(kp, page), vp) if side == "k" else (
            kp, _poison(vp, page))
        args = (q, kp, vp, bt, _ln())
        jfn, fn = (jops.window_paged_decode_attention,
                   dec_ops.window_paged_decode_attention)
    with ctx.target("generic"):
        want = jfn(*map(jnp.asarray, args), window=window)
    _law(fn(*_t(*args), window=window).numpy(), want, side == "k")


def test_corrupt_page_targets_value_leaf_and_scan_finds_it():
    f = torch.zeros(2, 5, 4, 8)                   # (H, pages, ps, D)
    caches = [{"h": torch.zeros(2, 3)},           # a recurrent layer
              {"kp": f.clone(), "vp": f.clone()}, {"kp": f.clone(),
                                                   "vp": f.clone()}]
    corrupt_page(caches, page=3)
    assert torch.isfinite(caches[1]["kp"]).all()           # K untouched
    assert not torch.isfinite(caches[1]["vp"][:, 3]).any()
    assert torch.isfinite(caches[2]["vp"]).all()           # one layer only
    assert nonfinite_pages(caches, [1, 2, 3, 4]) == [3]
    assert nonfinite_pages(caches, [4, 3, 1]) == [3]
    assert nonfinite_pages(caches, []) == []
    # quantized pools: the int8 pool cannot hold NaN; the V scale can
    qcaches = [{"kp": f.to(torch.int8), "vp": f.to(torch.int8),
                "ks": torch.ones(2, 5), "vs": torch.ones(2, 5)}]
    corrupt_page(qcaches, page=2)
    assert not torch.isfinite(qcaches[0]["vs"][:, 2]).any()
    assert nonfinite_pages(qcaches, [2, 3]) == [2]
    # fp8 pools are scanned through their bytes
    f8 = [{"kp": f.to(torch.float8_e4m3fn), "vp": f.to(torch.float8_e4m3fn),
           "ks": torch.ones(2, 5), "vs": torch.ones(2, 5)}]
    f8[0]["kp"].view(torch.uint8)[1, 4, 0, 0] = 0x7F          # e4m3 NaN
    assert nonfinite_pages(f8, [1, 4]) == [4]
    with pytest.raises(ValueError, match="no paged float pool"):
        corrupt_page([{"k": f, "v": f}, {"kw": f, "vw": f}], page=1)


def test_nonfinite_pages_makes_one_copy():
    """The scan over every layer's pools ends in one device-to-host copy
    (the engine's ``_device_get``, which its tests count)."""
    f = torch.zeros(2, 6, 4, 8)
    caches = [{"kp": f.clone(), "vp": f.clone()} for _ in range(3)]
    caches[2]["kp"][0, 5, 1, 1] = float("inf")
    calls = []

    def get(t):
        calls.append(t.shape)
        return t.numpy()

    assert nonfinite_pages(caches, [2, 5, 1], get) == [5]
    assert calls == [(3,)]


# ---------------------------------------------------- recovery ladder ----

def test_fault_plan_requires_paged_engine():
    _, _, pmodel, pparams = _models()
    with pytest.raises(ValueError, match="requires paged"):
        Engine(pmodel, pparams, ServeConfig(paged=False), device="cpu",
               fault_plan=FaultPlan())
    for bad in (dict(max_retries=-1), dict(retry_backoff=-1)):
        with pytest.raises(ValueError, match=">= 0"):
            Engine(pmodel, pparams, ServeConfig(**_sc(**bad)), device="cpu")


@pytest.mark.parametrize("kind", ["nan_logits", "kv_corrupt", "alloc_fail"])
def test_single_fault_recovers_like_reference(kind):
    """One scheduled fault of each non-stall class: detected, the slot
    requeued (its corrupted page quarantined), the drained outputs those
    of the unfaulted run, and everything equal to the reference's."""
    *_, want = _unfaulted()
    run = _pair([(3, kind, None)])
    _same_run(*run)
    peng, preqs = run[2], run[3]
    assert all(r.done for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in want]
    st = peng.stats()
    assert st["recoveries"][kind] >= 1, st
    assert any(r.retries > 0 for r in preqs)
    if kind == "kv_corrupt":
        assert st["quarantined"] >= 1
        assert st["available"] == st["total_pages"] - 1 - st["quarantined"]
        assert peng.allocator.usable == st["total_pages"] - 1 \
            - st["quarantined"]
    else:
        assert st["quarantined"] == 0
        assert st["available"] == st["total_pages"] - 1


def test_random_faults_recover_like_reference():
    """Seeded random draws of every class (stalls too short to trip the
    unarmed watchdog): the same schedule, the same recoveries."""
    run = _pair(plan_kw=dict(rate=0.3, seed=3), n=6)
    _same_run(*run)
    assert sum(run[2].stats()["faults_injected"].values()) > 0


def test_stall_watchdog_discards_step_and_recovers():
    """A 1.0 s stall against a 0.5 s deadline (margin under parallel
    test workers): the step is discarded, every active slot requeued."""
    *_, want = _unfaulted()
    run = _pair([(4, "stall", None)], plan_kw=dict(stall_s=1.0),
                watchdog_s=0.5)
    _same_run(*run)
    peng, preqs = run[2], run[3]
    assert all(r.done for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in want]
    st = peng.stats()
    assert st["watchdog_trips"] == 1
    assert st["recoveries"]["stall"] >= 1
    assert st["last_watchdog_trip"]["step"] == 4


def test_watchdog_is_armed_after_the_first_step():
    """ServeConfig.watchdog_s leaves the first step, which builds the
    kernels, unwatched: a stall there trips nothing, as the reference
    armed by hand after its first step."""
    *_, want = _unfaulted()
    run = _pair([(1, "stall", None)], plan_kw=dict(stall_s=1.0),
                watchdog_s=0.5)
    _same_run(*run)
    peng, preqs = run[2], run[3]
    assert [r.out for r in preqs] == [r.out for r in want]
    assert peng.stats()["watchdog_trips"] == 0
    assert peng.stats()["recoveries_total"] == 0


def test_retry_budget_exhaustion_fails_explicitly():
    """Past max_retries a request ends ``failed``, never raising; the
    others complete as unfaulted."""
    *_, want = _unfaulted()
    run = _pair([(s, "nan_logits", 0) for s in range(2, 14)], max_retries=2)
    _same_run(*run)
    peng, preqs = run[2], run[3]
    assert all(r.status in ("done", "failed") for r in preqs)
    failed = [r for r in preqs if r.failed]
    assert failed, "retry budget never exhausted"
    assert peng.stats()["failed_requests"] == len(failed)
    for r, w in zip(preqs, want):
        if r.done:
            assert r.out == w.out


def test_repeated_spec_faults_degrade_to_plain_decode():
    """spec_disable_after faults in speculative steps pin the request to
    one token a step; outputs still those of the unfaulted spec run."""
    *_, ref = _unfaulted(spec_mode="ngram", spec_k=3, n=2)
    run = _pair([(2, "nan_logits", 0), (3, "nan_logits", 0)], n=2,
                spec_mode="ngram", spec_k=3, spec_disable_after=2)
    _same_run(*run)
    peng, preqs = run[2], run[3]
    assert all(r.done for r in preqs)
    assert any(r.spec_disabled for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in ref]


def test_backoff_stamp_delays_readmission():
    """A faulted request is not re-admitted before its backoff stamp
    expires (not_before counts engine steps), at the reference's step."""
    model, params, pmodel, pparams = _models()
    seen = {}
    for name, eng_cls, sc_cls, req_cls, plan in (
            ("jax", JEngine, JServeConfig, JRequest, JFaultPlan()),
            ("port", Engine, ServeConfig, Request, FaultPlan())):
        plan.at(3, "nan_logits", slot=0)
        sc = sc_cls(**_sc(retry_backoff=4))
        with ctx.target("generic"):
            eng = (eng_cls(model, params, sc, fault_plan=plan)
                   if name == "jax" else
                   eng_cls(pmodel, pparams, sc, device="cpu",
                           fault_plan=plan))
            reqs = _reqs(req_cls, 1)
            for r in reqs:
                eng.submit(r)
            readmitted_at = None
            for _ in range(200):
                busy = eng.step()
                if readmitted_at is None and reqs[0].retries \
                        and eng._active_h[0]:
                    readmitted_at = eng.step_count
                    assert eng.step_count >= reqs[0].not_before
                if not busy and not eng.queue and not eng.requeue:
                    break
        assert reqs[0].done and readmitted_at is not None
        assert reqs[0].not_before > 3 + 1             # a real delay
        seen[name] = (readmitted_at, reqs[0].not_before, reqs[0].out)
    assert seen["port"] == seen["jax"]


def test_step_keeps_one_copy_and_scan_adds_one():
    """The step's sentinel rides its one copy: with a plan attached and
    nothing injected, copies = decode steps + admitted groups; a
    kv_corrupt adds exactly one copy, the page scan's."""
    _, _, pmodel, pparams = _models()
    real_get, real_scan = engine_mod._device_get, engine_mod.nonfinite_pages
    for plan, extra in ((FaultPlan(), 0),
                        (FaultPlan().at(3, "kv_corrupt"), 1)):
        calls, scans, groups = [], [0], [0]

        def counted_get(t, calls=calls):
            calls.append(tuple(t.shape))
            return real_get(t)

        def counted_scan(*a, scans=scans):
            scans[0] += 1
            return real_scan(*a)

        engine_mod._device_get = counted_get
        engine_mod.nonfinite_pages = counted_scan
        try:
            eng = Engine(pmodel, pparams, ServeConfig(**_sc()),
                         device="cpu", fault_plan=plan)
            real_admit = eng._admit_group

            def counted_admit(reqs, plen, groups=groups):
                n = real_admit(reqs, plen)
                groups[0] += n > 0
                return n

            eng._admit_group = counted_admit
            _drive(eng, _reqs(Request))
        finally:
            engine_mod._device_get = real_get
            engine_mod.nonfinite_pages = real_scan
        steps = calls.count((3, 2))              # (tokens, done, bad)
        assert scans[0] == extra
        assert len(calls) == steps + groups[0] + scans[0]


# ----------------------------------------------------- stats / counters ----

def test_stats_exposes_resilience_counters():
    _, _, pmodel, pparams = _models()
    eng = Engine(pmodel, pparams, ServeConfig(**_sc()), device="cpu")
    st = eng.stats()
    for key in ("requeue_depth", "requeue_peak_depth",
                "preemptions_by_policy", "recoveries", "recoveries_total",
                "failed_requests", "watchdog_trips", "steps",
                "last_watchdog_trip", "last_recovery", "quarantined"):
        assert key in st, key
    assert set(st["recoveries"]) == set(FAULT_KINDS)
    assert "faults_injected" not in st
    eng3 = Engine(pmodel, pparams, ServeConfig(**_sc()), device="cpu",
                  fault_plan=FaultPlan().at(2, "nan_logits"))
    _drive(eng3, _reqs(Request, 1))
    st3 = eng3.stats()
    assert st3["faults_injected"]["nan_logits"] == 1
    assert st3["last_recovery"]["kind"] == "nan_logits"
    assert st3["recoveries_total"] == 1


def test_launcher_fault_rate_on_cpu(capsys):
    """The launcher with --fault-rate on the CPU: every request done or
    failed, the resilience keys in the summary; --fault-rate without
    --paged is refused."""
    reqs = launch_serve.main([
        "--arch", "granite-8b", "--smoke", "--paged", "--page-size", "4",
        "--device", "cpu", "--prompts", "4", "--max-new", "6",
        "--fault-rate", "0.3", "--fault-seed", "1", "--max-retries", "4"])
    out = json.loads(capsys.readouterr().out)
    assert all(r.status in ("done", "failed") for r in reqs)
    for key in ("statuses", "recoveries", "failed_requests",
                "watchdog_trips", "last_watchdog_trip", "last_recovery",
                "quarantined_pages", "faults_injected"):
        assert key in out, key
    assert out["statuses"]["pending"] == 0
    assert sum(out["faults_injected"].values()) > 0
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "granite-8b", "--smoke", "--device",
                           "cpu", "--fault-rate", "0.1"])
