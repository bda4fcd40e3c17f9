"""The port's serving engine against ``repro.serve.Engine``: the same
requests on the same weights must give the same greedy tokens, in
float32, dense and paged, on the request sets of tests/test_serve.py.

The JAX engine runs under ``target("generic")`` (its Pallas interpret
path is broken for dense decode on this jax; ROADMAP.md queue C, note
0); the port runs on the CPU, where every kernel wrapper takes its
plain PyTorch version.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.models.registry import build_model
from repro.serve import Engine, Request, ServeConfig
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.serve import engine as port_engine_mod
from repro_torch.serve.engine import Engine as PortEngine
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.serve.engine import ServeConfig as PortServeConfig

_STATE = {}


def _models():
    """(jax model, jax params, port model, port params), float32."""
    if "m" not in _STATE:
        cfg = dataclasses.replace(smoke_config("granite-8b", num_layers=2),
                                  dtype="float32")
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        pcfg = dataclasses.replace(
            port_smoke_config("granite-8b", num_layers=2), dtype="float32")
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE["m"] = (model, params, port_build_model(pcfg),
                       from_jax_params(tree, pcfg, device="cpu"))
    return _STATE["m"]


def _run_jax(prompts, **sc):
    model, params, _, _ = _models()
    with ctx.target("generic"):
        eng = Engine(model, params, ServeConfig(**sc))
        reqs = [Request(rid=i, tokens=list(p)) for i, p in enumerate(prompts)]
        eng.run_to_completion(reqs)
    return eng, reqs


def _port_engine(**sc):
    _, _, pmodel, pparams = _models()
    return PortEngine(pmodel, pparams, PortServeConfig(**sc), device="cpu")


def _run_port(prompts, **sc):
    eng = _port_engine(**sc)
    reqs = [PortRequest(rid=i, tokens=list(p)) for i, p in enumerate(prompts)]
    eng.run_to_completion(reqs)
    return eng, reqs


def _same_tokens(prompts, **sc):
    """Run both engines; assert identical outputs; return both."""
    jeng, jreqs = _run_jax(prompts, **sc)
    peng, preqs = _run_port(prompts, **sc)
    assert all(r.done for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    return (jeng, jreqs), (peng, preqs)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_queueing_five_requests_two_slots(paged):
    _, (peng, preqs) = _same_tokens(
        [[1 + i, 2, 3, 4] for i in range(5)], slots=2, cache_len=32,
        max_new_tokens=3, paged=paged, page_size=8)
    assert all(len(r.out) == 3 for r in preqs)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_slots_are_reused(paged):
    _, (peng, _) = _same_tokens([[3, 1, 4]] * 3, slots=1, cache_len=32,
                                max_new_tokens=2, paged=paged, page_size=8)
    assert all(s is None for s in peng.active)
    if paged:
        assert peng.allocator.available == peng.allocator.total_pages - 1
        assert (peng.block_tables == 0).all()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_mixed_lengths_grouped_admission(paged):
    """Five prompt lengths over two slots: admission groups by exact
    length, and slots free and refill at different steps."""
    _same_tokens([[1 + i] * (3 + i) for i in range(5)], slots=2,
                 cache_len=32, max_new_tokens=4, paged=paged, page_size=8)


@pytest.mark.parametrize("where", ["decode", "prefill"])
def test_eos_finishes_like_reference(where):
    """EOS sampled mid-decode ends the request at that step; EOS as the
    prefill sample ends it at admission and the queue backfills."""
    prompt = [5, 9, 2]
    _, free = _run_port([prompt], slots=1, cache_len=32, max_new_tokens=8)
    eos = free[0].out[2 if where == "decode" else 0]
    (_, jreqs), (_, preqs) = _same_tokens(
        [prompt, [4, 4, 4, 4]], slots=1, cache_len=32, max_new_tokens=8,
        eos_id=eos)
    assert preqs[0].out[-1] == eos
    assert len(preqs[0].out) == free[0].out.index(eos) + 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cache_full_uses_final_row(paged):
    cache_len, plen = 12, 4
    _, (_, preqs) = _same_tokens([list(range(1, plen + 1))], slots=1,
                                 cache_len=cache_len, max_new_tokens=100,
                                 paged=paged, page_size=4)
    assert len(preqs[0].out) == cache_len - plen + 1


def test_paged_long_decode_crosses_page_boundaries():
    """page_size 4 over 24 new tokens: pages are allocated mid-stream;
    paged and dense ports and the reference all agree."""
    sc = dict(slots=1, cache_len=32, max_new_tokens=24, page_size=4)
    _, (_, paged) = _same_tokens([[11, 3]], paged=True, **sc)
    _, dense = _run_port([[11, 3]], paged=False, **sc)
    assert len(paged[0].out) == 24
    assert paged[0].out == dense[0].out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_freed_slot_does_not_corrupt_successor(paged):
    """A freed slot keeps flowing through the batched decode with its
    stale token; its writes must never reach a later request's rows."""
    sc = dict(slots=1, cache_len=32, max_new_tokens=3, paged=paged,
              page_size=4)
    _, reqs = _run_port([[7 + i, 3, 5] for i in range(3)], **sc)
    for i in range(3):
        _, solo = _run_port([[7 + i, 3, 5]], **sc)
        assert solo[0].out == reqs[i].out, i


@pytest.mark.parametrize("policy", ["lru", "shortest"])
def test_preemption_at_half_pool_is_token_identical(policy):
    """2 slots x 4 pages of 8 tokens are needed; the pool holds 4 usable
    pages.  Preempted requests re-prefill and must emit the tokens of the
    reference engine under the same policy, and of an unconstrained run."""
    prompts = [[1 + i] * 6 for i in range(4)]
    sc = dict(slots=2, cache_len=32, max_new_tokens=24, paged=True,
              page_size=8)
    _, free = _run_port(prompts, **sc)
    (jeng, _), (peng, preqs) = _same_tokens(
        prompts, total_pages=5, preempt_policy=policy, **sc)
    assert [r.out for r in preqs] == [r.out for r in free]
    assert peng.preemptions > 0
    assert peng.preemptions == jeng.preemptions
    assert sum(r.preempts for r in preqs) == peng.preemptions
    st = peng.stats()
    assert st["available"] == st["total_pages"] - 1
    assert st["preemptions_by_policy"][policy] == peng.preemptions
    assert not peng.requeue and not peng.queue and peng.audit() == []


def test_fail_policy_raises_when_pool_runs_dry():
    eng = _port_engine(slots=2, cache_len=32, max_new_tokens=24, paged=True,
                       page_size=8, total_pages=5, preempt_policy="fail")
    reqs = [PortRequest(rid=i, tokens=[1 + i] * 6) for i in range(2)]
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.run_to_completion(reqs)
    assert eng.preemptions == 0


def test_sole_active_sequence_overflowing_pool_raises():
    eng = _port_engine(slots=1, cache_len=32, max_new_tokens=24, paged=True,
                       page_size=8, total_pages=3)
    with pytest.raises(RuntimeError, match="only active"):
        eng.run_to_completion([PortRequest(rid=0, tokens=[2] * 6)])


def test_victim_selection_per_policy():
    eng = _port_engine(slots=3, cache_len=32, max_new_tokens=4, paged=True,
                       page_size=8)
    for s, (seq, n_gen) in enumerate([(5, 1), (2, 7), (9, 3)]):
        eng.active[s] = PortRequest(rid=s, tokens=[1], out=[0] * n_gen)
        eng._active_h[s] = True
        eng._admit_seq[s] = seq
    eng.sc.preempt_policy = "lru"
    assert eng._select_victim(0) == 1
    assert eng._select_victim(1) == 0
    eng.sc.preempt_policy = "shortest"
    assert eng._select_victim(1) == 0
    assert eng._select_victim(0) == 2
    eng._active_h[:] = False
    eng._active_h[0] = True
    assert eng._select_victim(0) is None


def test_checkpoint_readmitted_at_full_cache_emits_final_token():
    cache_len, plen = 12, 4
    sc = dict(slots=1, cache_len=cache_len, max_new_tokens=100, paged=True,
              page_size=4)
    _, ref = _run_port([list(range(1, plen + 1))], **sc)
    eng = _port_engine(**sc)
    resumed = PortRequest(rid=1, tokens=list(range(1, plen + 1)), preempts=1)
    resumed.out = list(ref[0].out[:-1])
    eng.requeue.append(resumed)
    eng.run_to_completion([])
    assert resumed.done and resumed.out == ref[0].out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_submit_rejects_prompt_overflowing_cache(paged):
    eng = _port_engine(slots=1, cache_len=8, paged=paged, page_size=4)
    # paged: the pool (2 pages of 4) is the tighter bound and says so
    msg = "whole pool" if paged else "does not fit"
    with pytest.raises(ValueError, match=msg):
        eng.submit(PortRequest(rid=0, tokens=list(range(8))))
    with pytest.raises(ValueError, match=msg):
        eng.submit(PortRequest(rid=1, tokens=list(range(20))))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(PortRequest(rid=2, tokens=[]))
    eng.submit(PortRequest(rid=3, tokens=list(range(7))))
    assert len(eng.queue) == 1


def test_submit_rejects_prompt_larger_than_pool():
    eng = _port_engine(slots=2, cache_len=16, max_new_tokens=2, paged=True,
                       page_size=4, total_pages=4)
    with pytest.raises(ValueError, match="whole pool"):
        eng.submit(PortRequest(rid=9, tokens=[1] * 14))


def test_submit_truncate_keeps_tail_and_matches_reference():
    sc = dict(slots=1, cache_len=8, max_new_tokens=4, on_overflow="truncate")
    jeng, jreqs = _run_jax([list(range(20))], **sc)
    eng = _port_engine(**sc)
    req = PortRequest(rid=0, tokens=list(range(20)))
    with pytest.warns(UserWarning, match="exceeds"):
        eng.submit(req)
    assert req.tokens == list(range(13, 20)) and req.truncated
    eng.run_to_completion([])
    assert req.done and req.out == jreqs[0].out


def test_unported_options_raise():
    """Sampling at temperature > 0 and the priority policy are served
    now; what the engine still refuses raises: sampling under
    speculation (its verify accepts by identity with the argmax chain)
    and an unknown policy."""
    assert _port_engine(temperature=0.8).sc.temperature == 0.8
    assert _port_engine(paged=True, preempt_policy="priority").paged
    with pytest.raises(ValueError, match="temperature"):
        _port_engine(paged=True, spec_mode="ngram", temperature=0.8)
    with pytest.raises(ValueError, match="preempt_policy"):
        _port_engine(paged=True, preempt_policy="round-robin")


def test_one_device_get_per_step_and_per_admitted_group(monkeypatch):
    """The port's host-sync hook runs once per admitted prompt-length
    group and once per decode step, never per slot."""
    eng = _port_engine(slots=4, cache_len=32, max_new_tokens=4, paged=True,
                       page_size=8)
    calls = []
    real = port_engine_mod._device_get
    monkeypatch.setattr(port_engine_mod, "_device_get",
                        lambda t: (calls.append(1), real(t))[1])
    for i in range(4):                      # two prompt lengths: 2 groups
        eng.submit(PortRequest(rid=i, tokens=[1 + i] * (3 + i % 2)))
    eng._admit()
    assert len(calls) == 2
    for n in range(1, 4):
        assert eng.step()
        assert len(calls) == 2 + n, f"{len(calls) - 2} syncs in {n} steps"


def test_stats_and_audit_after_drain():
    eng, reqs = _run_port([[1 + i] * 6 for i in range(4)], slots=2,
                          cache_len=32, max_new_tokens=24, paged=True,
                          page_size=8, total_pages=5)
    st = eng.stats()
    assert st["steps"] == eng.step_count > 0
    assert st["preemptions"] == eng.preemptions > 0
    assert st["requeue_peak_depth"] >= 1
    assert st["in_use"] == 0 and st["allocs"] == st["frees"]
    assert eng.audit() == []
    assert eng.metrics.snapshot()["counters"]["serve.preemptions"] == \
        eng.preemptions


def test_launcher_serves_on_cpu(capsys):
    """``python -m repro_torch.launch.serve`` end to end at smoke size."""
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", "granite-8b", "--smoke", "--prompts", "3",
                       "--prompt-len", "5", "--max-new", "4", "--paged",
                       "--page-size", "4", "--device", "cpu"])
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert '"all_done": true' in capsys.readouterr().out
