"""The port's MoE layer and its grouped matmul (kernel B8) against
``repro``'s, on the CPU.

``gmm``'s plain version against the reference op's under
``target("generic")`` with the op's own ``tol``; the routing helpers
(capacity, queue positions, destinations) against the reference's on
random routings; ``apply_moe`` against the reference's on the same
weights, with shared experts, with a dense residual MLP, and at a
capacity small enough that assignments drop on both sides.  The kernel
itself runs only on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.kernels import registry as R
from repro.kernels.gmm.ops import gmm as jgmm
from repro.models import moe as jmoe
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.core import build, tuning
from repro_torch.kernels.gmm import gmm as gmm_kern
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.models import moe as pmoe

ARCH = "deepseek-v2-lite-16b"
F32 = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _configs(**moe_changes):
    """(reference config, port config), float32, the smoke MoE with
    ``moe_changes`` applied to both."""
    cfgs = []
    for c in (smoke_config(ARCH), port_smoke_config(ARCH)):
        c = dataclasses.replace(c, dtype="float32")
        if moe_changes:
            c = dataclasses.replace(
                c, moe=dataclasses.replace(c.moe, **moe_changes))
        cfgs.append(c)
    return cfgs


# ------------------------------------------------------------- gmm ------

def test_gmm_registry_example_matches_reference():
    op = R.get_op("gmm")
    operands, params = op.example_inputs(jax.random.PRNGKey(0))
    with ctx.target("generic"):
        want = op.ref_call(operands, params)
    got = gmm_ops.gmm(*(_t(a) for a in operands))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **op.tol)
    assert gmm_ops.TOL == op.tol
    # the example masks rows: expert 0 holds none, expert 3 all 63
    assert not got[0].any() and got[3, :63].abs().sum() > 0


@pytest.mark.parametrize("sizes", [(0, 0, 0), (24, 24, 24), (0, 24, 7),
                                   (1, 23, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_masked_rows_and_empty_groups(sizes, dtype):
    """Sizes of 0 (every row zeroed) and C (none), and between."""
    lhs, rhs = _rand((3, 24, 40), 0), _rand((3, 40, 16), 1)
    gs = np.array(sizes, np.int32)
    jdt = jnp.dtype(dtype)
    with ctx.target("generic"):
        want = jgmm(jnp.asarray(lhs, jdt), jnp.asarray(rhs, jdt),
                    jnp.asarray(gs))
    tdt = getattr(torch, dtype)
    got = gmm_ops.gmm(_t(lhs).to(tdt), _t(rhs).to(tdt), _t(gs))
    assert got.dtype == tdt
    tol = gmm_ops.TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    for e, n in enumerate(sizes):
        assert not got[e, n:].any()


def test_gmm_tuning_rows_and_the_decode_tile():
    assert [tuning.block_size("gmm", p) for p in
            ("block_c", "block_n", "block_k")] == [64, 128, 32]
    assert gmm_kern.block_c_for(8) == 8 and gmm_kern.block_c_for(1) == 8
    assert gmm_kern.block_c_for(16) == 64 and gmm_kern.block_c_for(184) == 64


def test_gmm_launcher_refuses_what_it_cannot_take():
    lhs, rhs = torch.zeros(2, 8, 64), torch.zeros(2, 64, 32)
    gs = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        gmm_kern.gmm_fwd(lhs, rhs, gs)
    with pytest.raises(ValueError, match="int32"):
        gmm_kern.gmm_fwd(lhs, rhs, gs.long())
    with pytest.raises(ValueError, match="multiples"):
        gmm_kern.gmm_fwd(torch.zeros(2, 8, 66), torch.zeros(2, 66, 32), gs)
    with pytest.raises(ValueError, match="want lhs"):
        gmm_kern.gmm_fwd(lhs, torch.zeros(2, 32, 64), gs)
    assert gmm_kern.KERNEL.launches == 0
    assert gmm_kern.KERNEL in build.KERNELS


# ---------------------------------------------------------- routing -----

@pytest.mark.parametrize("tokens,k,cf", [(8, 6, 1.25), (1533, 6, 1.25),
                                         (7, 2, 2.0), (300, 2, 0.25)])
def test_capacity_matches_reference(tokens, k, cf):
    for e in (8, 64):
        assert pmoe._capacity(tokens, e, k, cf) == \
            jmoe._capacity(tokens, e, k, cf)


@pytest.mark.parametrize("seed,t,e,k,c", [(0, 40, 8, 2, 8), (1, 97, 8, 2, 16),
                                          (2, 64, 64, 6, 8), (3, 5, 4, 3, 8)])
def test_positions_and_dests_match_reference(seed, t, e, k, c):
    """Slot-major queue ranks and sentinel destinations, on routings
    skewed towards a few experts so queues overflow the capacity."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(e, 0.3))
    idx = np.stack([rng.choice(e, size=k, replace=False, p=p)
                    for _ in range(t)]).astype(np.int32)
    jpos, jcounts = jmoe._positions(jnp.asarray(idx), e)
    ppos, pcounts = pmoe._positions(_t(idx).long(), e)
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(pcounts.numpy(), np.asarray(jcounts))
    jdest, jkeep, jn = jmoe._dests(jnp.asarray(idx), jpos, c, e)
    pdest, pkeep, pn = pmoe._dests(_t(idx).long(), ppos, c, e)
    assert pn == jn == e * c
    np.testing.assert_array_equal(pdest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(pkeep.numpy(), np.asarray(jkeep))
    assert (~pkeep).any() or seed == 3        # the skew drops some


def test_route_matches_reference():
    x, w = _rand((33, 64), 0), _rand((64, 8), 1)
    _, _, jgates, jidx = jmoe._route(jnp.asarray(w), jnp.asarray(x), 2)
    pgates, pidx = pmoe._route(_t(w), _t(x), 2)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pgates.numpy(), np.asarray(jgates), **F32)
    np.testing.assert_allclose(pgates.sum(-1).numpy(), 1.0, atol=1e-6)


# ------------------------------------------------------------ layer -----

def _moe_params(jcfg, seed=0):
    """The reference's init of one MoE layer, and the port's copy."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)

    def conv(t):
        return ({k: conv(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.from_numpy(np.array(t, np.float32)))
    return jp, conv(tree)


@pytest.mark.parametrize("changes,b,s", [
    ({}, 2, 9),                                    # shared experts
    (dict(dense_residual=True), 2, 9),             # arctic's residual MLP
    (dict(capacity_factor=0.25), 3, 17),           # assignments drop
    ({}, 8, 1)])                                   # a decode batch
def test_apply_moe_matches_reference(changes, b, s):
    jcfg, pcfg = _configs(**changes)
    jp, pp = _moe_params(jcfg)
    x = _rand((b, s, jcfg.d_model), 3)
    with ctx.target("generic"):
        want, _ = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    drops = pmoe.count_drops("cpu")
    try:
        got = pmoe.apply_moe(pp, _t(x), pcfg)
    finally:
        pmoe.stop_counting_drops()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    m = pcfg.moe
    c = pmoe._capacity(b * s, m.num_experts, m.top_k, m.capacity_factor)
    gates, idx = pmoe._route(pp["router"], _t(x).reshape(b * s, -1), m.top_k)
    pos, _ = pmoe._positions(idx, m.num_experts)
    assert int(drops) == int((pos >= c).sum())
    assert (int(drops) > 0) == ("capacity_factor" in changes)


def test_apply_moe_plain_is_the_same_function():
    _, pcfg = _configs()
    _, pp = _moe_params(_configs()[0])
    x = _t(_rand((2, 5, pcfg.d_model), 4))
    torch.testing.assert_close(pmoe.apply_moe(pp, x, pcfg, plain=True),
                               pmoe.apply_moe(pp, x, pcfg), atol=0, rtol=0)


def test_init_moe_draws_the_reference_laws():
    cfg = dataclasses.replace(
        port_smoke_config(ARCH), d_model=256,
        moe=dataclasses.replace(port_smoke_config(ARCH).moe, d_ff_expert=512))
    p = pmoe.init_moe(torch.Generator().manual_seed(0), cfg,
                      dtype=torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["we_gate"].shape == (8, 256, 512)
    assert p["we_down"].shape == (8, 512, 256)
    for w, fan_in in ((p["router"], 256), (p["we_up"], 256),
                      (p["we_down"], 512)):
        assert abs(w.float().std().item() * fan_in ** 0.5 - 1.0) < 0.05
    assert set(p["shared"]) == {"w_gate", "w_up", "w_down"}
