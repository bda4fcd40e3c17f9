"""miniQMC's two hot regions B18-B19 of the port on the CPU, against the
reference's (``benchmarks/miniqmc.py``, paper Table 1).

The same inputs, drawn with numpy from a seed in the distributions of
the reference's ``run``, go through the JAX function bound to
``NativeRuntime`` and to ``runtime()`` under ``target("generic")``, and
through the port's public function on the CPU, which takes the plain
version (``bench/miniqmc_ref.py``); at the reference's shapes and at
another legal shape each.  The tolerances are ``bench/miniqmc.py``'s
``tolerance``, derived there.  Then the basis against its closed form,
the launchers' refusals, the bounds of the card shapes, the bench's
refusal without a card, and the sources: written against the runtime
facade, reaching it only through the ``REPRO_RT_NATIVE`` switch.  The
kernels run on the card only (``tests/test_torch_gpu.py``, ``python -m
repro_torch.bench.miniqmc``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import miniqmc as jmq
from benchmarks.native_rt import NativeRuntime
from repro.core import context as jctx
from repro.core.runtime import runtime as jruntime
from repro_torch.bench import miniqmc as mq
from repro_torch.bench import miniqmc_ref as ref
from repro_torch.core import build

JAX_FNS = {"evaluate_vgh": jmq.evaluate_vgh,
           "evaluateDetRatios": jmq.evaluate_det_ratios}
SOURCES = ("evaluate_vgh.cu", "evaluate_det_ratios.cu")


def _jax(name, rt_name, arrays):
    """The reference's region on ``arrays``, bound to NativeRuntime or
    to runtime() under target("generic"), as a tuple of numpy arrays."""
    args = [jnp.asarray(a) for a in arrays]
    if rt_name == "native":
        out = jax.jit(functools.partial(JAX_FNS[name], NativeRuntime()))(
            *args)
    else:
        with jctx.target("generic"):
            out = jax.jit(functools.partial(JAX_FNS[name], jruntime()))(
                *args)
    return tuple(np.asarray(o) for o in (out if isinstance(out, tuple)
                                         else (out,)))


@pytest.mark.parametrize("rt_name", ["native", "generic"])
@pytest.mark.parametrize("label", ["reference", "small"])
@pytest.mark.parametrize("name", ref.NAMES)
def test_cpu_path_matches_the_reference(name, label, rt_name):
    arrays = ref.inputs(name, label, seed=3)
    want = _jax(name, rt_name, arrays)
    args = tuple(torch.from_numpy(a) for a in arrays)
    portable, native = mq.TWINS[name]
    before = (portable.launches, native.launches)
    fn = mq.FUNCS[name][0]
    got, got_native = fn(*args), fn(*args, native=True)
    assert (portable.launches, native.launches) == before  # plain version
    got = got if isinstance(got, tuple) else (got,)
    got_native = got_native if isinstance(got_native, tuple) else (
        got_native,)
    assert len(got) == len(want) == (3 if name == "evaluate_vgh" else 1)
    atol, rtol = mq.tolerance(name, args, got)
    for g, gn, w in zip(got, got_native, want):
        assert torch.equal(gn, g)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=rtol)


def test_basis_is_the_cubic_b_spline_and_its_derivatives():
    """The value weights sum to 1, the gradient's to 0 and the
    hessian's to 0; each gradient weight is the derivative of its value
    weight and each hessian weight that of its gradient weight (central
    differences in float64)."""
    t = torch.linspace(0.05, 0.95, 19, dtype=torch.float64)[:, None]
    w = ref.basis(t)
    torch.testing.assert_close(w.sum(dim=2), torch.tensor(
        [1.0, 0.0, 0.0], dtype=torch.float64).expand(19, 3),
        atol=1e-12, rtol=0)
    eps = 1e-6
    dw = (ref.basis(t + eps) - ref.basis(t - eps)) / (2 * eps)
    torch.testing.assert_close(dw[:, 0], w[:, 1], atol=1e-8, rtol=0)
    torch.testing.assert_close(dw[:, 1], w[:, 2], atol=1e-8, rtol=0)


def test_det_ratios_are_each_walkers_row_times_its_matrix():
    a_inv, phi = ref.inputs("evaluateDetRatios", "small", seed=2)
    got = mq.evaluate_det_ratios(torch.from_numpy(a_inv),
                                 torch.from_numpy(phi))
    want = np.einsum("wi,wij->wj", phi.astype(np.float64),
                     a_inv.astype(np.float64))
    atol, _ = mq.tolerance("evaluateDetRatios",
                           (torch.from_numpy(a_inv), torch.from_numpy(phi)),
                           got)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("call,match", [
    (lambda: mq.evaluate_vgh(torch.zeros(8, 3, 16), torch.zeros(8, 1)),
     r"\(NW, 4, NS\)"),
    (lambda: mq.evaluate_vgh(torch.zeros(8, 4, 16), torch.zeros(8)),
     r"t \(NW, 1\)"),
    (lambda: mq.evaluate_vgh(torch.zeros(12, 4, 16), torch.zeros(12, 1)),
     "multiple of it"),
    (lambda: mq.evaluate_vgh(torch.zeros(0, 4, 16), torch.zeros(0, 1)),
     "NW, NS >= 1"),
    (lambda: mq.evaluate_vgh(torch.zeros(8, 4, 16, dtype=torch.float64),
                             torch.zeros(8, 1, dtype=torch.float64)),
     "float32"),
    (lambda: mq.evaluate_det_ratios(torch.zeros(4, 8, 9), torch.zeros(4, 8)),
     r"\(NW, N, N\)"),
    (lambda: mq.evaluate_det_ratios(torch.zeros(4, 8, 8), torch.zeros(3, 8)),
     r"phi \(NW, N\)"),
    (lambda: mq.evaluate_det_ratios(torch.zeros(1, 1, 1)
                                    .expand(1, 12289, 12289),
                                    torch.zeros(1, 12289)),
     "at most 12288"),
    (lambda: mq.evaluate_det_ratios(torch.zeros(4, 8, 8, dtype=torch.int32),
                                    torch.zeros(4, 8, dtype=torch.int32)),
     "float32"),
], ids=["vgh_taps", "vgh_t", "vgh_block", "vgh_empty", "vgh_dtype",
        "det_square", "det_phi", "det_n", "det_dtype"])
def test_launchers_refuse_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_walkers_below_a_block_are_one_block():
    """NW below 8 is one block of NW walkers, as the reference's
    min(8, NW)."""
    coefs4, t = ref.inputs("evaluate_vgh", "small", seed=1)
    out = mq.evaluate_vgh(torch.from_numpy(coefs4[:5]),
                          torch.from_numpy(t[:5]))
    assert [o.shape for o in out] == [(5, 200)] * 3


def test_cost_counts_the_bound_of_one_launch():
    """The bounds of the card shapes, from the code's bytes and
    operations: vgh at (512, 4, 16384) moves 235 MB, the det ratios at
    (256, 1024, 1024) read 1.07 GB of A_inv."""
    vgh = mq.cost("evaluate_vgh", (torch.empty(512, 4, 16384, device="meta"),
                                   torch.empty(512, 1, device="meta")))
    det = mq.cost("evaluateDetRatios",
                  (torch.empty(256, 1024, 1024, device="meta"),
                   torch.empty(256, 1024, device="meta")))
    assert vgh["bytes"] == 28 * 512 * 16384 + 4 * 512
    assert vgh["bound_by"] == "bytes"
    assert vgh["bound_ms"] == pytest.approx(0.0701, 1e-3)
    assert det["bytes"] == 4 * (256 << 20) + 8 * 256 * 1024
    assert det["bound_by"] == "bytes"
    assert det["bound_ms"] == pytest.approx(0.3211, 1e-3)
    assert det["ops"] == 2 * 256 * 1024 * 1024


def test_table1_columns():
    got = mq.table1([0.5, 0.25, 1.0, 0.25])
    assert got == {"time_ms": 2.0, "calls": 4, "avg_us": 500.0,
                   "min_us": 250.0, "max_us": 1000.0}


def test_library_calls_compute_the_same_function():
    """The yardsticks, on the CPU: vgh's one bmm of the weights with the
    taps, the det ratios' bmm of phi with A_inv."""
    for name in ref.NAMES:
        args = tuple(map(torch.from_numpy, ref.inputs(name, "small")))
        want = mq.FUNCS[name][1](*args)
        got = mq.library(name, args)()
        got = got.unbind(1) if name == "evaluate_vgh" else (got[:, 0],)
        atol, _ = mq.tolerance(name, args, want)
        for g, w in zip(got, want if isinstance(want, tuple) else (want,)):
            torch.testing.assert_close(g, w, atol=atol, rtol=0)


def test_bench_runs_on_the_card_only(monkeypatch):
    with pytest.raises(ValueError, match="CUDA card"):
        mq.run("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mq.run("cuda")
    assert mq.main() == 1


def _code(path):
    """A CUDA source without its comments."""
    return "\n".join(line.split("//")[0]
                     for line in path.read_text().splitlines())


def test_regions_reach_the_runtime_only_through_the_switch():
    switch = ('#if defined(REPRO_RT_NATIVE)\n#include "native/rt_native.cuh"'
              '\n#else\n#include "rt/runtime.cuh"\n#endif')
    for name in SOURCES:
        code = _code(build.CSRC / "miniqmc" / name)
        assert switch in code, name
        assert code.count("#include") == 3, name      # common.cuh too
        assert "rt::team_id" in code, name
        for direct in ("blockIdx", "threadIdx", "__shared__", "__shfl",
                       "__syncthreads", "__fdividef", "cublas", "wmma"):
            assert direct not in code, (name, direct)
    assert "rt::Arena" in _code(build.CSRC / "miniqmc" / SOURCES[1])
    for portable, native in mq.TWINS.values():
        assert portable.source == native.source
        assert portable.source.parent.name == "miniqmc"
        assert native.flags == ("-DREPRO_RT_NATIVE",) and portable.flags == ()
        assert native.name == f"{portable.name}_native"
