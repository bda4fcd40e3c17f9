"""The SPEC ACCEL stand-ins B12-B17 of the port on the CPU, against the
reference's (``benchmarks/spec_accel.py``).

The same inputs, drawn with numpy from a seed in the distributions of
the reference's ``_inputs``, go through the JAX function bound to
``NativeRuntime`` and to ``runtime()`` under ``target("generic")``, and
through the port's public function on the CPU, which takes the plain
version (``bench/spec_accel_ref.py``); at the reference's shapes and at
another legal shape each.  The tolerances are ``bench/spec_accel.py``'s
``tolerance``, derived there.  Then the launchers' refusals, the pep
hash on the whole int32 range, pcg's operator (the reference's, not
symmetric) and pbt's sweeps against dense float64 algebra, the bench's
refusal without a card, and
the stand-in sources: written against the runtime facade, reaching it
only through the ``REPRO_RT_NATIVE`` switch.  The kernels run on the
card only (``tests/test_torch_gpu.py``, ``python -m
repro_torch.bench.spec_accel``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import spec_accel as jsa
from benchmarks.native_rt import NativeRuntime
from repro.core import context as jctx
from repro.core.runtime import runtime as jruntime
from repro_torch.bench import spec_accel as sa
from repro_torch.bench import spec_accel_ref as ref
from repro_torch.bench import timing
from repro_torch.core import build

JAX_FNS = {"503.postencil": jsa.postencil, "504.polbm": jsa.polbm,
           "514.pomriq": jsa.pomriq, "552.pep": jsa.pep, "554.pcg": jsa.pcg,
           "570.pbt": jsa.pbt}
SOURCES = ("postencil.cu", "polbm.cu", "pomriq.cu", "pep.cu", "pcg.cu",
           "pbt.cu")
#: the sources that stage nothing in the shared arena
NO_ARENA = ("pep.cu", "pcg.cu")


@pytest.fixture(autouse=True, scope="module")
def _first_calls_of_the_cpu_math():
    """The first parallel call of ``torch.cos`` or ``torch.log`` in a
    process can return values off by ~1e-4 on the CPU build of torch (a
    first-call race of its math library, shown with torch alone: warm
    the intra-op pool, then two ``torch.cos`` of the same 65,536 values
    differ in about 1 process of 16, ``torch.log`` likewise; every later
    call agrees).  These tests hold the transcription, so that call is
    made here, once, before them."""
    x = torch.linspace(-80.0, 80.0, 1 << 17)
    torch.cos(x)
    torch.log(x.abs() + 1.0)


def _jax(name, rt_name, arrays):
    """The reference's stand-in on ``arrays``, bound to NativeRuntime
    or to runtime() under target("generic")."""
    args = [jnp.asarray(a) for a in arrays]
    if rt_name == "native":
        return np.asarray(jax.jit(functools.partial(
            JAX_FNS[name], NativeRuntime()))(*args))
    with jctx.target("generic"):
        return np.asarray(jax.jit(functools.partial(
            JAX_FNS[name], jruntime()))(*args))


@pytest.mark.parametrize("rt_name", ["native", "generic"])
@pytest.mark.parametrize("label", ["reference", "small"])
@pytest.mark.parametrize("name", ref.NAMES)
def test_cpu_path_matches_the_reference(name, label, rt_name):
    arrays = ref.inputs(name, label, seed=3)
    want = _jax(name, rt_name, arrays)
    args = tuple(torch.from_numpy(a) for a in arrays)
    portable, native = sa.TWINS[name]
    before = (portable.launches, native.launches)
    fn = sa.FUNCS[name][0]
    got, got_native = fn(*args), fn(*args, native=True)
    assert (portable.launches, native.launches) == before  # plain version
    assert torch.equal(got_native, got)
    atol, rtol = sa.tolerance(name, args, got)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)


def test_pep_hash_on_the_whole_int32_range():
    """Seeds past 2^31 (negative int32) and the extremes: the port's
    int64 arithmetic mod 2^32 equals numpy's uint32, and pep equals the
    reference on them."""
    rng = np.random.default_rng(5)
    seeds = rng.integers(-2 ** 31, 2 ** 31, 1024, dtype=np.int64)
    seeds[:4] = (-2 ** 31, -1, 0, 2 ** 31 - 1)
    seeds = seeds.astype(np.int32)
    a, b = ref.pep_hash(torch.from_numpy(seeds))
    s = seeds.astype(np.uint32)
    with np.errstate(over="ignore"):
        wa = s * np.uint32(1664525) + np.uint32(1013904223)
        wb = (wa ^ (wa >> np.uint32(16))) * np.uint32(2246822519)
    assert np.array_equal(a.numpy(), wa.astype(np.int64))
    assert np.array_equal(b.numpy(), wb.astype(np.int64))
    got = sa.pep(torch.from_numpy(seeds))
    atol, rtol = sa.tolerance("552.pep", (), got)
    np.testing.assert_allclose(got.numpy(), _jax("552.pep", "native",
                                                 (seeds,)),
                               atol=atol, rtol=rtol)


def test_pep_seeds_at_the_ends_of_the_uniforms():
    """The seeds whose hash gives u1 = 1 - 2^-24, u1 = 1, u1 = 2^-32 and
    u2 = 1, 1/2, just past 1/2, 2^-32 (``pep_unhash``): the hash gives
    them back, and pep's block of them is finite and the reference's."""
    seeds = ref.pep_edge_block(7)
    a, b = ref.pep_hash(torch.from_numpy(seeds))
    assert set(ref.PEP_EDGE_A) <= set(a.tolist())
    assert set(ref.PEP_EDGE_B) <= set(b.tolist())
    u1 = (a.to(torch.float32) + 1.0) / 4294967296.0
    u2 = (b.to(torch.float32) + 1.0) / 4294967296.0
    for u, ends in ((u1, (1 - 2 ** -24, 1.0, 2 ** -32)),
                    (u2, (1.0, 0.5, 0.5 + 2 ** -24, 2 ** -32))):
        assert all(bool((u == e).any()) for e in ends), ends
    got = sa.pep(torch.from_numpy(seeds))
    assert bool(torch.isfinite(got).all())
    assert float(got[0, 2]) == pytest.approx(6.6604, abs=1e-4)  # r at 2^-32
    atol, rtol = sa.tolerance("552.pep", (), got)
    np.testing.assert_allclose(got.numpy(), _jax("552.pep", "native",
                                                 (seeds,)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("w", [1, 2, 3, 5, 130])
def test_polbm_matches_the_reference_at_any_width(w):
    """Widths that are not whole 16-byte vectors of cells, or narrower
    than the halo (w 1 and 2 wrap onto themselves): the port's polbm
    against the reference's under NativeRuntime."""
    f = np.random.default_rng(w).random((64, w, 9), dtype=np.float32) + 0.5
    got = sa.polbm(torch.from_numpy(f))
    atol, rtol = sa.tolerance("504.polbm", (), got)
    np.testing.assert_allclose(got.numpy(), _jax("504.polbm", "native", (f,)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("w", [1, 3, 130])
def test_polbm_streams_every_plane_of_a_lattice_at_rest(w):
    """A lattice at rest collides to itself, so plane k of the output is
    plane k of the input moved by (cx_k, cy_k), wrapping at every edge."""
    f = torch.from_numpy(ref.polbm_rest_lattice(64, w))
    out = sa.polbm(f)
    for k, (cx, cy) in enumerate(ref.D2Q9):
        torch.testing.assert_close(
            out[..., k], torch.roll(f[..., k], (int(cx), int(cy)), (0, 1)),
            atol=1e-6, rtol=0)


def test_postencil_border_is_zero_and_sweeps_count():
    """One sweep of a single 1 in the corner: the border adds nothing
    (not periodic, not clamped); iters=0 is the input."""
    x = torch.zeros(64, 8)
    x[0, 0] = 1.0
    y = sa.postencil(x, 1)
    assert y[0, 0] == y[1, 0] == y[0, 1] == torch.tensor(0.2)
    assert float(y.sum()) == pytest.approx(0.6)
    assert y[63, 0] == 0 and y[0, 7] == 0         # periodic would not be
    assert sa.postencil(x, 0) is x


def test_polbm_streams_periodically_along_each_velocity():
    """A lattice at rest (every cell the weights, rho 1) collides to
    itself; a bump in one cell moves plane k by (cx_k, cy_k), wrapping."""
    f = torch.from_numpy(np.broadcast_to(ref.W9, (64, 4, 9)).copy())
    torch.testing.assert_close(sa.polbm(f), f, atol=1e-7, rtol=0)
    f[0, 0] *= 2.0                     # rho 2 at rest: still feq = f
    out = sa.polbm(f)
    for k, (cx, cy) in enumerate(ref.D2Q9):
        torch.testing.assert_close(out[cx % 64, cy % 4, k], f[0, 0, k],
                                   atol=1e-7, rtol=0)


def _tridiagonal(lower, diag, upper):
    """The dense float64 matrix with ``diag`` on the diagonal, row i's
    ``lower[i]`` left of it and ``upper[i]`` right of it."""
    n = diag.shape[0]
    a = np.diag(diag.astype(np.float64))
    a[np.arange(1, n), np.arange(n - 1)] = lower[1:]
    a[np.arange(n - 1), np.arange(1, n)] = upper[:-1]
    return a


def test_pcg_operator_is_the_references_and_not_symmetric():
    """pcg's SpMV applies the matrix whose row i is diag_i on the
    diagonal and off_i on both sides, so A[i, i+1] = off_i but A[i+1, i]
    = off_{i+1}: the reference's operator, not symmetrised.  CG's 8
    iterations still leave a small residual on the reference's inputs."""
    diag, off, b = ref.inputs("554.pcg", "small", seed=4)
    a = _tridiagonal(off, diag, off)
    assert a[0, 1] == off[0] and a[1, 0] == off[1] and off[0] != off[1]
    assert not np.allclose(a, a.T)
    x = np.random.default_rng(4).standard_normal(diag.shape[0])
    got = sa.pcg_spmv(*map(torch.from_numpy, (diag, off)),
                      torch.from_numpy(x.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), a @ x.astype(np.float32),
                               atol=1e-6, rtol=1e-6)
    sol = sa.pcg(*map(torch.from_numpy, (diag, off, b))).double().numpy()
    assert np.linalg.norm(a @ sol - b) < 1e-3 * np.linalg.norm(b)
    assert sa.pcg(*map(torch.from_numpy, (diag, off, b)), 0).abs().max() == 0


def test_pbt_sweeps_solve_each_system():
    """Each row of x solves its tridiagonal system, and cp, dp are the
    forward sweep's: x_{n-1} = dp_{n-1}, x_i = dp_i - cp_i x_{i+1}."""
    lo, di, up, rh = ref.inputs("570.pbt", "small", seed=6)
    x, cp, dp = sa.pbt_sweeps(*map(torch.from_numpy, (lo, di, up, rh)))
    for k in range(rh.shape[0]):
        a = _tridiagonal(lo[k], di[k], up[k])
        np.testing.assert_allclose(x[k].double().numpy(),
                                   np.linalg.solve(a, rh[k]), atol=1e-5)
    np.testing.assert_allclose(cp[:, 0], up[:, 0] / di[:, 0], rtol=1e-7)
    assert torch.equal(x[:, -1], dp[:, -1])
    torch.testing.assert_close(x[:, :-1], dp[:, :-1] - cp[:, :-1] * x[:, 1:],
                               atol=1e-6, rtol=0)
    assert torch.equal(sa.pbt(*map(torch.from_numpy, (lo, di, up, rh))), x)


@pytest.mark.parametrize("call,match", [
    (lambda: sa.postencil(torch.zeros(100, 64)), "multiple of 64"),
    (lambda: sa.postencil(torch.zeros(64, 64, dtype=torch.float64)),
     "float32"),
    (lambda: sa.postencil(torch.zeros(64, 64), -1), "iters"),
    (lambda: sa.polbm(torch.zeros(64, 64, 8)), r"\(h, w, 9\)"),
    (lambda: sa.polbm(torch.zeros(32, 64, 9)), "multiple of 64"),
    (lambda: sa.pomriq(torch.zeros(100, 3), torch.zeros(128, 3),
                       torch.zeros(128)), "multiples of 128"),
    (lambda: sa.pomriq(torch.zeros(128, 3), torch.zeros(100, 3),
                       torch.zeros(100)), "multiples of 128"),
    (lambda: sa.pomriq(torch.zeros(128, 3), torch.zeros(128, 3),
                       torch.zeros(64)), r"phi \(nk,\)"),
    (lambda: sa.pep(torch.arange(100, dtype=torch.int32)), "multiple of 256"),
    (lambda: sa.pep(torch.arange(256)), "int32"),
    (lambda: sa.pcg(torch.ones(8), torch.ones(8), torch.ones(9)), r"\(n,\)"),
    (lambda: sa.pcg(torch.ones(0), torch.ones(0), torch.ones(0)), "n >= 1"),
    (lambda: sa.pcg(torch.ones(8, 1), torch.ones(8, 1), torch.ones(8, 1)),
     r"\(n,\)"),
    (lambda: sa.pcg(*(torch.ones(8, dtype=torch.float64),) * 3), "float32"),
    (lambda: sa.pcg(torch.ones(8), torch.ones(8), torch.ones(8), -1),
     "iters"),
    (lambda: sa.pcg_spmv(torch.ones(8), torch.ones(7), torch.ones(8)),
     r"\(n,\)"),
    (lambda: sa.pbt(*(torch.ones(4, 8),) * 3, torch.ones(4, 9)),
     "one shape"),
    (lambda: sa.pbt(*(torch.ones(8),) * 4), r"\(nb, n\)"),
    (lambda: sa.pbt(*(torch.ones(0, 8),) * 4), "nb, n >= 1"),
    (lambda: sa.pbt(*(torch.ones(4, 8, dtype=torch.float64),) * 4),
     "float32"),
], ids=["postencil_h", "postencil_dtype", "postencil_iters", "polbm_q",
        "polbm_h", "pomriq_nx", "pomriq_nk", "pomriq_phi", "pep_n",
        "pep_dtype", "pcg_n", "pcg_empty", "pcg_rank", "pcg_dtype",
        "pcg_iters", "pcg_spmv_n", "pbt_shape", "pbt_rank", "pbt_empty",
        "pbt_dtype"])
def test_launchers_refuse_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_bench_runs_on_the_card_only(monkeypatch):
    with pytest.raises(ValueError, match="CUDA card"):
        sa.run("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sa.run("cuda")
    assert sa.main() == 1


def test_cost_counts_the_bound_of_one_launch():
    """The bounds of the card shapes, from the code's bytes and
    operations: postencil 8192^2 reads and writes 256 MiB a sweep; pcg's
    SpMV at 2^24 moves 268 MB, pbt at (65536, 512) 0.94 GB."""
    card = {name: tuple(torch.empty(s, device="meta") for s in shapes)
            for name, shapes in (
                ("503.postencil", [(8192, 8192)]),
                ("504.polbm", [(2048, 2048, 9)]),
                ("514.pomriq", [(262144, 3), (2048, 3), (2048,)]),
                ("552.pep", [(1 << 26,)]),
                ("554.pcg", [(1 << 24,)] * 3),
                ("570.pbt", [(65536, 512)] * 4))}
    got = {name: sa.cost(name, args) for name, args in card.items()}
    assert got["503.postencil"]["bytes"] == 2 * 256 * 2 ** 20
    assert got["503.postencil"]["bound_ms"] == pytest.approx(0.1602, 1e-3)
    assert got["504.polbm"]["bound_ms"] == pytest.approx(0.0901, 1e-3)
    assert got["552.pep"]["bound_by"] == "bytes"
    assert got["552.pep"]["bound_ms"] == pytest.approx(0.0814, 1e-3)
    # two conversions, a log, a sqrt and a cos a seed at 16 a clock per SM
    assert got["552.pep"]["ops"] == 5 << 26
    assert got["552.pep"]["unit"] == "G special-function ops"
    assert got["514.pomriq"]["bound_by"] == "operations"
    assert got["514.pomriq"]["ops"] == 262144 * 2048
    assert got["554.pcg"]["bytes"] == 16 << 24
    assert got["554.pcg"]["bound_ms"] == pytest.approx(0.0801, 1e-3)
    assert got["570.pbt"]["bytes"] == 28 * 65536 * 512
    assert got["570.pbt"]["bound_by"] == "bytes"
    assert got["570.pbt"]["bound_ms"] == pytest.approx(0.2805, 1e-3)


def test_turns_alternate_their_order():
    assert timing.turn_order(4, 0) == [0, 1, 2, 3]
    assert timing.turn_order(4, 1) == [3, 2, 1, 0]
    assert timing.turn_order(4, 2) == [0, 1, 2, 3]


def _code(path):
    """A CUDA source without its comments."""
    return "\n".join(line.split("//")[0]
                     for line in path.read_text().splitlines())


def test_stand_ins_reach_the_runtime_only_through_the_switch():
    switch = ('#if defined(REPRO_RT_NATIVE)\n#include "native/rt_native.cuh"'
              '\n#else\n#include "rt/runtime.cuh"\n#endif')
    for name in SOURCES:
        code = _code(build.CSRC / "spec_accel" / name)
        assert switch in code, name
        assert code.count("#include") == 3, name      # common.cuh too
        assert ("rt::Arena" in code) != (name in NO_ARENA), name
        for direct in ("blockIdx", "threadIdx", "__shared__", "__shfl",
                       "__syncthreads", "__cosf", "__logf"):
            assert direct not in code, (name, direct)
    for portable, native in sa.TWINS.values():
        assert portable.source == native.source
        assert native.flags == (sa.NATIVE_DEFINE,) and portable.flags == ()


def test_native_binding_hard_codes_cuda():
    code = _code(build.CSRC / "native" / "rt_native.cuh")
    assert "#include \"rt/" not in code and "#if" not in code
    for direct in ("blockIdx", "gridDim", "__syncthreads", "extern __shared__",
                   "__shfl_xor_sync"):
        assert direct in code, direct
    for member in ("team_id", "num_teams", "thread_id", "barrier",
                   "class Arena", "warp_reduce_sum", "warp_reduce_max",
                   "reduce_scratch", "reduce_sum", "reduce_max"):
        assert member in code, member
