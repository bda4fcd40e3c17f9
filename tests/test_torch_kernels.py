"""The port's kernels on the serving path (rmsnorm, flash prefill,
dense decode, paged decode, sliding-window paged decode and its
quantized mode, the selective scan, the mLSTM scan).

On the CPU: each public op (which takes the plain PyTorch version for a
CPU tensor) against the JAX op's reference under ``target("generic")``,
on the op's registered example inputs and on edge cases, with the JAX
op's own ``tol``; the index helpers the launchers share with these
tests; the launchers' refusals.  The kernels themselves run only on the card:
tests/test_torch_gpu.py holds them against their plain versions there.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import context as ctx
from repro.kernels import registry as R
from repro.kernels.decode_attention import paged as jpaged
from repro.kernels.decode_attention import ref as jdec_ref
from repro.kernels.flash_attention import ref as jflash_ref
from repro_torch.core import build, selftest, tuning  # noqa: F401
from repro_torch.core.context import target
from repro_torch.kernels.decode_attention import decode_attention as dec_kern
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import paged as paged_kern
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import flash_attention as fa_kern
from repro_torch.kernels.flash_attention import native as fa_native  # noqa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.gmm import ops as gmm_ops  # noqa: F401  (registers B8)
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.kernels.rmsnorm import native as rms_native  # noqa: F401
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import rmsnorm as rms_kern


def _t(x):
    """JAX or numpy array -> CPU torch tensor (int32 kept)."""
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **tol)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------- registry examples (CPU) ------

_PORT_OPS = {
    "rmsnorm": lambda x, w, **p: rms_ops.rmsnorm(
        x, w, eps=p["eps"], weight_offset=p["weight_offset"]),
    "flash_attention": lambda q, k, v, **p: fa_ops.flash_attention(
        q, k, v, causal=p["causal"], window=p["window"],
        softcap=p["softcap"], scale=p["scale"], q_offset=p["q_offset"]),
    "decode_attention": lambda q, k, v, ln, **p: dec_ops.decode_attention(
        q, k, v, ln, window=p["window"], softcap=p["softcap"],
        scale=p["scale"], return_residuals=True),
    "paged_decode_attention":
        lambda q, k, v, bt, ln, **p: dec_ops.paged_decode_attention(
            q, k, v, bt, ln, window=p["window"], softcap=p["softcap"],
            scale=p["scale"], page_size=p["page_size"],
            return_residuals=True),
    "window_paged_decode_attention":
        lambda q, k, v, bt, ln, **p: dec_ops.window_paged_decode_attention(
            q, k, v, bt, ln, window=p["window"], softcap=p["softcap"],
            scale=p["scale"], page_size=p["page_size"],
            return_residuals=True),
    "quant_window_paged_decode_attention":
        lambda q, k, v, ks, vs, bt, ln, **p:
        dec_ops.quant_window_paged_decode_attention(
            q, k, v, ks, vs, bt, ln, window=p["window"],
            softcap=p["softcap"], scale=p["scale"],
            page_size=p["page_size"], return_residuals=True),
    "mamba_scan": lambda x, dt, a, bm, cm, d, **p: scan_ops.mamba_scan(
        x, dt, a, bm, cm, d),
    "mlstm_scan": lambda q, k, v, ig, fg, **p: mlstm_ops.mlstm_scan(
        q, k, v, ig, fg),
}


@pytest.mark.parametrize("name", sorted(_PORT_OPS))
def test_registry_example_matches_reference(name):
    op = R.get_op(name)
    operands, params = op.example_inputs(jax.random.PRNGKey(0))
    with ctx.target("generic"):
        want = op.ref_call(operands, params)
    got = _PORT_OPS[name](*(_t(a) for a in operands), **params)
    _close(got, want, op.tol)
    tol = {"rmsnorm": rms_ops.TOL, "flash_attention": fa_ops.TOL,
           "mamba_scan": scan_ops.TOL,
           "mlstm_scan": mlstm_ops.TOL}.get(name, dec_ops.TOL)
    assert tol == op.tol


# -------------------------------------------------- edge cases (CPU) ------

@pytest.mark.parametrize("d,offset", [(4096, 1.0), (100, 0.0)])
def test_rmsnorm_rows_and_offset(d, offset):
    x, w = _rand((3, 5, d), 0), _rand((d,), 1) * 0.1
    want = R.get_op("rmsnorm").ref(jnp.asarray(x), jnp.asarray(w), eps=1e-6,
                                   weight_offset=offset, block_rows=None)
    got = rms_ops.rmsnorm(_t(x), _t(w), eps=1e-6, weight_offset=offset)
    _close(got, want, rms_ops.TOL)


@pytest.mark.parametrize("sq,skv,causal,window,softcap,q_offset", [
    (100, 100, True, None, None, 0),       # ragged: not a block multiple
    (37, 37, True, 16, 30.0, 0),           # window + softcap
    (8, 24, True, None, None, 16),         # static q_offset (chunk)
    (20, 33, False, None, None, 0),        # cross lengths, no mask
])
def test_flash_edge_cases(sq, skv, causal, window, softcap, q_offset):
    q = _rand((2, 4, sq, 32), 0)
    k, v = _rand((2, 2, skv, 32), 1), _rand((2, 2, skv, 32), 2)
    want = jflash_ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, softcap=softcap, q_offset=q_offset)
    got = fa_ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                 window=window, softcap=softcap,
                                 q_offset=q_offset)
    _close(got, want, fa_ops.TOL)


def test_flash_unported_variants_raise():
    """Dk != Dv (MLA) is ported: the plain version agrees with the
    reference's there; a traced q_offset is still refused."""
    q, k, v = _rand((1, 2, 4, 16), 0), _rand((1, 2, 4, 16), 1), \
        _rand((1, 2, 4, 8), 2)
    want = jflash_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=True)
    got = fa_ops.flash_attention(_t(q), _t(k), _t(v))
    assert got.shape == (1, 2, 4, 8)
    _close(got, want, fa_ops.TOL)
    with pytest.raises(NotImplementedError, match="q_offset"):
        fa_ops.flash_attention(_t(q), _t(k), _t(k), q_offset=torch.tensor(2))


def test_decode_zero_length_slot_and_window():
    """A slot of length 0 has no live key: acc 0, l 0, m = NEG_INF, and
    the normalized output is 0 (the ``l == 0`` guard)."""
    q = _rand((3, 8, 64), 0)
    kc, vc = _rand((3, 2, 40, 64), 1), _rand((3, 2, 40, 64), 2)
    lengths = np.array([0, 40, 17], np.int32)
    for window, softcap in ((None, None), (8, 20.0)):
        want = jdec_ref.decode_attention_ref(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(lengths), window=window, softcap=softcap,
            return_residuals=True)
        got = dec_ops.decode_attention(_t(q), _t(kc), _t(vc), _t(lengths),
                                       window=window, softcap=softcap,
                                       return_residuals=True)
        _close(got, want, dec_ops.TOL)
    acc, m, l = got
    assert not acc[0].any() and not l[0].any()
    assert (m[0] == dec_ref.NEG_INF).all()
    out = dec_ops.decode_attention(_t(q), _t(kc), _t(vc), _t(lengths))
    assert not out[0].any() and out.dtype == torch.float32


def _paged_case(b=3, hq=8, hkv=2, d=32, t=4, ps=16, seed=0):
    n_pages = 1 + b * t
    q = _rand((b, hq, d), seed)
    kp, vp = _rand((hkv, n_pages, ps, d), seed + 1), \
        _rand((hkv, n_pages, ps, d), seed + 2)
    bt = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    bt = bt.reshape(b, t).astype(np.int32)
    bt[1, 2:] = 0                          # null-page tail
    bt[2, 1:] = 0
    lengths = np.array([t * ps - 3, 2 * ps, 5], np.int32)
    return q, kp, vp, bt, lengths


@pytest.mark.parametrize("page_size", [None, 8, 4])
def test_paged_scrambled_table_null_tails_logical_pages(page_size):
    """Scrambled block table with null-page tails, at the physical page
    size and at logical page sizes below it: the reference's answer."""
    q, kp, vp, bt, lengths = _paged_case()
    want = jdec_ref.paged_decode_attention_ref(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, lengths)),
        return_residuals=True)
    got = dec_ops.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(bt), _t(lengths), page_size=page_size,
        return_residuals=True)
    _close(got, want, dec_ops.TOL)
    if page_size is not None:
        kl, btl = paged_kern.repage(_t(kp), _t(bt), page_size)
        vl, _ = paged_kern.repage(_t(vp), _t(bt), page_size)
        again = dec_ops.paged_decode_attention(
            _t(q), kl, vl, btl, _t(lengths), return_residuals=True)
        _close(again, want, dec_ops.TOL)


# ---------------------------------------------- shared index helpers -------

@pytest.mark.parametrize("page_size", [16, 8, 4, 1])
def test_repage_matches_reference(page_size):
    _, kp, _, bt, _ = _paged_case()
    jpool, jbt = jpaged.repage(jnp.asarray(kp), jnp.asarray(bt), page_size)
    pool, tbt = paged_kern.repage(_t(kp), _t(bt), page_size)
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tbt.numpy(), np.asarray(jbt))
    assert tbt.dtype == torch.int32
    np.testing.assert_array_equal(
        dec_ref.gather_pages(pool, tbt).numpy(),
        dec_ref.gather_pages(_t(kp), _t(bt)).numpy())


def test_repage_rejects_non_dividing_page():
    _, kp, _, bt, _ = _paged_case()
    with pytest.raises(ValueError, match="divide"):
        paged_kern.repage(_t(kp), _t(bt), 6)


def _reference_clamp(block_kv, page_size):
    """The loop at src/repro/kernels/decode_attention/paged.py:150."""
    block_kv = min(block_kv, page_size)
    while page_size % block_kv:
        block_kv -= 1
    return block_kv


@pytest.mark.parametrize("block_kv,page_size", [
    (64, 64), (64, 16), (12, 32), (7, 12), (5, 4), (64, 3), (1, 9)])
def test_block_kv_clamp_divides_page(block_kv, page_size):
    got = paged_kern.clamp_block_kv(block_kv, page_size)
    assert got == _reference_clamp(block_kv, page_size)
    assert page_size % got == 0 and 1 <= got <= block_kv


def test_tuning_table():
    assert tuning.block_size("paged_decode_attention", "page_size") == 64
    assert tuning.block_size("flash_attention", "block_q") == 64
    with pytest.raises(KeyError, match="no tuning entry"):
        tuning.block_size("gmm", "block_m")


# ------------------------------------------------- launcher refusals -------

def test_kernel_launchers_refuse_cpu_tensors():
    """A kernel launcher checks its operands before it builds or
    launches anything: a CPU tensor is refused, never computed."""
    q = torch.zeros(1, 4, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kern.flash_attention_fwd(q, q[:, :2], q[:, :2], causal=True,
                                    window=None, softcap=None, scale=None,
                                    q_offset=0)
    with pytest.raises(ValueError, match="CUDA"):
        rms_kern.rmsnorm_fwd(torch.zeros(4, 64), torch.zeros(64), eps=1e-6,
                             weight_offset=1.0)
    qd = torch.zeros(2, 4, 64)
    cache = torch.zeros(2, 2, 16, 64)
    ln = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        dec_kern.decode_attention_fwd(qd, cache, cache, ln, window=None,
                                      softcap=None, scale=None, block_kv=64)
    pool = torch.zeros(2, 3, 16, 64)
    bt = torch.ones(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kern.paged_decode_attention_fwd(
            qd, pool, pool, bt, ln, window=None, softcap=None, scale=None,
            page_size=None, block_kv=64)
    assert all(k.launches == 0 for k in build.KERNELS)


def test_kernel_launchers_refuse_shapes_they_were_not_built_for():
    ln = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="head dim"):
        dec_kern.decode_attention_fwd(
            torch.zeros(2, 4, 48), torch.zeros(2, 2, 8, 48),
            torch.zeros(2, 2, 8, 48), ln, window=None, softcap=None,
            scale=None, block_kv=64)
    with pytest.raises(ValueError, match="group"):
        dec_kern.decode_attention_fwd(
            torch.zeros(2, 32, 64), torch.zeros(2, 2, 8, 64),
            torch.zeros(2, 2, 8, 64), ln, window=None, softcap=None,
            scale=None, block_kv=64)
    with pytest.raises(ValueError, match="int32"):
        dec_kern.decode_attention_fwd(
            torch.zeros(2, 4, 64), torch.zeros(2, 2, 8, 64),
            torch.zeros(2, 2, 8, 64), ln.long(), window=None, softcap=None,
            scale=None, block_kv=64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        build.dtype_code(torch.zeros(2, dtype=torch.float16))


def test_every_kernel_has_a_source_and_a_build_key():
    names = sorted(k.name for k in build.KERNELS)
    assert names == ["decode_attention", "flash_attention",
                     "flash_attention_native", "gmm",
                     "mamba_scan", "mlstm_scan", "paged_decode_attention",
                     "quant_paged_decode_attention",
                     "quant_window_paged_decode_attention", "rmsnorm",
                     "rmsnorm_native", "rt_selftest", "rt_selftest_portable",
                     "spec_paged_decode_attention",
                     "window_paged_decode_attention"]
    with target("cuda", isa="sm_90a"):      # the card's build keys
        for k in build.KERNELS:
            assert k.source.is_file()
            text = k.source.read_text()
            assert ("Replaces the TPU kernel" in text
                    and "Bound on the H100" in text)
            assert f'extern "C" int {k.symbol}' in text
            assert k.library_path().parent == build.BUILD_DIR
        assert len({k.library_path() for k in build.KERNELS}) == 15
