"""The port's device runtime on the CPU, against the reference's.

``repro_torch.core.{context,variant,intrinsics,atomics,runtime}`` are
held to ``repro.core``'s: every ``declare_variant`` scenario of
``tests/test_variant.py`` picks the same winner in both (arch names
mapped: tpu/interpret/generic there, cuda/generic/cpu here),
``static_partition`` gives the same ranges, the plain atomics the same
captured values, the host intrinsics the same arrays.  Then what only
the port has: ``compiler_params`` (the nvcc flags of each target), the
build's library key (headers under ``csrc/`` at any depth, per-kernel
defines, the target), the native twins' CPU path (B11's plain versions)
against the reference's ``native.py`` kernels in interpret mode, the
runtime test kernel's plain replay and its order-free checker, and the
SASS parsers of ``bench/parity.py``.  The CUDA side runs on the card
only (``tests/test_torch_gpu.py``, ``python -m repro_torch.bench.parity``).
"""
from __future__ import annotations

import itertools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import atomics as jatomics
from repro.core import context as jctx
from repro.core import intrinsics as jI
from repro.core import variant as jV
from repro.core.runtime import runtime as jruntime
from repro.kernels.flash_attention.native import \
    flash_attention_native as jfa_native
from repro.kernels.rmsnorm.native import rmsnorm_native as jrms_native
from repro_torch.bench import parity
from repro_torch.core import atomics, build, context, selftest
from repro_torch.core import intrinsics as I
from repro_torch.core import variant as V
from repro_torch.core.runtime import DeviceRuntime, runtime
from repro_torch.core.targets.cuda import SM90A_FLAGS
from repro_torch.core.targets.generic import GENERIC_DEFINE
from repro_torch.kernels.flash_attention import native as fa_native
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import native as rms_native
from repro_torch.kernels.rmsnorm import ops as rms_ops

#: (variant module, context module, abstract arch -> that module's arch)
REF = (jV, jctx, {"A": "tpu", "B": "interpret", "C": "generic"})
PORT = (V, context, {"A": "cuda", "B": "generic", "C": "cpu"})

# ------------------------------------------------ declare_variant -----

#: name -> (variants: (archs, isa, extension), probes: (arch, isa),
#: winners): the scenarios of tests/test_variant.py
SCENARIOS = {
    "base_fallback": ([], [("C", None)], ["base"]),
    "arch_variant": ([(("A",), None, None)], [("A", None), ("B", None)],
                     ["v0", "base"]),
    "match_any": ([(("B", "C"), None, "match_any")],
                  [("B", None), ("C", None), ("A", None)],
                  ["v0", "v0", "base"]),
    "all_requires_exact": ([(("B", "C"), None, None)],
                           [("B", None), ("C", None), ("A", None)],
                           ["base"] * 3),
    "match_none": ([(("A",), None, "match_none")], [("A", None), ("B", None)],
                   ["base", "v0"]),
    "isa_beats_arch": ([(("A",), None, None), (("A",), "v5e", None)],
                       [("A", "v5e"), ("A", "v4"), ("A", None)],
                       ["v1", "v0", "v0"]),
    "tie_later_wins": ([(("A",), None, None), (("A",), None, None)],
                       [("A", None)], ["v1"]),
    "tie_later_of_equal_scores": ([(("B",), None, None),
                                   (("A", "B"), None, "match_any")],
                                  [("B", None)], ["v1"]),
    "match_none_many": ([(("A", "B"), None, "match_none")],
                        [("C", None), ("A", None), ("B", None)],
                        ["v0", "base", "base"]),
}
_N = itertools.count()


def _base(mods, variants):
    V_, _, names = mods

    def base(x):
        return "base"

    base = V_.declare_target(base, name=f"_t_runtime_{next(_N)}")
    for n, (archs, isa, ext) in enumerate(variants):
        sels = [V_.arch(*(names[a] for a in archs))]
        sels += [V_.isa(isa)] if isa else []
        V_.declare_variant(base, match=V_.match(device=sels,
                                                implementation=ext))(
            lambda x, n=n: f"v{n}")
    return base


def _winners(mods, variants, probes):
    _, ctx, names = mods
    base = _base(mods, variants)
    out = []
    for a, isa in probes:
        with ctx.target(names[a], isa=isa):
            out.append(base(0))
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_variant_scenarios_pick_the_reference_winner(name):
    variants, probes, want = SCENARIOS[name]
    assert _winners(REF, variants, probes) == want
    assert _winners(PORT, variants, probes) == want


@pytest.mark.parametrize("mods", [REF, PORT], ids=["repro", "repro_torch"])
def test_variant_edge_cases(mods):
    V_, ctx, names = mods

    def stub(x):
        raise V_.VariantError("target dependent implementation missing")

    stub = V_.declare_target(stub, name=f"_t_runtime_{next(_N)}")
    with ctx.target(names["C"]):
        with pytest.raises(V_.VariantError, match="implementation missing"):
            stub(1)
    with pytest.raises(ValueError):
        V_.match(device=V_.arch(names["A"]),
                 implementation=["match_any", "match_none"])
    assert V_.match(device=V_.arch(names["A"]),
                    implementation=["match_any", "match_any"]).ext == \
        "match_any"
    assert V_.match(device=V_.arch(names["A"]),
                    implementation=["match_none"]).ext == "match_none"
    with pytest.raises(TypeError):
        V_.declare_variant(lambda x: x, match=V_.match())


@pytest.mark.parametrize("mods", [REF, PORT], ids=["repro", "repro_torch"])
def test_variant_for_and_nested_contexts(mods):
    _, ctx, names = mods
    base = _base(mods, [(("B",), None, None)])
    with ctx.target(names["A"]):
        with ctx.target(names["C"]):
            assert base.variant_for(names["B"])(3) == "v0"
            assert base(3) == "base"
            assert ctx.current_context().arch == names["C"]
        assert ctx.current_context().arch == names["A"]
    isa_base = _base(mods, [(("A",), "v5e", None)])
    with ctx.target(names["A"], isa="v5e"):
        with ctx.target(names["A"], isa="v4"):
            assert isa_base(1) == "base"
        assert isa_base(1) == "v0"


def test_unknown_arch_is_refused_by_both():
    with pytest.raises(ValueError, match="unknown target arch"):
        context.target("tpu")
    with pytest.raises(ValueError, match="unknown target arch"):
        jctx.target("cuda")


# ------------------------------------------------------------ context -----

def test_default_context_is_the_card_or_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        context.detect_default_context()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        context.current_context()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime()
    with context.target("cpu"):
        assert runtime().arch == "cpu"          # named: fine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev=None: (9, 0))
    ctx = context.detect_default_context()
    assert (ctx.arch, ctx.device.isa, ctx.device.kind,
            ctx.implementation.vendor) == ("cuda", "sm_90a", "gpu", "nvidia")


def test_isa_and_traits_of_each_target():
    assert context.isa_of((9, 0)) == "sm_90a"
    assert context.isa_of((8, 0)) == "sm_80"
    cpu = context.context_for("cpu")
    assert (cpu.device.kind, cpu.implementation.vendor) == ("cpu", "pytorch")
    gen = context.context_for("generic")
    assert (gen.device.kind, gen.device.isa) == ("gpu", None)


# --------------------------------------------------- static_partition -----

@pytest.mark.parametrize("total", [0, 1, 7, 999, 1000, 1001, 4096, 8192])
def test_static_partition_equals_the_reference(total):
    jrt = jruntime()
    for teams in (1, 2, 3, 7, 8, 64, 132, 1000):
        got = [DeviceRuntime.static_partition(total, teams, t)
               for t in range(teams)]
        want = [tuple(int(v) for v in jrt.static_partition(
            total, teams, jnp.int32(t))) for t in range(teams)]
        assert got == want, (total, teams)
        covered = [i for lo, hi in got for i in range(lo, hi)]
        assert covered == list(range(total)), (total, teams)


# ------------------------------------------------------------ atomics -----

class _Ref:
    """A one-element ref for ``repro.core.atomics``."""

    def __init__(self, v):
        self.v = jnp.asarray(v)

    def __getitem__(self, idx):
        return self.v

    def __setitem__(self, idx, val):
        self.v = jnp.asarray(val)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_plain_atomics_equal_the_reference(seed, dtype):
    """A seeded sequence of the five portable atomics: the same captured
    values and the same final value, on element 1 of a 3-vector here
    and on a scalar ref there."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-20, 20, size=(200, 2))
    ref = _Ref(np.asarray(3, dtype))
    t = torch.tensor([7, 3, -7], dtype=getattr(torch, dtype))
    for n, (a, b) in enumerate(vals):
        op = ("add", "max", "min", "exchange", "cas")[rng.integers(5)]
        a, b = np.asarray(a, dtype), np.asarray(b, dtype)
        if op == "cas":
            a = np.asarray(ref.v) if n % 3 == 0 else a   # some succeed
            want = jatomics.atomic_cas(ref, a, b)
            got = atomics.atomic_cas(t, torch.tensor(a), torch.tensor(b), 1)
        else:
            want = getattr(jatomics, f"atomic_{op}")(ref, a)
            got = getattr(atomics, f"atomic_{op}")(t, torch.tensor(a), 1)
        assert float(got) == float(want), (n, op)
        assert float(t[1]) == float(ref.v), (n, op)
    assert t[0] == 7 and t[2] == -7


def test_atomic_inc_wraps_as_the_reference_and_cuda():
    ref, t = _Ref(np.int32(0)), torch.zeros(2, dtype=torch.int32)
    got = [int(atomics.atomic_inc(t, 2, 0)) for _ in range(6)]
    want = [int(jatomics.atomic_inc(ref, 2)) for _ in range(6)]
    assert got == want == [0, 1, 2, 0, 1, 2]
    whole = torch.tensor(5)
    assert int(atomics.atomic_inc(whole, 3)) == 5 and int(whole) == 0


# ------------------------------------------------------ host intrinsics -----

_X = np.random.default_rng(3).standard_normal((8, 128)).astype(np.float32)
_INTRINSICS = {
    "iota": lambda m, x: m.iota((4, 8), 1),
    "reduce_sum": lambda m, x: m.reduce_sum(x, axis=1, keepdims=True),
    "reduce_sum_all": lambda m, x: m.reduce_sum(x),
    "reduce_max": lambda m, x: m.reduce_max(x, axis=0),
    "exp": lambda m, x: m.exp(x),
    "approx_reciprocal": lambda m, x: m.approx_reciprocal(x + 5.0),
    "repeat": lambda m, x: m.repeat(x, 2, 0),
    "roll": lambda m, x: m.roll(x, 3, 1),
}


@pytest.mark.parametrize("arch,ref_arch", [("cpu", "interpret"),
                                           ("generic", "generic")])
@pytest.mark.parametrize("name", sorted(_INTRINSICS))
def test_host_intrinsics_equal_the_reference(name, arch, ref_arch):
    with context.target(arch):
        got = _INTRINSICS[name](I, torch.from_numpy(_X)).numpy()
    with jctx.target(ref_arch):
        want = np.asarray(_INTRINSICS[name](jI, jnp.asarray(_X)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_make_async_copy_has_no_portable_form():
    src, dst = torch.arange(4.0), torch.zeros(4)
    with context.target("generic"):
        with pytest.raises(V.VariantError, match="implementation missing"):
            I.make_async_copy(src, dst)
    with context.target("cpu"):
        I.make_async_copy(src, dst)
    assert torch.equal(dst, src)
    cuda = I.make_async_copy.variant_for("cuda")
    assert "cuda" in cuda.__name__


# ---------------------------------------------------- compiler_params -----

def test_compiler_params_of_each_target():
    with context.target("cuda", isa="sm_90a"):
        assert runtime().compiler_params() == SM90A_FLAGS
    assert SM90A_FLAGS == ("-gencode", "arch=compute_90a,code=sm_90a")
    with context.target("generic"):
        assert runtime().compiler_params() == SM90A_FLAGS + (GENERIC_DEFINE,)
    assert GENERIC_DEFINE == "-DREPRO_RT_TARGET_GENERIC"
    for arch, isa in (("cpu", None), ("cuda", "sm_80"), ("cuda", None)):
        with context.target(arch, isa=isa):
            with pytest.raises(V.VariantError, match="compiler_params"):
                runtime().compiler_params()
    # a runtime keeps the target it was bound to
    generic = DeviceRuntime(context.context_for("generic"))
    with context.target("cpu"):
        assert GENERIC_DEFINE in generic.compiler_params()
        assert generic.arch == "generic"


# -------------------------------------------------------------- build -----

def test_library_key_covers_nested_headers_defines_and_target(tmp_path,
                                                              monkeypatch):
    """An edit to a header under csrc/rt/ rebuilds; so does another
    define for the same source, or another target."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "KERNELS", [])
    args = ("rmsnorm.cu", "rmsnorm_fwd", [])
    plain_k = build.CudaKernel("probe", *args)
    defined = build.CudaKernel("probe", *args, flags=("-DPROBE=1",))
    assert build.KERNELS == [plain_k, defined]
    with context.target("cuda", isa="sm_90a"):
        before = plain_k.library_path()
        assert before.parent == build.BUILD_DIR
        assert before.name.startswith("probe-cuda-")
        assert defined.library_path() != before
        header = csrc / "rt" / "targets" / "generic.cuh"
        header.write_text(header.read_text() + "\n// an edit\n")
        after = plain_k.library_path()
        assert after != before
        assert plain_k._nvcc_flags()[-len(SM90A_FLAGS):] == SM90A_FLAGS
    with context.target("generic"):
        generic = plain_k.library_path()
        assert generic.name.startswith("probe-generic-") and generic != after
        assert defined._nvcc_flags()[-2:] == (GENERIC_DEFINE, "-DPROBE=1")
    with context.target("cpu"):
        with pytest.raises(V.VariantError):
            plain_k.library_path()


def _code(path):
    """A CUDA source without its comments."""
    return "\n".join(line.split("//")[0]
                     for line in path.read_text().splitlines())


def test_portable_sources_use_the_runtime_and_native_ones_do_not():
    for name in ("rmsnorm.cu", "flash_attention.cu"):
        code = _code(build.CSRC / name)
        assert '#include "rt/runtime.cuh"' in code
        for direct in ("blockIdx", "__shared__", "__shfl", "__syncthreads"):
            assert direct not in code, (name, direct)
    for name in ("rmsnorm_native.cu", "flash_attention_native.cu"):
        code = _code(build.CSRC / "native" / name)
        assert '#include "rt/' not in code and "rt::" not in code, name
        assert "blockIdx" in code and "__shfl_xor_sync" in code, name


# ------------------------------------------------- B11 on the CPU -----

@pytest.mark.parametrize("rows,d", [(16, 256), (3, 100)])
def test_rmsnorm_native_cpu_path_matches_the_reference(rows, d):
    """The native twin's plain version against ``repro``'s
    ``rmsnorm_native`` (interpret mode), at the op's f32 tolerance."""
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    w = (0.1 * rng.standard_normal(d)).astype(np.float32)
    kw = dict(eps=1e-6, weight_offset=1.0)
    want = np.asarray(jrms_native(jnp.asarray(x), jnp.asarray(w),
                                  interpret=True, **kw))
    before = rms_native.KERNEL.launches
    got = rms_native.rmsnorm_native(torch.from_numpy(x), torch.from_numpy(w),
                                    **kw)
    assert rms_native.KERNEL.launches == before       # the plain version
    np.testing.assert_allclose(got.numpy(), want, **rms_ops.TOL)


@pytest.mark.parametrize("masks", [{}, dict(window=16, softcap=30.0),
                                   dict(causal=False)],
                         ids=["causal", "window_softcap", "full"])
def test_flash_native_cpu_path_matches_the_reference(masks):
    """The native twin's plain version against ``repro``'s
    ``flash_attention_native`` (interpret mode): GQA 4/2, S 64, D 32,
    at the op's f32 tolerance."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, h, 64, 32)).astype(np.float32)
               for h in (4, 2, 2))
    want = np.asarray(jfa_native(*(jnp.asarray(a) for a in (q, k, v)),
                                 interpret=True, **masks))
    before = fa_native.KERNEL.launches
    got = fa_native.flash_attention_native(
        *(torch.from_numpy(a) for a in (q, k, v)), **masks)
    assert fa_native.KERNEL.launches == before
    np.testing.assert_allclose(got.numpy(), want, **fa_ops.TOL)


# ------------------------------------------ the runtime test kernel -----

@pytest.mark.parametrize("teams,total,bound", [
    (7, 1000, 6), (40, 100, 0), (132, 1000, 254)])
def test_selftest_plain_replay(teams, total, bound):
    """The plain replay's outcomes in closed form, and the checker
    passing it against itself."""
    got = selftest.launch(teams, total, bound, device="cpu")
    keys = [selftest.key_of(i) for i in range(total)]
    c = got["counters"]
    assert (c["add"], c["max"], c["min"], c["wins"], c["reduce_errs"]) == (
        sum(keys), max(keys), min(keys), 1, 0)
    assert c["exch_olds"] + c["exch"] == -1 + sum(keys)
    assert got["inc"] == total % (bound + 1)
    counts = np.bincount(got["inc_olds"], minlength=bound + 1)
    assert set(counts) <= {total // (bound + 1), -(-total // (bound + 1))}
    assert got["parts"] == [DeviceRuntime.static_partition(total, teams, t)
                            for t in range(teams)]
    assert selftest.mismatches(got, selftest.plain(teams, total, bound),
                               total, bound) == []


def test_selftest_checker_catches_order_free_faults():
    want = selftest.plain(7, 1000, 6)
    for fault in ("wins", "add", "reduce_errs", "mma_errs", "quad_errs",
                  "inc", "copied", "team_sums", "recip"):
        got = {k: (dict(v) if isinstance(v, dict) else
                   v.clone() if torch.is_tensor(v) else list(v)
                   if isinstance(v, list) else v) for k, v in want.items()}
        if fault in ("wins", "add", "reduce_errs", "mma_errs", "quad_errs"):
            got["counters"][fault] += 1
        elif fault == "inc":
            got["inc_olds"][0] = 5
        elif fault == "copied":
            got["copied"][0, 0, 0] += 1
        elif fault == "recip":
            got["recip_rel_err"] = 1e-3
        else:
            got["team_sums"][3] += 1.0
        assert selftest.mismatches(got, want, 1000, 6), fault


# ------------------------------------------------------- SASS parsers -----

SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_114rmsnorm_kernelIfEEvPKT_S3_PS1_iff
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
        /*0010*/               @!P0 BRA 0x120 ;
        /*0020*/                   SHFL.BFLY PT, R3, R2, 0x10, 0x1f ;
        /*0030*/              @!UPT UIADD3 UR4, UR4, 0x1, URZ ;
        /*0040*/                   SHFL.BFLY PT, R5, R4, 0x8, 0x1f ;
\t\tFunction : _Z1kv
        /*0000*/                   EXIT ;
"""
USAGE = """Resource usage:
 Common:
  GLOBAL:0
 Function _ZN12_GLOBAL__N_114rmsnorm_kernelIfEEvPKT_S3_PS1_iff:
  REG:16 STACK:0 SHARED:32 LOCAL:0 CONSTANT[0]:572 TEXTURE:0 SURFACE:0
 Function _Z1kv:
  REG:4 STACK:0 SHARED:0 LOCAL:8 CONSTANT[0]:528 TEXTURE:0 SURFACE:0
"""


def test_parity_reads_opcodes_registers_and_instantiations():
    hists = parity.opcode_histograms(SASS)
    rms = "_ZN12_GLOBAL__N_114rmsnorm_kernelIfEEvPKT_S3_PS1_iff"
    assert hists[rms] == {"LDC": 1, "BRA": 1, "SHFL.BFLY": 2, "UIADD3": 1}
    assert hists["_Z1kv"] == {"EXIT": 1}
    assert parity.resource_usage(USAGE) == {
        rms: {"regs": 16, "shared": 32, "local": 0},
        "_Z1kv": {"regs": 4, "shared": 0, "local": 8}}
    assert parity.instantiation(
        "void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 128, "
        "128>(const T1 *, int)") == ("flash_fwd_kernel",
                                     ("__nv_bfloat16", "128"))
    assert parity.instantiation(
        "void (anonymous namespace)::flash_fwd_kernel<float, 192, 128>"
        "(const T1 *)")[1] == ("float", "192", "128")
    assert parity.instantiation(
        "void (anonymous namespace)::flash_native_kernel<float, 64>"
        "(const T1 *)")[1] == ("float", "64")
    assert parity.instantiation(
        "void (anonymous namespace)::flash_mma_kernel<64, 64>"
        "(const __nv_bfloat16 *)") == ("flash_mma_kernel", ("64",))
    assert parity.instantiation(
        "void (anonymous namespace)::flash_native_mma_kernel<64>"
        "(const __nv_bfloat16 *)") == ("flash_native_mma_kernel", ("64",))


MMA_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_116flash_mma_kernelILi64ELi64EEEvPK13__nv_bfloat16
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
        /*0020*/                   HMMA.16816.F32.BF16 R16, R4, R14, R16 ;
\t\tFunction : _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64ELi64EEEvPKT_
        /*0000*/                   FFMA R1, R2, R3, R1 ;
\t\tFunction : _ZN12_GLOBAL__N_114gmm_mma_kernelEPK13__nv_bfloat16
        /*0000*/              @!P0 HMMA.16816.F32.BF16 R8, R4, R12, R8 ;
"""
MMA_NAMES = [
    "void (anonymous namespace)::flash_mma_kernel<64, 64>(const "
    "__nv_bfloat16 *)",
    "void (anonymous namespace)::flash_fwd_kernel<float, 64, 64>(const "
    "T1 *)",
    "void (anonymous namespace)::gmm_mma_kernel(const __nv_bfloat16 *)"]


def test_parity_counts_hmma_by_instantiation():
    """The tensor-core check's reader: HMMA (any modifiers, predicated
    or not) per kernel, split into bf16 and f32 instantiations; and what
    it fails on: a card build's bf16 kernel without HMMA, a generic one
    with any."""
    got = parity.tensor_core_counts(MMA_SASS, MMA_NAMES)
    assert got == {"bf16": {"flash_mma_kernel<64>": 2, "gmm_mma_kernel": 1},
                   "f32": {"flash_fwd_kernel<float, 64>": 0}}
    card = {"build": "b", "target": "cuda", **got}
    assert parity.hmma_failures([card]) == []
    assert parity.hmma_failures([dict(card, target="generic")]) == [
        "b (generic): flash_mma_kernel<64> holds 2 HMMA",
        "b (generic): gmm_mma_kernel holds 1 HMMA"]
    zero = dict(card, bf16={"flash_mma_kernel<64>": 0})
    assert parity.hmma_failures([zero]) == [
        "b (cuda): flash_mma_kernel<64> holds 0 HMMA"]
    assert parity.hmma_failures([dict(card, bf16={})]) == [
        "b (cuda): no bf16 instantiation"]
