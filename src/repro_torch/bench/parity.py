"""Native against portable on the card (paper §4.1; the twin part of
``benchmarks/parity.py``, DESIGN.md §7.4):

    python -m repro_torch.bench.parity

For each twin pair, B1 (``csrc/rmsnorm.cu``, written against the device
runtime ``csrc/rt/``) against B11a (``csrc/native/rmsnorm_native.cu``,
hard-coded CUDA), B2 (``csrc/flash_attention.cu``) against B11b
(``csrc/native/flash_attention_native.cu``), and the two builds of each
SPEC ACCEL stand-in B12-B17 (``csrc/spec_accel/*.cu``, one source
against ``csrc/rt/`` and against ``csrc/native/rt_native.cuh``;
``bench/spec_accel.py``) and of miniQMC's regions B18-B19
(``csrc/miniqmc/*.cu``, ``bench/miniqmc.py``, which holds their bits and
times on its own path):

1. both libraries are dumped with ``cuobjdump -sass`` and each kernel
   instantiation's opcode histogram (addresses, registers and operands
   stripped: the CUDA form of "metadata stripped") is compared with its
   twin's, beside each side's registers (``cuobjdump -res-usage``);
2. at the serving paths' shapes and at the reference's parity shapes
   (the stand-ins: at the reference's shapes and at a card shape), the
   two outputs must be bit-identical, and each within the op's
   tolerance of its plain version;
3. the two are timed in turns in this one process (median of
   ``timing.ITERS`` launches each, L2 flushed before each, the order
   alternating from turn to turn), since register allocation moves
   with small source changes; the generic build and the plain version
   take their turns too.

4. the tensor-core builds, B2's and B11b's bf16 bodies and B8's, must
   hold HMMA instructions in their SASS, and B2's generic build none
   (:func:`hmma_counts`).

B1, B2, the stand-ins and the regions are also built for the
``generic`` target (the same sources on a target that provides no
intrinsic: the port of ``examples/new_target.py``), and all but the
regions held to their plain versions and timed in the same turns; and
the runtime's test kernel (``core/selftest.py``) is run for both
targets and held to the plain atomics, after a generic build of its
target part has been refused with the stub's message.

Exits 1, after printing every result, if any check fails.  Needs a
CUDA card and the CUDA toolkit (``nvcc``, ``cuobjdump``, ``cu++filt``).
"""
from __future__ import annotations

import collections
import contextlib
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from repro_torch.bench import miniqmc, spec_accel
from repro_torch.bench.timing import time_in_turns, under
from repro_torch.core import build, selftest
from repro_torch.core.context import context_for, target
from repro_torch.core.runtime import DeviceRuntime
from repro_torch.kernels.flash_attention import flash_attention as fa_kern
from repro_torch.kernels.flash_attention import native as fa_native
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.gmm import gmm as gmm_kern
from repro_torch.kernels.rmsnorm import native as rms_native
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.rmsnorm import rmsnorm as rms_kern

#: the bf16 outputs' tolerance (atol = rtol): both sides sum in f32, in
#: another order, and round to bf16's 8 bits; f32 outputs take the op's
TOL_BF16 = 2e-2
STUB = "target dependent implementation missing"

#: rmsnorm: (label, rows, d, dtype): granite's, gemma2's and jamba's
#: prefill rows, and benchmarks/parity.py's (256, 512) f32
RMS_CASES = (("granite", 4096, 4096, torch.bfloat16),
             ("gemma2", 18000, 2304, torch.bfloat16),
             ("jamba", 1022, 8192, torch.bfloat16),
             ("parity", 256, 512, torch.float32))
#: flash: (label, B, Hq, Hkv, S, D, dtype, masks), all causal:
#: granite's prefill, gemma2's (window 4096, softcap 50) and
#: benchmarks/parity.py's (1, 4, 512, 64) over 2 KV heads in f32 and in
#: bf16 (the tensor-core body's head-dim-64 build)
FLASH_CASES = (("granite", 4, 32, 8, 512, 128, torch.bfloat16, {}),
               ("gemma2", 3, 8, 4, 6000, 256, torch.bfloat16,
                dict(window=4096, softcap=50.0)),
               ("parity", 1, 4, 2, 512, 64, torch.float32, {}),
               ("parity bf16", 1, 4, 2, 512, 64, torch.bfloat16, {}))
#: runtime test kernel: (teams, total, bound): the reference's
#: partition of 1000 over 7 teams, then 132 teams under contention
SELFTEST_CASES = ((7, 1000, 6), (132, 8192, 254))

GENERIC = DeviceRuntime(context_for("generic"))


def _tool(name: str) -> str:
    path = Path(build._nvcc()).parent / name
    if not path.exists():
        raise FileNotFoundError(f"{name} is not beside nvcc ({path}): the "
                                f"SASS comparison needs the CUDA toolkit's")
    return str(path)


def _run(cmd: List[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return res.stdout


# ---------------------------------------------------------------- SASS ----

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P(?:T|\d+)\s+)?"
                    r"([A-Z][A-Z0-9_.]*)")
_USAGE = re.compile(r"Function ([^\s:]+):\s*\n[^\n]*?REG:(\d+)[^\n]*?"
                    r"SHARED:(\d+)[^\n]*?LOCAL:(\d+)")
_TEMPLATE = re.compile(r"(\w+)<([^<>]*)>\(")


def opcode_histograms(sass_text: str) -> Dict[str, collections.Counter]:
    """``cuobjdump -sass`` text -> mangled kernel name -> opcode counts,
    each opcode with its modifiers (``SHFL.BFLY``, ``MUFU.RCP``) but
    no predicate, register, operand or address."""
    hists, cur = {}, None
    for line in sass_text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = hists.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return hists


def resource_usage(text: str) -> Dict[str, Dict[str, int]]:
    """``cuobjdump -res-usage`` text -> mangled name -> registers per
    thread, static shared bytes, local (spill) bytes."""
    return {m.group(1): {"regs": int(m.group(2)), "shared": int(m.group(3)),
                         "local": int(m.group(4))}
            for m in _USAGE.finditer(text)}


def instantiation(demangled: str) -> Tuple[str, Tuple[str, ...]]:
    """``void (anonymous namespace)::k<float, 64, 64>(...)`` -> (name,
    key): the template arguments, the repeated width of an equal-dim
    build once, so a portable ``<T, 64, 64>`` meets a native
    ``<T, 64>`` (and a bf16 ``<64, 64>`` a native ``<64>``)."""
    m = _TEMPLATE.search(demangled)
    if m is None:
        return demangled, ()
    args = tuple(a.strip() for a in m.group(2).split(","))
    if len(args) >= 2 and args[-1] == args[-2]:
        args = args[:-1]
    return m.group(1), args


def kernels_of(lib: Path) -> Dict[Tuple[str, ...], dict]:
    """Each kernel instantiation of a library: key -> its name, opcode
    histogram and resource usage."""
    hists = opcode_histograms(_run([_tool("cuobjdump"), "-sass", str(lib)]))
    usage = resource_usage(_run([_tool("cuobjdump"), "-res-usage",
                                 str(lib)]))
    if not hists or set(hists) - set(usage):
        raise RuntimeError(f"could not read the SASS or the resource usage "
                           f"of every kernel in {lib.name}")
    names = list(hists)
    demangled = _run([_tool("cu++filt"), *names]).splitlines()
    out = {}
    for mangled, dem in zip(names, demangled):
        name, key = instantiation(dem)
        out[key] = {"kernel": f"{name}<{', '.join(key)}>",
                    "hist": hists[mangled], **usage[mangled]}
    return out


_NAME = re.compile(r"(\w+)(?:<[^<>]*>)?\(")


def tensor_core_counts(sass_text: str, demangled: List[str]
                       ) -> Dict[str, Dict[str, int]]:
    """HMMA instructions of each kernel in ``cuobjdump -sass`` text
    (``demangled``: its kernels' names, in the text's order), split by
    element type: {"bf16": {kernel: count}, "f32": {...}}; an
    instantiation with ``float`` among its template arguments is f32,
    any other bf16."""
    hists = opcode_histograms(sass_text)
    out = {"bf16": {}, "f32": {}}
    for mangled, dem in zip(hists, demangled):
        name, key = instantiation(dem)
        if not key:
            m = _NAME.search(name)
            name = m.group(1) if m else name
        label = f"{name}<{', '.join(key)}>" if key else name
        n = sum(c for op, c in hists[mangled].items()
                if op.split(".")[0] == "HMMA")
        out["f32" if "float" in key else "bf16"][label] = n
    return out


#: (kernel, target) of each build whose bf16 body is meant for the tensor
#: cores, and B2's generic build, which must not use them
TENSOR_CORE_BUILDS = ((fa_kern.KERNEL, "cuda"), (fa_native.KERNEL, "cuda"),
                      (gmm_kern.KERNEL, "cuda"), (fa_kern.KERNEL, "generic"))


def hmma_counts() -> List[dict]:
    """Each of TENSOR_CORE_BUILDS, built if it is not, with its
    instantiations' HMMA counts (:func:`tensor_core_counts`)."""
    rows = []
    for kernel, arch in TENSOR_CORE_BUILDS:
        lib = kernel.build(GENERIC if arch == "generic" else None)
        sass = _run([_tool("cuobjdump"), "-sass", str(lib)])
        names = list(opcode_histograms(sass))
        dem = _run([_tool("cu++filt"), *names]).splitlines()
        rows.append({"build": kernel.name, "target": arch,
                     **tensor_core_counts(sass, dem)})
    return rows


def hmma_failures(rows: List[dict]) -> List[str]:
    """What :func:`hmma_counts`'s rows break: a bf16 instantiation of a
    card build without HMMA, an instantiation of the generic build with
    one, or a build with no bf16 instantiation at all."""
    bad = []
    for r in rows:
        what = f"{r['build']} ({r['target']})"
        if not r["bf16"]:
            bad.append(f"{what}: no bf16 instantiation")
        for kname, n in r["bf16"].items():
            if (n == 0) == (r["target"] != "generic"):
                bad.append(f"{what}: {kname} holds {n} HMMA")
        if r["target"] == "generic" and any(r["f32"].values()):
            bad.append(f"{what}: an f32 instantiation holds HMMA")
    return bad


def compare_sass(pair: str, portable: build.CudaKernel,
                 native: build.CudaKernel) -> List[dict]:
    """One record per instantiation: the twins' instruction counts,
    their opcode histogram diff ({opcode: [native, portable]}) and
    registers, shared and local bytes; an instantiation only one side
    builds (B2's 192/128) is listed with the other side empty."""
    p = kernels_of(portable.library_path())
    n = kernels_of(native.library_path())
    rows = []
    for key in sorted(set(p) | set(n)):
        a, b = n.get(key), p.get(key)
        ha = a["hist"] if a else collections.Counter()
        hb = b["hist"] if b else collections.Counter()
        rows.append({
            "pair": pair, "key": list(key),
            "native": a["kernel"] if a else None,
            "portable": b["kernel"] if b else None,
            "instructions": [sum(ha.values()), sum(hb.values())],
            # an instantiation without a twin has no diff to show
            "diff": {op: [ha[op], hb[op]] for op in sorted(set(ha) | set(hb))
                     if ha[op] != hb[op]} if a and b else None,
            "hmma": [sum(c for op, c in h.items() if op.split(".")[0] == "HMMA")
                     for h in (ha, hb)],
            **{f: [a[f] if a else None, b[f] if b else None]
               for f in ("regs", "shared", "local")}})
    return rows


# ------------------------------------------------------------- numbers ----

def _err(got: torch.Tensor, want: torch.Tensor, tol: float) -> Tuple[float,
                                                                     bool]:
    g, w = got.float(), want.float()
    ok = (g.shape == w.shape and bool(torch.isfinite(g).all())
          and bool(torch.allclose(g, w, atol=tol, rtol=tol)))
    return float((g - w).abs().max()), ok


def _case(pair, label, shape, dtype, args, portable, native, plain, tol,
          flush, failures) -> dict:
    out_p, out_n = portable(), native()
    out_g = under("generic", portable)()
    want = plain()
    torch.cuda.synchronize()
    tol = tol if dtype == torch.float32 else TOL_BF16
    err_p, ok_p = _err(out_p, want, tol)
    err_n, ok_n = _err(out_n, want, tol)
    err_g, ok_g = _err(out_g, want, tol)
    same = torch.equal(out_p, out_n)
    same_g = torch.equal(out_p, out_g)
    what = f"{pair} {label} {tuple(shape)} {str(dtype).split('.')[-1]}"
    for ok, msg in ((same, "portable and native outputs differ"),
                    (ok_p, f"portable off its plain version by {err_p:.3e}"),
                    (ok_n, f"native off its plain version by {err_n:.3e}"),
                    (ok_g, f"generic build off its plain version by "
                           f"{err_g:.3e}")):
        if not ok:
            failures.append(f"{what}: {msg} (tol {tol:g})")
    del out_p, out_n, out_g, want
    ms_p, ms_n, ms_g, ms_plain = time_in_turns(
        [portable, native, under("generic", portable), plain], flush)
    return {"pair": pair, "case": label, "shape": list(shape),
            "dtype": str(dtype).split(".")[-1], "bit_identical": same,
            "generic_bit_identical": same_g,
            "tol": tol, "err_portable": err_p, "err_native": err_n,
            "err_generic": err_g, "ok_portable": ok_p, "ok_native": ok_n,
            "ok_generic": ok_g, "ms_portable": ms_p, "ms_native": ms_n,
            "ms_generic": ms_g, "ms_plain": ms_plain,
            "args": args}


def _stub_refusal() -> str:
    """nvcc's complaint when the generic target builds a source that
    calls atomic_inc (empty if the build went through)."""
    try:
        selftest.KERNEL.build(GENERIC)
    except RuntimeError as e:
        return str(e)
    return ""


def run(device="cuda") -> dict:
    """Every comparison above; ``failures`` lists what failed.  Each
    case keeps its inputs under ``args``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the parity run needs the CUDA card, got {dev}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    failures: List[str] = []
    res = {"device": torch.cuda.get_device_name(dev), "failures": failures}

    with ThreadPoolExecutor(max_workers=1) as ex:
        refusal = ex.submit(_stub_refusal)
        t0 = time.perf_counter()
        build.build_all(extra=generic_jobs())
        res["build_s"] = time.perf_counter() - t0
        refusal = refusal.result()
    res["stub_refused"] = STUB in refusal
    if not res["stub_refused"]:
        failures.append("the generic build of atomic_inc was not refused "
                        "with the stub's message")

    res["sass"] = (compare_sass("rmsnorm", rms_kern.KERNEL, rms_native.KERNEL)
                   + compare_sass("flash_attention", fa_kern.KERNEL,
                                  fa_native.KERNEL))
    for portable, native in [*spec_accel.TWINS.values(),
                             *miniqmc.TWINS.values()]:
        res["sass"] += compare_sass(portable.name, portable, native)
    res["hmma"] = hmma_counts()
    failures.extend(f"tensor cores: {m}" for m in hmma_failures(res["hmma"]))

    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for label, rows, d, dt in RMS_CASES:
        x = torch.randn(rows, d, device=dev, generator=g).to(dt)
        w = (0.1 * torch.randn(d, device=dev, generator=g)).to(dt)
        kw = dict(eps=1e-6, weight_offset=1.0)
        cases.append(_case(
            "rmsnorm", label, (rows, d), dt, (x, w),
            lambda: rms_ops.rmsnorm(x, w, **kw),
            lambda: rms_native.rmsnorm_native(x, w, **kw),
            lambda: rms_ref.rmsnorm_ref(x, w, **kw), rms_ops.TOL["atol"],
            flush, failures))
    for label, b, hq, hkv, s, d, dt, masks in FLASH_CASES:
        q, k, v = (torch.randn(b, h, s, d, device=dev, generator=g).to(dt)
                   for h in (hq, hkv, hkv))
        cases.append(_case(
            "flash_attention", label, (b, hq, hkv, s, d), dt, (q, k, v, masks),
            lambda: fa_ops.flash_attention(q, k, v, **masks),
            lambda: fa_native.flash_attention_native(q, k, v, **masks),
            lambda: fa_ref.flash_attention_ref(q, k, v, **masks),
            fa_ops.TOL["atol"], flush, failures))
    spec = spec_accel.cases(dev, flush)
    failures.extend(m for c in spec for m in spec_accel.failures_of(c))
    res["cases"] = cases + spec

    runs = []
    for teams, total, bound in SELFTEST_CASES:
        t0 = time.perf_counter()
        want = selftest.plain(teams, total, bound)
        plain_ms = (time.perf_counter() - t0) * 1e3
        for arch, portable in (("cuda", False), ("cuda", True),
                               ("generic", True)):
            with (target(arch) if arch == "generic"
                  else contextlib.nullcontext()):
                got = selftest.launch(teams, total, bound, portable=portable,
                                      device=dev)
                bad = selftest.mismatches(got, want, total, bound)
                bufs = selftest.buffers(teams, total, dev)
                ms = time_in_turns([lambda: selftest.start(
                    bufs, teams, total, bound, portable=portable)], flush)[0]
            name = "portable part" if portable else "with target part"
            runs.append({"teams": teams, "total": total, "bound": bound,
                         "target": arch, "build": name, "ok": not bad,
                         "mismatches": bad, "ms": ms, "plain_ms": plain_ms})
            failures.extend(f"runtime test kernel ({arch}, {name}, {teams} "
                            f"teams, {total} items): {m}" for m in bad)
    res["selftest"] = runs
    return res


def generic_jobs() -> List[Tuple[build.CudaKernel, DeviceRuntime]]:
    """The builds the parity run needs beyond each kernel's for the
    card: B1, B2, the runtime test kernel's portable part and the
    stand-ins' and regions' portable builds for the generic target."""
    return [(k, GENERIC) for k in (rms_kern.KERNEL, fa_kern.KERNEL,
                                   selftest.PORTABLE)] + \
        spec_accel.generic_jobs() + miniqmc.generic_jobs()


def report(res: dict) -> None:
    """Print the run's results, one line each, then one JSON line."""
    print(f"parity on {res['device']}; builds {res['build_s']:.1f} s; "
          f"generic atomic_inc refused with the stub's message: "
          f"{res['stub_refused']}")
    for r in res["sass"]:
        diff = ("no twin" if r["diff"] is None else ", ".join(
            f"{op} {a}/{b}" for op, (a, b) in r["diff"].items()) or "none")
        print(f"  SASS {r['native'] or '-'} | {r['portable'] or '-'}: "
              f"instructions native/portable {r['instructions'][0]}/"
              f"{r['instructions'][1]}, HMMA {r['hmma'][0]}/"
              f"{r['hmma'][1]}, registers {r['regs'][0]}/"
              f"{r['regs'][1]}, static shared {r['shared'][0]}/"
              f"{r['shared'][1]} B; diff {diff}")
    for r in res["hmma"]:
        print(f"  HMMA in {r['build']} ({r['target']}): bf16 "
              + ", ".join(f"{k} {n}" for k, n in r["bf16"].items())
              + "; f32 " + ", ".join(f"{k} {n}" for k, n in r["f32"].items()))
    for c in res["cases"]:
        print(f"  {c['pair']} {c['case']} {tuple(c['shape'])} {c['dtype']}: "
              f"bit-identical {c['bit_identical']}; ms portable "
              f"{c['ms_portable']:.4f}, native {c['ms_native']:.4f} "
              f"({(c['ms_native'] / c['ms_portable'] - 1) * 100:+.1f}% vs "
              f"portable), generic {c['ms_generic']:.4f}, plain "
              f"{c['ms_plain']:.4f}; max |diff| vs plain portable "
              f"{c['err_portable']:.3e}, native {c['err_native']:.3e}, "
              f"generic {c['err_generic']:.3e} (tol {c['tol']:g})")
    for r in res["selftest"]:
        print(f"  runtime test kernel, {r['target']} ({r['build']}), "
              f"{r['teams']} teams x {r['total']} items, inc bound "
              f"{r['bound']}: {'ok' if r['ok'] else r['mismatches']}; "
              f"{r['ms']:.4f} ms (plain replay {r['plain_ms']:.1f} ms)")
    print(json.dumps({"parity": {
        k: ([{f: v for f, v in c.items() if f != "args"} for c in res[k]]
            if k == "cases" else res[k]) for k in res}}))


def main() -> int:
    if not torch.cuda.is_available():
        print("parity: no CUDA device; the comparison runs on the card",
              file=sys.stderr)
        return 1
    res = run()
    report(res)
    if res["failures"]:
        print("parity: failed:\n  " + "\n  ".join(res["failures"]),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
