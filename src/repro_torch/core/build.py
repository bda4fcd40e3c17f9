"""Build and bind the hand-written CUDA kernels (counterpart of
``repro.core.runtime.kernel_call``).

Each ``csrc/**/*.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The target flags come from the
device runtime, ``runtime().compiler_params()``, so the active target
context (``core/context.py``: the card's ``cuda``/``sm_90a`` by
default, or ``generic``) picks the target part of ``csrc/rt/`` at
compile time; a kernel may add flags of its own.  A library is built
at first use into ``build/repro_torch/`` at the root of the checkout,
under a name keyed by the target and a hash of the flags, the source
and every header under ``csrc/``, so an edit never loads a stale
build.  Every C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :meth:`CudaKernel.launch` raises on a
non-zero code and counts the launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.context import TargetContext, current_context
from repro_torch.core.runtime import DeviceRuntime, runtime
from repro_torch.obs import profile

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: Flags of every build; the target's come from ``compiler_params``.
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

#: Every kernel the port defines, in declaration order.
KERNELS: List["CudaKernel"] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


class CudaKernel:
    """One CUDA source, built with its own ``flags`` (defines) for each
    target it is launched under, and one C entry point.

    ``launches`` counts successful launches through :meth:`launch`, the
    only place a wrapper starts the kernel, whatever the target; callers
    reset it to 0 around a run to prove that run went through the
    kernel.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, flags: Sequence[str] = ()):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.flags = tuple(flags)
        self.launches = 0
        self._entries: Dict[TargetContext, Tuple[ctypes.CDLL, object]] = {}
        self._lock = threading.Lock()
        KERNELS.append(self)

    def _nvcc_flags(self, rt: Optional[DeviceRuntime] = None) -> tuple:
        rt = rt or runtime()
        return (*NVCC_FLAGS, *rt.compiler_params(), *self.flags)

    def library_path(self, rt: Optional[DeviceRuntime] = None) -> Path:
        rt = rt or runtime()
        h = hashlib.sha256(" ".join(self._nvcc_flags(rt)).encode())
        for p in sorted(CSRC.rglob("*.cuh")) + [self.source]:
            h.update(p.relative_to(CSRC).as_posix().encode())
            h.update(p.read_bytes())
        return BUILD_DIR / f"{self.name}-{rt.arch}-{h.hexdigest()[:16]}.so"

    def build(self, rt: Optional[DeviceRuntime] = None) -> Path:
        """Compile the source for ``rt``'s target (the current one by
        default) unless a library of the same hash exists."""
        rt = rt or runtime()
        path = self.library_path(rt)
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}."
                             f"{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *self._nvcc_flags(rt), "-I", str(CSRC), "-o",
               str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} for "
                               f"target {rt.arch} (exit {res.returncode}):"
                               f"\n{res.stderr}")
        os.replace(tmp, path)          # atomic: readers see all or nothing
        return path

    def _entry(self, ctx: TargetContext):
        with self._lock:
            if ctx not in self._entries:
                lib = ctypes.CDLL(str(self.build(DeviceRuntime(ctx))))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.repro_cuda_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._entries[ctx] = (lib, fn)
        return self._entries[ctx]

    def launch(self, *args) -> None:
        """Launch the build of the current target context."""
        ctx = current_context()
        lib, fn = self._entries.get(ctx) or self._entry(ctx)
        if profile._ENABLED:
            # host dispatch of an asynchronous launch, not kernel time
            with profile.timed(f"kernel_call.{self.name}"):
                code = fn(*args)
        else:
            code = fn(*args)
        if code != 0:
            msg = lib.repro_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{code} ({msg})")
        self.launches += 1


def build_all(extra: Sequence[Tuple[CudaKernel, DeviceRuntime]] = ()
              ) -> float:
    """Build every kernel's library for the current target, and each
    ``(kernel, runtime)`` of ``extra``, in parallel (one ``nvcc`` per
    library, all started together); returns the wall seconds taken."""
    t0 = time.perf_counter()
    jobs = [(k, runtime()) for k in KERNELS] + list(extra)
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as ex:
        for fut in [ex.submit(k.build, rt) for k, rt in jobs]:
            fut.result()
    return time.perf_counter() - t0


#: Element-type codes of csrc/common.cuh: f32 and bf16 for activations
#: and unquantized pools, int8 and fp8-e4m3 for quantized pools.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.float8_e4m3fn: 3}


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' element-type code; raises on a type they lack."""
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"CUDA kernels take float32 or bfloat16 (and int8 "
                        f"or float8_e4m3fn KV pools), got {t.dtype}") from None


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned tensor
    on one CUDA device: the kernels take raw pointers, assume dense rows
    and load them 16 bytes at a time."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every operand must lie on one CUDA "
                             f"device (got {t.device}, expected {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous "
                             f"(got strides {tuple(t.stride())})")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned "
                             f"(got address {t.data_ptr():#x})")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, as ctypes wants it."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current PyTorch stream on ``t``'s device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
