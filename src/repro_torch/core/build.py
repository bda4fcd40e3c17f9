"""Build and bind the hand-written CUDA kernels (counterpart of
``repro.core.runtime.kernel_call``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  A library is built at first use
into ``build/repro_torch/`` at the root of the checkout, under a name
keyed by a hash of the sources and flags, so an edited source never
loads a stale build.  Every C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; :meth:`CudaKernel.launch`
raises on a non-zero code and counts the launch.
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
from typing import List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: Every kernel the port defines, in declaration order.
KERNELS: List["CudaKernel"] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


class CudaKernel:
    """One CUDA source, its shared library, and one C entry point.

    ``launches`` counts successful launches through :meth:`launch`, the
    only place a wrapper starts the kernel; callers reset it to 0
    around a run to prove that run went through the kernel.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()
        KERNELS.append(self)

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in sorted(CSRC.glob("*.cuh")) + [self.source]:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless a library of the same hash exists."""
        path = self.library_path()
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}."
                             f"{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp, path)          # atomic: readers see all or nothing
        return path

    def _entry(self):
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(str(self.build()))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.repro_cuda_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        code = self._entry()(*args)
        if code != 0:
            msg = self._lib.repro_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{code} ({msg})")
        self.launches += 1


def build_all() -> float:
    """Build every kernel's library in parallel (one ``nvcc`` per
    source, all started together); returns the wall seconds taken."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, len(KERNELS))) as ex:
        for fut in [ex.submit(k.build) for k in KERNELS]:
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
