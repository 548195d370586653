"""Build and load the port's CUDA C++ kernels (``keds_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
library lives under ``build/keds_tpu_torch/`` at the repository root and
its file name carries a hash of the sources and flags, so an edited source
is rebuilt on next use.  Nothing is compiled at import time:
:meth:`CudaKernel.lib` builds on first call, and :func:`build_all` builds
every kernel at once, one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, List, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "keds_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "nvcc on a machine with the CUDA toolkit")
    return path


class CudaKernel:
    """One ``csrc/<name>.cu`` library, its C entry points and a launch count
    per kernel variant.

    ``launches[variant]`` is incremented by the op's wrapper each time it
    launches that variant on a CUDA tensor, and nowhere else; a run resets
    the counts (:meth:`reset`) to show that a code path went through a kernel.
    ``pads[variant]`` counts the calls whose inputs the wrapper copied with
    zero padding before the launch.
    """

    def __init__(self, name: str, functions: Dict[str, List], variants: Iterable[str]):
        self.name = name
        self.functions = functions      # C name -> ctypes argtypes
        self.launches = dict.fromkeys(variants, 0)
        self.pads = dict.fromkeys(self.launches, 0)
        self._lib: Optional[ctypes.CDLL] = None
        self.build_log = ""

    def reset(self) -> None:
        self.launches = dict.fromkeys(self.launches, 0)
        self.pads = dict.fromkeys(self.launches, 0)

    @property
    def source(self) -> pathlib.Path:
        return CSRC / f"{self.name}.cu"

    def _lib_path(self) -> pathlib.Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in [self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(p.read_bytes())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def _start_build(self) -> Optional[subprocess.Popen]:
        out = self._lib_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def _finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{self.build_log}")
        tmp = pathlib.Path(proc.args[proc.args.index("-o") + 1])
        os.replace(tmp, self._lib_path())

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self._finish_build(self._start_build())
            lib = ctypes.CDLL(str(self._lib_path()))
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.keds_error_string.argtypes = [ctypes.c_int]
            lib.keds_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, err: int) -> None:
        """Raise on a non-zero ``cudaError_t`` returned by an entry point."""
        if err:
            msg = self.lib().keds_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} ({err})")


def build_all(kernels: Iterable[CudaKernel]) -> None:
    """Build every kernel's library in parallel (one nvcc each) and load it."""
    kernels = list(kernels)
    procs = [k._start_build() for k in kernels]
    for k, p in zip(kernels, procs):
        k._finish_build(p)
        k.lib()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of ``t``'s CUDA device."""
    return _sm_count(t.device.index if t.device.index is not None
                     else torch.cuda.current_device())


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the raw pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected tensors on one CUDA device, got {t.device}")
