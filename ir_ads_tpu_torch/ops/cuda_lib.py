"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into ``build/lib<name>.so`` at first use, then loaded
with ``ctypes``.  Nothing here runs at import time: the CPU tests import every
module of the package on a machine without ``nvcc``.

A ``CudaKernel`` also carries its launch count, which the wrapper that
launches it raises by one per call; ``chip_smoke.py`` reads the counts to show
that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

VOIDP = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


class CudaKernel:
    """One entry point of a CUDA source, its shared library and its launch
    count.  Two kernels may share a source (``unit``, default ``name``): it
    is then built once."""

    def __init__(self, name: str, fn: str, argtypes: Sequence, replaces: str,
                 unit: str = ""):
        self.name = name
        self.fn = fn
        self.unit = unit or name
        self.argtypes = list(argtypes)
        self.replaces = replaces  # file:line of the TPU kernel it ports
        self.launches = 0
        self._lib = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.unit}.cu"

    @property
    def library(self) -> Path:
        return BUILD / f"lib{self.unit}.so"

    def _stale(self) -> bool:
        if not self.library.exists():
            return True
        built = self.library.stat().st_mtime
        deps = [self.source, *CSRC.glob("*.cuh")]
        return any(d.stat().st_mtime > built for d in deps)

    def compile_command(self) -> List[str]:
        return [
            nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-I", str(CSRC),
            "-o", str(self.library), str(self.source),
        ]

    def start_build(self):
        """Start nvcc for this source; returns the process, or None when the
        library is up to date."""
        if not self._stale():
            return None
        BUILD.mkdir(parents=True, exist_ok=True)
        return subprocess.Popen(
            self.compile_command(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )

    def call(self, *args) -> None:
        """Launch on the current CUDA stream; raises if the launch failed."""
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.library))
            f = getattr(lib, self.fn)
            f.argtypes = self.argtypes + [VOIDP]
            f.restype = INT
            self._lib = f
        stream = torch.cuda.current_stream().cuda_stream
        err = self._lib(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {err}")
        self.launches += 1


def build_all(kernels: Sequence[CudaKernel]) -> Dict[str, str]:
    """Compile every stale library in parallel (one nvcc per source).

    Returns the compiler output (ptxas register and shared-memory report) by
    source name; raises with that output if any build fails."""
    units = {k.unit: k for k in kernels}
    procs = {name: k.start_build() for name, k in units.items()}
    logs: Dict[str, str] = {}
    failed = []
    for name, proc in procs.items():
        if proc is None:
            logs[name] = "up to date"
            continue
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def up(t: torch.Tensor) -> torch.Tensor:
    """The dtype a plain version accumulates in: f32, or f64 for f64 inputs
    (so that ``torch.autograd.gradcheck`` can run the plain versions)."""
    return t if t.dtype == torch.float64 else t.float()


def forbid_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a forward-only kernel: its output
    would carry no gradient (on the card) or the wrong one (the plain
    version's, on the CPU)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is an eval-only kernel with no backward: an input requires "
            "a gradient.  Build the model with dispatch='train' (K1 with its "
            "backward K7 and the module tail) or run under torch.no_grad()")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check_cuda(name: str, *tensors: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
