"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``.cu`` source has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``. The
build happens at first use, never at import, into ``orleans_tpu_torch/
_build/`` (listed in ``.gitignore``); a library is named by the hash of
its source and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. ``build_all`` starts one ``nvcc`` per source, all at
once.

Each :class:`Kernel` also carries the count of its launches, a plain
integer that its wrapper raises by one per launch: a run reads it to show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "Kernel", "build_all", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels of orleans_tpu_torch "
                       "need the CUDA toolkit to build")


class Kernel:
    """One CUDA source, its loaded library and its launch count."""

    def __init__(self, name: str, source: str, signatures: dict):
        self.name = name
        self.source = CSRC / source
        # C function name → (restype, argtypes)
        self.signatures = signatures
        self.launches = 0
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes()
                           + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}-{h}.so"

    def _start_build(self) -> subprocess.Popen | None:
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def _finish_build(self, proc: subprocess.Popen) -> None:
        out, _ = proc.communicate()
        self.build_log = out
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{out}")
        os.replace(tmp, self.library)  # atomic: a reader sees all or none

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if need be."""
        if self._lib is None:
            proc = self._start_build()
            if proc is not None:
                self._finish_build(proc)
            lib = ctypes.CDLL(str(self.library))
            for fn, (restype, argtypes) in self.signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            self._lib = lib
        return self._lib


def build_all(kernels) -> float:
    """Build every kernel's library in parallel (one nvcc per source),
    load them all, and return the seconds it took."""
    t0 = time.perf_counter()
    procs = [(k, k._start_build()) for k in kernels]
    errors = []
    for k, proc in procs:
        if proc is not None:
            try:
                k._finish_build(proc)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.lib()
    return time.perf_counter() - t0


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
