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
that its path went through the kernel; and its scratch, device memory
that it keeps from call to call (see :meth:`Kernel.scratch`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "CSRC", "Kernel", "build_all", "check", "sm_count"]

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
    """One CUDA source, its loaded library and its launch count.
    ``defines`` are extra ``-D`` flags: a measurement build of a source
    (see ``scripts/torch_kernel_plans.py``)."""

    def __init__(self, name: str, source: str, signatures: dict,
                 defines: tuple = ()):
        self.name = name
        self.source = CSRC / source
        self.flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
        # C function name → (restype, argtypes)
        self.signatures = signatures
        self.launches = 0
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None
        self._scratch: dict = {}

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes()
                           + " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}-{h}.so"

    def _start_build(self) -> subprocess.Popen | None:
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        return subprocess.Popen(
            [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)],
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

    def scratch(self, words: int, dtype: torch.dtype, device: torch.device,
                stream: int, zeroed: bool = True) -> int | None:
        """The address of ``words`` words of ``dtype`` on ``device`` that
        the kernel keeps from call to call, or None for 0 words: one
        buffer per device and stream (``stream``, a ``cudaStream_t``),
        grown but never shrunk. A zeroed buffer is zeroed when it is made
        or grown, and the kernel must leave every word of it zero when it
        ends, so that no call needs a memset; the other buffer's content
        is the kernel's. Calls on one stream never overlap in either."""
        if words == 0:
            return None
        key = (device.index, stream, zeroed)
        buf = self._scratch.get(key)
        if buf is None or buf.numel() < words or buf.dtype != dtype:
            make = torch.zeros if zeroed else torch.empty
            buf = make(words, dtype=dtype, device=device)
            self._scratch[key] = buf
        return buf.data_ptr()


_sms: dict = {}


def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device, asked once."""
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


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
