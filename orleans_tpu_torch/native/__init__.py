"""Native runtime components (C extensions).

The reference runs its serializer/transport hot path in compiled code
(codegen'd C# + IL emission, SerializationManager.cs:50,133); this package
holds the port's native equivalents. Components:

* ``_hotwire`` — wire-tier value codec (see ``hotwire.c``).
* ``_hotloop`` — per-callback runner for the host-loop occupancy
  profiler (see ``hotloop.c``).

Build strategy: compile-on-first-use with the system toolchain (gcc/cc)
into ``orleans_tpu_torch/_build/`` (gitignored, beside the CUDA kernels'
libraries), each library named by the hash of its source so edits rebuild
automatically. No setuptools ceremony, no install step; if the toolchain
or headers are missing the caller falls back to the pure-Python path
(``ORLEANS_TPU_NATIVE=0`` forces that fallback).

The port's copy of ``orleans_tpu.native``. The C sources are copies of
the JAX package's, loaded under this package's module names
(``orleans_tpu_torch.native._hotwire``) from libraries at their own
paths, so a process that loads both packages keeps two codecs, each with
its own configured id types.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sysconfig
from pathlib import Path

log = logging.getLogger("orleans_tpu_torch.native")

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
_CACHED: dict[str, object] = {}


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _build(name: str, source: Path, tag: str) -> Path | None:
    """Compile ``source`` into ``_build/<name>.<tag>.so``; returns the path
    or None on toolchain failure."""
    so = BUILD_DIR / f"{name}.{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    cc = os.environ.get("CC", "gcc")
    # per-process tmp name: concurrent silo processes racing to build must
    # not interleave writes into one tmp file (os.replace itself is atomic)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cc, "-O2", "-g0", "-fPIC", "-shared", "-fvisibility=hidden",
           f"-I{include}", str(source), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native build unavailable (%s): %s", name, e)
        _unlink_quiet(tmp)
        return None
    if proc.returncode != 0:
        log.warning("native build failed (%s):\n%s", name, proc.stderr[-2000:])
        _unlink_quiet(tmp)
        return None
    os.replace(tmp, so)
    # retire stale builds of this module (old source hashes)
    for old in BUILD_DIR.glob(f"{name}.*.so"):
        if old != so:
            try:
                old.unlink()
            except OSError:
                pass
    return so


def load(name: str):
    """Load (building if needed) the native module ``name``; None if the
    environment can't build/load it."""
    if name in _CACHED:
        return _CACHED[name]
    mod = None
    if os.environ.get("ORLEANS_TPU_NATIVE", "1") != "0":
        source = _DIR / f"{name.lstrip('_')}.c"
        try:
            tag = hashlib.blake2b(source.read_bytes(),
                                  digest_size=8).hexdigest()
            so = _build(name, source, tag)
            if so is not None:
                spec = importlib.util.spec_from_file_location(
                    f"orleans_tpu_torch.native.{name}", so)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
        except Exception as e:  # noqa: BLE001 — never let native break import
            log.warning("native load failed (%s): %s", name, e)
            mod = None
    _CACHED[name] = mod
    return mod
