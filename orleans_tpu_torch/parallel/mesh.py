"""Device mesh for the port: a shard count and one ``torch.device``.

The JAX package's mesh is a 1-D ``jax.sharding.Mesh`` over the ``"silo"``
axis. Here every shard lives on one device as a leading tensor dimension,
so ``shard_map`` becomes a batched index over dim 0 and the exchange's
``all_to_all`` becomes a transpose (parallel.transport).

A forked worker process of a multi-process silo (``runtime.multiproc``)
must never start CUDA: its parent holds a CUDA context, and torch cannot
initialize CUDA again in a forked child. ``_worker_main`` marks the
process (:func:`mark_worker_process`), and from then on the device entry
points (:func:`resolve_device`, so :func:`make_mesh` and the device
directories, and ``VectorRuntime``) raise :class:`WorkerProcessError`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["SILO_AXIS", "Mesh", "WorkerProcessError", "in_worker_process",
           "make_mesh", "mark_worker_process", "refuse_in_worker",
           "resolve_device"]

SILO_AXIS = "silo"

# set once in a forked worker process, never cleared: the process's own
# state, not a setting (see the module docstring)
_worker_process = False


class WorkerProcessError(RuntimeError):
    """A device entry point was called in a forked worker process, where
    only the owner process may touch the device."""


def mark_worker_process() -> None:
    """Mark this process as a forked silo worker (``_worker_main``)."""
    global _worker_process
    _worker_process = True


def in_worker_process() -> bool:
    return _worker_process


def refuse_in_worker(what: str) -> None:
    """Raise :class:`WorkerProcessError` naming ``what`` in a worker."""
    if _worker_process:
        raise WorkerProcessError(
            f"{what} in a forked worker process of a multi-process silo: "
            f"only the owner process touches the device (its vector calls "
            f"cross the staging ring to the owner's engine)")


@dataclass(frozen=True)
class Mesh:
    """``n_shards`` logical silo shards, all resident on ``device``."""

    n_shards: int
    device: torch.device


def make_mesh(n_shards: int = 1, device=None) -> Mesh:
    """Mesh of ``n_shards`` shards on ``device``.

    ``device=None`` means CUDA. Without CUDA this raises: pass
    ``device="cpu"`` to run the plain versions on the CPU explicitly.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return Mesh(int(n_shards), resolve_device(device))


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA, and raises when
    CUDA is absent instead of falling back to the CPU. Raises
    :class:`WorkerProcessError` in a forked worker process."""
    refuse_in_worker(f"resolve_device({device!r})")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None means CUDA, which is not available; pass "
                "device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)
