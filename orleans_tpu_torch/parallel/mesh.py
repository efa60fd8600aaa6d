"""Device mesh for the port: a shard count and one ``torch.device``.

The JAX package's mesh is a 1-D ``jax.sharding.Mesh`` over the ``"silo"``
axis. Here every shard lives on one device as a leading tensor dimension,
so ``shard_map`` becomes a batched index over dim 0 and the exchange's
``all_to_all`` becomes a transpose (parallel.transport).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["SILO_AXIS", "Mesh", "make_mesh", "resolve_device"]

SILO_AXIS = "silo"


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
    CUDA is absent instead of falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None means CUDA, which is not available; pass "
                "device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)
