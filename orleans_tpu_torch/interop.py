"""Carry dtypes and table state across from numpy.

``ShardedActorTable.snapshot()`` in either package is a dict of numpy
``[n_shards, C+1, ...]`` arrays. ``state_from_numpy`` turns one into the
port's state dict on a device, and the port's ``ShardedActorTable.restore``
accepts it. Only numpy crosses: this module imports neither jax nor the
JAX package, so dtype names (``"float32"``, ``np.int32``, a jnp scalar
type) are resolved through numpy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["numpy_dtype", "state_from_numpy", "torch_dtype"]

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or scalar type,
    a dtype name, or a jnp scalar type (which numpy resolves by name)."""
    if isinstance(dt, torch.dtype):
        return dt
    try:
        return _NP_TO_TORCH[np.dtype(dt)]
    except (KeyError, TypeError) as e:
        raise TypeError(f"no torch dtype for {dt!r}") from e


def numpy_dtype(dt) -> np.dtype:
    """The numpy dtype of a torch dtype (or anything torch_dtype takes)."""
    return _TORCH_TO_NP[torch_dtype(dt)]


def state_from_numpy(snapshot: dict[str, np.ndarray],
                     device) -> dict[str, torch.Tensor]:
    """A table snapshot (field → numpy ``[n_shards, C+1, ...]``) as the
    port's state dict of tensors on ``device``, dtypes preserved."""
    # np.array copies: snapshots of device arrays are read-only views
    return {k: torch.from_numpy(np.array(v)).to(
                device=torch.device(device), dtype=torch_dtype(v.dtype))
            for k, v in snapshot.items()}
