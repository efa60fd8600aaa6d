"""Carry dtypes and table state across from numpy.

``ShardedActorTable.snapshot()`` in either package is a dict of numpy
``[n_shards, C+1, ...]`` arrays. ``state_from_numpy`` turns one into the
port's state dict on a device, and the port's ``ShardedActorTable.restore``
accepts it. ``carry_table`` carries a whole table across: state, the
dense regime, the hashed directory and the hit and cost counters. Only
numpy crosses: this module imports neither jax nor the JAX package, so
dtype names (``"float32"``, ``np.int32``, a jnp scalar type) are resolved
through numpy, and a JAX table is read through its attributes and its
arrays' ``__array__``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["carry_table", "numpy_dtype", "state_from_numpy",
           "torch_dtype"]

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


def carry_table(src, dst) -> None:
    """Make the port's table ``dst`` continue from ``src``, a table of
    either package with the same shard count: its state rows, its dense
    regime (mapping and activation bitmap), its hashed directory (key →
    (shard, slot), free lists, routing hashes; the device directory is
    rebuilt from them) and its hit and cost counters. ``dst`` grows to
    ``src``'s capacity; a larger ``dst`` is refused."""
    if src.n_shards != dst.n_shards:
        raise ValueError(f"shard counts differ: {src.n_shards} -> "
                         f"{dst.n_shards}; reshard the dense regime with "
                         f"dispatch.reshard_dense")
    with dst.fence:
        if dst.capacity < src.capacity:
            dst.grow(src.capacity)
        if dst.capacity != src.capacity:
            raise ValueError(f"capacity {dst.capacity} > {src.capacity}: "
                             f"build the destination table no larger")
        dst.restore(src.snapshot())
        dst.dense_n = int(src.dense_n)
        dst.dense_per_shard = int(src.dense_per_shard)
        dst.dense_active = np.array(src.dense_active, dtype=bool)
        dst.free = [list(f) for f in src.free]
        dst.key_to_slot = {int(k): (int(s), int(sl))
                           for k, (s, sl) in src.key_to_slot.items()}
        dst.route_hash = dict(getattr(src, "route_hash", {}))
        directory = type(dst.device_dir)(device=dst.device)
        for k, (s, sl) in dst.key_to_slot.items():
            directory.insert(k, dst._encode_loc(s, sl))
        dst.device_dir = directory
        for name in ("hits", "cost"):
            ctr = getattr(src, name, None)
            setattr(dst, name, None if ctr is None else torch.from_numpy(
                np.array(ctr, dtype=np.int32)).to(dst.device))
