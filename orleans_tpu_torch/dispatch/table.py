"""ShardedActorTable: device-resident activation state, sharded by shard row.

The port of ``orleans_tpu.dispatch.table``. Activation state for one
VectorGrain class lives in a slot pool of shape ``[n_shards, capacity+1,
*field]`` on the mesh's device. Slot ``capacity`` (the last row) is a
write sink for padding lanes, so masked scatters never collide with real
rows; its contents are undefined.

Key → shard is ``key % n_shards`` in the hashed regime; the slot within
the shard comes from a host-side free list. Two key regimes:

* **hashed** (general): host dict key→(shard, slot), mirrored on device by
  a ``DeviceDirectory64`` so sparse keys can be resolved in the tick.
* **dense** (bulk workloads, e.g. 1M Presence players with keys 0..N-1):
  ``ensure_dense(n)`` pre-provisions key → (key // per_shard, key %
  per_shard), so a contiguous key range is an exact reshape onto the
  ``[n_shards, B]`` batch layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..interop import state_from_numpy, torch_dtype
from ..ops.hash_probe import DeviceDirectory64
from ..parallel.mesh import Mesh
from .vector_grain import VectorGrain, vector_methods

# directory-value encoding stride: loc = shard * _LOC_STRIDE + slot. Fixed
# (not the live capacity) so encoded values survive table growth.
_LOC_STRIDE = 1 << 20

__all__ = ["ShardedActorTable"]


class ShardedActorTable:
    def __init__(self, grain_class: type[VectorGrain], mesh: Mesh,
                 capacity_per_shard: int = 1024):
        self.grain_class = grain_class
        self.mesh = mesh
        self.device = mesh.device
        self.n_shards = mesh.n_shards
        # power-of-two capacity: bounds distinct batch shapes and lets
        # padded buckets (also po2) slice the pool contiguously
        self.capacity = 1 << (int(capacity_per_shard) - 1).bit_length()
        self.methods = vector_methods(grain_class)
        self.key_to_slot: dict[int, tuple[int, int]] = {}
        self.device_dir = DeviceDirectory64(device=self.device)
        self.free: list[list[int]] = [
            list(range(self.capacity - 1, -1, -1))
            for _ in range(self.n_shards)]
        self.dense_n = 0  # keys [0, dense_n) are dense-mapped
        self.dense_per_shard = 0
        self.dense_active = np.zeros(0, dtype=bool)
        self.state: dict[str, torch.Tensor] = {
            name: self._zeros(name, self.capacity)
            for name in grain_class.STATE}

    def _zeros(self, name: str, capacity: int) -> torch.Tensor:
        dtype, shape = self.grain_class.STATE[name]
        return torch.zeros((self.n_shards, capacity + 1, *shape),
                           dtype=torch_dtype(dtype), device=self.device)

    @property
    def sink_slot(self) -> int:
        return self.capacity

    # -- dense regime -----------------------------------------------------
    def ensure_dense(self, n: int) -> None:
        """Pre-provision keys 0..n-1 with the block-wise dense mapping key
        → (key // per_shard, key % per_shard). Must come before any hashed
        allocation; the mapping is frozen at the first call."""
        if self.key_to_slot:
            raise RuntimeError(
                "dense mapping must be set up before hashed keys")
        if self.dense_per_shard:
            if n <= self.dense_per_shard * self.n_shards:
                if n > self.dense_n:
                    self.dense_active = np.concatenate(
                        [self.dense_active, np.zeros(n - self.dense_n, bool)])
                    self.dense_n = n
                return
            raise RuntimeError(
                f"dense keyspace exhausted ({n} > "
                f"{self.dense_per_shard * self.n_shards}); provision the "
                f"maximum population in the first ensure_dense call")
        per_shard = -(-n // self.n_shards)  # ceil
        if per_shard > self.capacity:
            self.grow(per_shard)
        self.dense_n = n
        self.dense_per_shard = per_shard
        # host-side activation bitmap: which dense keys were fresh-inited
        self.dense_active = np.zeros(n, dtype=bool)
        for s in range(self.n_shards):
            self.free[s] = [i for i in self.free[s]
                            if i >= self.dense_per_shard]

    def dense_fresh_mask(self, keys: np.ndarray) -> np.ndarray | None:
        """Bool [M] mask of dense keys not yet activated, or None when every
        key is already active."""
        if self.dense_active.size == 0:
            return None
        m = ~self.dense_active[keys]
        return m if m.any() else None

    def mark_dense_active(self, keys: np.ndarray) -> None:
        if self.dense_active.size:
            self.dense_active[keys] = True

    def dense_shard_slot(self, keys: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized key→(shard, slot) for dense keys (int array)."""
        per = max(self.dense_per_shard, 1)
        return keys // per, keys % per

    # -- hashed regime ----------------------------------------------------
    def lookup_or_allocate(self, key_hash: int) -> tuple[int, int, bool]:
        """Returns (shard, slot, fresh)."""
        loc = self.key_to_slot.get(key_hash)
        if loc is not None:
            return loc[0], loc[1], False
        shard = key_hash % self.n_shards
        if not self.free[shard]:
            self.grow(self.capacity * 2)
        slot = self.free[shard].pop()
        self.key_to_slot[key_hash] = (shard, slot)
        self.device_dir.insert(key_hash, self._encode_loc(shard, slot))
        return shard, slot, True

    @staticmethod
    def _encode_loc(shard: int, slot: int) -> int:
        """(shard, slot) as one int32 directory value."""
        assert slot < _LOC_STRIDE
        return shard * _LOC_STRIDE + slot

    def lookup(self, key_hash: int) -> tuple[int, int] | None:
        return self.key_to_slot.get(key_hash)

    def release(self, key_hash: int) -> bool:
        """Free a slot (deactivation). The row data stays; the next
        activation's fresh-init overwrites it."""
        loc = self.key_to_slot.pop(key_hash, None)
        if loc is None:
            return False
        self.free[loc[0]].append(loc[1])
        self.device_dir.remove(key_hash)
        return True

    # -- growth -----------------------------------------------------------
    def grow(self, new_capacity: int) -> None:
        """Grow every shard's slot pool to the next power of two at least
        ``new_capacity`` and twice the old one; rows keep their slots."""
        new_capacity = max(new_capacity, self.capacity * 2)
        new_capacity = 1 << (new_capacity - 1).bit_length()
        old = self.capacity
        for name, arr in self.state.items():
            grown = self._zeros(name, new_capacity)
            grown[:, :old] = arr[:, :old]  # the old sink row is junk
            self.state[name] = grown
        for s in range(self.n_shards):
            self.free[s] = list(range(new_capacity - 1, old - 1, -1)) \
                + self.free[s]
        self.capacity = new_capacity

    # -- host access (tests, persistence) ---------------------------------
    def read_row(self, key_hash: int) -> dict[str, np.ndarray] | None:
        loc = self.key_to_slot.get(key_hash)
        if loc is None:
            if 0 <= key_hash < self.dense_n:
                loc = (key_hash // self.dense_per_shard,
                       key_hash % self.dense_per_shard)
            else:
                return None
        shard, slot = loc
        return {k: v[shard, slot].cpu().numpy()
                for k, v in self.state.items()}

    def snapshot(self) -> dict[str, np.ndarray]:
        """Full host copy of the state (field → numpy [n, C+1, ...])."""
        return {k: v.cpu().numpy() for k, v in self.state.items()}

    def restore(self, snap: dict) -> None:
        """Replace the state with ``snap``: numpy arrays (a snapshot of
        either package's table) or tensors (``interop.state_from_numpy``).
        Each field is cast to its STATE dtype on this table's device."""
        tensors = state_from_numpy(
            {k: v for k, v in snap.items() if isinstance(v, np.ndarray)},
            self.device)
        for k, v in snap.items():
            t = tensors.get(k, v)
            dtype, shape = self.grain_class.STATE[k]
            want = (self.n_shards, self.capacity + 1, *shape)
            if tuple(t.shape) != want:
                raise ValueError(f"field {k!r}: shape {tuple(t.shape)}, "
                                 f"want {want}")
            self.state[k] = t.to(device=self.device,
                                 dtype=torch_dtype(dtype)).contiguous()
