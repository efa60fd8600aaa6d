"""ShardedActorTable: device-resident activation state, sharded by shard row.

The port of ``orleans_tpu.dispatch.table``. Activation state for one
VectorGrain class lives in a slot pool of shape ``[n_shards, capacity+1,
*field]`` on the mesh's device. Slot ``capacity`` (the last row) is a
write sink for padding lanes, so masked scatters never collide with real
rows; its contents are undefined.

Key → shard is ``key % n_global`` in the hashed regime (``n_global`` is
the mesh's shard count); the slot within the shard comes from a
host-side free list. Two key regimes:

* **hashed** (general): host dict key→(shard, slot), mirrored on device by
  a ``DeviceDirectory64`` so sparse keys can be resolved in the tick.
* **dense** (bulk workloads, e.g. 1M Presence players with keys 0..N-1):
  ``ensure_dense(n)`` pre-provisions key → (key // per_shard, key %
  per_shard), so a contiguous key range is an exact reshape onto the
  ``[n_shards, B]`` batch layout.

On a mesh over a process group the table holds only this rank's
``[n_local, capacity+1, *field]`` pools: ``n_shards`` is the rows held
here, ``n_global`` the mesh's shards, and both regimes map keys over
``n_global`` (global shard ``shard0 + row``). The host bookkeeping is
one controller's, kept alike on every rank: ``key_to_slot``, the free
lists of all ``n_global`` shards, the directory with global locations,
``dense_active`` and ``route_hash``. So every rank must make the same
calls in the same order; ``grow`` then runs on every rank alike.
``move_rows`` (rows between ranks) raises ``GroupMeshError``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..interop import state_from_numpy, torch_dtype
from ..ops.hash_probe import DeviceDirectory64
from ..parallel.mesh import Mesh, refuse_on_group
from .vector_grain import VectorGrain, vector_methods

# directory-value encoding stride: loc = shard * _LOC_STRIDE + slot. Fixed
# (not the live capacity) so encoded values survive table growth.
_LOC_STRIDE = 1 << 20

__all__ = ["ShardedActorTable"]


def _accumulate_hits(hits: torch.Tensor, slots_b, valid_b,
                     scale: int) -> None:
    """Add ``scale`` per valid lane into the ``[n, C+1]`` int32 counter at
    (shard, slot), in place. Padding lanes aim at the sink row with
    weight 0, so the fold needs no host sync and no data-dependent
    shape."""
    dev = hits.device
    slots = torch.as_tensor(slots_b).to(device=dev, dtype=torch.int64)
    valid = torch.as_tensor(valid_b).to(dev)
    n, B = slots.shape
    shard = torch.arange(n, device=dev)[:, None].expand(n, B)
    hits.index_put_((shard, slots), valid.to(torch.int32) * int(scale),
                    accumulate=True)


class ShardedActorTable:
    def __init__(self, grain_class: type[VectorGrain], mesh: Mesh,
                 capacity_per_shard: int = 1024):
        self.grain_class = grain_class
        self.mesh = mesh
        self.device = mesh.device
        # rows held on this process; the dense mapping spans n_global
        self.n_shards = mesh.n_local
        self.n_global = mesh.n_shards
        self.shard0 = mesh.shard0
        # power-of-two capacity: bounds distinct batch shapes and lets
        # padded buckets (also po2) slice the pool contiguously
        self.capacity = 1 << (int(capacity_per_shard) - 1).bit_length()
        self.methods = vector_methods(grain_class)
        # tick-serialization fence: grow, move_rows, read_row,
        # snapshot/restore and the counters take it, so they never
        # interleave with a batch of the engine's off-loop worker;
        # VectorRuntime.register replaces it with the engine's own lock
        self.fence = threading.RLock()
        self.key_to_slot: dict[int, tuple[int, int]] = {}
        self.device_dir = DeviceDirectory64(device=self.device)
        # key_hash -> the GrainId uniform hash that routes it, where they
        # differ (small int keys): what an ownership sweep reads
        self.route_hash: dict[int, int] = {}
        # free slots of every global shard (replicated on a group)
        self.free: list[list[int]] = [
            list(range(self.capacity - 1, -1, -1))
            for _ in range(self.n_global)]
        self.dense_n = 0  # keys [0, dense_n) are dense-mapped
        self.dense_per_shard = 0
        self.dense_active = np.zeros(0, dtype=bool)
        # called with the keys of a bulk tick before their fresh mask is
        # read (a storage bridge's VectorStorageBridge.rehydrate); None
        # without write-behind storage
        self.rehydrate = None
        self.state: dict[str, torch.Tensor] = {
            name: self._zeros(name, self.capacity)
            for name in grain_class.STATE}
        # per-slot invocation counters and per-slot tick cost in
        # microseconds, [n_shards, C+1] int32 with the sink row absorbing
        # padding lanes; None until enabled
        self.hits: torch.Tensor | None = None
        self.cost: torch.Tensor | None = None

    def _zeros(self, name: str, capacity: int) -> torch.Tensor:
        dtype, shape = self.grain_class.STATE[name]
        return torch.zeros((self.n_shards, capacity + 1, *shape),
                           dtype=torch_dtype(dtype), device=self.device)

    def _counter(self, capacity: int) -> torch.Tensor:
        return torch.zeros((self.n_shards, capacity + 1), dtype=torch.int32,
                           device=self.device)

    @property
    def sink_slot(self) -> int:
        return self.capacity

    def active_count(self) -> int:
        """Live activations: hashed slots plus dense keys touched."""
        return len(self.key_to_slot) + int(self.dense_active.sum())

    # -- hot-spot telemetry (per-slot hit counters) -----------------------
    def enable_hit_tracking(self) -> None:
        with self.fence:
            if self.hits is None:
                self.hits = self._counter(self.capacity)

    def record_hits(self, slots_b, valid_b, scale: int = 1) -> None:
        """Fold one tick's [n_shards, B] batch (numpy or tensors) into the
        hit counters; ``scale`` messages per lane (K for K rounds)."""
        with self.fence:
            if self.hits is not None:
                _accumulate_hits(self.hits, slots_b, valid_b, scale)

    def shard_hits(self) -> np.ndarray:
        """[n_shards] invocation totals since the last reset, sink row
        excluded."""
        with self.fence:
            if self.hits is None:
                return np.zeros(self.n_shards, dtype=np.int64)
            return self.hits[:, :self.capacity].sum(dim=1).to(
                torch.int32).cpu().numpy().astype(np.int64)

    def slot_hits(self) -> np.ndarray:
        with self.fence:
            if self.hits is None:
                return np.zeros((self.n_shards, self.capacity + 1), np.int32)
            return self.hits.cpu().numpy().copy()

    def reset_hits(self) -> None:
        with self.fence:
            if self.hits is not None:
                self.hits = self._counter(self.capacity)

    # -- cost attribution (per-slot tick cost, microseconds) --------------
    def enable_cost_tracking(self) -> None:
        with self.fence:
            if self.cost is None:
                self.cost = self._counter(self.capacity)

    def record_cost(self, slots_b, valid_b, cost_us: int) -> None:
        """Charge every valid lane of one tick ``cost_us`` microseconds."""
        with self.fence:
            if self.cost is not None and cost_us > 0:
                _accumulate_hits(self.cost, slots_b, valid_b, cost_us)

    def slot_cost(self) -> np.ndarray:
        with self.fence:
            if self.cost is None:
                return np.zeros((self.n_shards, self.capacity + 1), np.int32)
            return self.cost.cpu().numpy().copy()

    def cost_seconds(self) -> float:
        """Charged row-seconds since the last reset, summed on the device
        with the sink column masked out."""
        with self.fence:
            if self.cost is None:
                return 0.0
            from ..ops.segment_reduce import masked_reduce
            valid = (torch.arange(self.capacity + 1, device=self.device)
                     < self.capacity).expand(self.n_shards, -1)
            return float(masked_reduce(self.cost, valid, "sum")) * 1e-6

    def reset_cost(self) -> None:
        with self.fence:
            if self.cost is not None:
                self.cost = self._counter(self.capacity)

    # -- dense regime -----------------------------------------------------
    def ensure_dense(self, n: int) -> None:
        """Pre-provision keys 0..n-1 with the block-wise dense mapping key
        → (key // per_shard, key % per_shard). Must come before any hashed
        allocation; the mapping is frozen at the first call."""
        if self.key_to_slot:
            raise RuntimeError(
                "dense mapping must be set up before hashed keys")
        if self.dense_per_shard:
            if n <= self.dense_per_shard * self.n_global:
                if n > self.dense_n:
                    self.dense_active = np.concatenate(
                        [self.dense_active, np.zeros(n - self.dense_n, bool)])
                    self.dense_n = n
                return
            raise RuntimeError(
                f"dense keyspace exhausted ({n} > "
                f"{self.dense_per_shard * self.n_global}); provision the "
                f"maximum population in the first ensure_dense call")
        per_shard = -(-n // self.n_global)  # ceil
        if per_shard > self.capacity:
            self.grow(per_shard)
        self.dense_n = n
        self.dense_per_shard = per_shard
        # host-side activation bitmap: which dense keys were fresh-inited
        self.dense_active = np.zeros(n, dtype=bool)
        for s in range(self.n_global):
            self.free[s] = [i for i in self.free[s]
                            if i >= self.dense_per_shard]

    def dense_fresh_mask(self, keys: np.ndarray) -> np.ndarray | None:
        """Bool [M] mask of dense keys not yet activated, or None when every
        key is already active."""
        if self.dense_active.size == 0:
            return None
        if self.rehydrate is not None:
            self.rehydrate(keys)
        m = ~self.dense_active[keys]
        return m if m.any() else None

    def mark_dense_active(self, keys: np.ndarray) -> None:
        if self.dense_active.size:
            self.dense_active[keys] = True

    def dense_shard_slot(self, keys: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized key→(global shard, slot) for dense keys (int
        array); the row on this process is ``shard - shard0``."""
        per = max(self.dense_per_shard, 1)
        return keys // per, keys % per

    # -- hashed regime ----------------------------------------------------
    def lookup_or_allocate(self, key_hash: int) -> tuple[int, int, bool]:
        """Returns (global shard, slot, fresh)."""
        loc = self.key_to_slot.get(key_hash)
        if loc is not None:
            return loc[0], loc[1], False
        shard = key_hash % self.n_global
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
        self.route_hash.pop(key_hash, None)
        return True

    def move_rows(self, keys, dest_shards) -> int:
        """Live-migrate hashed rows to other shards under the fence: a
        move reads and replaces ``state``, which must not interleave with
        a batch of the off-loop worker. Keeping pending or in-flight calls
        off a moving key stays the caller's job
        (``VectorRuntime.pending_key_hashes``). Raises ``GroupMeshError``
        on a group mesh: rows between ranks are rebalancing, queued."""
        refuse_on_group(self.mesh, "move_rows")
        with self.fence:
            return self._move_rows(keys, dest_shards)

    def _move_rows(self, keys, dest_shards) -> int:
        """Move each resident hashed key to a freshly allocated slot on
        its destination shard: copy its state row and its hit and cost
        counters there, zero the counters it left, then re-point the host
        maps and the on-device directory. Keys not resident, already on
        their destination, repeated, or whose destination has no free
        slot are skipped (a move never grows the pool). Returns the rows
        moved.

        The copy writes into clones and swaps them in at one commit
        point, so the live pools stay the rollback snapshot until then:
        a failure before the commit leaves state, counters, free lists
        and directory as they were."""
        src_sh, src_sl, dst_sh, dst_sl, moved_keys = [], [], [], [], []
        taken: dict[int, int] = {}  # dest shard -> slots claimed this call
        seen: set[int] = set()
        for key, dest in zip(keys, dest_shards):
            key, dest = int(key), int(dest)
            loc = self.key_to_slot.get(key)
            if key in seen or loc is None or loc[0] == dest or \
                    not (0 <= dest < self.n_shards):
                continue
            seen.add(key)
            n_taken = taken.get(dest, 0)
            if n_taken >= len(self.free[dest]):
                continue  # destination full: skip, never grow mid-move
            taken[dest] = n_taken + 1
            src_sh.append(loc[0])
            src_sl.append(loc[1])
            dst_sh.append(dest)
            # peek (no pop): a failure below leaves the free lists intact
            dst_sl.append(self.free[dest][-1 - n_taken])
            moved_keys.append(key)
        if not moved_keys:
            return 0
        src = (torch.tensor(src_sh, device=self.device),
               torch.tensor(src_sl, device=self.device))
        dst = (torch.tensor(dst_sh, device=self.device),
               torch.tensor(dst_sl, device=self.device))

        def moved(arr: torch.Tensor, zero_source: bool) -> torch.Tensor:
            out = arr.clone()
            out[dst] = arr[src]
            if zero_source:
                out[src] = 0
            return out

        new_state = {k: moved(v, False) for k, v in self.state.items()}
        # counters travel with the row: the next view of a key's heat and
        # cost must be at its new home, not a ghost at the old one
        new_hits = None if self.hits is None else moved(self.hits, True)
        new_cost = None if self.cost is None else moved(self.cost, True)
        self.state, self.hits, self.cost = new_state, new_hits, new_cost
        # the claimed slots are the tail of each destination's free list
        # (peeked above): cut them off in one step, not one list search a
        # key
        for d_sh, n_taken in taken.items():
            del self.free[d_sh][-n_taken:]
        for key, s_sh, s_sl, d_sh, d_sl in zip(
                moved_keys, src_sh, src_sl, dst_sh, dst_sl):
            self.free[s_sh].append(s_sl)
            self.key_to_slot[key] = (d_sh, d_sl)
            self.device_dir.remove(key)
            self.device_dir.insert(key, self._encode_loc(d_sh, d_sl))
        return len(moved_keys)

    def note_route(self, key_hash: int, uniform_hash: int) -> None:
        """Record the routing hash of a hashed key (every entry point that
        knows the GrainId calls this)."""
        if key_hash != uniform_hash:
            self.route_hash[key_hash] = uniform_hash

    def note_route_many(self, pairs) -> None:
        """Batched :meth:`note_route` over (key_hash, uniform_hash) pairs
        already filtered to key_hash != uniform_hash."""
        self.route_hash.update(pairs)

    def unowned_keys(self, still_owned) -> list[int]:
        """Hashed rows whose ring owner is no longer this silo: keys whose
        routing hash (the key hash where none was noted) fails
        ``still_owned``. Dense rows are not swept."""
        return [kh for kh in self.key_to_slot
                if not still_owned(self.route_hash.get(kh, kh))]

    # -- growth -----------------------------------------------------------
    def grow(self, new_capacity: int) -> None:
        """Grow every shard's slot pool to the next power of two at least
        ``new_capacity`` and twice the old one; rows keep their slots.
        Under the fence: growth swaps ``state`` and moves the sink, which
        a worker batch in flight must not see half done."""
        with self.fence:
            self._grow(new_capacity)

    def _grow(self, new_capacity: int) -> None:
        new_capacity = max(new_capacity, self.capacity * 2)
        new_capacity = 1 << (new_capacity - 1).bit_length()
        old = self.capacity
        for name, arr in self.state.items():
            grown = self._zeros(name, new_capacity)
            grown[:, :old] = arr[:, :old]  # the old sink row is junk
            self.state[name] = grown
        for name in ("hits", "cost"):
            old_ctr = getattr(self, name)
            if old_ctr is not None:
                grown = self._counter(new_capacity)
                grown[:, :old] = old_ctr[:, :old]
                setattr(self, name, grown)
        for s in range(self.n_global):
            self.free[s] = list(range(new_capacity - 1, old - 1, -1)) \
                + self.free[s]
        self.capacity = new_capacity

    # -- host access (tests, persistence) ---------------------------------
    def read_row(self, key_hash: int) -> dict[str, np.ndarray] | None:
        with self.fence:
            return self._read_row(key_hash)

    def _read_row(self, key_hash: int) -> dict[str, np.ndarray] | None:
        """The row of ``key_hash`` from this process's pools; a key whose
        shard another rank holds raises ``ValueError``."""
        loc = self.key_to_slot.get(key_hash)
        if loc is None:
            if not 0 <= key_hash < self.dense_n:
                return None
            loc = (key_hash // self.dense_per_shard,
                   key_hash % self.dense_per_shard)
        shard, slot = loc[0] - self.shard0, loc[1]
        if not 0 <= shard < self.n_shards:
            raise ValueError(
                f"key {key_hash} lives on global shard {loc[0]}, not on "
                f"rank {self.mesh.rank}'s shards")
        return {k: v[shard, slot].cpu().numpy().copy()
                for k, v in self.state.items()}

    def snapshot(self) -> dict[str, np.ndarray]:
        """Full host copy of the state (field → numpy [n, C+1, ...]),
        owning its memory (on the CPU the pool is the same buffer)."""
        with self.fence:
            return {k: v.cpu().numpy().copy() for k, v in self.state.items()}

    def restore(self, snap: dict) -> None:
        """Replace the state with ``snap``: numpy arrays (a snapshot of
        either package's table) or tensors (``interop.state_from_numpy``).
        Each field is cast to its STATE dtype on this table's device."""
        with self.fence:
            self._restore(snap)

    def _restore(self, snap: dict) -> None:
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
