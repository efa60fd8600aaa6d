"""Device-resident directory: batched hash-probe lookup.

The port of ``orleans_tpu.ops.hash_probe``: an open-addressing table
(power-of-two capacity, linear probing, Knuth multiplicative hashing)
stored as int32 tensors. Inserts and removes are host-side on numpy
shadows; lookups are a batched device op, so a tick resolves thousands of
``key → slot`` routes without a host round-trip.

Lookup is P parallel gathers, not a hand-written kernel, as in the JAX
package: a [B, P] gather from a device-resident table has no fusion or
blocking a kernel would add.

The probe hash is the JAX package's uint32 arithmetic, computed in int64
and masked to 32 bits, so probe sequences (and therefore which cell holds
which key) match it exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import resolve_device

__all__ = ["EMPTY", "build_directory_arrays", "device_lookup",
           "DeviceDirectory", "device_lookup64", "DeviceDirectory64",
           "split64"]

EMPTY = -1
_MULT = 2654435761  # Knuth multiplicative hash


def _hash_np(keys: np.ndarray, cap: int) -> np.ndarray:
    return ((keys.astype(np.uint32) * np.uint32(_MULT)) >> np.uint32(1)) \
        % np.uint32(cap)


def _hash_t(k31: torch.Tensor, cap: int) -> torch.Tensor:
    """uint32 ``(k * MULT) >> 1 % cap`` for non-negative 31-bit keys; the
    int64 product stays below 2^63, the mask gives the uint32 wrap."""
    h = ((k31.to(torch.int64) * _MULT) & 0xFFFFFFFF) >> 1
    return h % cap


def _check_key(key: int) -> int:
    """Keys live in the 31-bit uniform-hash domain (int32 table cells with
    EMPTY = -1); reject anything wider instead of silently aliasing."""
    if not 0 <= key < 2**31:
        raise ValueError(
            f"directory keys must be 31-bit uniform hashes, got {key}; "
            f"reduce with `key & 0x7FFFFFFF` at the call site")
    return key


def build_directory_arrays(entries: dict[int, int], capacity: int,
                           max_probes: int = 16):
    """Host-build (tkeys, tvals) int32 numpy arrays from key→value pairs.

    capacity must be a power of two and at least twice len(entries).
    """
    if capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    if len(entries) * 2 > capacity:
        raise ValueError(
            f"load factor too high: {len(entries)} entries / {capacity}")
    tkeys = np.full(capacity, EMPTY, dtype=np.int32)
    tvals = np.zeros(capacity, dtype=np.int32)
    for k, v in entries.items():
        k31 = _check_key(k)
        h = int(_hash_np(np.asarray(k31), capacity))
        for p in range(max_probes):
            idx = (h + p) % capacity
            if tkeys[idx] == EMPTY or tkeys[idx] == k31:
                tkeys[idx] = k31
                tvals[idx] = v
                break
        else:
            raise RuntimeError(
                f"probe depth {max_probes} exhausted inserting {k}")
    return tkeys, tvals


def _probe(cells_match, cells_key, tvals, probes):
    """First hit before the first EMPTY cell of each probe row."""
    before_empty = torch.cumprod((cells_key != EMPTY).to(torch.int32),
                                 dim=1).bool()
    hit = cells_match & before_empty
    found = hit.any(dim=1)
    first = torch.argmax(hit.to(torch.int32), dim=1)  # first max wins
    vals = tvals[probes.gather(1, first[:, None])[:, 0]]
    return torch.where(found, vals, torch.zeros_like(vals)), found


def _probes(k31: torch.Tensor, cap: int, max_probes: int) -> torch.Tensor:
    steps = torch.arange(max_probes, dtype=torch.int64, device=k31.device)
    return (_hash_t(k31, cap)[:, None] + steps) % cap          # [B, P]


def device_lookup(tkeys: torch.Tensor, tvals: torch.Tensor,
                  keys: torch.Tensor, max_probes: int = 16):
    """Batched lookup: keys [B] → (vals [B] int32, found [B] bool).
    Missing keys return (0, False); keys are reduced to 31 bits."""
    cap = tkeys.shape[0]
    k31 = (keys & 0x7FFFFFFF).to(torch.int32)
    probes = _probes(k31, cap, max_probes)
    tk = tkeys[probes]                                          # [B, P]
    return _probe(tk == k31[:, None], tk, tvals, probes)


def split64(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split uint64-domain keys into (lo31, hi31) int32 halves — the wire
    layout for 62-bit uniform hashes in 32-bit device lanes."""
    k = np.asarray(keys, dtype=np.int64)
    lo = (k & 0x7FFFFFFF).astype(np.int32)
    hi = ((k >> 31) & 0x7FFFFFFF).astype(np.int32)
    return lo, hi


def device_lookup64(tk_lo: torch.Tensor, tk_hi: torch.Tensor,
                    tvals: torch.Tensor, keys_lo: torch.Tensor,
                    keys_hi: torch.Tensor, max_probes: int = 16):
    """Batched lookup with FULL 62-bit key identity: (lo, hi) [B] int32
    halves → (vals [B] int32, found [B] bool). The probe hash comes from
    the low half; a hit requires BOTH halves to match."""
    cap = tk_lo.shape[0]
    lo = (keys_lo & 0x7FFFFFFF).to(torch.int32)
    hi = (keys_hi & 0x7FFFFFFF).to(torch.int32)
    probes = _probes(lo, cap, max_probes)
    plo = tk_lo[probes]                                         # [B, P]
    phi = tk_hi[probes]
    match = (plo == lo[:, None]) & (phi == hi[:, None])
    return _probe(match, plo, tvals, probes)


class DeviceDirectory64:
    """Host-mutated, device-queried directory over full 62-bit keys:
    (lo31, hi31) split cells, linear probing on the low half, backward-
    shift delete. The key→slot map for sparse vector-grain keys in the
    on-device routing path (route/apply_received sparse mode)."""

    def __init__(self, capacity: int = 1024, max_probes: int = 16,
                 device=None):
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self.device = resolve_device(device)
        self.capacity = capacity
        self.max_probes = max_probes
        self.tk_lo = np.full(capacity, EMPTY, dtype=np.int32)
        self.tk_hi = np.zeros(capacity, dtype=np.int32)
        self.tvals = np.zeros(capacity, dtype=np.int32)
        self.count = 0
        self._dev: tuple[torch.Tensor, ...] | None = None

    @staticmethod
    def _split(key: int) -> tuple[int, int]:
        if key < 0:
            raise ValueError(f"directory keys must be non-negative: {key}")
        return key & 0x7FFFFFFF, (key >> 31) & 0x7FFFFFFF

    def _probe_host(self, lo: int, hi: int) -> int | None:
        h = int(_hash_np(np.asarray(lo), self.capacity))
        for p in range(self.max_probes):
            idx = (h + p) % self.capacity
            if self.tk_lo[idx] == EMPTY or (
                    self.tk_lo[idx] == lo and self.tk_hi[idx] == hi):
                return idx
        return None

    def insert(self, key: int, val: int) -> None:
        if (self.count + 1) * 2 > self.capacity:
            self._grow()
        lo, hi = self._split(key)
        idx = self._probe_host(lo, hi)
        if idx is None:
            self._grow()
            idx = self._probe_host(lo, hi)
            assert idx is not None
        if self.tk_lo[idx] == EMPTY:
            self.count += 1
        self.tk_lo[idx] = lo
        self.tk_hi[idx] = hi
        self.tvals[idx] = val
        self._dev = None

    def remove(self, key: int) -> bool:
        lo, hi = self._split(key)
        h = int(_hash_np(np.asarray(lo), self.capacity))
        idx = None
        for p in range(self.max_probes):
            i = (h + p) % self.capacity
            if self.tk_lo[i] == lo and self.tk_hi[i] == hi:
                idx = i
                break
            if self.tk_lo[i] == EMPTY:
                return False
        if idx is None:
            return False
        self.tk_lo[idx] = EMPTY
        self.count -= 1
        j = (idx + 1) % self.capacity
        moved: list[tuple[int, int, int]] = []
        while self.tk_lo[j] != EMPTY:
            moved.append((int(self.tk_lo[j]), int(self.tk_hi[j]),
                          int(self.tvals[j])))
            self.tk_lo[j] = EMPTY
            self.count -= 1
            j = (j + 1) % self.capacity
        for mlo, mhi, mv in moved:
            i2 = self._probe_host(mlo, mhi)
            assert i2 is not None
            if self.tk_lo[i2] == EMPTY:
                self.count += 1
            self.tk_lo[i2] = mlo
            self.tk_hi[i2] = mhi
            self.tvals[i2] = mv
        self._dev = None
        return True

    def _grow(self) -> None:
        old = [(int(lo) | (int(hi) << 31), int(v))
               for lo, hi, v in zip(self.tk_lo, self.tk_hi, self.tvals)
               if lo != EMPTY]
        self.capacity *= 2
        self.tk_lo = np.full(self.capacity, EMPTY, dtype=np.int32)
        self.tk_hi = np.zeros(self.capacity, dtype=np.int32)
        self.tvals = np.zeros(self.capacity, dtype=np.int32)
        self.count = 0
        self._dev = None
        for k, v in old:
            self.insert(k, v)

    def device_arrays(self) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        if self._dev is None:
            self._dev = tuple(torch.from_numpy(a.copy()).to(self.device)
                              for a in (self.tk_lo, self.tk_hi, self.tvals))
        return self._dev

    def lookup_batch(self, keys_lo, keys_hi):
        lo, hi, tv = self.device_arrays()
        return device_lookup64(lo, hi, tv,
                               torch.as_tensor(keys_lo, device=self.device),
                               torch.as_tensor(keys_hi, device=self.device),
                               self.max_probes)

    def lookup(self, key: int) -> int | None:
        lo, hi = self._split(key)
        idx = self._probe_host(lo, hi)
        if idx is None or self.tk_lo[idx] != lo:
            return None
        return int(self.tvals[idx])


class DeviceDirectory:
    """Host-mutated, device-queried 31-bit key→slot directory (the
    directory-cache tier). Host writes go to numpy shadows; the device
    copy refreshes lazily on the next batched lookup."""

    def __init__(self, capacity: int = 1024, max_probes: int = 16,
                 device=None):
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self.device = resolve_device(device)
        self.capacity = capacity
        self.max_probes = max_probes
        self.tkeys = np.full(capacity, EMPTY, dtype=np.int32)
        self.tvals = np.zeros(capacity, dtype=np.int32)
        self.count = 0
        self._dev: tuple[torch.Tensor, torch.Tensor] | None = None

    def _probe_host(self, k31: int) -> int | None:
        h = int(_hash_np(np.asarray(k31), self.capacity))
        for p in range(self.max_probes):
            idx = (h + p) % self.capacity
            tk = self.tkeys[idx]
            if tk == EMPTY or tk == k31:
                return idx
        return None

    def insert(self, key: int, val: int) -> None:
        if (self.count + 1) * 2 > self.capacity:
            self._grow()
        k31 = _check_key(key)
        idx = self._probe_host(k31)
        if idx is None:
            self._grow()
            idx = self._probe_host(k31)
            assert idx is not None
        if self.tkeys[idx] == EMPTY:
            self.count += 1
        self.tkeys[idx] = k31
        self.tvals[idx] = val
        self._dev = None

    def remove(self, key: int) -> bool:
        """Tombstone-free removal: re-insert the tail of the probe cluster
        (backward-shift delete)."""
        k31 = _check_key(key)
        h = int(_hash_np(np.asarray(k31), self.capacity))
        idx = None
        for p in range(self.max_probes):
            i = (h + p) % self.capacity
            if self.tkeys[i] == k31:
                idx = i
                break
            if self.tkeys[i] == EMPTY:
                return False
        if idx is None:
            return False
        self.tkeys[idx] = EMPTY
        self.count -= 1
        j = (idx + 1) % self.capacity
        moved: list[tuple[int, int]] = []
        while self.tkeys[j] != EMPTY:
            moved.append((int(self.tkeys[j]), int(self.tvals[j])))
            self.tkeys[j] = EMPTY
            self.count -= 1
            j = (j + 1) % self.capacity
        for k, v in moved:
            # re-insert without growth: these entries already fit
            i2 = self._probe_host(k)
            assert i2 is not None
            if self.tkeys[i2] == EMPTY:
                self.count += 1
            self.tkeys[i2] = k
            self.tvals[i2] = v
        self._dev = None
        return True

    def _grow(self) -> None:
        entries = {int(k): int(v)
                   for k, v in zip(self.tkeys, self.tvals) if k != EMPTY}
        self.capacity *= 2
        self.tkeys, self.tvals = build_directory_arrays(
            entries, self.capacity, self.max_probes)
        self._dev = None

    def device_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._dev is None:
            self._dev = (torch.from_numpy(self.tkeys.copy()).to(self.device),
                         torch.from_numpy(self.tvals.copy()).to(self.device))
        return self._dev

    def lookup_batch(self, keys):
        tk, tv = self.device_arrays()
        return device_lookup(tk, tv,
                             torch.as_tensor(keys, device=self.device),
                             self.max_probes)

    def lookup(self, key: int) -> int | None:
        k31 = _check_key(key)
        idx = self._probe_host(k31)
        if idx is None or self.tkeys[idx] != k31:
            return None
        return int(self.tvals[idx])
