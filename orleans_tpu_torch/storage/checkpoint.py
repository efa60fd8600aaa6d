"""Checkpoint/resume for the device tier: whole-table snapshots +
write-behind per-actor persistence.

The reference has no cluster-wide checkpoint — durable truth is per-grain
storage (Grain<TState> via StateStorageBridge.cs:11,49,80,107) plus the
membership table (SURVEY.md §5 "Checkpoint / resume"). The device tier
keeps that contract and adds two recovery paths:

* **whole-silo resume** — ``VectorCheckpointer.save(step)`` writes every
  table (state copied to the host + its bookkeeping); after restart
  ``restore()`` rebuilds every table and its host bookkeeping.
* **per-actor lazy resume** — ``VectorStorageBridge.flush(keys)`` write-
  behind after ticks; on re-activation ``load(keys)`` writes stored rows
  back into the table (the virtual-actor guarantee: the next call finds
  the state, wherever the actor lands).

The port of ``orleans_tpu.storage.checkpoint``. Orbax becomes
``torch.save``/``torch.load(weights_only=True)``: step ``s`` is the
directory ``<dir>/<s>/`` holding ``state.pt`` (every table's state
tensors on the host, by class name and field) and ``meta.json`` (each
table's bookkeeping, as the JAX package's ``_table_meta``). A write goes
to a temporary directory beside it and is moved into place with
``os.replace``, so a reader sees a whole step or none. The bridge's
``load`` writes rows with an in-place ``index_put_`` on the slot pool
under the tick fence. ``restore`` also rebuilds the on-device directory
of hashed keys and the hit/cost counters at the restored capacity, which
the JAX package's restore leaves as they were.

Two more departures from the JAX package, both repairs. A write-behind
flush writes ``FLUSH_SLICE`` rows at a time and yields to the event loop
between slices, so a flush of a million rows no longer holds the loop
(and every response timeout) for its whole length. And a dense row
released after an etag conflict keeps the stored state and etag read at
the conflict, which the bulk paths (``call_batch``, ``call_batch_rounds``,
``broadcast_actors``) write back before they would fresh-init the key:
the reference rebuilds such a row from storage only on the routed path,
so a bulk call started it from ``initial_state`` and the next flush
overwrote the newer stored state.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import shutil
import threading
import uuid
from typing import TYPE_CHECKING, Iterable

import numpy as np
import torch

from ..core.errors import InconsistentStateError
from ..core.ids import GrainId, GrainType
from ..interop import numpy_dtype, torch_dtype
from .core import GrainStorage

if TYPE_CHECKING:
    from ..dispatch.engine import VectorRuntime

__all__ = ["VectorCheckpointer", "VectorStorageBridge"]

_STATE_FILE = "state.pt"
_META_FILE = "meta.json"
# rows a write-behind flush writes between two yields to the event loop
FLUSH_SLICE = 1024


class _ConflictReleased(Exception):
    """Internal flush marker: this key's etag conflicted (another silo
    flushed it since we last did), so the local row was released —
    deactivate-and-rebuild, never overwrite. Not a flush failure."""

    def __init__(self, key: int):
        super().__init__(key)
        self.key = key


def _table_meta(tbl) -> dict:
    return {
        "capacity": tbl.capacity,
        "dense_n": tbl.dense_n,
        "dense_per_shard": tbl.dense_per_shard,
        "dense_active": [int(i) for i in np.flatnonzero(tbl.dense_active)],
        "key_to_slot": {str(k): list(v) for k, v in tbl.key_to_slot.items()},
        "route_hash": {str(k): int(v) for k, v in tbl.route_hash.items()},
        "free": [list(f) for f in tbl.free],
    }


def _apply_meta(tbl, meta: dict) -> None:
    # capacity is taken from the checkpoint verbatim (the state tensors are
    # replaced wholesale right after; grow() would only churn buffers)
    tbl.capacity = meta["capacity"]
    tbl.dense_n = meta["dense_n"]
    tbl.dense_per_shard = meta["dense_per_shard"]
    tbl.dense_active = np.zeros(tbl.dense_n, dtype=bool)
    if meta["dense_active"]:
        tbl.dense_active[np.asarray(meta["dense_active"], int)] = True
    tbl.key_to_slot = {int(k): tuple(v)
                       for k, v in meta["key_to_slot"].items()}
    tbl.route_hash = {int(k): int(v)
                      for k, v in meta.get("route_hash", {}).items()}
    tbl.free = [list(f) for f in meta["free"]]
    # the on-device directory of hashed keys follows key_to_slot
    directory = type(tbl.device_dir)(device=tbl.device)
    for k, (s, sl) in tbl.key_to_slot.items():
        directory.insert(k, tbl._encode_loc(s, sl))
    tbl.device_dir = directory
    for name in ("hits", "cost"):
        if getattr(tbl, name) is not None:
            setattr(tbl, name, tbl._counter(tbl.capacity))


class VectorCheckpointer:
    """``torch.save`` snapshots of every ShardedActorTable in a
    VectorRuntime (state tensors + host bookkeeping), one directory per
    step, keeping the newest ``max_to_keep``."""

    def __init__(self, runtime: "VectorRuntime", directory: str,
                 max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.runtime = runtime
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        # writes come from the snapshotter's thread and from the loop's
        # final save; one at a time
        self._write_lock = threading.Lock()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _state_tree(self) -> dict:
        # host copies: ticks write the state tensors in place, so a device
        # tensor handed to the writer would change under it
        return {cls.__name__:
                {f: t.detach().to("cpu", copy=True)
                 for f, t in tbl.state.items()}
                for cls, tbl in self.runtime.tables.items()}

    def capture(self) -> tuple[dict, dict]:
        """Snapshot of every table (a synchronous copy to the host +
        bookkeeping), taken under the engine's tick fence so that no
        batch of the off-loop worker writes the state mid-copy. The
        returned tree is host tensors and plain data — write it from any
        thread."""
        with self.runtime.tick_fence():
            state = self._state_tree()
            meta = {cls.__name__: _table_meta(tbl)
                    for cls, tbl in self.runtime.tables.items()}
        return state, meta

    def write(self, step: int, captured: tuple[dict, dict]) -> None:
        """Persist a captured snapshot as step ``step`` (thread-safe;
        hosting runs this in a worker thread so the silo event loop keeps
        serving), then drop the steps beyond ``max_to_keep``."""
        state, meta = captured
        with self._write_lock:
            tmp = os.path.join(self.directory,
                               f".tmp-{int(step)}-{uuid.uuid4().hex}")
            os.makedirs(tmp)
            try:
                torch.save(state, os.path.join(tmp, _STATE_FILE))
                with open(os.path.join(tmp, _META_FILE), "w") as f:
                    json.dump(meta, f)
                final = self._step_dir(step)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def save(self, step: int) -> None:
        """capture() + write() in one synchronous call."""
        self.write(step, self.capture())

    def wait(self) -> None:
        """Writes are synchronous; nothing is left to wait for (kept for
        the JAX package's interface)."""

    def all_steps(self) -> list[int]:
        """Steps on disk, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, _META_FILE)):
                out.append(int(name))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> int:
        """Rebuild every registered table from the checkpoint, onto the
        runtime's device. The runtime must have the same grain classes
        registered, with the same state schema (a mismatch raises)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint to restore")
        by_name = {cls.__name__: tbl
                   for cls, tbl in self.runtime.tables.items()}
        d = self._step_dir(step)
        with open(os.path.join(d, _META_FILE)) as f:
            meta = json.load(f)
        missing = set(meta) - set(by_name)
        if missing:
            raise KeyError(
                f"checkpoint has tables {sorted(missing)} not registered "
                f"on this runtime — register the grain classes first")
        state = torch.load(os.path.join(d, _STATE_FILE),
                           map_location="cpu", weights_only=True)
        # validate every table before touching any: shapes come from the
        # checkpoint's own capacity, so a runtime built with another
        # capacity_per_shard still restores
        for name in meta:
            tbl = by_name[name]
            cap = meta[name]["capacity"]
            fields = state[name]
            if set(fields) != set(tbl.grain_class.STATE):
                raise ValueError(
                    f"{name}: checkpoint fields {sorted(fields)} != state "
                    f"schema {sorted(tbl.grain_class.STATE)}")
            for f, (dtype, shape) in tbl.grain_class.STATE.items():
                want = (tbl.n_shards, cap + 1, *shape)
                t = fields[f]
                if tuple(t.shape) != want or t.dtype != torch_dtype(dtype):
                    raise ValueError(
                        f"{name}.{f}: checkpoint {tuple(t.shape)} "
                        f"{t.dtype}, schema wants {want} "
                        f"{torch_dtype(dtype)}")
        with self.runtime.tick_fence():
            for name in meta:
                tbl = by_name[name]
                _apply_meta(tbl, meta[name])
                tbl.restore(state[name])
        return step

    def close(self) -> None:
        """Nothing to release (kept for the JAX package's interface)."""


class VectorStorageBridge:
    """Write-behind per-actor persistence for one VectorGrain class: rows
    flushed to / loaded from an ordinary ``GrainStorage`` provider, with
    the same etag discipline host grains get from StateStorageBridge."""

    def __init__(self, runtime: "VectorRuntime", grain_class: type,
                 storage: GrainStorage):
        self.runtime = runtime
        self.grain_class = grain_class
        self.storage = storage
        self.grain_type = grain_class.__name__
        self._etags: dict[int, str | None] = {}
        self.storage_conflicts = 0
        # dense keys released after an etag conflict -> the (state, etag)
        # storage held then; the bulk paths' fresh mask writes them back
        # (rehydrate) instead of fresh-initializing the key
        self._released: dict[int, tuple[dict, str | None]] = {}
        runtime.table(grain_class).rehydrate = self.rehydrate

    def _grain_id(self, key: int) -> GrainId:
        return GrainId.for_grain(GrainType.of(self.grain_type), int(key))

    def _locate(self, keys, drop_missing: bool = False
                ) -> tuple[list[int], np.ndarray, np.ndarray]:
        """Resolve keys to (surviving_keys, shards, slots). Keys with no
        activation slot raise KeyError, or are dropped with a log when
        ``drop_missing`` (a released slot has no row left to persist)."""
        tbl = self.runtime.table(self.grain_class)
        arr = np.asarray(keys, dtype=np.int64).reshape(-1)
        if tbl.dense_n and arr.size and arr.min() >= 0 \
                and arr.max() < tbl.dense_n:
            # all dense: the mapping is arithmetic, no per-key Python
            shards, slots = tbl.dense_shard_slot(arr)
            return arr.tolist(), shards, slots
        kept, shards, slots = [], [], []
        for k in keys:
            k = int(k)
            if 0 <= k < tbl.dense_n:
                shard, slot = k // tbl.dense_per_shard, k % tbl.dense_per_shard
            elif (loc := tbl.lookup(k)) is not None:
                shard, slot = loc[0], loc[1]
            elif drop_missing:
                logging.getLogger("orleans.vector").warning(
                    "write-behind: key %d has no activation slot; dropping",
                    k)
                continue
            else:
                raise KeyError(f"key {k} has no activation slot")
            kept.append(k)
            shards.append(shard)
            slots.append(slot)
        return kept, np.asarray(shards, np.int64), np.asarray(slots, np.int64)

    async def flush(self, keys: Iterable[int], strict: bool = False) -> int:
        """Write-behind: persist the current device rows for ``keys``.
        One batched device→host gather, then per-actor etag'd writes,
        ``FLUSH_SLICE`` at a time with a yield to the event loop between
        slices (other turns and responses run while a large flush does).

        Per-key failure isolation: keys whose activation slot is gone
        (released) are dropped with a log — there is no row left to
        persist — and keys whose storage write fails are re-marked dirty
        individually, so one bad key cannot wedge write-behind for the
        whole class. Failures re-raise (after re-marking) when ``strict``
        is set OR when the runtime has no dirty tracking to hold the
        retry — a standalone bridge must never report silent success."""
        keys = keys.tolist() if isinstance(keys, np.ndarray) \
            else [int(k) for k in keys]
        if not keys:
            return 0
        tbl = self.runtime.table(self.grain_class)
        # under the tick fence: the gather reads state rows that an
        # off-loop tick writes in place
        with self.runtime.tick_fence():
            kept, shards, slots = self._locate(keys, drop_missing=True)
            if not kept:
                return 0
            sh = torch.from_numpy(shards).to(tbl.device)
            sl = torch.from_numpy(slots).to(tbl.device)
            # advanced indexing copies, so these rows own their memory
            host = {f: a[sh, sl].cpu().numpy()
                    for f, a in tbl.state.items()}

        async def write_one(i: int, key: int) -> None:
            state = {f: host[f][i] for f in host}
            etag = self._etags.get(key)
            if etag is None:
                # adopt the stored etag (a fresh bridge after a checkpoint
                # restore has no etag memory but IS the legitimate writer —
                # the device row is the truth being flushed)
                _, etag = await self.storage.read(
                    self.grain_type, self._grain_id(key))
            try:
                etag = await self.storage.write(
                    self.grain_type, self._grain_id(key), state, etag)
            except InconsistentStateError:
                # another silo flushed this key since our last write: an
                # ownership move happened (partition-era vote, failover,
                # re-range). Reference semantics
                # (InsideRuntimeClient.cs:390-402): the conflicted
                # activation DEACTIVATES and rebuilds from storage on
                # next touch — never overwrite. Overwriting would let a
                # stale ex-owner silently REVERT durable state the live
                # owner wrote (fatal once the key goes quiet: no later
                # flush corrects it); releasing loses at most this
                # silo's not-yet-durable tail, which is the documented
                # write-behind loss window. The stale etag must also be
                # dropped or it would wedge this key's flushes forever
                self.storage_conflicts += 1
                self._etags.pop(key, None)
                if 0 <= key < tbl.dense_n:
                    tbl.dense_active[key] = False
                    # what the routed path would rebuild from: the bulk
                    # paths, which cannot await a read, write it back
                    # with its etag (a later write by the new owner
                    # still conflicts, so nothing newer is overwritten)
                    stored, stored_etag = await self.storage.read(
                        self.grain_type, self._grain_id(key))
                    if stored is not None:
                        self._released[key] = (stored, stored_etag)
                else:
                    tbl.release(key)
                logging.getLogger("orleans.vector").info(
                    "write-behind: etag conflict on key %d — row "
                    "released for rebuild from storage", key)
                raise _ConflictReleased(key) from None
            self._etags[key] = etag

        results = []
        for start in range(0, len(kept), FLUSH_SLICE):
            await asyncio.sleep(0)  # after the gather too: it is a slice
            results += await asyncio.gather(
                *(write_one(i, kept[i])
                  for i in range(start, min(start + FLUSH_SLICE, len(kept)))),
                return_exceptions=True)
        conflicts = [r.key for r in results
                     if isinstance(r, _ConflictReleased)]
        failed = [k for k, r in zip(kept, results)
                  if isinstance(r, BaseException)
                  and not isinstance(r, _ConflictReleased)]
        if failed:
            self.runtime._mark_dirty(self.grain_class, failed)
            first = next(r for r in results
                         if isinstance(r, BaseException)
                         and not isinstance(r, _ConflictReleased))
            logging.getLogger("orleans.vector").warning(
                "write-behind: %d/%d key writes failed (re-marked): %r",
                len(failed), len(kept), first)
            if strict or not self.runtime.track_dirty:
                # no retry mechanism will see the re-mark (or the caller
                # demanded completeness — the final stop() drain): surface
                # the failure instead of reporting partial success
                raise first
        return len(kept) - len(failed) - len(conflicts)

    async def load(self, keys: Iterable[int]) -> list[int]:
        """Resume: read stored rows and write them into the table.
        Returns the keys that had persisted state (missing keys keep
        their fresh-init state — the lazy-recreate contract)."""
        keys = [int(k) for k in keys]
        if not keys:
            return []
        tbl = self.runtime.table(self.grain_class)

        async def read_one(key: int):
            state, etag = await self.storage.read(
                self.grain_type, self._grain_id(key))
            return key, state, etag

        rows = await asyncio.gather(*(read_one(k) for k in keys))
        found = [(k, s, e) for k, s, e in rows if s is not None]
        if not found:
            return []
        for k, _, e in found:
            self._etags[k] = e
            self._released.pop(k, None)
        fkeys = [k for k, _, _ in found]
        # claim slots for hashed keys that have no activation yet, and
        # record their routing hash (ownership sweeps need it for rows
        # that never entered through a routed call)
        for k in fkeys:
            if not (0 <= k < tbl.dense_n):
                if tbl.lookup(k) is None:
                    tbl.lookup_or_allocate(k)
                tbl.note_route(k, self._grain_id(k).uniform_hash)
        if tbl.dense_active.size:
            dense = [k for k in fkeys if 0 <= k < tbl.dense_n]
            if dense:
                tbl.dense_active[np.asarray(dense, int)] = True
        self._write_rows(fkeys, [s for _, s, _ in found])
        return fkeys

    def _write_rows(self, keys: list[int], states: list[dict]) -> None:
        """Write stored records into the keys' rows with one in-place
        ``index_put_`` a field, under the tick fence: an off-loop tick
        writes the same pools, and must see none or all of the rows."""
        tbl = self.runtime.table(self.grain_class)
        _, shards, slots = self._locate(keys)
        with self.runtime.tick_fence():
            sh = torch.from_numpy(shards).to(tbl.device)
            sl = torch.from_numpy(slots).to(tbl.device)
            for f, arr in tbl.state.items():
                dtype, _ = tbl.grain_class.STATE[f]
                vals = np.stack([np.asarray(s[f], numpy_dtype(dtype))
                                 for s in states])
                arr.index_put_((sh, sl),
                               torch.from_numpy(vals).to(arr.device))

    def rehydrate(self, keys: np.ndarray) -> None:
        """The table's hook before a bulk path fresh-initializes dense
        ``keys``: rows released after an etag conflict get back the
        stored state (and etag) read at the conflict, and count as
        active, so the bulk tick continues them instead of starting over
        from ``initial_state``."""
        if not self._released:
            return
        rel = np.fromiter(self._released, np.int64, len(self._released))
        back = rel[np.isin(rel, np.asarray(keys))].tolist()
        if not back:
            return
        states = []
        for k in back:
            state, etag = self._released.pop(k)
            self._etags[k] = etag
            states.append(state)
        self._write_rows(back, states)
        self.runtime.table(self.grain_class).dense_active[back] = True
