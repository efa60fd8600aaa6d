"""Device-tier stateless workers: a VectorGrain class replicated over the
shard axis (the device analog of ``[StatelessWorker]``).

The port of ``orleans_tpu.dispatch.replicated``:

* no directory entry and no owner: every shard holds its own replica row
  of every key, and a call for key k runs on a round-robin shard;
* replicas are independent workers and diverge by design (local caches,
  aggregators);
* reads merge the replicas with the class's ``MERGE`` spec. The JAX
  package's ``psum``/``pmax``/``pmin`` over the silo axis are ``sum``/
  ``amax``/``amin`` over the leading shard dimension here.

Classes opt in with :func:`replicated_worker` and declare how each field
merges::

    @replicated_worker
    class HitCounter(VectorGrain):
        STATE = {"hits": (torch.int32, ()), "peak": (torch.int32, ())}
        MERGE = {"hits": "sum", "peak": "max"}

and are hosted through ``VectorRuntime.replicated_host(cls, n_keys)``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.func import vmap

from ..interop import numpy_dtype, torch_dtype
from .engine import _leaves, _tree_map, _validate_args
from .vector_grain import VectorGrain, vector_methods

__all__ = ["ReplicatedWorkerHost", "replicated_worker"]


def _merge_sum(v: torch.Tensor) -> torch.Tensor:
    # torch sums integers in int64; the cast back wraps as an int32 psum
    return v.sum(dim=0).to(v.dtype)


_MERGE_OPS = {
    "sum": _merge_sum,
    "max": lambda v: v.amax(dim=0),
    "min": lambda v: v.amin(dim=0),
}


def replicated_worker(cls: type) -> type:
    """Mark a VectorGrain class for shard-axis replication. Requires a
    ``MERGE`` dict naming "sum" | "max" | "min" for every STATE field."""
    merge = getattr(cls, "MERGE", None)
    if not isinstance(merge, dict) or set(merge) != set(cls.STATE):
        raise TypeError(
            f"{cls.__name__} needs MERGE covering exactly its STATE fields "
            f"({sorted(cls.STATE)}); got {merge!r}")
    bad = {f: op for f, op in merge.items() if op not in _MERGE_OPS}
    if bad:
        raise TypeError(f"unknown merge ops {bad}; choose from "
                        f"{sorted(_MERGE_OPS)}")
    cls.__vector_replicated__ = True
    return cls


class ReplicatedWorkerHost:
    """Replicated table and dispatch of one stateless-worker class.

    State: ``[n_shards, n_keys + 1, *field]`` on the mesh's device (row
    ``n_keys`` is the padding sink); every shard holds the full key
    range."""

    def __init__(self, cls: type[VectorGrain], mesh, n_keys: int):
        if not getattr(cls, "__vector_replicated__", False):
            raise TypeError(
                f"{cls.__name__} is not @replicated_worker-decorated")
        self.cls = cls
        self.mesh = mesh
        self.device = mesh.device
        self.n_shards = mesh.n_shards
        self.n_keys = int(n_keys)
        self.methods = vector_methods(cls)
        self._rr = 0  # round-robin shard assignment
        # per-(shard, key) activation bitmap: a first touch on a shard
        # runs initial_state on that shard's replica row
        self.active = np.zeros((self.n_shards, self.n_keys), dtype=bool)
        self.state: dict[str, torch.Tensor] = {
            name: torch.zeros((self.n_shards, self.n_keys + 1, *shape),
                              dtype=torch_dtype(dtype), device=self.device)
            for name, (dtype, shape) in cls.STATE.items()}
        self._kernel_cache: dict[tuple, Any] = {}
        self.calls = 0

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------------
    def call_batch(self, method: str, keys: np.ndarray,
                   args: dict[str, np.ndarray] | None = None):
        """Run ``method`` for each key on a round-robin shard, in as many
        ticks as duplicate (shard, key) pairs need (one turn per worker
        per tick; no call is dropped). Returns results in caller order."""
        m = self.methods.get(method)
        if m is None:
            raise AttributeError(
                f"{self.cls.__name__} has no @actor_method {method!r}")
        keys = np.asarray(keys)
        self._check_keys(keys)
        M = keys.shape[0]
        args = args or {}
        n = self.n_shards
        if m.args_schema is None and args:
            m.infer_schema(args, lead=1)
        if m.args_schema is not None:
            _validate_args(self.cls, method, m.args_schema, args)
        shard = (np.arange(self._rr, self._rr + M) % n).astype(np.int64)
        self._rr = int((self._rr + M) % n)
        shape_tree = None  # the result tree of the first tick
        out: list[np.ndarray] = []  # one [M, ...] array per result leaf
        remaining = list(range(M))
        while remaining:
            claimed: set = set()
            this_round: list = []
            deferred: list = []
            for idx in remaining:
                loc = (shard[idx], int(keys[idx]))
                if loc in claimed:
                    deferred.append(idx)
                else:
                    claimed.add(loc)
                    this_round.append(idx)
            results, dest, ssh, lane = self._one_tick(
                m, method, keys, args, shard, this_round)
            leaves = _leaves(results)
            if shape_tree is None:
                shape_tree = results
                out = [np.zeros((M, *r.shape[2:]),
                                dtype=numpy_dtype(r.dtype))
                       for r in leaves]
            for o, r in zip(out, leaves):
                o[dest] = r.cpu().numpy()[ssh, lane]
            remaining = deferred
        self.calls += M
        if shape_tree is None:
            return np.zeros(0)
        it = iter(out)
        return _tree_map(lambda _: next(it), shape_tree)

    def _one_tick(self, m, method: str, keys, args, shard, idxs: list):
        """One tick over conflict-free calls ``idxs``: returns the device
        results and where each call's lane is (caller index, shard,
        lane)."""
        n = self.n_shards
        sh = shard[idxs]
        ks = keys[idxs]
        counts = np.bincount(sh, minlength=n)
        B = max(8, 1 << int(counts.max() - 1).bit_length())
        order = np.argsort(sh, kind="stable")
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        ssh = sh[order]
        lane = np.arange(len(idxs)) - starts[ssh]
        slots = np.full((n, B), self.n_keys, dtype=np.int32)
        valid = np.zeros((n, B), dtype=bool)
        fresh = np.zeros((n, B), dtype=bool)
        slots[ssh, lane] = ks[order]
        valid[ssh, lane] = True
        fresh[ssh, lane] = ~self.active[ssh, ks[order]]
        if not m.read_only:
            # a read-only first touch persists nothing, so the key stays
            # fresh until its first write runs initial_state
            self.active[ssh, ks[order]] = True
        args_b = {}
        for fname, (dtype, shape) in (m.args_schema or {}).items():
            dt = numpy_dtype(dtype)
            buf = np.zeros((n, B, *shape), dtype=dt)
            buf[ssh, lane] = np.asarray(args[fname], dtype=dt)[idxs][order]
            args_b[fname] = self._upload(buf)
        results = self._tick_kernel(method, B)(
            self.state, self._upload(slots), self._upload(fresh),
            self._upload(valid), args_b)
        return results, np.asarray(idxs)[order], ssh, lane

    def _check_keys(self, keys: np.ndarray) -> None:
        if keys.size and (keys.min() < 0 or keys.max() >= self.n_keys):
            raise ValueError(
                f"{self.cls.__name__} keys must be in [0, {self.n_keys}); "
                f"got range [{keys.min()}, {keys.max()}]")

    def _tick_kernel(self, method: str, B: int):
        key = ("tick", method, B, self.n_keys)
        k = self._kernel_cache.get(key)
        if k is not None:
            return k
        m = self.methods[method]
        handler = vmap(m.fn)
        init = vmap(self.cls.initial_state)
        read_only = m.read_only

        def sel(mask, a, b):
            return torch.where(
                mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)

        def run(state, slots, fresh, valid, args):
            n = slots.shape[0]
            idx = (torch.arange(n, device=slots.device)[:, None]
                   .expand(n, B), slots.to(torch.int64))
            rows = {f: v[idx].reshape(n * B, *v.shape[2:])
                    for f, v in state.items()}
            init_rows = init(slots.reshape(-1))
            fr = fresh.reshape(-1)
            rows = {f: sel(fr, init_rows[f].to(r.dtype), r)
                    for f, r in rows.items()}
            new_rows, results = handler(
                rows, {f: a.reshape(n * B, *a.shape[2:])
                       for f, a in args.items()})
            results = _tree_map(lambda r: r.reshape(n, B, *r.shape[1:]),
                                results)
            if not read_only:
                v = valid.reshape(-1)
                for f, r in rows.items():
                    nr = new_rows[f].to(r.dtype)
                    state[f][idx] = sel(v, nr, r).reshape(
                        n, B, *r.shape[1:])
            return results

        self._kernel_cache[key] = run
        return run

    # ------------------------------------------------------------------
    def read_merged(self, keys: np.ndarray) -> dict[str, np.ndarray]:
        """Cluster-wide view of ``keys``: every shard's replica rows
        folded with the class's MERGE spec over the shard dimension."""
        keys = np.asarray(keys, dtype=np.int32)
        self._check_keys(keys)
        d_keys = self._upload(keys.astype(np.int64))
        merge = self.cls.MERGE
        return {f: _MERGE_OPS[merge[f]](v[:, d_keys]).cpu().numpy().copy()
                for f, v in self.state.items()}

