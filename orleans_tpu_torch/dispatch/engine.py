"""The tick engine: coalesce VectorGrain invocations into batched ticks.

The port of the synchronous part of ``orleans_tpu.dispatch.engine``. One
tick of one (class, method) over the slot pools is

    gather rows → fresh-init (on-device activation) → vmapped handler
    → masked write-back (skipped for read-only methods)

over every shard at once: shards are the leading tensor dimension, so the
JAX package's ``shard_map`` is a batched index over dim 0 here, and the
handler is vmapped with ``torch.func.vmap`` over all ``n_shards * B``
lanes. Where the JAX package donates the state buffers, the port writes
into ``tbl.state`` in place. K-round streams (``call_batch_rounds``) run
as a Python loop in which round k+1 reads what round k wrote.

Turn semantics: within a tick at most one message per activation
(``make_dense_plan`` refuses duplicate keys; ``apply_received`` masks
duplicate deliveries off and reports them for the next tick). Padding
lanes address the sink row ``capacity``; only they may collide, and the
sink's contents are undefined.

Batch buckets are powers of two with a floor (``_bucket``), as in the
JAX package, so both packages see the same ``[n_shards, B]`` layouts.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.func import vmap

from ..interop import numpy_dtype, torch_dtype
from ..ops.hash_probe import device_lookup64
from ..ops.route import rank_dense_keys
from ..parallel.mesh import Mesh
from ..parallel.transport import build_exchange
from .table import _LOC_STRIDE, ShardedActorTable
from .vector_grain import ActorMethod, VectorGrain

__all__ = ["VectorRuntime"]

MIN_BUCKET = 8


def _bucket(n: int) -> int:
    return max(MIN_BUCKET, 1 << max(0, (n - 1).bit_length()))


def _validate_args(cls: type, method: str, schema: dict, args: dict) -> None:
    missing = set(schema) - set(args)
    extra = set(args) - set(schema)
    if missing or extra:
        raise TypeError(
            f"{cls.__name__}.{method} args mismatch: "
            f"missing {sorted(missing)}, unexpected {sorted(extra)} "
            f"(schema: {sorted(schema)})")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class _DensePlan:
    """Cached batch layout for a recurring dense key set. The constant
    batch operands (slots, key hashes, valid mask, zero fresh mask) go to
    the device once and are reused every tick; nothing may write into
    them (a kernel that did would corrupt every later tick of the plan)."""

    __slots__ = ("keys", "order", "inv", "sorted_shard", "lane_sorted", "B",
                 "slots_b", "valid_b", "khash_b", "_dev", "identity",
                 "counts")

    def __init__(self, keys, order, inv, sorted_shard, lane_sorted, B,
                 slots_b, valid_b, khash_b, identity=False, counts=None):
        self.keys = keys
        self.order = order
        self.inv = inv
        self.sorted_shard = sorted_shard
        self.lane_sorted = lane_sorted
        self.B = B
        self.slots_b = slots_b
        self.valid_b = valid_b
        self.khash_b = khash_b
        self._dev = None
        # identity plans (keys == 0..M-1 under the block-wise dense
        # mapping) repack by contiguous slices instead of fancy indexing
        self.identity = identity
        self.counts = counts

    def pack(self, x: np.ndarray, dtype, shape) -> np.ndarray:
        """[M, ...] caller-order payload → [n_shards, B, ...] host batch."""
        n = self.valid_b.shape[0]
        dtype = numpy_dtype(dtype)
        buf = np.zeros((n, self.B, *shape), dtype=dtype)
        if self.identity:
            off = 0
            for s in range(n):
                c = self.counts[s]
                buf[s, :c] = x[off:off + c]
                off += c
        else:
            buf[self.sorted_shard, self.lane_sorted] = \
                np.asarray(x, dtype=dtype)[self.order]
        return buf

    def pack_device(self, x: torch.Tensor) -> torch.Tensor:
        """Identity plans: [K, M, ...] device payload → [K, n, B, ...]."""
        n = self.valid_b.shape[0]
        K = x.shape[0]
        if n * self.B == x.shape[1] or n == 1:
            pad = n * self.B - x.shape[1]
            if pad:
                x = torch.cat([x, x.new_zeros((K, pad, *x.shape[2:]))], 1)
            return x.reshape(K, n, self.B, *x.shape[2:])
        buf = x.new_zeros((K, n, self.B, *x.shape[2:]))
        off = 0
        for s in range(n):
            c = int(self.counts[s])
            buf[:, s, :c] = x[:, off:off + c]
            off += c
        return buf

    def device_operands(self, device):
        """(slots int32, khash int32, valid bool, zero fresh bool), each
        [n_shards, B] on ``device``; read-only, shared by every tick."""
        if self._dev is None:
            self._dev = (
                torch.from_numpy(self.slots_b).to(device),
                torch.from_numpy(self.khash_b).to(device),
                torch.from_numpy(self.valid_b).to(device),
                torch.zeros(self.valid_b.shape, dtype=torch.bool,
                            device=device),
            )
        return self._dev

    def unpack(self, results):
        """[n_shards, B, ...] device results → [M, ...] host rows in the
        caller's original key order (synchronizes)."""
        def one(a):
            a = a.cpu().numpy()
            if self.identity:
                return np.concatenate(
                    [a[s, :c] for s, c in enumerate(self.counts)])
            return a[self.sorted_shard, self.lane_sorted][self.inv]
        return _tree_map(one, results)


class VectorRuntime:
    """Per-silo device-tier runtime: tables + synchronous ticks."""

    def __init__(self, mesh: Mesh, capacity_per_shard: int = 1024):
        self.mesh = mesh
        self.device = mesh.device
        self.capacity_per_shard = capacity_per_shard
        self.tables: dict[type, ShardedActorTable] = {}
        self._kernel_cache: dict[tuple, Any] = {}
        self.ticks = 0
        self.messages_processed = 0
        self.exchange_lanes = 0  # device-valid lanes (call_batch_device)

    # ------------------------------------------------------------------
    def register(self, *grain_classes: type[VectorGrain],
                 capacity_per_shard: int | None = None) -> None:
        for cls in grain_classes:
            if cls not in self.tables:
                self.tables[cls] = ShardedActorTable(
                    cls, self.mesh,
                    capacity_per_shard or self.capacity_per_shard)

    def table(self, cls: type) -> ShardedActorTable:
        if cls not in self.tables:
            self.register(cls)
        return self.tables[cls]

    def method_of(self, cls: type, name: str) -> ActorMethod:
        m = self.table(cls).methods.get(name)
        if m is None:
            raise AttributeError(
                f"{cls.__name__} has no @actor_method {name!r}")
        return m

    # ------------------------------------------------------------------
    # Bulk path (dense keys)
    # ------------------------------------------------------------------
    def make_dense_plan(self, grain_class: type,
                        keys: np.ndarray) -> _DensePlan:
        """Precompute the key→(shard, lane) batch layout for a recurring
        bulk key set (amortizes the argsort across ticks)."""
        tbl = self.table(grain_class)
        keys = np.asarray(keys)
        M = keys.shape[0]
        n = tbl.n_shards
        if keys.shape[0] and np.unique(keys).shape[0] != keys.shape[0]:
            raise ValueError(
                "call_batch keys must be unique within a tick; split "
                "duplicate-key traffic across ticks")
        shard, slot = tbl.dense_shard_slot(keys)
        order = np.argsort(shard, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(M)
        counts = np.bincount(shard, minlength=n)
        B = _bucket(int(counts.max()) if M else MIN_BUCKET)
        sorted_shard = shard[order]
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        lane_sorted = np.arange(M) - starts[sorted_shard]
        slots_b = np.full((n, B), tbl.sink_slot, dtype=np.int32)
        valid_b = np.zeros((n, B), dtype=bool)
        khash_b = np.zeros((n, B), dtype=np.int32)
        slots_b[sorted_shard, lane_sorted] = slot[order]
        valid_b[sorted_shard, lane_sorted] = True
        # key hashes reach the device as int32, 31 bits (the JAX package
        # runs with x64 off): initial_state sees the same values
        khash_b[sorted_shard, lane_sorted] = keys[order] & 0x7FFFFFFF
        identity = bool(M) and keys[0] == 0 and keys[-1] == M - 1 and \
            np.array_equal(keys, np.arange(M))
        return _DensePlan(keys, order, inv, sorted_shard, lane_sorted, B,
                          slots_b, valid_b, khash_b,
                          identity=identity, counts=counts)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def call_batch(self, grain_class: type, method: str,
                   keys: np.ndarray, args: dict[str, np.ndarray],
                   fresh: np.ndarray | None = None,
                   plan: _DensePlan | None = None,
                   device_results: bool = False):
        """Invoke ``method`` on many dense-keyed activations in one tick.

        ``keys``: int array [M] of dense keys (ensure_dense'd, unique).
        ``args``: dict of [M, ...] arrays. Returns the result tree with
        leading axis [M] as numpy, or the raw [n_shards, B, ...] device
        tensors with ``device_results``. Keys never touched before are
        fresh-initialized unless ``fresh`` says otherwise."""
        tbl = self.table(grain_class)
        m = self.method_of(grain_class, method)
        m.infer_schema(args, lead=1)
        _validate_args(grain_class, method, m.args_schema, args)
        if plan is None:
            plan = self.make_dense_plan(grain_class, keys)
        M = plan.keys.shape[0]
        d_slots, d_khash, d_valid, _ = plan.device_operands(self.device)
        if fresh is None:
            fresh = tbl.dense_fresh_mask(plan.keys)
        d_fresh = None
        if fresh is not None:
            d_fresh = self._upload(plan.pack(np.asarray(fresh), bool, ()))
            tbl.mark_dense_active(plan.keys)
        args_b = {f: self._upload(plan.pack(np.asarray(args[f]), dt, sh))
                  for f, (dt, sh) in m.args_schema.items()}
        kern = self._kernel(grain_class, method, plan.B,
                            contiguous=self._plan_contiguous(tbl, plan))
        _, results = kern(tbl.state, d_slots, d_khash, d_fresh, d_valid,
                          args_b)
        self.ticks += 1
        self.messages_processed += M
        if device_results:
            return results
        return plan.unpack(results)

    def call_batch_rounds(self, grain_class: type, method: str,
                          keys: np.ndarray, args_rounds: dict,
                          plan: _DensePlan | None = None,
                          device_results: bool = False):
        """K message rounds to the same dense key set in one call.

        ``args_rounds``: dict of [K, M, ...] arrays (numpy, or device
        tensors, which an identity plan keeps on the device). Round k+1
        sees the state round k wrote. Returns results stacked [K, M, ...]
        (numpy), or [K, n_shards, B, ...] device tensors with
        ``device_results``."""
        tbl = self.table(grain_class)
        m = self.method_of(grain_class, method)
        if not args_rounds:
            raise TypeError(
                "call_batch_rounds requires at least one [K, M, ...] args "
                "array to define K; use call_batch for single no-arg ticks")
        m.infer_schema(args_rounds, lead=2)
        _validate_args(grain_class, method, m.args_schema, args_rounds)
        if plan is None:
            plan = self.make_dense_plan(grain_class, keys)
        K = next(iter(args_rounds.values())).shape[0]
        M = plan.keys.shape[0]
        n = tbl.n_shards
        fresh0 = tbl.dense_fresh_mask(plan.keys)
        d_slots, d_khash, d_valid, _ = plan.device_operands(self.device)
        d_fresh = None
        if fresh0 is not None:
            d_fresh = self._upload(plan.pack(np.asarray(fresh0), bool, ()))
            tbl.mark_dense_active(plan.keys)
        args_b = {}
        for fname, (dtype, shape) in m.args_schema.items():
            a = args_rounds[fname]
            if isinstance(a, torch.Tensor) and plan.identity:
                # device-resident payload on an identity plan: each
                # shard's lanes are a contiguous run of the [K, M, ...]
                # payload, so it is packed on the device, never copied
                # through the host
                args_b[fname] = plan.pack_device(
                    a.to(device=self.device, dtype=torch_dtype(dtype)))
                continue
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)
            args_b[fname] = self._upload(np.stack(
                [plan.pack(a[k], dtype, shape) for k in range(K)]))
        kern = self._scan_kernel(
            grain_class, method, plan.B, K,
            contiguous=self._plan_contiguous(tbl, plan),
            # dropping the validity select is safe ONLY when every lane is
            # real: a padded lane in contiguous mode addresses by position
            all_valid=bool(plan.valid_b.all()))
        _, results = kern(tbl.state, d_slots, d_khash, d_fresh, d_valid,
                          args_b)
        self.ticks += K
        self.messages_processed += K * M
        if device_results:
            return results  # [K, n, B, ...]
        return _tree_map(
            lambda a: np.stack([plan.unpack(a[k]) for k in range(K)]),
            results)

    def _plan_contiguous(self, tbl, plan: _DensePlan) -> bool:
        """Identity plans touch slots [0, counts[s]) per shard in lane
        order: the gather/scatter is a contiguous slice of the pool."""
        return plan.identity and plan.B <= tbl.capacity

    def call_batch_device(self, grain_class: type, method: str,
                          slots_b, khash_b, fresh_b, valid_b, args_b):
        """Tick for callers that already hold device-layout [n_shards, B]
        batches (the exchange, benchmarks). Returns the raw
        [n_shards, B, ...] results; nothing is copied to the host."""
        B = slots_b.shape[1]
        _, results = self._kernel(grain_class, method, B)(
            self.table(grain_class).state, slots_b, khash_b, fresh_b,
            valid_b, args_b)
        self.ticks += 1
        # counting the valid mask would synchronize: count lanes instead
        self.exchange_lanes += int(slots_b.shape[0] * B)
        return results

    # ------------------------------------------------------------------
    # Device-tier actor→actor messaging
    # ------------------------------------------------------------------
    def route(self, dest_class: type, dest_keys, payload: dict, valid,
              capacity: int = 256, sparse: bool = False):
        """Route per-message payloads to the shards owning ``dest_keys``
        over the tick exchange (parallel.transport).

        dest_keys/valid: [n_shards, B] device tensors (dense keys of
        ``dest_class``); payload: dict of [n_shards, B, ...]. Returns
        (recv_keys, recv_payload, recv_valid, drops) with recv lanes
        [n_shards, n_shards*capacity] and drops [n_shards] int32.

        ``sparse=True``: dest_keys is a ``(keys_lo, keys_hi)`` int32 pair
        (62-bit keys split by ops.hash_probe.split64), and the owning shard
        is resolved on the device through the table's DeviceDirectory64;
        unregistered keys are dropped and counted."""
        if "__key__" in payload:
            raise ValueError("payload field name '__key__' is reserved")
        tbl = self.table(dest_class)
        key = ("exchange", tbl.n_shards, capacity)
        ex = self._kernel_cache.get(key)
        if ex is None:
            ex = build_exchange(self.mesh, capacity=capacity)
            self._kernel_cache[key] = ex
        if sparse:
            keys_lo, keys_hi = dest_keys
            tk_lo, tk_hi, tv = tbl.device_dir.device_arrays()
            loc, found = device_lookup64(
                tk_lo, tk_hi, tv, keys_lo.reshape(-1), keys_hi.reshape(-1),
                tbl.device_dir.max_probes)
            loc = loc.reshape(keys_lo.shape)
            found = found.reshape(keys_lo.shape)
            dest_shard = (loc // _LOC_STRIDE).to(torch.int32)
            recv, recv_valid, drops = ex(
                dest_shard, valid & found,
                {"__key__": keys_lo, "__key_hi__": keys_hi, **payload})
            # unregistered destinations count as drops per source shard
            drops = drops + (valid & ~found).sum(dim=-1).to(torch.int32)
            recv_lo = recv.pop("__key__")
            recv_hi = recv.pop("__key_hi__")
            return (recv_lo, recv_hi), recv, recv_valid, drops
        per = max(tbl.dense_per_shard, 1)
        dest_shard = (dest_keys // per).to(torch.int32)
        recv, recv_valid, drops = ex(
            dest_shard, valid, {"__key__": dest_keys, **payload})
        recv_keys = recv.pop("__key__")
        return recv_keys, recv, recv_valid, drops

    def apply_received(self, dest_class: type, method: str, recv_keys,
                       recv_valid, args: dict, sparse: bool = False):
        """Apply routed messages as invocations on ``dest_class``, on the
        device. At most one message per actor per tick: duplicate
        deliveries are masked off (first lane wins) and reported in the
        returned ``applied`` mask for the caller to re-apply next tick.

        Returns (results [n_shards, L, ...], applied [n_shards, L])."""
        self.method_of(dest_class, method)  # validate the method exists
        slots, applied, khash = self._apply_resolver(
            dest_class, sparse)(recv_keys, recv_valid)
        fresh = torch.zeros_like(applied)
        results = self.call_batch_device(dest_class, method, slots, khash,
                                         fresh, applied, args)
        return results, applied

    def _apply_resolver(self, dest_class: type, sparse: bool):
        """The slot-resolution half of :meth:`apply_received`: key → local
        slot, and the first-delivery dedup mask."""
        tbl = self.table(dest_class)
        capacity = tbl.capacity
        n_shards = tbl.n_shards

        def first_delivery(v, slot):
            # rank within (shard, slot) groups: one stable sort over all
            # shards, each shard's keys offset into a span of its own
            span = capacity + 2
            keyed = torch.where(v, slot, torch.full_like(slot, capacity + 1))
            off = torch.arange(n_shards, dtype=torch.int64,
                               device=slot.device)[:, None] * span
            rank = rank_dense_keys((keyed.to(torch.int64) + off).reshape(-1))
            applied = v & (rank.reshape(v.shape) == 0)
            slot = torch.where(applied, slot, torch.full_like(slot, capacity))
            return slot.to(torch.int32), applied

        if sparse:
            probes = tbl.device_dir.max_probes

            def resolve(keys, ok):
                lo, hi = keys
                tk_lo, tk_hi, tv = tbl.device_dir.device_arrays()
                loc, found = device_lookup64(tk_lo, tk_hi, tv, lo.reshape(-1),
                                             hi.reshape(-1), probes)
                loc, found = loc.reshape(lo.shape), found.reshape(lo.shape)
                myshard = torch.arange(n_shards, device=lo.device)[:, None]
                # a lane misrouted against a stale directory must not
                # scribble another actor's slot on this shard
                v = ok & found & ((loc // _LOC_STRIDE) == myshard)
                slot = torch.where(v, loc % _LOC_STRIDE,
                                   torch.full_like(loc, capacity))
                slot, applied = first_delivery(v, slot)
                return slot, applied, lo.to(torch.int32)
        else:
            per = max(tbl.dense_per_shard, 1)

            def resolve(keys, ok):
                slot = torch.where(ok, keys % per,
                                   torch.full_like(keys, capacity))
                slot, applied = first_delivery(ok, slot)
                return slot, applied, (keys & 0x7FFFFFFF).to(torch.int32)
        return resolve

    # ------------------------------------------------------------------
    # Kernel construction
    # ------------------------------------------------------------------
    def _kernel(self, cls: type, method: str, B: int,
                contiguous: bool = False):
        tbl = self.tables[cls]
        key = (cls, method, B, tbl.capacity, tbl.n_shards, contiguous)
        k = self._kernel_cache.get(key)
        if k is None:
            k = self._build_kernel(cls, method, contiguous=contiguous)
            self._kernel_cache[key] = k
        return k

    def _scan_kernel(self, cls: type, method: str, B: int, K: int,
                     contiguous: bool = False, all_valid: bool = False):
        tbl = self.tables[cls]
        key = ("scan", cls, method, B, K, tbl.capacity, tbl.n_shards,
               contiguous, all_valid)
        k = self._kernel_cache.get(key)
        if k is None:
            k = self._build_kernel(cls, method, scan_rounds=K,
                                   contiguous=contiguous,
                                   scan_all_valid=all_valid)
            self._kernel_cache[key] = k
        return k

    def _build_kernel(self, cls: type, method: str, scan_rounds: int = 0,
                      contiguous: bool = False,
                      scan_all_valid: bool = False):
        """The tick as a function ``kern(state, slots, khash, fresh, valid,
        args) -> (state, results)`` over [n_shards, B] operands. ``state``
        (a table's dict) is updated IN PLACE and returned; ``fresh`` may be
        None for "no lane is fresh". The scanned variant takes args
        [K, n, B, ...] and returns results [K, n, B, ...]."""
        tbl = self.tables[cls]
        handler = vmap(tbl.methods[method].fn)
        init = vmap(cls.initial_state)
        read_only = tbl.methods[method].read_only
        field_dtype = {k: torch_dtype(dt)
                       for k, (dt, _) in cls.STATE.items()}

        def access(state, slots):
            """(read_all() → rows [n*B, ...] per field, write(field,
            [n*B, ...])) for this tick's slot addressing."""
            n, B = slots.shape
            if contiguous:
                def read(f):
                    return f[:, :B].reshape(n * B, *f.shape[2:])

                def write(name, v):
                    state[name][:, :B] = v.reshape(n, B, *v.shape[1:])
            else:
                shard = torch.arange(n, device=slots.device)[:, None] \
                    .expand(n, B)
                idx = (shard, slots.to(torch.int64))

                def read(f):
                    return f[idx].reshape(n * B, *f.shape[2:])

                def write(name, v):
                    # duplicate indices are padding lanes on the sink row
                    state[name][idx] = v.reshape(n, B, *v.shape[1:])

            def read_all():
                return {k: read(f) for k, f in state.items()}
            return read_all, write

        def as_field(name, v, like):
            return v.to(device=like.device, dtype=field_dtype[name])

        def sel(mask, a, b):
            return torch.where(
                mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)

        def own(results, state):
            """Copy results that alias the state (a handler passing a row
            through under contiguous addressing returns a view of the
            pool), so the write-back cannot change them."""
            ptrs = {f.untyped_storage().data_ptr() for f in state.values()}
            return _tree_map(
                lambda r: r.clone()
                if r.untyped_storage().data_ptr() in ptrs else r, results)

        def fresh_rows(rows, khash_flat):
            init_rows = init(khash_flat)
            return {k: as_field(k, init_rows[k], rows[k]) for k in rows}

        def shape_results(results, n, B, device):
            return _tree_map(
                lambda r: r.to(device).reshape(n, B, *r.shape[1:]), results)

        def flat(x):
            return x.reshape(-1, *x.shape[2:])

        def local_step(state, slots, khash, fresh, valid, args):
            n, B = slots.shape
            read_all, write = access(state, slots)
            rows = read_all()
            if fresh is not None:
                init_rows = fresh_rows(rows, flat(khash))
                f = flat(fresh)
                rows = {k: sel(f, init_rows[k], r) for k, r in rows.items()}
            new_rows, results = handler(rows, {k: flat(a)
                                               for k, a in args.items()})
            results = own(results, state)
            if not read_only:
                v = flat(valid)
                for k, r in rows.items():
                    write(k, sel(v, as_field(k, new_rows[k], r), r))
            return state, shape_results(results, n, B, slots.device)

        if not scan_rounds:
            return local_step

        def scanned(state, slots, khash, fresh, valid, args_rounds):
            n, B = slots.shape
            read_all, write = access(state, slots)
            fixed_rows = None
            if fresh is not None:
                # the OnActivate pre-pass: round 0 sees initialized rows
                # and later rounds never re-init
                rows = read_all()
                init_rows = fresh_rows(rows, flat(khash))
                w = flat(fresh & valid)
                inited = {k: sel(w, init_rows[k], r) for k, r in rows.items()}
                if read_only:
                    # a read-only call commits nothing, not even the
                    # activation (as the JAX package drops its carry)
                    fixed_rows = inited
                else:
                    for k, r in inited.items():
                        write(k, r)
            v = flat(valid)
            outs = []
            for k_round in range(scan_rounds):
                rows = fixed_rows if fixed_rows is not None else read_all()
                args = {k: flat(a[k_round]) for k, a in args_rounds.items()}
                new_rows, results = handler(rows, args)
                results = own(results, state)
                if not read_only:
                    for k, r in rows.items():
                        nr = as_field(k, new_rows[k], r)
                        write(k, nr if scan_all_valid else sel(v, nr, r))
                outs.append(shape_results(results, n, B, slots.device))
            return state, _stack_rounds(outs)

        return scanned


def _stack_rounds(outs: list):
    """Stack a list of per-round result trees along a new leading axis."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack_rounds([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_rounds([o[i] for o in outs])
                           for i in range(len(first)))
    return torch.stack(outs)
