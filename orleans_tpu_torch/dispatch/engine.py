"""The tick engine: coalesce VectorGrain invocations into batched ticks.

The port of ``orleans_tpu.dispatch.engine``. One tick of one (class,
method) over the slot pools is

    gather rows → fresh-init (on-device activation) → vmapped handler
    → masked write-back (skipped for read-only methods)

over every shard at once: shards are the leading tensor dimension, so the
JAX package's ``shard_map`` is a batched index over dim 0 here, and the
handler is vmapped with ``torch.func.vmap`` over all ``n_shards * B``
lanes. Where the JAX package donates the state buffers, the port writes
into ``tbl.state`` in place. K-round streams (``call_batch_rounds``) run
as a Python loop in which round k+1 reads what round k wrote.

Entry points:

* per key (``call``, ``call_group``, ``call_packed``, ``actor()``): calls
  queue per (class, method) and one tick per event-loop iteration runs
  each queue as one batch, inline or on the engine's worker thread
  (``offloop_tick``); futures resolve after the tick that ran them;
* dense bulk (``call_batch``, ``call_batch_rounds``, ``call_batch_device``):
  the caller is the tick;
* collectives (``map_actors``, ``reduce_actors``, ``broadcast_actors``,
  ``stream_fanout``, ``join_when``): whole-population ticks; broadcasts
  ride the exchange (``route``, which ranks lanes with K2);
* device messaging (``route``, ``apply_received``).

Turn semantics: within a tick at most one message per activation. The
per-key path defers same-slot conflicts to the next tick, in arrival
order; ``make_dense_plan`` refuses duplicate keys; ``apply_received``
masks duplicate deliveries off and reports them for the next tick.
Padding lanes address the sink row ``capacity``; only they may collide,
and the sink's contents are undefined.

One lock, the tick fence (``tick_fence()``, shared by every table of the
engine), serializes every tick with ``grow``/``read_row``/``snapshot``/
``restore``: the worker holds it for a whole batch, through the sync that
proves the batch's uploads and kernel finished, so a staging buffer never
rotates back to "filling" while a copy still reads it.

Batch buckets are powers of two with a floor (``_bucket``), as in the
JAX package, so both packages see the same ``[n_shards, B]`` layouts.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import queue as _queue
import threading
import time
from contextlib import nullcontext
from functools import partial
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..core.ids import GrainId, GrainType
from ..interop import numpy_dtype, torch_dtype
from ..observability.profiling import LOOP_CATEGORY
from ..observability.stats import INGEST_STATS as _INGEST
from ..ops.hash_probe import device_lookup64
from ..ops.route import rank_dense_keys
from ..ops.segment_reduce import REDUCE_OPS, host_fold, masked_reduce
from ..parallel.mesh import (Mesh, make_mesh, refuse_in_worker,
                             refuse_on_group)
from ..parallel.transport import build_exchange
from .table import _LOC_STRIDE, ShardedActorTable
from .vector_grain import ActorMethod, VectorGrain

__all__ = ["VectorActorRef", "VectorRuntime", "join_poll"]

_QUEUE_WAIT = _INGEST["queue_wait"]
_STAGING = _INGEST["staging"]
_TRANSFER = _INGEST["transfer"]
_TICK = _INGEST["tick"]
_MESSAGES = _INGEST["messages"]
# marks a ledger payload in a worker job's deferred-stats list: the
# worker stamps it, the loop charges it in _complete_job
_LEDGER = object()

log = logging.getLogger("orleans.vector")

MIN_BUCKET = 8


def _bucket(n: int) -> int:
    return max(MIN_BUCKET, 1 << max(0, (n - 1).bit_length()))


def _emit(sink, st, key: str, value: float) -> None:
    """One stage observation: straight to the registry on the loop, or
    deferred into ``sink`` on the worker (the registries are loop-confined;
    _complete_job replays the list loop-side)."""
    if sink is not None:
        sink.append((key, value))
    else:
        st.observe(key, value)


def _validate_args(cls: type, method: str, schema: dict, args: dict) -> None:
    missing = set(schema) - set(args)
    extra = set(args) - set(schema)
    if missing or extra:
        raise TypeError(
            f"{cls.__name__}.{method} args mismatch: "
            f"missing {sorted(missing)}, unexpected {sorted(extra)} "
            f"(schema: {sorted(schema)})")


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _leaves(tree) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _np_dtype(dt) -> np.dtype:
    """A schema dtype (torch, or numpy as first-call inference gives it)
    as numpy."""
    return numpy_dtype(dt) if isinstance(dt, torch.dtype) else np.dtype(dt)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A result tensor as a numpy array that owns its memory. On the CPU
    ``.cpu().numpy()`` is the tensor's own buffer, which may be a staging
    buffer or the slot pool that the next tick overwrites; on the card
    the copy to the host is the batch's sync."""
    a = t.detach().cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


async def join_poll(reduce_once, need: int, timeout: float | None,
                    poll: float) -> int:
    """Await ``reduce_once()`` (a sum over the key set) until its first
    leaf reaches ``need`` or ``timeout`` elapses; returns the count."""
    loop = asyncio.get_running_loop()
    deadline = None if timeout is None else loop.time() + timeout
    while True:
        val = await reduce_once()
        ready = 0
        if val is not None:
            leaves = _leaves(val)
            ready = int(leaves[0]) if leaves else 0
        if ready >= need:
            return ready
        if deadline is not None and loop.time() >= deadline:
            raise asyncio.TimeoutError(
                f"join_when: {ready}/{need} ready after {timeout}s")
        await asyncio.sleep(poll)


class _Packed(NamedTuple):
    order: np.ndarray         # [M] stable sort of the targets by shard
    counts: np.ndarray        # [n] targets per shard
    shard_sorted: np.ndarray  # [M] shard of each sorted target
    lane: np.ndarray          # [M] lane of each sorted target
    B: int
    slots_b: np.ndarray       # [n, B] int32, idle lanes on the sink row
    valid_b: np.ndarray       # [n, B] bool
    khash_b: np.ndarray       # [n, B] int32
    fresh_b: np.ndarray | None  # [n, B] bool when ``fresh`` was given


def _pack_lanes(tbl, shard: np.ndarray, slot: np.ndarray, keys: np.ndarray,
                fresh: np.ndarray | None = None) -> _Packed:
    """Group M (shard, slot) targets into padded ``[n_shards, B]``
    batches: targets keep their order within a shard, idle lanes aim at
    the sink row."""
    n = tbl.n_shards
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=n)
    B = _bucket(int(counts.max()) if shard.size else MIN_BUCKET)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    ss = shard[order]
    lane = np.arange(shard.size) - starts[ss]
    slots_b = np.full((n, B), tbl.sink_slot, dtype=np.int32)
    valid_b = np.zeros((n, B), dtype=bool)
    khash_b = np.zeros((n, B), dtype=np.int32)
    slots_b[ss, lane] = slot[order]
    valid_b[ss, lane] = True
    # key hashes reach the device as int32, 31 bits (the JAX package runs
    # with x64 off): initial_state sees the same values
    khash_b[ss, lane] = (keys[order] & 0x7FFFFFFF).astype(np.int32)
    fresh_b = None
    if fresh is not None:
        fresh_b = np.zeros((n, B), dtype=bool)
        fresh_b[ss, lane] = fresh[order]
    return _Packed(order, counts, ss, lane, B, slots_b, valid_b, khash_b,
                   fresh_b)


class _DensePlan:
    """Cached batch layout for a recurring dense key set. The constant
    batch operands (slots, key hashes, valid mask, zero fresh mask) go to
    the device once and are reused every tick; nothing may write into
    them (a kernel that did would corrupt every later tick of the plan).

    On a process-group mesh the plan holds this rank's keys only:
    ``keys`` are the caller's keys whose shard is local, ``sel`` their
    positions in the caller's order; :meth:`pack` and
    :meth:`pack_device` take caller-order payloads and keep those
    positions, and :meth:`unpack` returns the rows of ``keys``."""

    __slots__ = ("keys", "order", "inv", "sorted_shard", "lane_sorted", "B",
                 "slots_b", "valid_b", "khash_b", "_dev", "identity",
                 "counts", "sel")

    def __init__(self, keys, order, inv, sorted_shard, lane_sorted, B,
                 slots_b, valid_b, khash_b, identity=False, counts=None,
                 sel=None):
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
        self.sel = sel  # None: every caller key is in the plan

    def select(self, x):
        """The plan's rows of a caller-order [M, ...] array."""
        return x if self.sel is None else x[self.sel]

    def pack(self, x: np.ndarray, dtype, shape) -> np.ndarray:
        """[M, ...] caller-order payload → [n_shards, B, ...] host batch."""
        return self.pack_own(self.select(np.asarray(x)), dtype, shape)

    def pack_own(self, x: np.ndarray, dtype, shape) -> np.ndarray:
        """:meth:`pack` of an array already in the order of ``keys``."""
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
        if self.sel is not None:  # the rank's keys: one contiguous run
            x = x[:, int(self.sel[0]):int(self.sel[0]) + self.sel.size]
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




class _StagingSet:
    """One preallocated ``[n_shards, B, ...]`` host staging set for a
    (class, method) batch bucket: the batch operands (slots, key hashes,
    fresh, valid) and one array per schema field. Two sets per bucket
    alternate between "filling from ingress" and "uploaded by the tick in
    flight" (``VectorRuntime._staging_acquire``), so steady-state ingest
    allocates nothing.

    On a CUDA mesh every array is a numpy view of a pinned host tensor,
    uploaded with ``non_blocking=True``; the batch syncs before it returns,
    so a set that rotates back is never still being read. On the CPU the
    kernel reads the staging arrays themselves (``torch.from_numpy``)."""

    __slots__ = ("slots", "khash", "fresh", "valid", "args", "used", "sink",
                 "_host")

    def __init__(self, n: int, B: int, sink: int, schema: dict,
                 pin: bool):
        self._host: dict[str, torch.Tensor] = {}

        def alloc(name, shape, dtype, fill=0):
            dtype = _np_dtype(dtype)
            try:
                t = torch.full(shape, fill, dtype=torch_dtype(dtype),
                               pin_memory=pin)
            except TypeError:
                # no torch dtype (a first-call inference from a string):
                # plain numpy, which the upload then refuses
                return np.full(shape, fill, dtype=dtype)
            self._host[name] = t
            return t.numpy()

        self.slots = alloc("slots", (n, B), np.int32, sink)
        self.khash = alloc("khash", (n, B), np.int32)
        self.fresh = alloc("fresh", (n, B), np.bool_)
        self.valid = alloc("valid", (n, B), np.bool_)
        self.args = {f: alloc(f"arg:{f}", (n, B, *shape), dtype)
                     for f, (dtype, shape) in schema.items()}
        self.used = [0] * n  # lanes filled per shard on the LAST use
        self.sink = sink     # the junk row every idle lane points at

    def reset(self, sink: int) -> None:
        """Re-arm for the next fill: only the used lane prefix needs
        slots→sink and valid→False. When the sink itself moved (a grow()
        turns the old sink row into a real slot) every lane re-points, or
        an idle lane still aimed at the old sink would scatter into a live
        actor's row."""
        if sink != self.sink:
            self.slots[:] = sink
            self.valid[:] = False
            self.fresh[:] = False
            self.sink = sink
            self.used = [0] * len(self.used)
            return
        for s, c in enumerate(self.used):
            if c:
                self.slots[s, :c] = sink
                self.valid[s, :c] = False
            self.used[s] = 0

    def upload(self, device: torch.device, any_fresh: bool):
        """(slots, khash, fresh or None, valid, args) as tensors on
        ``device``: asynchronous copies from pinned memory on the card,
        the staging buffers themselves on the CPU."""
        def up(name, a):
            t = self._host.get(name)
            if t is None:
                t = torch.from_numpy(a)  # raises for non-numeric dtypes
            return t.to(device, non_blocking=True)
        return (up("slots", self.slots), up("khash", self.khash),
                up("fresh", self.fresh) if any_fresh else None,
                up("valid", self.valid),
                {f: up(f"arg:{f}", a) for f, a in self.args.items()})


class _Pending:
    """One queued invocation of the per-key path. ``t_enq`` is the
    monotonic enqueue stamp (0.0 when nothing reads it); ``future`` is
    None for one-way batched-ingress calls; ``trace`` an optional
    ``(trace_id, parent_span_id)``; ``origin`` the originating worker
    process of a packed cross-process batch."""

    __slots__ = ("key_hash", "shard", "slot", "fresh", "args", "future",
                 "t_enq", "trace", "origin")

    def __init__(self, key_hash, shard, slot, fresh, args, future,
                 t_enq=0.0, trace=None, origin=None):
        self.key_hash = key_hash
        self.shard = shard
        self.slot = slot
        self.fresh = fresh
        self.args = args
        self.future = future
        self.t_enq = t_enq
        self.trace = trace
        self.origin = origin


class _TickJob:
    """One claimed (class, method) batch bound for the off-loop worker.
    ``ready`` is the conflict-free claim (decided loop-side); ``trace``
    the loop-side sampling roll; ``per_shard``/``span`` are filled by the
    worker; ``stats`` collects its deferred observations — ``(key,
    value)``, None = shed-trend note, _MESSAGES = counter, _LEDGER =
    ledger payload — replayed loop-side."""

    __slots__ = ("cls", "method", "ready", "trace", "per_shard", "span",
                 "stats")

    def __init__(self, cls, method, ready, trace=False):
        self.cls = cls
        self.method = method
        self.ready = ready
        self.trace = trace
        self.per_shard = None
        self.span = None
        self.stats: list = []


class VectorActorRef:
    """Typed handle to one device-tier activation."""

    __slots__ = ("runtime", "grain_class", "key", "key_hash")

    def __init__(self, runtime: "VectorRuntime", grain_class: type, key,
                 key_hash: int):
        self.runtime = runtime
        self.grain_class = grain_class
        self.key = key
        self.key_hash = key_hash

    def __getattr__(self, name: str):
        self.runtime.method_of(self.grain_class, name)  # raise if unknown
        return partial(self.runtime.call, self.grain_class, self.key_hash,
                       name)

    def __repr__(self) -> str:
        return f"VectorActorRef({self.grain_class.__name__}, {self.key!r})"


class VectorRuntime:
    """Per-silo device-tier runtime: tables, the tick loop, kernel cache.

    ``mesh=None`` means ``make_mesh()``: CUDA, or raise. Raises
    ``WorkerProcessError`` in a forked worker process of a multi-process
    silo (``parallel.mesh``)."""

    def __init__(self, mesh: Mesh | None = None,
                 capacity_per_shard: int = 1024, options=None):
        refuse_in_worker("VectorRuntime")
        if options is not None:  # config.DispatchOptions
            options.validate()
            capacity_per_shard = options.capacity_per_shard
        self.mesh = mesh if mesh is not None else make_mesh()
        self.device = self.mesh.device
        self.capacity_per_shard = capacity_per_shard
        self.tables: dict[type, ShardedActorTable] = {}
        self._kernel_cache: dict[tuple, Any] = {}
        # per-key path: queued invocations per (class, method)
        self.pending: dict[tuple[type, str], list[_Pending]] = {}
        self._tick_scheduled = False
        self.ticks = 0
        self.messages_processed = 0
        self.exchange_lanes = 0  # device-valid lanes (call_batch_device)
        # write-behind dirty tracking, hit and cost telemetry: off unless
        # a consumer turns them on
        self.track_dirty = False
        self._dirty: dict[type, list[np.ndarray]] = {}
        self.track_load = False
        self.track_cost = False
        self.conflicts_deferred = 0
        # double-buffered host staging per (class, method) → signature →
        # [two _StagingSets, next index]; the last batch's fill count
        self._staging: dict[tuple, dict] = {}
        self.staging_fill = 0
        # duck-typed hooks a host tier sets (None: nothing is recorded):
        # shed_trend.note(mean_wait), tracer.sample()/record(...),
        # stats.observe/increment, ledger.charge_tick(payload),
        # loop_prof.set_category(...)
        self.shed_trend = None
        self.tracer = None
        self.stats = None
        self.ledger = None
        self.loop_prof = None
        self._replicated_hosts: dict[type, Any] = {}
        # off-loop tick: claimed batches run on a worker thread of this
        # engine, which holds the fence for each whole batch; futures
        # resolve back on the loop through call_soon_threadsafe
        self.offloop_tick = bool(getattr(options, "offloop_tick", False))
        self._fence = threading.RLock()
        self._worker: threading.Thread | None = None
        self._worker_q: "_queue.SimpleQueue | None" = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._quiesced: asyncio.Event | None = None
        self._complete_ctx = None
        self._inflight = 0        # jobs handed to the worker, unresolved
        self._inflight_msgs = 0   # messages inside those jobs
        # class → {key_hash: count} inside in-flight jobs: fenced like
        # pending keys (pending_key_hashes)
        self._inflight_keys: dict[type, dict[int, int]] = {}

    def validate_pipeline_depth(self, depth: int,
                                allow_unproven: bool = False) -> int:
        """Refuse to keep more than one super-round in flight on a
        multi-shard mesh, as the JAX package does: overlapping collective
        programs deadlock its CPU backend's shared rendezvous pool, and
        the combination is unproven on the card. On the CPU it always
        raises; on the card ``allow_unproven=True`` lets it through.
        Single-shard meshes pipeline freely."""
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        n = self.mesh.n_shards
        if depth > 1 and n > 1:
            platform = self.device.type
            if platform == "cpu" or not allow_unproven:
                raise ValueError(
                    f"pipeline_depth={depth} is not supported on a "
                    f"{n}-shard mesh ({platform}): overlapping collective "
                    "programs deadlock the CPU backend's shared rendezvous "
                    "pool, and the combination is unproven on the card. "
                    "Run cross-shard supers at depth 1, or pass "
                    "allow_unproven=True on a CUDA mesh.")
        return depth

    def replicated_host(self, cls: type, n_keys: int | None = None):
        """Host ``cls`` as a mesh-replicated stateless worker (every shard
        holds a replica row per key; reads merge them). ``n_keys`` is
        required on the first call."""
        host = self._replicated_hosts.get(cls)
        if host is None:
            if n_keys is None:
                raise ValueError(
                    f"first replicated_host({cls.__name__}) needs n_keys")
            from .replicated import ReplicatedWorkerHost
            host = ReplicatedWorkerHost(cls, self.mesh, n_keys)
            self._replicated_hosts[cls] = host
        elif n_keys is not None and n_keys != host.n_keys:
            raise ValueError(
                f"{cls.__name__} already hosted with n_keys="
                f"{host.n_keys}; cannot re-host with n_keys={n_keys}")
        return host

    # ------------------------------------------------------------------
    def register(self, *grain_classes: type[VectorGrain],
                 capacity_per_shard: int | None = None) -> None:
        for cls in grain_classes:
            if cls not in self.tables:
                tbl = ShardedActorTable(
                    cls, self.mesh,
                    capacity_per_shard or self.capacity_per_shard)
                # every table of the engine shares the worker's fence
                tbl.fence = self._fence
                if self.track_load:
                    tbl.enable_hit_tracking()
                if self.track_cost:
                    tbl.enable_cost_tracking()
                self.tables[cls] = tbl

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

    @staticmethod
    def key_hash_for(key, uniform_hash: int) -> int:
        """The key→hash rule of every entry point: small non-negative int
        keys map to themselves (so the dense regime applies), everything
        else to the GrainId uniform hash."""
        if isinstance(key, int) and 0 <= key < 2**62:
            return key
        return uniform_hash

    def actor(self, grain_class: type, key: int | str) -> VectorActorRef:
        """Reference to one device-tier activation."""
        refuse_on_group(self.mesh, "VectorRuntime.actor")
        gid = GrainId.for_grain(GrainType.of(grain_class.__name__), key)
        kh = self.key_hash_for(key, gid.uniform_hash)
        self.table(grain_class).note_route(kh, gid.uniform_hash)
        return VectorActorRef(self, grain_class, key, kh)

    # ------------------------------------------------------------------
    # Per-key path (general; conflict-safe)
    # ------------------------------------------------------------------
    def _locate(self, tbl, key_hash: int) -> tuple[int, int, bool]:
        """(shard, slot, fresh) of a key; a dense key's first touch is
        fresh (its initial_state runs in the tick)."""
        if 0 <= key_hash < tbl.dense_n:
            per = tbl.dense_per_shard
            fresh = not bool(tbl.dense_active[key_hash])
            tbl.dense_active[key_hash] = True
            return key_hash // per, key_hash % per, fresh
        return tbl.lookup_or_allocate(key_hash)

    def _stamp(self, traced: bool = False) -> float:
        return time.monotonic() if (self.stats is not None
                                    or self.shed_trend is not None
                                    or traced) else 0.0

    def call(self, grain_class: type, key_hash: int, method: str,
             **args) -> asyncio.Future:
        """Queue one invocation; the future resolves after its tick."""
        refuse_on_group(self.mesh, "VectorRuntime.call")
        m = self.method_of(grain_class, method)
        if m.args_schema is not None:
            _validate_args(grain_class, method, m.args_schema, args)
        shard, slot, fresh = self._locate(self.table(grain_class), key_hash)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self.pending.setdefault((grain_class, method), []).append(
            _Pending(key_hash, shard, slot, fresh, args, fut,
                     self._stamp()))
        self._schedule_tick(loop)
        return fut

    def call_group(self, grain_class: type, method: str, items: list,
                   traces: list | None = None,
                   origin: str | None = None) -> list:
        """Grouped enqueue (the batched-ingress hand-off): ``items`` are
        ``(key_hash, kwargs, want_future)`` triples of ONE (class, method),
        enqueued with one resolution, one stamp and one tick schedule.
        Returns a future per item where ``want_future``, else None, in item
        order. A per-item schema or allocation failure resolves that item's
        future with the error (or drops a one-way item); the rest proceed.
        ``traces``: per-item ``(trace_id, parent_span_id)`` or None;
        ``origin``: the originating worker process of every item."""
        refuse_on_group(self.mesh, "VectorRuntime.call_group")
        m = self.method_of(grain_class, method)
        schema = m.args_schema
        skeys = schema.keys() if schema is not None else None
        tbl = self.table(grain_class)
        loop = asyncio.get_running_loop()
        t_enq = self._stamp(traces is not None)
        pend: list | None = None  # made on the first enqueued item, so an
        # all-failed group leaves no empty pending entry behind
        futs: list = []
        for idx, (key_hash, args, want_future) in enumerate(items):
            fut = loop.create_future() if want_future else None
            futs.append(fut)
            try:
                if skeys is not None and args.keys() != skeys:
                    _validate_args(grain_class, method, schema, args)
                shard, slot, fresh = self._locate(tbl, key_hash)
            except Exception as e:  # noqa: BLE001 — scoped to this item
                if fut is not None:
                    fut.set_exception(e)
                continue
            if pend is None:
                pend = self.pending.setdefault((grain_class, method), [])
            pend.append(_Pending(
                key_hash, shard, slot, fresh, args, fut, t_enq,
                traces[idx] if traces is not None else None, origin))
        if pend is not None:
            self._schedule_tick(loop)
        return futs

    def call_packed(self, grain_class: type, method: str, key_hashes: list,
                    columns: dict, wants: list, traces: list | None = None,
                    origin: str | None = None) -> list:
        """Columnar enqueue (the owner side of the cross-process staging
        ring): ``columns[name]`` holds argument ``name`` of every call.
        Builds the same pending batch as :meth:`call_group`, with the same
        results."""
        names = tuple(columns)
        cols = [columns[n] for n in names]
        return self.call_group(grain_class, method, [
            (kh, {n: col[i] for n, col in zip(names, cols)}, want)
            for i, (kh, want) in enumerate(zip(key_hashes, wants))],
            traces=traces, origin=origin)

    # -- tracking toggles -------------------------------------------------
    def enable_dirty_tracking(self) -> None:
        self.track_dirty = True

    def enable_load_tracking(self) -> None:
        self.track_load = True
        for tbl in self.tables.values():
            tbl.enable_hit_tracking()

    def enable_cost_tracking(self) -> None:
        self.track_cost = True
        for tbl in self.tables.values():
            tbl.enable_cost_tracking()

    def queue_depth(self) -> int:
        """Invocations queued for later ticks, conflict-deferred ones and
        those in worker batches included."""
        return sum(len(v) for v in self.pending.values()) + \
            self._inflight_msgs

    def pending_key_hashes(self, cls: type) -> set[int]:
        """Keys of ``cls`` with queued invocations or inside batches on
        the worker: their (shard, slot) is cached, so they must not move."""
        keys = {p.key_hash for (c, _m), items in self.pending.items()
                if c is cls for p in items}
        ctr = self._inflight_keys.get(cls)
        if ctr:
            keys.update(ctr)
        return keys

    def shard_loads(self) -> dict[type, np.ndarray]:
        """Per-class per-shard invocation totals since the last reset."""
        return {cls: tbl.shard_hits() for cls, tbl in self.tables.items()}

    def _mark_dirty(self, cls: type, keys) -> None:
        if self.track_dirty:
            self._dirty.setdefault(cls, []).append(
                np.atleast_1d(np.asarray(keys)))

    def drain_dirty(self, cls: type) -> np.ndarray:
        """Keys written since the last drain (deduplicated). The pop is
        under the fence: a worker batch appends to the list while it runs."""
        with self._fence:
            batches = self._dirty.pop(cls, None)
        if not batches:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.concatenate(batches))

    def _staging_acquire(self, cls: type, method: str, tbl, B: int,
                         schema: dict) -> _StagingSet:
        """The "filling" half of the staging pair of this (class, method,
        B, schema) bucket. The other half fed the previous batch, which
        synced before it returned."""
        pool = self._staging.setdefault((cls, method), {})
        sig = (tbl.n_shards, B, tuple(sorted(
            (f, _np_dtype(d).str, tuple(int(x) for x in shape))
            for f, (d, shape) in schema.items())))
        entry = pool.get(sig)
        if entry is None:
            entry = pool[sig] = [[], 0]
        sets, idx = entry
        if len(sets) < 2:
            st = _StagingSet(tbl.n_shards, B, tbl.sink_slot, schema,
                             pin=self.device.type == "cuda")
            sets.append(st)
            entry[1] = len(sets) % 2
            return st
        st = sets[idx]
        entry[1] = idx ^ 1
        st.reset(tbl.sink_slot)
        return st

    def staging_lanes(self) -> int:
        """Preallocated staging lanes over every set (a footprint gauge),
        read without the fence: retried if the worker grows the pools."""
        for _ in range(4):
            try:
                total = 0
                for pool in list(self._staging.values()):
                    for (n, B, _sig), (sets, _idx) in list(pool.items()):
                        total += n * B * len(sets)
                return total
            except RuntimeError:  # dict changed during iteration
                continue
        return 0

    def _schedule_tick(self, loop) -> None:
        if not self._tick_scheduled:
            self._tick_scheduled = True
            loop.call_soon(self._tick)

    # -- off-loop tick worker ---------------------------------------------
    def tick_fence(self):
        """The tick-serialization fence (a reentrant lock): code outside
        the tick path that mutates or reads table state takes it, so it
        never interleaves with a worker batch."""
        return self._fence

    def _ensure_worker(self) -> None:
        if self._worker is not None:
            return
        self._loop = asyncio.get_running_loop()
        self._worker_q = _queue.SimpleQueue()
        self._quiesced = asyncio.Event()
        self._quiesced.set()
        # completions run loop-side in this context, booked to
        # tick_schedule like the inline path's resolution work
        self._complete_ctx = contextvars.Context()
        self._complete_ctx.run(LOOP_CATEGORY.set, "tick_schedule")
        t = threading.Thread(target=self._worker_main,
                             name="orleans-tick-worker", daemon=True)
        self._worker = t
        t.start()

    def shutdown_worker(self, timeout: float = 10.0) -> None:
        """Stop the worker: queued jobs finish in order, then it exits.
        Idempotent; a later tick starts a fresh worker."""
        w, self._worker = self._worker, None
        if w is None:
            return
        self._worker_q.put(None)
        w.join(timeout)

    def _worker_main(self) -> None:
        q = self._worker_q
        while True:
            job = q.get()
            if job is None:
                return
            host = err = None
            try:
                # the fence is held for the whole batch, through its sync
                with self._fence:
                    job.per_shard, host, job.span = self._execute_batch(
                        job.cls, job.method, job.ready, None,
                        trace_roll=job.trace, sink=job.stats)
            except BaseException as e:  # noqa: BLE001 — futures fail loop-side
                err = e
            try:
                self._loop.call_soon_threadsafe(
                    self._complete_job, job, host, err,
                    context=self._complete_ctx)
            except RuntimeError:
                return  # the loop is closed: nothing left to resolve

    def _submit_job(self, job: _TickJob) -> None:
        self._ensure_worker()
        self._inflight += 1
        self._inflight_msgs += len(job.ready)
        self._quiesced.clear()
        ctr = self._inflight_keys.setdefault(job.cls, {})
        for p in job.ready:
            ctr[p.key_hash] = ctr.get(p.key_hash, 0) + 1
        self._worker_q.put(job)

    def _record_tick_span(self, span, ready: list,
                          error: bool = False) -> None:
        """Record a device-tick span loop-side from stamped timings;
        ``span`` = (name, wall_start, duration[, batch_wall, batch_mono])
        or None. Items with a trace context also get a child span in
        their trace and a queue-wait span, one pair per context."""
        tracer = self.tracer
        if span is None or tracer is None:
            return
        name, start_wall, dur = span[0], span[1], span[2]
        n = len(ready)
        extra = {"error": True} if error else {}
        tracer.record(tracer.device_trace_id, None, name, "device_tick",
                      start_wall, dur, batch=n, **extra)
        if len(span) < 5:
            return
        batch_wall, batch_mono = span[3], span[4]
        end_wall = start_wall + dur
        seen: set = set()
        for p in ready:
            tr = p.trace
            if tr is None or tr in seen:
                continue
            seen.add(tr)
            tid, psid = tr
            tracer.record(tid, psid, name, "device_tick", batch_wall,
                          max(0.0, end_wall - batch_wall), batch=n, **extra)
            if p.t_enq and batch_mono > p.t_enq:
                q = batch_mono - p.t_enq
                tracer.record(tid, psid, "engine.queue_wait", "server",
                              batch_wall - q, q, queue_s=q, exec_s=0.0)

    def _complete_job(self, job: _TickJob, host, err) -> None:
        """Loop-side completion of a worker batch: replay its deferred
        observations, resolve (or fail) its futures, record its span, and
        in a finally release its in-flight keys."""
        try:
            if job.stats:
                st = self.stats
                trend = self.shed_trend
                for key, val in job.stats:
                    if key is None:
                        if trend is not None:
                            trend.note(val)
                    elif key is _LEDGER:
                        if self.ledger is not None:
                            self.ledger.charge_tick(val)
                    elif st is None:
                        continue
                    elif key is _MESSAGES:
                        st.increment(key, val)
                    else:
                        st.observe(key, val)
            if err is not None:
                log.error("vector tick failed for %s.%s",
                          job.cls.__name__, job.method, exc_info=err)
                self._record_tick_span(getattr(err, "_tick_span", None),
                                       job.ready, error=True)
                for p in job.ready:
                    if p.future is not None and not p.future.done():
                        p.future.set_exception(err)
            else:
                self._record_tick_span(job.span, job.ready)
                self._resolve_batch(job.ready, job.per_shard, host)
        except BaseException as e2:  # noqa: BLE001 — fail futures, not loop
            log.exception("vector tick completion failed for %s.%s",
                          job.cls.__name__, job.method)
            for p in job.ready:
                if p.future is not None and not p.future.done():
                    p.future.set_exception(e2)
        finally:
            self._inflight -= 1
            self._inflight_msgs -= len(job.ready)
            ctr = self._inflight_keys.get(job.cls)
            if ctr is not None:
                for p in job.ready:
                    left = ctr.get(p.key_hash, 0) - 1
                    if left <= 0:
                        ctr.pop(p.key_hash, None)
                    else:
                        ctr[p.key_hash] = left
            if self._inflight == 0:
                self._quiesced.set()

    async def flush(self) -> None:
        """Run ticks until all pending work, conflict-deferred and worker
        batches included, has drained."""
        while self.pending or self._inflight:
            if self.pending:
                self._tick()
            if self._inflight:
                await self._quiesced.wait()
            else:
                await asyncio.sleep(0)

    # ------------------------------------------------------------------
    def _tick(self) -> None:
        self._tick_scheduled = False
        if not self.pending:
            return
        lp = self.loop_prof
        if lp is not None:
            lp.set_category("tick_schedule")
        work, self.pending = self.pending, {}
        offloop = self.offloop_tick
        tracer = self.tracer
        for (cls, method), items in work.items():
            ready = self._claim(cls, method, items)
            if not ready:
                continue
            # the sampling roll is loop-side on both paths; a batch with
            # request trace contexts records regardless
            roll = tracer is not None and (
                tracer.sample()
                or any(p.trace is not None for p in ready))
            if offloop:
                self._submit_job(_TickJob(cls, method, ready, roll))
                continue
            try:
                self._run_batch(cls, method, ready, trace_roll=roll)
            except Exception as e:  # noqa: BLE001 — fail the futures, not the loop
                log.exception("vector tick failed for %s.%s",
                              cls.__name__, method)
                self._record_tick_span(getattr(e, "_tick_span", None),
                                       ready, error=True)
                for p in ready:
                    if p.future is not None and not p.future.done():
                        p.future.set_exception(e)
        self.ticks += 1
        if self.pending:  # conflict-deferred work → next tick
            self._schedule_tick(asyncio.get_running_loop())

    def _claim(self, cls: type, method: str,
               items: list[_Pending]) -> list[_Pending]:
        """One message per slot per tick; same-slot conflicts defer to the
        next tick, in arrival order."""
        claimed: set[tuple[int, int]] = set()
        ready: list[_Pending] = []
        for p in items:
            loc = (p.shard, p.slot)
            if loc in claimed:
                self.pending.setdefault((cls, method), []).append(p)
                self.conflicts_deferred += 1
                continue
            claimed.add(loc)
            ready.append(p)
        return ready

    def _run_batch(self, cls: type, method: str, ready: list[_Pending],
                   trace_roll: bool = False) -> None:
        """The inline batch, under the fence like the worker's."""
        with self._fence:
            per_shard, host, span = self._execute_batch(
                cls, method, ready, self.loop_prof, trace_roll=trace_roll)
        self._record_tick_span(span, ready)
        self._resolve_batch(ready, per_shard, host)

    def _resolve_batch(self, ready: list[_Pending], per_shard,
                       host) -> None:
        for s, ps in enumerate(per_shard):
            for i, p in enumerate(ps):
                if p.future is not None and not p.future.done():
                    p.future.set_result(_tree_map(lambda a: a[s, i], host))
        self.messages_processed += len(ready)

    def _execute_batch(self, cls: type, method: str, ready: list[_Pending],
                       lp, trace_roll: bool = False,
                       sink: list | None = None):
        """Staging fill → upload → kernel → host sync for one claimed,
        conflict-free batch, on the loop (``lp`` the loop profiler, ``sink``
        None) or on the worker (``lp`` None, ``sink`` the job's deferred
        list). Returns ``(per_shard, host_results, span_timing)``."""
        st = self.stats
        led = self.ledger
        if lp is not None:
            lp.set_category("tick_staging", ("tick", cls.__name__, method))
        t_stage = now_mono = batch_wall = 0.0
        if st is not None:
            t_stage = time.perf_counter()
        if st is not None or self.shed_trend is not None or trace_roll:
            now_mono = time.monotonic()  # queue wait ends at batch start
        if trace_roll:
            batch_wall = time.time()
        tbl = self.tables[cls]
        m = tbl.methods[method]
        # a schema inferred from the first item is committed only after a
        # successful batch, so a bad first call cannot poison the class
        schema = m.args_schema
        inferred = schema is None
        if inferred:
            schema = {k: (np.asarray(v).dtype, np.asarray(v).shape)
                      for k, v in ready[0].args.items()}
        n = tbl.n_shards
        per_shard: list[list[_Pending]] = [[] for _ in range(n)]
        for p in ready:
            per_shard[p.shard].append(p)
        B = _bucket(max(len(ps) for ps in per_shard))
        stg = self._staging_acquire(cls, method, tbl, B, schema)
        slots, khash = stg.slots, stg.khash
        fresh, valid = stg.fresh, stg.valid
        args_stacked = stg.args
        any_fresh = False
        for s, ps in enumerate(per_shard):
            stg.used[s] = len(ps)
            for i, p in enumerate(ps):
                slots[s, i] = p.slot
                # key hashes reach the device as 31-bit ints
                khash[s, i] = p.key_hash & 0x7FFFFFFF
                fresh[s, i] = p.fresh
                any_fresh |= p.fresh
                valid[s, i] = True
                for fname in schema:
                    args_stacked[fname][s, i] = p.args[fname]
        self.staging_fill = len(ready)
        if lp is not None:
            lp.set_category("tick_transfer")
        t_xfer = t_tick = 0.0
        if st is not None:
            t_xfer = time.perf_counter()
            _emit(sink, st, _STAGING, t_xfer - t_stage)
            for p in ready:
                if p.t_enq:
                    _emit(sink, st, _QUEUE_WAIT,
                          max(0.0, now_mono - p.t_enq))
        if self.shed_trend is not None:
            stamped = [now_mono - p.t_enq for p in ready if p.t_enq]
            if stamped:
                mean = max(0.0, sum(stamped) / len(stamped))
                if sink is not None:
                    sink.append((None, mean))
                else:
                    self.shed_trend.note(mean)
        span_name = span_start = t_span0 = None
        try:
            if inferred:
                m.args_schema = {k: (torch_dtype(d), tuple(shape))
                                 for k, (d, shape) in schema.items()}
            kernel = self._kernel(cls, method, B)
            operands = stg.upload(self.device, any_fresh)
            if st is not None:
                t_tick = time.perf_counter()
                _emit(sink, st, _TRANSFER, t_tick - t_xfer)
            elif led is not None:
                t_tick = time.perf_counter()
            if trace_roll:
                span_name = f"tick {cls.__name__}.{method}"
                span_start = time.time()
                t_span0 = time.perf_counter()
            # on a sampled tick the kernels nest under a profiler range
            # named like the logical tick span
            with torch.profiler.record_function(span_name) \
                    if trace_roll else nullcontext():
                _, results = kernel(tbl.state, *operands)
            if lp is not None:
                # the sync below is where the device work is paid on the
                # loop (the slice the off-loop worker removes)
                lp.set_category("tick_sync")
            host = _tree_map(_to_host, results)
            if not _leaves(host):
                # nothing was copied back: sync on an event after the
                # kernel, so the staging set can rotate back safely
                if self.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
                    done.synchronize()
        except BaseException as e:
            if inferred:
                m.args_schema = None  # do not poison the class schema
            if span_start is not None:
                # a sampled tick that raised still records an errored span
                try:
                    e._tick_span = (span_name, span_start,
                                    time.perf_counter() - t_span0,
                                    batch_wall, now_mono)
                except AttributeError:
                    pass
            raise
        if not m.read_only:
            # dirty marks at state-apply time, not enqueue time
            self._mark_dirty(cls, np.fromiter(
                (p.key_hash for p in ready), dtype=np.int64,
                count=len(ready)))
        if self.track_load:
            tbl.record_hits(slots, valid)
        if st is not None:
            _emit(sink, st, _TICK, time.perf_counter() - t_tick)
            if sink is not None:
                sink.append((_MESSAGES, len(ready)))
            else:
                st.increment(_MESSAGES, len(ready))
        if led is not None:
            # every resident row is charged this tick's wall
            tick_s = max(0.0, time.perf_counter() - t_tick)
            payload = (cls.__name__, method, len(ready), tick_s,
                       tuple(f"{cls.__name__}#{p.key_hash}" for p in ready))
            if any(p.origin is not None for p in ready):
                payload = payload + (tuple(p.origin for p in ready),)
            if sink is not None:
                sink.append((_LEDGER, payload))
            else:
                led.charge_tick(payload)
            if self.track_cost:
                tbl.record_cost(slots, valid, int(tick_s * 1e6))
        span = None
        if trace_roll and span_name is not None:
            span = (span_name, span_start, time.perf_counter() - t_span0,
                    batch_wall, now_mono)
        if lp is not None:
            lp.set_category("tick_schedule")
        return per_shard, host, span

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
        if keys.shape[0] and np.unique(keys).shape[0] != keys.shape[0]:
            raise ValueError(
                "call_batch keys must be unique within a tick; split "
                "duplicate-key traffic across ticks")
        shard, slot = tbl.dense_shard_slot(keys)
        sel, first = None, 0
        if self.mesh.group is not None:
            # this rank's keys only, its shards as rows 0..n_local-1
            sel = np.flatnonzero((shard >= tbl.shard0)
                                 & (shard < tbl.shard0 + tbl.n_shards))
            keys, shard, slot = keys[sel], shard[sel] - tbl.shard0, \
                slot[sel]
            M = keys.shape[0]
            # an identity plan starts at this rank's first dense key, and
            # its keys are one run of the caller's order
            first = tbl.shard0 * tbl.dense_per_shard
            if M and not np.array_equal(
                    sel, np.arange(sel[0], sel[0] + M)):
                first = -1
        p = _pack_lanes(tbl, shard, slot, keys)
        inv = np.empty_like(p.order)
        inv[p.order] = np.arange(M)
        identity = bool(M) and keys[0] == first and \
            keys[-1] == first + M - 1 and \
            np.array_equal(keys, np.arange(first, first + M))
        return _DensePlan(keys, p.order, inv, p.shard_sorted, p.lane, p.B,
                          p.slots_b, p.valid_b, p.khash_b,
                          identity=identity, counts=p.counts, sel=sel)

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
        # in the order of plan.keys (the rank's keys on a group mesh)
        fresh = tbl.dense_fresh_mask(plan.keys) if fresh is None \
            else plan.select(np.asarray(fresh))
        d_fresh = None
        if fresh is not None:
            d_fresh = self._upload(plan.pack_own(fresh, bool, ()))
            tbl.mark_dense_active(plan.keys)
        args_b = {f: self._upload(plan.pack(np.asarray(args[f]), dt, sh))
                  for f, (dt, sh) in m.args_schema.items()}
        kern = self._kernel(grain_class, method, plan.B,
                            contiguous=self._plan_contiguous(tbl, plan))
        led = self.ledger
        t_led = time.perf_counter() if led is not None else 0.0
        # the caller is the tick: it must not touch tbl.state while a
        # worker batch is in flight
        with self._fence:
            _, results = kern(tbl.state, d_slots, d_khash, d_fresh,
                              d_valid, args_b)
            if not m.read_only:
                self._mark_dirty(grain_class, plan.keys)
        if self.track_load:
            tbl.record_hits(d_slots, d_valid)
        if led is not None:
            # bulk ticks charge dispatch wall with no per-key labels
            wall = max(0.0, time.perf_counter() - t_led)
            led.charge_tick((grain_class.__name__, method, M, wall, ()))
            if self.track_cost:
                tbl.record_cost(d_slots, d_valid, int(wall * 1e6))
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
            d_fresh = self._upload(plan.pack_own(fresh0, bool, ()))
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
        led = self.ledger
        t_led = time.perf_counter() if led is not None else 0.0
        with self._fence:
            _, results = kern(tbl.state, d_slots, d_khash, d_fresh,
                              d_valid, args_b)
            if not m.read_only:
                self._mark_dirty(grain_class, plan.keys)
        if self.track_load:
            tbl.record_hits(d_slots, d_valid, scale=K)
        if led is not None:
            # the wall spans all K rounds: charged per round, no scale
            wall = max(0.0, time.perf_counter() - t_led)
            led.charge_tick((grain_class.__name__, method, K * M,
                             wall / max(1, K), ()))
            if self.track_cost:
                tbl.record_cost(d_slots, d_valid, int(wall * 1e6))
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
        """Tick for callers that already hold [n_shards, B] batches (the
        exchange, the bulk collectives, benchmarks). Operands are tensors
        or numpy arrays (uploaded here); ``fresh_b`` may be None. Returns
        the raw [n_shards, B, ...] results; nothing is copied to the host.
        A numpy ``valid_b`` is counted into ``messages_processed``; a mask
        already on the device adds its lanes to ``exchange_lanes``
        (counting it would sync)."""
        tbl = self.table(grain_class)
        self.method_of(grain_class, method)  # raise if unknown
        B = slots_b.shape[1]

        def dev(x):
            return self._upload(x) if isinstance(x, np.ndarray) else x

        operands = (dev(slots_b), dev(khash_b),
                    None if fresh_b is None else dev(fresh_b), dev(valid_b),
                    {k: dev(v) for k, v in args_b.items()})
        led = self.ledger
        t_led = time.perf_counter() if led is not None else 0.0
        with self._fence:
            _, results = self._kernel(grain_class, method, B)(
                tbl.state, *operands)
        if self.track_load:
            tbl.record_hits(slots_b, valid_b)
        if led is not None:
            # rows = all lanes: a device mask is not synced to count it
            wall = max(0.0, time.perf_counter() - t_led)
            led.charge_tick((grain_class.__name__, method,
                             int(slots_b.shape[0] * B), wall, ()))
            if self.track_cost:
                tbl.record_cost(slots_b, valid_b, int(wall * 1e6))
        self.ticks += 1
        if isinstance(valid_b, np.ndarray):
            self.messages_processed += int(valid_b.sum())
        else:
            self.exchange_lanes += int(valid_b.shape[0] * B)
        return results

    # ------------------------------------------------------------------
    # Bulk-population collectives (MapReduce over actors): whole-
    # population fan-out/fan-in as ticks over the sharded table. Each
    # round re-resolves key locations (so grow/migration/checkpoint at
    # its await points is safe) and defers keys with queued or in-flight
    # per-key turns, as call_group conflicts defer.
    # ------------------------------------------------------------------
    def _bulk_resolve(self, cls: type, keys: np.ndarray | None
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
        """``(keys, shard, slot, fresh)`` of a bulk target set.
        ``keys=None`` targets every live activation (dense keys touched
        and resident hashed rows). An explicit subset may hold dense keys
        not yet active (they fresh-init this tick); non-resident hashed
        keys are skipped (the returned keys are the applied set)."""
        tbl = self.table(cls)
        if keys is None:
            dense = np.flatnonzero(tbl.dense_active).astype(np.int64)
            n_h = len(tbl.key_to_slot)
            hashed = np.fromiter(tbl.key_to_slot, dtype=np.int64,
                                 count=n_h)
            fresh = np.zeros(dense.size + n_h, dtype=bool)
        else:
            # one message per actor per bulk op
            keys = np.unique(np.asarray(keys, dtype=np.int64))
            is_dense = (keys >= 0) & (keys < tbl.dense_n)
            dense = keys[is_dense]
            resident = np.fromiter(
                (k in tbl.key_to_slot for k in keys[~is_dense].tolist()),
                dtype=bool, count=int((~is_dense).sum()))
            hashed = keys[~is_dense][resident]
            fresh = np.concatenate([
                ~tbl.dense_active[dense] if dense.size else
                np.zeros(0, bool),
                np.zeros(hashed.size, bool)])
        d_sh, d_sl = tbl.dense_shard_slot(dense)
        d_shard, d_slot = d_sh.astype(np.int32), d_sl.astype(np.int32)
        if hashed.size:
            locs = np.array([tbl.key_to_slot[int(k)] for k in hashed],
                            dtype=np.int32).reshape(-1, 2)
            h_shard, h_slot = locs[:, 0], locs[:, 1]
        else:
            h_shard = h_slot = np.zeros(0, dtype=np.int32)
        out_keys = np.concatenate([dense, hashed]) if hashed.size \
            else dense
        return (out_keys, np.concatenate([d_shard, h_shard]),
                np.concatenate([d_slot, h_slot]), fresh)

    def _bulk_args(self, cls: type, m, kwargs: dict | None, n: int,
                   B: int) -> dict:
        """ONE kwargs row broadcast to every lane of a ``[n, B]`` batch, on
        the device."""
        kwargs = kwargs or {}
        m.infer_schema(kwargs, lead=0)
        _validate_args(cls, m.name, m.args_schema, kwargs)
        return {f: torch.as_tensor(np.asarray(kwargs[f],
                                              dtype=numpy_dtype(dtype)))
                .to(self.device).expand(n, B, *shape)
                for f, (dtype, shape) in m.args_schema.items()}

    def _bulk_apply_once(self, cls: type, method: str, keys: np.ndarray,
                         shard: np.ndarray, slot: np.ndarray,
                         fresh: np.ndarray, kwargs: dict | None):
        """One bulk tick over resolved targets through call_batch_device
        (its fence, kernel and telemetry), plus the bookkeeping only the
        holder of the keys can do: dirty marks and dense activation.
        Returns ``(results_device, valid_b)``."""
        tbl = self.table(cls)
        m = self.method_of(cls, method)
        p = _pack_lanes(tbl, shard, slot, keys, fresh)
        args_b = self._bulk_args(cls, m, kwargs, tbl.n_shards, p.B)
        results = self.call_batch_device(
            cls, method, p.slots_b, p.khash_b,
            p.fresh_b if fresh.any() else None, p.valid_b, args_b)
        if not m.read_only:
            self._mark_dirty(cls, keys)
            if fresh.any():
                # a read-only tick writes no fresh-init row back, so only
                # a writing tick may mark its keys active
                tbl.mark_dense_active(keys[fresh])
        return results, p.valid_b

    def _busy_split(self, cls: type, keys: np.ndarray):
        """``(ready, deferred, busy_mask)`` against keys with queued or
        in-flight per-key turns; ``busy_mask`` is None when none is busy."""
        busy = self.pending_key_hashes(cls)
        if not busy:
            return keys, keys[:0], None
        mask = np.isin(keys, np.fromiter(busy, dtype=np.int64,
                                         count=len(busy)))
        return keys[~mask], keys[mask], mask

    async def _bulk_yield(self) -> None:
        """Let deferred per-key turns drain one round."""
        if self.pending:
            self._tick()
        if self._inflight:
            await self._quiesced.wait()
        else:
            await asyncio.sleep(0)

    async def _bulk_rounds(self, grain_class: type, method: str,
                           kwargs: dict | None, keys, skip_busy: bool,
                           on_apply) -> None:
        """The deferral-round loop of map_actors and reduce_actors:
        resolve → split off busy keys (unless ``skip_busy``: a read-only
        reduction has no turn to conflict with) → apply the ready slice
        → yield a tick round for the rest and re-resolve.
        ``on_apply(results, valid_b, n_ready)`` accumulates per round."""
        target_keys = keys
        while True:
            ks, shard, slot, fresh = self._bulk_resolve(grain_class,
                                                        target_keys)
            if skip_busy:
                ready, deferred, bmask = ks, ks[:0], None
            else:
                ready, deferred, bmask = self._busy_split(grain_class, ks)
            if ready.size:
                sel = slice(None) if bmask is None else ~bmask
                results, valid_b = self._bulk_apply_once(
                    grain_class, method, ks[sel], shard[sel], slot[sel],
                    fresh[sel], kwargs)
                on_apply(results, valid_b, int(ready.size))
            if not deferred.size:
                return
            target_keys = deferred
            await self._bulk_yield()

    async def map_actors(self, grain_class: type, method: str,
                         kwargs: dict | None = None,
                         keys: np.ndarray | None = None) -> int:
        """Apply ``method`` (one broadcast kwargs row) to every live
        activation of ``grain_class``, or to a key subset, as bulk ticks.
        Keys with per-key turns in flight defer to later rounds. Returns
        the number of activations applied."""
        refuse_on_group(self.mesh, "VectorRuntime.map_actors")
        m = self.method_of(grain_class, method)
        if m.args_schema is not None:
            # fail even when the live population is empty
            _validate_args(grain_class, method, m.args_schema, kwargs or {})
        applied = 0

        def on_apply(_results, _valid_b, n: int) -> None:
            nonlocal applied
            applied += n

        await self._bulk_rounds(grain_class, method, kwargs, keys, False,
                                on_apply)
        return applied

    async def reduce_actors(self, grain_class: type, method: str,
                            kwargs: dict | None = None,
                            keys: np.ndarray | None = None,
                            combine: str = "sum"):
        """Run ``method`` over the population and reduce the per-actor
        results on the device (``masked_reduce``): one row crosses to the
        host. ``combine``: "sum" | "max" | "min" | "mean" (mean = sum /
        count, combined exactly across rounds). Returns numpy values, or
        None when no live actor matched."""
        refuse_on_group(self.mesh, "VectorRuntime.reduce_actors")
        value, count = await self.reduce_actors_partial(
            grain_class, method, kwargs, keys, combine)
        if value is None or count == 0:
            return None
        if combine == "mean":
            return _tree_map(lambda v: v / count, value)
        return value

    async def reduce_actors_partial(self, grain_class: type, method: str,
                                    kwargs: dict | None = None,
                                    keys: np.ndarray | None = None,
                                    combine: str = "sum"):
        """``(partial_value, count)`` of :meth:`reduce_actors`, where a
        mean partial carries the sum: the form a cross-silo merge folds."""
        refuse_on_group(self.mesh, "VectorRuntime.reduce_actors_partial")
        op = "sum" if combine == "mean" else combine
        if op not in REDUCE_OPS:
            raise ValueError(
                f"combine must be one of {REDUCE_OPS + ('mean',)}, "
                f"got {combine!r}")
        m = self.method_of(grain_class, method)
        if m.args_schema is not None:
            _validate_args(grain_class, method, m.args_schema, kwargs or {})
        total = None
        count = 0
        fold = host_fold(op)

        def on_apply(results, valid_b, n: int) -> None:
            nonlocal total, count
            part = _tree_map(
                lambda t: t.cpu().numpy(),
                masked_reduce(results, self._upload(valid_b), op=op))
            count += n
            total = part if total is None else _tree_map2(fold, total, part)

        await self._bulk_rounds(grain_class, method, kwargs, keys,
                                m.read_only, on_apply)
        return total, count

    def _init_kernel(self, cls: type, B: int):
        """Bulk OnActivate: write ``initial_state(khash)`` rows at fresh
        lanes, in place; no handler, so it serves read-only methods too."""
        tbl = self.tables[cls]
        key = ("bulkinit", cls, B, tbl.capacity, tbl.n_shards)
        k = self._kernel_cache.get(key)
        if k is not None:
            return k
        init = vmap(cls.initial_state)

        def run(state, slots, khash, fresh):
            n = slots.shape[0]
            shard = torch.arange(n, device=slots.device)[:, None] \
                .expand(n, B)
            idx = (shard, slots.to(torch.int64))
            init_rows = init(khash.reshape(-1))
            for name, f in state.items():
                rows = f[idx]
                ir = init_rows[name].to(device=f.device, dtype=f.dtype) \
                    .reshape(rows.shape)
                f[idx] = torch.where(
                    fresh.reshape(fresh.shape + (1,) * (rows.ndim - 2)),
                    ir, rows)

        self._kernel_cache[key] = run
        return run

    def _bulk_activate(self, cls: type, keys: np.ndarray) -> None:
        """Fresh-init the not-yet-active dense keys a broadcast is about
        to deliver to, in one scatter, before apply_received's zero-fresh
        batches touch them."""
        tbl = self.table(cls)
        fresh = tbl.dense_fresh_mask(keys)
        if fresh is None:
            return
        ks = np.unique(keys[fresh])
        sh, sl = tbl.dense_shard_slot(ks)
        p = _pack_lanes(tbl, sh.astype(np.int32), sl.astype(np.int32), ks,
                        np.ones(ks.size, bool))
        kern = self._init_kernel(cls, p.B)
        with self._fence:
            kern(tbl.state, self._upload(p.slots_b), self._upload(p.khash_b),
                 self._upload(p.fresh_b))
        tbl.mark_dense_active(ks)

    async def broadcast_actors(self, grain_class: type, method: str,
                               targets: np.ndarray,
                               args: dict | None = None,
                               chunk: int = 16384) -> int:
        """Edge-list fan-out: deliver ``method`` to ``targets[i]`` with
        per-edge payload ``args[f][i]`` (scalars go to every edge).
        Targets are dense keys. Each chunk of ``chunk`` edges rides ONE
        exchange (``route``, K2) to the owning shards and is applied by
        :meth:`apply_received`, whose dedup gives duplicate targets the
        mailbox-defer semantics across ticks. Targets with per-key turns
        in flight defer to later rounds. Returns the edges delivered."""
        refuse_on_group(self.mesh, "VectorRuntime.broadcast_actors")
        tbl = self.table(grain_class)
        targets = np.asarray(targets, dtype=np.int64).reshape(-1)
        if targets.size and (targets.min() < 0
                             or targets.max() >= tbl.dense_n):
            raise ValueError(
                "broadcast_actors targets must be dense-regime keys "
                f"in [0, {tbl.dense_n}); route hashed-key traffic "
                "through map_actors/call paths")
        m = self.method_of(grain_class, method)
        E = targets.shape[0]
        args = args or {}
        if m.args_schema is None:
            m.args_schema = {
                k: (torch_dtype(np.asarray(v).dtype),
                    np.asarray(v).shape[1:] if np.asarray(v).ndim else ())
                for k, v in args.items()}
        schema = m.args_schema
        if set(args) != set(schema):
            _validate_args(grain_class, method, schema, args)
        flat_args = {f: np.broadcast_to(
                         np.asarray(args[f], dtype=numpy_dtype(dtype)),
                         (E, *shape))
                     for f, (dtype, shape) in schema.items()}
        delivered = 0
        pending = (targets, flat_args)
        while pending[0].size:
            tg, fa = pending
            _ready, deferred, bmask = self._busy_split(grain_class, tg)
            if deferred.size:
                pending = (tg[bmask], {f: a[bmask] for f, a in fa.items()})
                tg = tg[~bmask]
                fa = {f: a[~bmask] for f, a in fa.items()}
            else:
                pending = (tg[:0], {f: a[:0] for f, a in fa.items()})
            for off in range(0, tg.shape[0], chunk):
                if off:
                    # yield to the loop between chunks; one chunk stays
                    # the atomic quantum and chunks run in order
                    await asyncio.sleep(0)
                delivered += self._broadcast_chunk(
                    grain_class, method, tg[off:off + chunk],
                    {f: a[off:off + chunk] for f, a in fa.items()})
            if not pending[0].size:
                return delivered
            await self._bulk_yield()
        return delivered

    async def stream_fanout(self, grain_class: type, method: str,
                            targets: np.ndarray, args: dict | None = None,
                            chunk: int = 16384) -> int:
        """Device-stream delivery: one publish batch's per-subscriber
        fan-out through :meth:`broadcast_actors`. Items stacked item-major
        keep per-key event order (first occurrence wins each dedup
        round). Returns edge-events delivered."""
        refuse_on_group(self.mesh, "VectorRuntime.stream_fanout")
        targets = np.asarray(targets, dtype=np.int64).reshape(-1)
        d = await self.broadcast_actors(grain_class, method, targets, args,
                                        chunk=chunk)
        self.last_stream_group = int(targets.size)
        if self.stats is not None:
            self.stats.increment("streams.device.fanout_rounds")
        return d

    def _broadcast_chunk(self, cls: type, method: str,
                         targets: np.ndarray, args: dict) -> int:
        """Route one edge chunk to its owning shards and apply it,
        re-applying deduped duplicate-target lanes tick by tick until
        every edge lands. Synchronous, so no per-key turn interleaves."""
        tbl = self.table(cls)
        self._bulk_activate(cls, targets)
        n = tbl.n_shards
        E = targets.shape[0]
        if E == 0:
            return 0
        schema = tbl.methods[method].args_schema

        def padded(a, dtype, shape, pad):
            a = np.asarray(a, dtype=numpy_dtype(dtype))
            return np.concatenate([a, np.zeros((pad, *shape), a.dtype)])

        if n == 1:
            # lanes bucketed to a power of two, so chunk-size jitter
            # reuses the same batch shapes
            B = _bucket(E)
            pad = B - E
            recv_keys = self._upload(padded(targets, torch.int64, (),
                                            pad)[None])
            recv_valid = self._upload(np.arange(B) < E)[None]
            recv_args = {f: self._upload(padded(args[f], dtype, shape,
                                                pad)[None])
                         for f, (dtype, shape) in schema.items()}
        else:
            # the host is every shard's ingress: edges split over source
            # shards, padded to power-of-two lanes L, capacity L, so no
            # (src, dst) pair can overflow
            L = _bucket(-(-E // n))
            pad = n * L - E
            payload = {f: self._upload(padded(args[f], dtype, shape, pad)
                                       .reshape(n, L, *shape))
                       for f, (dtype, shape) in schema.items()}
            recv_keys, recv_args, recv_valid, drops = self.route(
                cls,
                self._upload(padded(targets, torch.int64, (), pad)
                             .reshape(n, L)),
                payload, self._upload((np.arange(n * L) < E).reshape(n, L)),
                capacity=L)
            # capacity == L: a drop means the invariant broke, not load
            assert int(drops.sum()) == 0
        delivered = 0
        valid = recv_valid
        while True:
            _res, applied = self.apply_received(cls, method, recv_keys,
                                                valid, recv_args)
            valid = valid & ~applied
            got = int(applied.sum())
            delivered += got
            # got == 0 with lanes left cannot happen for dense keys (the
            # first of each applies); the guard stops a logic bug spinning
            if int(valid.sum()) == 0 or got == 0:
                break
        if delivered and not tbl.methods[method].read_only:
            # broadcast holds its targets on the host, so the write-behind
            # flusher sees them (unlike device-resident exchange flows)
            self._mark_dirty(cls, np.unique(targets))
        return delivered

    async def join_when(self, grain_class: type, keys: np.ndarray,
                        k: int | None = None, *, method: str,
                        kwargs: dict | None = None,
                        timeout: float | None = None,
                        poll: float = 0.02) -> int:
        """Resolve when at least ``k`` of ``keys`` (default: all) report
        ready through ``method``, a read-only method returning 0/1 per
        actor. Each poll is one reduce_actors sum. Returns the ready
        count observed."""
        refuse_on_group(self.mesh, "VectorRuntime.join_when")
        keys = np.asarray(keys, dtype=np.int64)
        need = int(keys.size if k is None else k)
        return await join_poll(
            lambda: self.reduce_actors(grain_class, method, kwargs,
                                       keys=keys, combine="sum"),
            need, timeout, poll)

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
        if sparse:
            refuse_on_group(self.mesh, "VectorRuntime.route(sparse=True)")
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
        if sparse:
            refuse_on_group(self.mesh,
                            "VectorRuntime.apply_received(sparse=True)")
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
                        if scan_all_valid and _same_view(nr, r):
                            # a field passed through unchanged, still a
                            # view of the pool (one shard, contiguous
                            # rows): writing it over itself is a no-op
                            # that torch refuses as an overlapping copy
                            continue
                        write(k, nr if scan_all_valid else sel(v, nr, r))
                outs.append(shape_results(results, n, B, slots.device))
            return state, _stack_rounds(outs)

        return scanned


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` are the same elements of the same storage."""
    return a.data_ptr() == b.data_ptr() and a.shape == b.shape and \
        a.stride() == b.stride() and a.dtype == b.dtype


def _stack_rounds(outs: list):
    """Stack a list of per-round result trees along a new leading axis."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack_rounds([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_rounds([o[i] for o in outs])
                           for i in range(len(first)))
    return torch.stack(outs)
