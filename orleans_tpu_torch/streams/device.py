"""Device-tier stream provider: namespace fan-out compiled onto the bulk
collectives.

The per-subscriber delivery loop of the host-tier providers (one envelope
per ``SubscriptionHandle`` — pubsub.deliver_to_consumer) is replaced, for
vector-grain consumers, by the engine's broadcast machinery: the subscriber
table of a namespace is materialized as ONE dense edge list per
(vector-class, method) group, and publishing a batch compiles into
``stream_fanout`` edge exchanges — one ``parallel.transport`` hop per silo
per delivery batch instead of one envelope per subscriber (the DrJAX
broadcast-as-primitive direction, arXiv 2403.07128).

Sequence tokens and rewind ride the existing :class:`PooledQueueCache`:
every produced item consumes one token (item-cumulative, like the
persistent provider's ``QueueBatch.seq``), each delivery group owns a
cache cursor, and a rewound subscription replays exactly-from-token
through a solo catch-up cursor that merges into the fused edge list once
it reaches the group's position. Backpressure is the cache's
``under_pressure`` signal surfaced through the silo's queue-wait-trend —
no new mechanism.

QoS invariant (regression-guarded since the batched-ingress PRs): stream
delivery batches ride APPLICATION envelopes end to end — PING/SYSTEM
lanes never carry them.

The port's copy of ``orleans_tpu.streams.device``.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

import numpy as np

from ..core.errors import StreamError
from ..core.ids import GrainCategory, GrainId, GrainType
from .cache import PooledQueueCache
from .core import (StreamId, StreamProvider, StreamSignal,
                   SubscriptionHandle)
from .persistent import QueueBatch

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.streams.device")

__all__ = ["DeviceSubscription", "DeviceStreamProvider",
           "add_device_streams"]

# keys hashed per event-loop slice during an ownership-partition rebuild:
# a 1M-subscriber edge list is ~250 slices with a loop yield between
# each, so membership probes keep answering while the table rebuilds
# (hashing the whole list inline would stall the loop for seconds and
# fabricate suspicion votes — the QoS failure the gauntlet scenario
# guards). The slice is sized so ONE slice's hashing stays well under
# the membership probe period: a probe that lands mid-rebuild waits at
# most one slice, not the whole pass.
_HASH_SLICE = 4096
# edge-events per stacked dispatch round: items of one cached batch stack
# item-major (np.tile targets + np.repeat payload rows) up to this bound,
# so a celebrity-sized edge list still dispatches in bounded host memory
_STACK_LIMIT = 1 << 20


def _owner_hash(type_code: int, key: int) -> int:
    """The ring-routing hash of a dense int key WITHOUT touching the
    GrainId intern table (partitioning a million-key edge list through
    ``for_grain`` would churn the bounded intern cache that per-key
    traffic relies on). Constructing the frozen dataclass directly
    computes the same ``uniform_hash`` as ``GrainId.for_grain``."""
    return GrainId(GrainCategory.GRAIN, type_code, int(key)).uniform_hash


@dataclass
class DeviceSubscription:
    """One vector-grain subscription: every event published to
    ``namespace`` is delivered to rows ``keys`` of ``vcls`` through
    ``method``. Until a rewound subscription (``from_token``) catches up
    it replays through a solo cursor; ``live`` flips when it merges into
    the group's fused edge list."""

    namespace: str
    vcls: type
    method: str
    keys: np.ndarray
    sub_id: int
    from_token: int | None = None
    live: bool = False
    # ownership-partition cache (ring-fingerprint keyed) for the solo
    # catch-up phase; the live phase uses the group's
    parts: dict | None = None
    ring_sig: tuple | None = None


class _FanoutGroup:
    """The anchor-side subscriber table for one (namespace, vector-class,
    method): live subscriptions fused into ONE dense edge list (rebuilt on
    subscribe/unsubscribe at batch boundaries), one cache cursor, and the
    ownership partition cached per ring fingerprint."""

    def __init__(self, ns_name: str, vcls: type, method: str,
                 cache: PooledQueueCache):
        self.vcls = vcls
        self.method = method
        self.subs: dict[int, DeviceSubscription] = {}
        self.edges = np.zeros(0, dtype=np.int64)
        self.parts: dict | None = None
        self.ring_sig: tuple | None = None
        # group cursor starts at the write head: a new group only hears
        # batches produced after it exists (pre-subscribe backlog belongs
        # to rewound subscriptions' catch-up cursors)
        self.cursor = cache.new_cursor(("grp", ns_name, vcls.__name__,
                                        method), from_oldest=False)
        # serializes deliveries with subscribe/unsubscribe drains so an
        # edge-list rebuild never lands mid-batch (changes take effect at
        # batch boundaries — the per-consumer order contract)
        self.lock = asyncio.Lock()

    def rebuild(self) -> None:
        arrs = [s.keys for s in self.subs.values() if s.live]
        self.edges = (np.concatenate(arrs) if arrs
                      else np.zeros(0, dtype=np.int64))
        self.parts = None
        self.ring_sig = None


class _Namespace:
    """Per-namespace pump state: one PooledQueueCache, item-cumulative
    sequence tokens, the fan-out groups, and rewound catch-up cursors."""

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.cache = PooledQueueCache(capacity=capacity)
        self.seq = 0                       # next item sequence token
        self.groups: dict[tuple, _FanoutGroup] = {}
        # sub_id -> (subscription, solo cursor) while catching up
        self.catchup: dict[int, tuple] = {}
        self.wake = asyncio.Event()
        self.publish_ts: dict[int, float] = {}   # cache token -> loop.time
        self.task: asyncio.Task | None = None


class DeviceStreamProvider(StreamProvider):
    """Stream provider whose consumers are vector-grain rows and whose
    delivery path is the bulk-collective fan-out (``engine.stream_fanout``
    → broadcast edge exchanges under the tick fence). Subscribe whole key
    sets with :meth:`subscribe_keys`; ``StreamRef.subscribe`` bridges
    single-key vector consumers onto the same table."""

    def __init__(self, silo: "Silo", name: str,
                 cache_capacity: int | None = None,
                 chunk: int = 16384,
                 backpressure_poll: float = 0.005):
        super().__init__(silo, name)
        self.cache_capacity = int(
            cache_capacity
            if cache_capacity is not None
            else getattr(silo.config, "stream_device_cache_capacity", 1024))
        self.chunk = chunk
        self.backpressure_poll = backpressure_poll
        self._namespaces: dict[str, _Namespace] = {}
        self._sub_seq = 0
        self._handle_subs: dict[str, DeviceSubscription] = {}
        self._running = False
        # last stacked delivery-group size (edge-events per dispatch) —
        # the streams.delivery_group gauge source
        self.last_delivery_group = 0

    # -- lifecycle -------------------------------------------------------
    async def start(self) -> None:
        self._running = True
        for ns in self._namespaces.values():
            self._ensure_pump(ns)

    async def stop(self) -> None:
        self._running = False
        tasks = []
        for ns in self._namespaces.values():
            ns.wake.set()
            if ns.task is not None:
                ns.task.cancel()
                tasks.append(ns.task)
                ns.task = None
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass

    def _ns(self, name: str) -> _Namespace:
        ns = self._namespaces.get(name)
        if ns is None:
            ns = _Namespace(name, self.cache_capacity)
            self._namespaces[name] = ns
            if self._running:
                self._ensure_pump(ns)
        return ns

    def _ensure_pump(self, ns: _Namespace) -> None:
        if ns.task is None:
            ns.task = asyncio.get_running_loop().create_task(
                self._pump(ns))

    # -- subscribe surface ----------------------------------------------
    def _vector_class(self, vcls_or_name) -> type:
        name = (vcls_or_name if isinstance(vcls_or_name, str)
                else vcls_or_name.__name__)
        vcls = self.silo.vector_interfaces.get(name)
        if vcls is None or self.silo.vector is None:
            raise StreamError(
                f"DeviceStreamProvider consumers must be registered "
                f"vector-grain classes; {name!r} is not one on this silo "
                f"(host-tier consumers belong on an SMS/persistent "
                f"provider)")
        return vcls

    async def subscribe_keys(self, namespace: str, vcls: type, keys,
                             method: str = "on_next",
                             from_token: int | None = None
                             ) -> DeviceSubscription:
        """Subscribe dense-regime rows ``keys`` of ``vcls`` to every event
        of ``namespace``. Takes effect at a batch boundary: the group
        drains in-flight batches against the OLD edge list first, so no
        subscriber sees a partial batch. ``from_token`` rewinds: the new
        subscription replays exactly-from-token out of the cache window
        (clamped to oldest-cached, the reference's replay contract)
        through the same bulk path, then merges into the fused list."""
        vcls = self._vector_class(vcls)
        rt = self.silo.vector
        tbl = rt.table(vcls)
        keys = np.asarray(keys, dtype=np.int64).reshape(-1)
        if keys.size and (keys.min() < 0 or keys.max() >= tbl.dense_n):
            raise StreamError(
                f"device stream subscribers must be dense-regime keys in "
                f"[0, {tbl.dense_n}); hashed-key subscriber sets are a "
                f"ROADMAP follow-on")
        rt.method_of(vcls, method)  # typo fails at subscribe, not publish
        ns = self._ns(namespace)
        grp = ns.groups.get((vcls.__name__, method))
        if grp is None:
            grp = _FanoutGroup(namespace, vcls, method, ns.cache)
            ns.groups[(vcls.__name__, method)] = grp
        self._sub_seq += 1
        sub = DeviceSubscription(namespace, vcls, method, keys,
                                 self._sub_seq, from_token)
        grp.subs[sub.sub_id] = sub
        if from_token is None:
            async with grp.lock:
                await self._drain_group(ns, grp)
                sub.live = True
                grp.rebuild()
        else:
            cur = ns.cache.new_cursor(("sub", sub.sub_id),
                                      from_oldest=True)
            ns.catchup[sub.sub_id] = (sub, cur)
            ns.wake.set()
        self.silo.stats.increment("streams.device.subscribed", keys.size)
        return sub

    async def unsubscribe_keys(self, sub: DeviceSubscription) -> None:
        """Remove a subscription at the next batch boundary: batches the
        group already holds cursors past still deliver; nothing after the
        rebuild does."""
        ns = self._namespaces.get(sub.namespace)
        if ns is None:
            return
        grp = ns.groups.get((sub.vcls.__name__, sub.method))
        entry = ns.catchup.pop(sub.sub_id, None)
        if entry is not None:
            ns.cache.remove_cursor(("sub", sub.sub_id))
        if grp is not None and sub.sub_id in grp.subs:
            async with grp.lock:
                await self._drain_group(ns, grp)
                del grp.subs[sub.sub_id]
                grp.rebuild()
                if not grp.subs:
                    ns.cache.remove_cursor(grp.cursor.consumer_key)
                    del ns.groups[(sub.vcls.__name__, sub.method)]

    # StreamRef.subscribe bridge: a single-key vector consumer is a
    # one-row subscribe_keys (the stream KEY is the row key)
    async def register_consumer(self, handle: SubscriptionHandle) -> None:
        vcls = self._vector_class(handle.interface_name)
        key = handle.grain_id.key
        sub = await self.subscribe_keys(
            handle.stream.namespace, vcls, [int(key)],
            method=handle.method_name, from_token=handle.from_token)
        self._handle_subs[handle.handle_id] = sub

    async def unregister_consumer(self, handle: SubscriptionHandle) -> None:
        sub = self._handle_subs.pop(handle.handle_id, None)
        if sub is not None:
            await self.unsubscribe_keys(sub)

    async def consumer_handles(self, stream: StreamId
                               ) -> list[SubscriptionHandle]:
        # key-set subscriptions are not per-handle records, so the
        # handle-form enumeration is empty by design; introspect via
        # the groups' DeviceSubscription objects instead
        return []

    # -- producer surface ------------------------------------------------
    async def produce(self, stream: StreamId, items: list) -> int:
        """Append a batch, assign item-cumulative sequence tokens, wake
        the pump. Returns the first token. Blocks (cooperatively) while
        the cache is under pressure — the wait is surfaced through the
        silo's queue-wait-trend shed signal, not a new mechanism."""
        ns = self._ns(stream.namespace)
        st = self.silo.stats
        data = []
        for it in items:
            if isinstance(it, StreamSignal):
                # device-tier kernel methods cannot take the signal call
                # shape (the implicit_consumers host-only rule); counted
                # and dropped rather than poisoning a batch
                st.increment("streams.device.signals_dropped")
                continue
            if not isinstance(it, dict):
                raise StreamError(
                    "device stream items must be dicts of method args "
                    f"(field -> value); got {type(it).__name__}")
            data.append(it)
        loop = asyncio.get_running_loop()
        if ns.cache.under_pressure:
            t0 = loop.time()
            st.increment("streams.device.backpressure_waits")
            while ns.cache.under_pressure and self._running:
                ns.wake.set()
                await asyncio.sleep(self.backpressure_poll)
            waited = loop.time() - t0
            st.observe("streams.produce.wait.seconds", waited)
            trend = getattr(self.silo, "shed_trend", None)
            if trend is not None:
                trend.note(waited)
        first = ns.seq
        ns.seq += len(data)
        cb = ns.cache.add(QueueBatch(stream=stream, items=data, seq=first))
        ns.cache.resolved_streams.add(stream)
        ns.publish_ts[cb.token] = loop.time()
        st.increment("streams.device.produced", len(data))
        ns.wake.set()
        return first

    # -- pump ------------------------------------------------------------
    async def _pump(self, ns: _Namespace) -> None:
        while self._running:
            await ns.wake.wait()
            ns.wake.clear()
            try:
                await self._drain(ns)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — isolate; next wake retries
                self.silo.stats.increment("streams.device.delivery_errors")
                log.exception("device stream pump for %r failed", ns.name)
                await asyncio.sleep(0.05)

    async def _drain(self, ns: _Namespace) -> None:
        progressed = True
        while progressed:
            progressed = False
            for grp in list(ns.groups.values()):
                async with grp.lock:
                    if await self._drain_group(ns, grp):
                        progressed = True
            for sub_id, (sub, cur) in list(ns.catchup.items()):
                if await self._drain_catchup(ns, sub, cur):
                    progressed = True
            self._promote_ready(ns)
        if ns.cache.purge():
            # evicted tokens are gone from every cursor's view; drop
            # their publish stamps (tokens are contiguous, so everything
            # below the current floor is evicted)
            floor = ns.cache.write_token - ns.cache.count
            for tok in [t for t in ns.publish_ts if t < floor]:
                ns.publish_ts.pop(tok, None)

    async def _drain_group(self, ns: _Namespace, grp: _FanoutGroup) -> int:
        """Deliver every cached batch the group cursor has not passed.
        Caller holds ``grp.lock``."""
        n = 0
        while True:
            cb = ns.cache.next(grp.cursor)
            if cb is None:
                return n
            delivered = await self._deliver_batch(ns, grp, grp, cb,
                                                  cb.batch.items,
                                                  grp.edges)
            n += 1
            if delivered:
                ts = ns.publish_ts.get(cb.token)
                if ts is not None:
                    self.silo.stats.observe(
                        "streams.delivery.seconds",
                        asyncio.get_running_loop().time() - ts)

    async def _drain_catchup(self, ns: _Namespace, sub: DeviceSubscription,
                             cur) -> int:
        """Replay cached batches >= the subscription's token through the
        SAME bulk path, trimming the partial batch at the token edge
        (the deliver_to_consumer rewind contract)."""
        n = 0
        while True:
            cb = ns.cache.next(cur)
            if cb is None:
                return n
            items = list(cb.batch.items)
            base = cb.batch.seq
            ft = sub.from_token or 0
            if base + len(items) <= ft:
                n += 1
                continue
            if base < ft:
                items = items[ft - base:]
            await self._deliver_batch(ns, sub, sub, cb, items, sub.keys)
            n += 1

    def _promote_ready(self, ns: _Namespace) -> None:
        """Merge caught-up rewound subscriptions into their group's fused
        edge list: both cursors at the write head means the solo replay
        and the group view agree on what has been delivered, so the merge
        is exactly at a batch boundary."""
        head = ns.cache.write_token
        for sub_id, (sub, cur) in list(ns.catchup.items()):
            grp = ns.groups.get((sub.vcls.__name__, sub.method))
            if grp is None:
                continue
            if cur.next_token >= head and grp.cursor.next_token >= head:
                del ns.catchup[sub_id]
                ns.cache.remove_cursor(("sub", sub_id))
                sub.live = True
                grp.rebuild()

    # -- delivery --------------------------------------------------------
    async def _deliver_batch(self, ns: _Namespace, grp, holder, cb,
                             items: list, edges: np.ndarray) -> int:
        """Fan one cached batch out to ``edges``: items stack item-major
        (np.tile targets / np.repeat payload rows) so apply_received's
        first-occurrence-wins dedup rounds deliver each key's events in
        token order, partitioned by ring ownership — the local part runs
        ``stream_fanout`` directly, each peer part rides ONE
        ``__stream_deliver__`` APPLICATION envelope."""
        if not items or edges.size == 0:
            return 0
        fields = set(items[0])
        for it in items:
            if set(it) != fields:
                raise StreamError(
                    f"device stream batch items must share one arg set; "
                    f"got {sorted(fields)} vs {sorted(set(it))}")
        parts = await self._parts_for(grp.vcls, holder, edges)
        me = self.silo.silo_address
        rt = self.silo.vector
        delivered = 0
        E = int(edges.size)
        blk = max(1, _STACK_LIMIT // max(E, 1))
        for off in range(0, len(items), blk):
            chunk_items = items[off:off + blk]
            self.last_delivery_group = E * len(chunk_items)
            work = []
            for addr, pe in parts.items():
                if pe.size == 0:
                    continue
                targets, args = _stack_items(pe, chunk_items)
                if addr == me:
                    work.append(rt.stream_fanout(
                        grp.vcls, grp.method, targets, args,
                        chunk=self.chunk))
                else:
                    work.append(self._send_remote(grp, targets, args,
                                                  addr))
            for got in await asyncio.gather(*work):
                delivered += int(got)
        self.silo.stats.increment("streams.device.delivered", delivered)
        led = self.silo.ledger
        if led is not None:
            # cost attribution: the pump runs on the silo loop, charge
            # the namespace's delivery count directly
            led.charge_stream(self.name, delivered)
        return delivered

    def _send_remote(self, grp: _FanoutGroup, targets: np.ndarray,
                     args: dict, addr):
        """One peer silo's slice of a delivery batch: a single
        ``__stream_deliver__`` envelope (APPLICATION category — the QoS
        rule) carrying a pre-partitioned ``local=True`` spec; the peer's
        dispatcher runs its stream_fanout."""
        spec = {"method": grp.method, "targets": targets, "args": args,
                "chunk": self.chunk, "local": True}
        gid = GrainId.for_grain(GrainType.of(grp.vcls.__name__),
                                f"__stream__{self.name}")
        return self.silo.runtime_client.send_request(
            target_grain=gid, grain_class=grp.vcls,
            interface_name=grp.vcls.__name__,
            method_name="__stream_deliver__", args=(),
            kwargs={"spec": spec}, target_silo=addr)

    # -- ownership partition --------------------------------------------
    async def _parts_for(self, vcls: type, holder, edges: np.ndarray
                         ) -> dict:
        """The edge list split by ring owner, cached per ring fingerprint
        on the holder (group or catch-up subscription) — partitions are
        rebuilt on subscribe/unsubscribe and on membership change, never
        per delivery. Locations therefore re-resolve per round: a reshard
        or migration between rounds invalidates the fingerprint and the
        next delivery re-partitions before touching the wire."""
        ring = self.silo.locator.ring
        sig = tuple(ring.silos)
        if holder.parts is None or holder.ring_sig != sig:
            holder.parts = await self._partition(vcls, edges, ring)
            holder.ring_sig = sig
        return holder.parts

    async def _partition(self, vcls: type, edges: np.ndarray, ring
                         ) -> dict:
        me = self.silo.silo_address
        if len(ring.silos) <= 1 or edges.size == 0:
            return {me: edges}
        tc = GrainType.of(vcls.__name__).type_code
        silos = list(ring.silos)
        idx_of = {s: i for i, s in enumerate(silos)}
        uniq, inv = np.unique(edges, return_inverse=True)
        uidx = np.empty(uniq.size, dtype=np.int64)
        for s in range(0, uniq.size, _HASH_SLICE):
            e = min(s + _HASH_SLICE, uniq.size)
            for j in range(s, e):
                owner = ring.owner(_owner_hash(tc, uniq[j])) or me
                uidx[j] = idx_of.get(owner, idx_of[me])
            # keep the loop breathing mid-rebuild: PING probes and turn
            # traffic must not queue behind a million blake2b calls
            await asyncio.sleep(0)
        per_edge = uidx[inv]
        out = {}
        for i, addr in enumerate(silos):
            m = per_edge == i
            if m.any():
                out[addr] = edges[m]
        return out

    # -- observability probes (MetricsSampler streams.* sources) ---------
    def stream_backlog(self) -> float:
        """Cached batches not yet passed by every cursor."""
        return float(sum(ns.cache.count
                         for ns in self._namespaces.values()))

    def stream_cursor_lag(self) -> float:
        """Worst cursor lag (batches) behind the write head."""
        lag = 0
        for ns in self._namespaces.values():
            head = ns.cache.write_token
            for cur in ns.cache.cursors.values():
                lag = max(lag, head - cur.next_token)
        return float(lag)

    def stream_delivery_group(self) -> float:
        """Edge-events in the last stacked dispatch (sustained 1 means
        the fan-out degenerated to per-event delivery)."""
        return float(self.last_delivery_group)


def _stack_items(edges: np.ndarray, items: list) -> tuple:
    """Item-major stacking of one delivery block: targets are
    ``np.tile(edges, B)`` and every payload field repeats per edge —
    lane order == token order per key, which is exactly the order
    apply_received's dedup rounds deliver duplicates in."""
    B = len(items)
    targets = np.tile(edges, B)
    args = {}
    for f in items[0]:
        vals = np.asarray([it[f] for it in items])
        args[f] = np.repeat(vals, edges.size, axis=0)
    return targets, args


def add_device_streams(builder, name: str = "device", **kw):
    """Install a :class:`DeviceStreamProvider` (the install idiom of
    ``add_persistent_streams``): provider registered under ``name``,
    lifecycle hooked at RUNTIME_GRAIN_SERVICES."""

    def install(silo):
        provider = DeviceStreamProvider(silo, name, **kw)
        silo.stream_providers[name] = provider
        from ..runtime.silo import ServiceLifecycleStage
        silo.subscribe_lifecycle(ServiceLifecycleStage.RUNTIME_GRAIN_SERVICES,
                                 provider.start, provider.stop)

    return builder.configure(install)
