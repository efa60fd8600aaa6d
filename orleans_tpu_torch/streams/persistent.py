"""Persistent (queue-backed) streams: adapters, balancer, pulling agents.

Re-design of Orleans' src/Orleans.Runtime/Streams/PersistentStream/:
``PersistentStreamPullingAgent.cs:13`` (timer-driven pull loop :141, read
:350-368, per-consumer delivery with backoff retry + IStreamFailureHandler),
``PersistentStreamPullingManager.cs:14`` (queue↔silo assignment), the
``IQueueAdapter`` abstraction (Core/Streams/PersistentStreams/), the
membership-driven ``DeploymentBasedQueueBalancer.cs:40``, and the Memory
adapter (OrleansProviders/Streams/Memory/MemoryAdapterFactory.cs:22 — there
backed by MemoryStreamQueueGrain; here a shared in-proc queue object standing
in for the external queue service).

The port's copy of ``orleans_tpu.streams.persistent``.
"""

from __future__ import annotations

import asyncio
import collections
import logging
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable

from ..core.asyncs import ExponentialBackoff, retry
from ..core.errors import StreamError
from .balancer import DeploymentBasedBalancer, QueueBalancer
from .cache import PooledQueueCache
from .core import StreamId, StreamProvider, SubscriptionHandle
from .pubsub import PubSubRendezvousGrain, deliver_to_consumer, resolve_consumers

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.streams.persistent")

__all__ = [
    "QueueBatch", "QueueAdapter", "QueueReceiver", "MemoryQueueAdapter",
    "GeneratorQueueAdapter",
    "PersistentStreamProvider", "PullingManager", "PullingAgent",
    "add_persistent_streams",
]


@dataclass
class QueueBatch:
    """One queued batch (IBatchContainer): events of one stream + cursor."""

    stream: StreamId
    items: list
    seq: int


class QueueAdapter:
    """External-queue abstraction (IQueueAdapter)."""

    name = "queue"
    n_queues = 8

    async def queue_message_batch(self, queue_id: int, stream: StreamId,
                                  items: list) -> None:
        raise NotImplementedError

    def create_receiver(self, queue_id: int) -> "QueueReceiver":
        raise NotImplementedError


class QueueReceiver:
    """Per-queue pull handle (IQueueAdapterReceiver)."""

    async def get_messages(self, max_count: int) -> list[QueueBatch]:
        raise NotImplementedError

    async def ack(self, batch: QueueBatch) -> None:  # noqa: B027
        pass

    def shutdown(self) -> None:  # noqa: B027
        """Abandon the receiver: unacked batches must become visible to the
        queue's next owner (IQueueAdapterReceiver.Shutdown — at-least-once
        across queue-ownership handoff)."""


class MemoryQueueAdapter(QueueAdapter):
    """In-proc shared queue bank: the dev/test "external queue service".
    One instance must be shared by every silo of the cluster (like a real
    queue service endpoint)."""

    def __init__(self, n_queues: int = 8, name: str = "memory"):
        self.name = name
        self.n_queues = n_queues
        self._queues: list[collections.deque[QueueBatch]] = [
            collections.deque() for _ in range(n_queues)]
        self._seq = 0

    async def queue_message_batch(self, queue_id, stream, items) -> None:
        # item-cumulative sequence: batch.seq is the token of the batch's
        # FIRST item, so per-item tokens (seq + i) are unique and ordered
        # across batches — the EventSequenceToken contract consumers dedup
        # and rewind by (per-batch numbering made tokens of adjacent
        # multi-item batches overlap)
        seq = self._seq
        self._seq += len(items)
        self._queues[queue_id].append(QueueBatch(stream, list(items), seq))

    def create_receiver(self, queue_id: int) -> "QueueReceiver":
        return _MemoryReceiver(self._queues[queue_id])


class _MemoryReceiver(QueueReceiver):
    def __init__(self, queue: collections.deque):
        self._queue = queue
        # ALL delivered-but-unacked batches, across pulls — acks may arrive
        # long after later pulls (cursor-paced consumers)
        self._inflight: list[QueueBatch] = []

    async def get_messages(self, max_count: int) -> list[QueueBatch]:
        out = []
        while self._queue and len(out) < max_count:
            out.append(self._queue.popleft())
        self._inflight.extend(out)
        return out

    async def ack(self, batch: QueueBatch) -> None:
        if batch in self._inflight:
            self._inflight.remove(batch)

    def shutdown(self) -> None:
        """Return unacked batches to the head of the shared queue (in order)
        so the queue's next owner redelivers them."""
        for batch in reversed(self._inflight):
            self._queue.appendleft(batch)
        self._inflight.clear()


class GeneratorQueueAdapter(QueueAdapter):
    """Self-generating adapter — the reference's Generator stream provider
    (OrleansProviders/Streams/Generator/GeneratorAdapter.cs: streams
    synthesized inside the receiver, no external queue), used for load
    and failure-injection testing of the pulling machinery.

    ``generate(queue_id, poll_index)`` returns ``(StreamId, items)`` for
    the next batch, or ``None`` when that queue is exhausted. Sequence
    tokens are item-cumulative per queue and namespaced by a per-queue
    stride, so tokens from different queues can never collide (a
    generator that emits one StreamId from several queues still gets
    distinct tokens; keep a stream on one queue if rewind offsets should
    be contiguous). A regenerated receiver (queue-ownership handoff)
    restarts its sequence — deterministic regeneration is the adapter's
    purpose, matching the reference's Generator provider. Producing into
    this adapter is an error — the generator is the only source."""

    def __init__(self, generate, n_queues: int = 4, name: str = "generator"):
        self.name = name
        self.n_queues = n_queues
        self._generate = generate

    async def queue_message_batch(self, queue_id, stream, items) -> None:
        raise StreamError(
            "GeneratorQueueAdapter synthesizes its own batches; "
            "on_next/on_next_batch cannot produce into it")

    def create_receiver(self, queue_id: int) -> "QueueReceiver":
        return _GeneratorReceiver(self._generate, queue_id)


_GENERATOR_TOKEN_STRIDE = 1 << 32


class _GeneratorReceiver(QueueReceiver):
    def __init__(self, generate, queue_id: int):
        self._generate = generate
        self._queue_id = queue_id
        self._poll = 0
        self._seq = queue_id * _GENERATOR_TOKEN_STRIDE
        self._done = False

    async def get_messages(self, max_count: int) -> list[QueueBatch]:
        out: list[QueueBatch] = []
        while not self._done and len(out) < max_count:
            produced = self._generate(self._queue_id, self._poll)
            self._poll += 1
            if produced is None:
                self._done = True
                break
            stream, items = produced
            out.append(QueueBatch(stream, list(items), self._seq))
            self._seq += len(items)
        return out


class _ConsumerPump:
    """One consumer's delivery loop over the agent's cache: an independent
    cursor + serial task, so a slow consumer throttles only itself (and,
    via cache pressure, the pull) — never other consumers."""

    def __init__(self, agent: "PullingAgent", stream: StreamId, handle):
        self.agent = agent
        self.stream = stream
        self.handle = handle
        self.key = (stream, handle.handle_id)
        self.cursor = agent.cache.new_cursor(self.key, from_oldest=True)
        self.wake = asyncio.Event()
        self.task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        agent = self.agent
        await self._replay_durable_history()
        while True:
            # clear BEFORE checking so a set() racing the check is kept
            self.wake.clear()
            cb = self._next_mine()
            if cb is None:
                await agent.evict_and_ack()  # yields: new batches may land
                cb = self._next_mine()
                if cb is None:
                    await self.wake.wait()
                    continue
            end = cb.batch.seq + len(cb.batch.items)
            if end <= agent.provider.replay_progress.get(self.key, 0):
                # fully below the recorded progress floor: this batch was
                # already delivered by durable-history replay (or an
                # earlier pump incarnation) — skip the avoidable duplicate
                continue
            await self._deliver(cb.batch)
            agent.provider.note_replay_progress(self.key, end)

    async def _replay_durable_history(self) -> None:
        """Rewind beyond the in-memory cache window: a subscription with a
        ``from_token`` older than anything cached replays ACKED batches
        from the durable queue log (the EventHub-offset retention replay;
        durable.DurableQueueAdapter.replay). Only acked batches: unacked
        ones redeliver through the normal pull, and this pump's cursor —
        created from_oldest BEFORE this runs — pins eviction, so no batch
        can slip between replay and the cache (at-least-once holds; cache
        batches overlapping what replay already delivered are skipped by
        the replay-progress floor in the delivery loop).

        The replay floor is max(subscription token, this silo's recorded
        delivery progress for the consumer): pumps are recreated on every
        queue rebalance / consumer-view churn, and without the progress
        floor each recreation would re-deliver the full retained history.
        Progress is silo-local — a queue handed to ANOTHER silo replays
        from the subscription token again (at-least-once; consumers dedup
        by token)."""
        ft = getattr(self.handle, "from_token", None)
        replay = getattr(self.agent.provider.adapter, "replay", None)
        if ft is None or replay is None:
            return
        progress = self.agent.provider.replay_progress
        floor = max(ft, progress.get(self.key, ft))
        try:
            history = await replay(self.stream, floor)
        except Exception:  # noqa: BLE001 — replay is best-effort recovery
            log.exception("durable replay failed for %s", self.stream)
            return
        for batch in sorted(history, key=lambda b: b.seq):
            await self._deliver(batch)
            self.agent.provider.note_replay_progress(
                self.key, batch.seq + len(batch.items))

    def _next_mine(self):
        """Advance past other streams' batches to the next batch of ours."""
        while True:
            cb = self.agent.cache.next(self.cursor)
            if cb is None or cb.batch.stream == self.stream:
                return cb

    async def _deliver(self, batch: QueueBatch) -> None:
        silo = self.agent.provider.silo
        # shared across retry attempts: a mid-batch failure resumes at the
        # failed item instead of re-applying delivered ones
        progress: dict = {}
        try:
            await retry(
                lambda: deliver_to_consumer(
                    silo, self.handle, batch.items, batch.seq, progress),
                max_attempts=self.agent.max_delivery_attempts,
                backoff=ExponentialBackoff(min_delay=0.05, max_delay=2.0))
        except Exception as exc:  # noqa: BLE001 — retries exhausted
            self.agent.provider.on_delivery_failure(
                self.handle, self.stream, batch, exc)

    def stop(self) -> None:
        self.agent.cache.remove_cursor(self.key)
        self.task.cancel()


class PullingAgent:
    """One owned queue's pump (PersistentStreamPullingAgent.cs:13): pull
    into a cursor-based PooledQueueCache, fan out via independent
    per-consumer pumps, ack batches upstream only once every cursor has
    passed them, and pause pulling while the cache is under pressure —
    slow consumers throttle the pull instead of forcing redelivery."""

    def __init__(self, provider: "PersistentStreamProvider", queue_id: int,
                 pull_period: float, max_batch: int,
                 max_delivery_attempts: int = 3, cache_capacity: int = 256,
                 consumer_refresh_period: float = 1.0):
        self.provider = provider
        self.queue_id = queue_id
        self.pull_period = pull_period
        self.max_batch = max_batch
        self.max_delivery_attempts = max_delivery_attempts
        self.consumer_refresh_period = consumer_refresh_period
        self.receiver = provider.adapter.create_receiver(queue_id)
        self.cache = PooledQueueCache(capacity=cache_capacity)
        self.pumps: dict[tuple, _ConsumerPump] = {}
        self._streams_seen: dict[StreamId, float] = {}  # stream -> last refresh
        self._stream_activity: dict[StreamId, float] = {}  # stream -> last batch
        self.stream_idle_ttl = 5 * consumer_refresh_period
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        for pump in self.pumps.values():
            pump.stop()
        self.pumps.clear()
        # hand unacked work back to the queue for the next owner
        try:
            self.receiver.shutdown()
        except Exception:  # noqa: BLE001
            log.exception("receiver shutdown failed for queue %d",
                          self.queue_id)

    async def _run(self) -> None:
        silo = self.provider.silo
        loop = asyncio.get_running_loop()
        while True:
            if self.cache.under_pressure:
                # backpressure: the slowest consumer gates the pull
                # (SimpleQueueCache under-pressure semantics)
                await asyncio.sleep(self.pull_period)
                await self.evict_and_ack()
                continue
            try:
                batches = await self.receiver.get_messages(self.max_batch)
            except Exception:  # noqa: BLE001
                log.exception("queue %d read failed", self.queue_id)
                batches = []
            for batch in batches:
                self.cache.add(batch)
                silo.stats.increment("streams.persistent.pulled",
                                     len(batch.items))
            streams = {b.stream for b in batches}
            now = loop.time()
            for stream in streams:
                self._stream_activity[stream] = now
            # refresh pub-sub views for streams that are new or stale;
            # prune streams gone idle with no consumers and nothing cached
            # (the agent's stream-TTL purge — otherwise dead streams are
            # re-resolved forever)
            cached_streams = self.cache.cached_streams() \
                if len(streams) < len(self._streams_seen) else set()
            for stream in list(self._streams_seen):
                if now - self._streams_seen[stream] \
                        > self.consumer_refresh_period:
                    has_pump = any(k[0] == stream for k in self.pumps)
                    idle = now - self._stream_activity.get(stream, now) \
                        > self.stream_idle_ttl
                    if idle and not has_pump and stream not in cached_streams:
                        self._streams_seen.pop(stream, None)
                        self._stream_activity.pop(stream, None)
                        # a reappearing stream must re-pin eviction until
                        # its consumer view is re-resolved
                        self.cache.resolved_streams.discard(stream)
                    else:
                        streams.add(stream)
            for stream in streams:
                await self._refresh_consumers(stream, now)
            if batches:
                for pump in self.pumps.values():
                    pump.wake.set()
            else:
                await asyncio.sleep(self.pull_period)

    async def _refresh_consumers(self, stream: StreamId, now: float) -> None:
        """Reconcile per-consumer pumps with the pub-sub view
        (the agent's AddSubscriber/RemoveSubscriber path)."""
        self._streams_seen[stream] = now
        try:
            handles = await resolve_consumers(self.provider.silo, stream)
        except Exception:  # noqa: BLE001
            log.exception("pubsub resolve failed for %s", stream)
            return
        live = {(stream, h.handle_id) for h in handles}
        for key in [k for k in self.pumps if k[0] == stream and k not in live]:
            self.pumps.pop(key).stop()
            # the subscription itself is gone (pubsub unregister), not a
            # rebalance-driven pump recreation: its replay floor will never
            # be consulted again — drop it or it leaks per dead handle_id
            self.provider.replay_progress.pop(key, None)
        for h in handles:
            key = (stream, h.handle_id)
            if key not in self.pumps:
                self.pumps[key] = _ConsumerPump(self, stream, h)
                self.pumps[key].wake.set()
        # consumer view now known: cached batches for this stream may be
        # evicted once cursors pass (or immediately, if no consumers) —
        # until this point they pin the cache's eviction floor
        self.cache.resolved_streams.add(stream)

    async def evict_and_ack(self) -> None:
        """Evict fully-consumed batches and ack them upstream — at-least-once
        delivery: a batch leaves the external queue only after every
        consumer cursor has passed it. Acks are independent (each marks a
        distinct seq) and go out concurrently so a group-committing
        durable backend coalesces them into shared fsyncs."""
        purged = self.cache.purge()
        if not purged:
            return
        results = await asyncio.gather(
            *(self.receiver.ack(b) for b in purged),
            return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                log.warning("ack failed for queue %d: %r",
                            self.queue_id, r)


class PullingManager:
    """Per-silo agent manager (PersistentStreamPullingManager.cs:14):
    recomputes owned queues from the membership view and starts/stops
    agents on re-balance."""

    def __init__(self, provider: "PersistentStreamProvider",
                 rebalance_period: float = 2.0):
        self.provider = provider
        self.rebalance_period = rebalance_period
        self.agents: dict[int, PullingAgent] = {}
        self._task: asyncio.Task | None = None
        self._kick = asyncio.Event()

    def start(self) -> None:
        silo = self.provider.silo
        if silo.membership is not None:
            silo.membership.subscribe(lambda a, d: self._kick.set())
        self._task = asyncio.get_running_loop().create_task(self._loop())
        self._kick.set()

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        for agent in self.agents.values():
            agent.stop()
        self.agents.clear()
        self.provider.balancer.close(self.provider.silo.silo_address)

    async def _loop(self) -> None:
        while True:
            try:
                await asyncio.wait_for(self._kick.wait(),
                                       timeout=self.rebalance_period)
            except asyncio.TimeoutError:
                pass
            self._kick.clear()
            try:
                await self._rebalance()
            except Exception:  # noqa: BLE001
                log.exception("stream queue rebalance failed")

    async def _rebalance(self) -> None:
        """Recompute owned queues via the provider's balancer; the loop's
        period doubles as the lease renewal timer for LeaseBasedBalancer."""
        p = self.provider
        me = p.silo.silo_address
        alive = p.silo.locator.alive_list
        mine = await p.balancer.owned_queues(
            p.adapter.n_queues, p.adapter.name, me, alive)
        for q in list(self.agents):
            if q not in mine:
                self.agents.pop(q).stop()
        for q in mine:
            if q not in self.agents:
                agent = PullingAgent(
                    p, q, p.pull_period, p.max_batch,
                    max_delivery_attempts=p.max_delivery_attempts,
                    cache_capacity=p.cache_capacity)
                agent.start()
                self.agents[q] = agent


class PersistentStreamProvider(StreamProvider):
    """Queue-backed provider (PersistentStreamProvider.cs)."""

    def __init__(self, silo: "Silo", name: str, adapter: QueueAdapter,
                 pull_period: float = 0.1, max_batch: int = 32,
                 failure_handler: Callable | None = None,
                 balancer: "QueueBalancer | None" = None,
                 cache_capacity: int = 256,
                 rebalance_period: float = 2.0,
                 max_delivery_attempts: int = 3):
        super().__init__(silo, name)
        self.adapter = adapter
        self.pull_period = pull_period
        self.max_batch = max_batch
        # per-batch delivery retries before the failure handler takes the
        # batch (StreamPubSubMatch retry discipline): size this to outlast
        # expected partition/failover windows when zero loss is required
        self.max_delivery_attempts = max_delivery_attempts
        self.failure_handler = failure_handler
        self.balancer = balancer or DeploymentBasedBalancer()
        self.cache_capacity = cache_capacity
        self.manager = PullingManager(self, rebalance_period=rebalance_period)
        # silo-local delivery progress per (stream, handle_id): the floor
        # for durable-history replay across pump recreations. Entries for
        # unsubscribed handles are dropped at pump reconciliation; the LRU
        # cap below catches handles removed while this silo did not own
        # the queue (losing a floor only re-delivers — at-least-once holds)
        self.replay_progress: dict[tuple, int] = {}

    _REPLAY_PROGRESS_CAP = 4096

    def note_replay_progress(self, key: tuple, end: int) -> None:
        """Raise the delivery floor for (stream, handle_id); re-insertion
        keeps the dict ordered by last update so the cap evicts the
        longest-idle floors first."""
        prog = self.replay_progress
        cur = prog.pop(key, 0)
        prog[key] = max(cur, end)
        while len(prog) > self._REPLAY_PROGRESS_CAP:
            prog.pop(next(iter(prog)))

    async def produce(self, stream: StreamId, items: list) -> None:
        queue_id = stream.uniform_hash % self.adapter.n_queues
        await self.adapter.queue_message_batch(queue_id, stream, items)
        # count AFTER the adapter accepts: a rejecting adapter (e.g. the
        # generator provider) must not inflate the produced counter
        self.silo.stats.increment("streams.persistent.produced", len(items))

    async def register_consumer(self, handle: SubscriptionHandle) -> None:
        await self._rendezvous(handle.stream).register_consumer(handle)

    async def unregister_consumer(self, handle: SubscriptionHandle) -> None:
        await self._rendezvous(handle.stream).unregister_consumer(
            handle.handle_id)

    async def consumer_handles(self, stream: StreamId):
        return await resolve_consumers(self.silo, stream)

    def on_delivery_failure(self, handle: SubscriptionHandle,
                            stream: StreamId, batch: QueueBatch,
                            exc: BaseException) -> None:
        """IStreamFailureHandler: called after delivery retries exhaust."""
        self.silo.stats.increment("streams.persistent.delivery_failures")
        if self.failure_handler is not None:
            self.failure_handler(handle, stream, batch, exc)
        else:
            log.warning("dropping %d events of %s for %s after retries: %s",
                        len(batch.items), stream, handle.grain_id, exc)

    def _rendezvous(self, stream: StreamId):
        return self.silo.grain_factory.get_grain(
            PubSubRendezvousGrain, str(stream))


def add_persistent_streams(builder, name: str, adapter: QueueAdapter,
                           **kw):
    """Register a queue-backed provider on a SiloBuilder. ``adapter`` must
    be the cluster-shared queue object (the external queue service)."""
    builder.add_grains(PubSubRendezvousGrain)

    def install(silo) -> None:
        provider = PersistentStreamProvider(silo, name, adapter, **kw)
        silo.stream_providers[name] = provider
        from ..runtime.silo import ServiceLifecycleStage
        silo.subscribe_lifecycle(
            ServiceLifecycleStage.RUNTIME_GRAIN_SERVICES,
            provider.manager.start, provider.manager.stop)

    return builder.configure(install)
