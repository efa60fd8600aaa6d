"""Silo: composition root, lifecycle, message center, hosting builder.

Re-design of Orleans' src/Orleans.Runtime/Silo/Silo.cs:39 (ctor wiring
:124-260, StartAsync:267, staged start :377-564, stop :663-802), the hosting
builder (Hosting/Generic/SiloHostBuilder.cs:13, DefaultSiloServices.cs:99-195),
and the silo transport (Runtime/Messaging/MessageCenter.cs:12,
IncomingMessageAgent.cs:43, InboundMessageQueue.cs — three QoS queues with
dedicated draining).

The in-proc fabric (runtime.cluster.InProcFabric) replaces sockets for
single-host clusters and tests; the data plane for vectorized grains rides
device collectives (parallel.transport) instead of either.

The port's copy of ``orleans_tpu.runtime.silo``. A replicated journaled
grain class, whose module the port does not hold yet, is refused when the
silo is built (:func:`refuse_unported`, ``NotImplementedError`` naming the
module and its ROADMAP item).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable

from ..core.ids import GrainId, SiloAddress
from ..core.message import Category, Direction, Message
from ..core.serialization import copy_call_body, copy_result
from ..observability.stats import DISPATCH_STATS, StatsRegistry
from ..observability.stats import INGEST_STATS as _INGEST
from ..observability.tracing import mark_remote_if_traced

_INGEST_ENQUEUE = _INGEST["enqueue"]
from .activation import ActivationState
from ..storage.core import StorageManager
from .cancellation import TokenInterner
from .catalog import Catalog
from .context import current_activation, current_call_chain
from .dispatcher import Dispatcher
from .hotlane import marker_ids as _marker_ids
from .hotlane import try_hot_invoke as _hot_invoke
from .invoker import InvokerTable
from .references import GrainFactory
from .runtime_client import RuntimeClient

if TYPE_CHECKING:
    from .cluster import InProcFabric

log = logging.getLogger("orleans.silo")

__all__ = ["SiloConfig", "Silo", "SiloBuilder", "ServiceLifecycleStage"]


def refuse_unported(registry: "GrainRegistry") -> None:
    """Raise NotImplementedError for a grain class that needs a module the
    port does not hold yet."""
    for cls in registry.all_classes():
        if getattr(cls, "__journal_replicated__", False):
            raise NotImplementedError(
                f"{cls.__name__} is a replicated journaled grain, which "
                f"needs eventsourcing/journaled.py; orleans_tpu_torch does "
                f"not port it yet (ROADMAP Queue 1 item 18)")


# eager_task_factory is a per-loop setting shared by every silo on the
# loop (and the embedding app). Refcount installs so the last silo to
# stop restores whatever factory the application had before.
_eager_refs: dict[int, tuple[int, Any]] = {}


def _install_eager_factory(loop: asyncio.AbstractEventLoop) -> None:
    if not hasattr(asyncio, "eager_task_factory"):
        return  # pre-3.12 runtime: turns run through the ordinary factory
    key = id(loop)
    if key in _eager_refs:
        n, prev = _eager_refs[key]
        _eager_refs[key] = (n + 1, prev)
        return
    _eager_refs[key] = (1, loop.get_task_factory())
    loop.set_task_factory(asyncio.eager_task_factory)


def _uninstall_eager_factory(loop: asyncio.AbstractEventLoop) -> None:
    key = id(loop)
    if key not in _eager_refs:
        return
    n, prev = _eager_refs[key]
    if n <= 1:
        del _eager_refs[key]
        loop.set_task_factory(prev)
    else:
        _eager_refs[key] = (n - 1, prev)


class ServiceLifecycleStage:
    """Ordered stages (Core/Lifecycle/ServiceLifecycleStage.cs)."""

    RUNTIME_INITIALIZE = 2000
    RUNTIME_SERVICES = 4000
    RUNTIME_GRAIN_SERVICES = 6000
    APPLICATION_SERVICES = 8000
    ACTIVE = 10000


@dataclass
class SiloConfig:
    """Typed options (the Options-classes analog: SchedulingOptions,
    GrainCollectionOptions, SiloMessagingOptions defaults)."""

    name: str = "silo"
    cluster_id: str = "default"
    service_id: str = "default"
    response_timeout: float = 30.0
    # a turn older than this is "stuck": the activation is abandoned and
    # rebuilt (SiloMessagingOptions.MaxRequestProcessingTime)
    max_request_processing_time: float = 60.0
    # gateway load shedding (LoadSheddingOptions): when enabled, client
    # ingress is rejected GATEWAY_TOO_BUSY once the application inbound
    # queue backs up past the limit (the queue-depth analog of the
    # reference's CPU-threshold shed)
    load_shedding_enabled: bool = False
    load_shedding_limit: int = 10_000
    # queue-wait-trend shedding (the INGEST_STATS backpressure signal):
    # when > 0, client ingress is also shed while the WINDOWED mean of
    # observed ingest queue-wait (host turn start + device batch start)
    # exceeds this many seconds — depth alone misses slow-drain overload
    # where the queue stays short but every message waits long
    load_shedding_queue_wait: float = 0.0
    load_shedding_window: float = 5.0
    # batched ingress (the batched-ingress pipeline, wire.decode_frames →
    # MessageCenter.deliver_batch → grouped vector enqueue): off = the
    # per-frame decode + per-message hand-off (the A/B lever; bytes on
    # the wire are identical either way)
    batched_ingress: bool = True
    # multi-loop silo ingress (runtime.multiloop): N >= 2 spawns N
    # dedicated ingress pump threads, each running its own event loop
    # with its own (vectored, hotwire.sock_recv_batch) socket pump; the
    # listener hands accepted connections round-robin and decoded
    # batches ride SPSC hand-off rings to this loop's turn machinery.
    # PING/SYSTEM traffic bypasses the rings (QoS). Default 1 = today's
    # single-loop in-loop pump bit for bit; in-proc fabrics have no
    # sockets and ignore the knob.
    ingress_loops: int = 1
    # sharded egress (runtime.multiloop.EgressShardPool): the
    # outbound twin of ingress_loops. N >= 1 moves silo-peer senders
    # (dial + encode + write) and shard-owned client-route response
    # encode+writev onto shard loops, fed over SPSC egress rings from
    # this loop — borrowing the ingress shard that owns the inbound
    # half of the same peering when ingress_loops >= 2 (link-ownership
    # affinity), else spawning N dedicated egress loop threads.
    # PING/SYSTEM traffic bypasses the rings per-message (QoS).
    # Default 0 = today's main-loop senders/encode bit for bit (the
    # A/B lever); in-proc fabrics have no sockets and ignore the knob.
    egress_shards: int = 0
    # multi-process silo (runtime.multiproc): N >= 2 forks N
    # single-GIL worker processes at start(). Each worker is a full
    # cluster-member silo that binds the SAME advertised endpoint with
    # an SO_REUSEPORT listener — the kernel balances accepted
    # connections across workers and a connection pins to its accepting
    # worker for life (senders hash grains to connections, so the
    # multiloop per-grain FIFO argument carries over verbatim; host
    # activations live in the accepting worker). The device engine is
    # owned by THIS process only: workers feed vector calls through
    # cross-process SPSC staging rings on multiprocessing.shared_memory
    # and completions ride per-worker response rings back. Default 1 =
    # today's single-process path bit for bit (the A/B lever). Requires
    # a SocketFabric and a file-backed membership table.
    worker_procs: int = 1
    # batched egress (the response-path twin of batched_ingress):
    # responses resolved from one inbound batch group per origin in a
    # per-destination flush accumulator (runtime.egress.EgressBatcher)
    # and ride ONE MessageCenter.send_batch → encode_message_batch write
    # per destination (header-prefix template on the native build),
    # instead of N per-message send_response → transmit hops. Off = the
    # per-message response path bit for bit (the A/B lever; wire bytes
    # are identical either way)
    batched_egress: bool = True
    # off-loop device-tick pipeline (dispatch.engine): the staging fill,
    # operand upload, kernel dispatch, and host materialize sync of every
    # vector tick run on a dedicated worker thread behind a tick-
    # serialization fence, so host turns and the socket pump interleave
    # with device hand-off instead of queueing behind it. Off = today's
    # loop-inline tick (the A/B lever; results and turn semantics are
    # identical either way)
    offloop_tick: bool = True
    collection_age: float = 2 * 3600.0
    collection_quantum: float = 60.0
    max_enqueued_requests: int = 5000
    deactivation_timeout: float = 5.0
    detect_deadlocks: bool = False
    membership_probe_period: float = 1.0
    membership_probe_timeout: float = 1.0
    membership_missed_probes_limit: int = 3
    membership_votes_needed: int = 2
    membership_num_probed: int = 3
    membership_iam_alive_period: float = 5.0
    membership_refresh_period: float = 5.0
    membership_vote_expiration: float = 10.0
    directory_cache_size: int = 100_000
    # adaptive directory cache (AdaptiveGrainDirectoryCache.cs:178):
    # per-entry TTL doubles on revalidation up to the max; the maintainer
    # refreshes hot entries every refresh period (0 disables the loop)
    directory_cache_initial_ttl: float = 5.0
    directory_cache_max_ttl: float = 120.0
    directory_cache_refresh_period: float = 2.0
    turn_warning_length: float = 0.2  # TurnWarningLengthThreshold
    # distributed request tracing (observability.tracing /
    # config.TracingOptions): when enabled, a SpanCollector on the silo
    # records client/server/network/directory/device/migration spans for
    # requests head-sampled at trace_sample_rate, into a ring buffer of
    # trace_buffer_size spans (management surface + Perfetto export read
    # it). Disabled: zero collector, one None-check per hot-path site.
    trace_enabled: bool = False
    trace_sample_rate: float = 1.0
    trace_buffer_size: int = 4096
    # tail-based retention (config.TracingOptions.tail_*): keep/drop moves
    # from the head roll to trace completion — slow/errored/forced traces
    # survive, the rest drop after the quiescence window. Legs of traces
    # rooted on other silos buffer up to trace_tail_leg_ttl awaiting the
    # rooting silo's retention pull (ctl_trace_spans), then expire.
    trace_tail_enabled: bool = False
    trace_tail_window: float = 0.25
    trace_tail_slow_threshold: float = 0.1
    trace_tail_slow_percentile: float = 0.0
    # auto-tune the tail slow threshold from the root-duration percentile
    # history (LatencyErrorPolicy auto mode; config.TracingOptions.tail_auto)
    trace_tail_auto: bool = False
    trace_tail_leg_ttl: float = 2.0
    trace_tail_max_pending: int = 256
    # streaming OTLP/HTTP export of retained spans (export.OtlpSink);
    # None = no sink. Unreachable collectors degrade to counted drops.
    trace_otlp_endpoint: str | None = None
    trace_otlp_batch_size: int = 64
    trace_otlp_flush_interval: float = 0.5
    # ship OTLP bodies as protobuf wire bytes instead of the JSON mapping
    # (opt-in; requires google.protobuf importable, else falls back to
    # JSON with a warning — the JSON path is untouched when off)
    trace_otlp_protobuf: bool = False
    # live rebalancer (orleans_tpu.rebalance): plan/execute period in
    # seconds (0 disables the loop even when the service is installed),
    # per-round migration budget, and the hot/mean load ratio below which
    # a round is a no-op (hysteresis: don't churn a balanced cluster)
    rebalance_period: float = 0.0
    rebalance_budget: int = 8
    rebalance_imbalance_ratio: float = 1.2
    # ledger-fed host-tier rebalancing: when enabled (and the
    # ledger is on), the planner also plans moves for grains whose
    # CHARGED seconds run hot against the per-key mean — load the
    # activation-count signal cannot see
    rebalance_use_ledger: bool = False
    # run new turn tasks eagerly to their first suspension
    # (asyncio.eager_task_factory): a turn that completes without awaiting
    # skips the event-loop round trip entirely — the asyncio analog of the
    # reference's inline WorkItemGroup execution (WorkItemGroup.cs:269
    # runs queued tasks synchronously on the worker thread)
    eager_turns: bool = True
    # hot-lane dispatch (runtime.hotlane): frame-collapsed inline turns for
    # local gate-admitting calls. Off → every call takes the full messaging
    # path (the perf-floor A/B lever; semantics are identical either way)
    hot_lane_enabled: bool = True
    # live metrics pipeline (observability.metrics / config.MetricsOptions):
    # stage-level ingest instrumentation (decode/enqueue/queue-wait/
    # staging/transfer/tick histograms against the envelope's received_at
    # stamp) + the queue/backpressure sampler loop. Off = one attribute
    # check per instrumented site (guarded by
    # tests/test_perf_floors.py::test_floor_metrics_overhead when on).
    metrics_enabled: bool = False
    metrics_sample_period: float = 1.0
    metrics_window: float = 60.0
    # Prometheus/OpenMetrics pull endpoint (GET /metrics, stdlib HTTP):
    # None = no server, 0 = ephemeral port (read back from
    # silo.metrics_server.port)
    metrics_port: int | None = None
    # periodic OTLP metrics push (export.OtlpMetricsSink); None = no sink
    metrics_otlp_endpoint: str | None = None
    metrics_otlp_period: float = 5.0
    # protobuf wire encoding for the metrics push (same gate/fallback as
    # trace_otlp_protobuf)
    metrics_otlp_protobuf: bool = False
    # host-loop occupancy profiler + flight recorder (observability.
    # profiling.LoopProfiler / config.ProfilingOptions): when enabled the
    # silo interposes on its event loop's call_soon/call_at and buckets
    # every callback's wall time into named categories (turns, device
    # tick schedule/staging/transfer/SYNC, socket pump, storage IO,
    # observability internals, idle), keeps a bounded ring of per-window
    # occupancy slices + top-K slowest callbacks, and snapshots the ring
    # on anomalies (load shed, watchdog lag, tail-retained traces). Off
    # (default): NOTHING is installed — the loop keeps its class methods
    # and hot paths pay one None check per site.
    # SLO engine (observability.slo / config.SloOptions): a per-silo
    # SloMonitor loop evaluating declarative objectives (app ingest
    # latency, membership probe RTT, turn errors, gateway shed rate —
    # or silo.slo_specs) every slo_period seconds with multi-window
    # burn-rate detection (fast window catches, slow window confirms,
    # both over slo_burn_threshold× the error budget). Breach →
    # flight-recorder snapshot + tail-trace force-retention + slo.*
    # counters/gauges + telemetry event; cluster rollup via
    # ManagementGrain.get_cluster_slo. Evaluation rides interval-diffed
    # registry snapshots — zero new hot-path instrumentation.
    slo_enabled: bool = False
    slo_period: float = 1.0
    slo_fast_window: float = 60.0
    slo_slow_window: float = 300.0
    slo_burn_threshold: float = 4.0
    slo_min_events: int = 10
    slo_latency_threshold: float = 0.1
    slo_latency_target: float = 0.99
    slo_probe_target: float = 0.99
    slo_error_target: float = 0.999
    slo_shed_target: float = 0.99
    # stream delivery latency objective (publish -> consumer-turn, fed
    # from the streams.delivery.seconds histogram; metrics-gated like
    # app_latency — zero observations never burn)
    slo_stream_target: float = 0.99
    slo_stream_threshold: float = 0.25
    # device-tier streams (streams.device / config.StreamOptions):
    # device_fanout arms the bulk-collective delivery lever on the
    # persistent providers' vector path (stream_fanout edge exchanges
    # for dense bulk items); OFF keeps the per-consumer call_batch path
    # bit for bit — the A/B lever. cache_capacity bounds each device
    # namespace's PooledQueueCache (batches; pressure at 75%).
    stream_device_fanout: bool = False
    stream_device_cache_capacity: int = 1024
    # cost-attribution ledger (observability.ledger / config.
    # LedgerOptions): when enabled the silo charges every unit of work —
    # host-turn exec/queue seconds, device row-seconds, wire bytes per
    # route, stream deliveries — to (grain_class, method) × hashed-key ×
    # tenant, bounded by top-K space-saving sketches. Off (default):
    # silo.ledger is None, every charge site pays one attribute check.
    ledger_enabled: bool = False
    ledger_top_k: int = 32
    # label ("Class/key") -> tenant hook; host turns also read the
    # caller's "orleans.tenant" RequestContext baggage
    ledger_tenant_of: object = None
    profiling_enabled: bool = False
    profiling_window: float = 1.0          # seconds per occupancy slice
    profiling_ring: int = 120              # slices retained (flight data)
    profiling_top_k: int = 8               # slowest callbacks per window
    profiling_trigger_interval: float = 1.0  # min seconds between
    # snapshots per trigger reason (a shed storm -> one snapshot/interval)
    profiling_lag_threshold: float = 0.25  # sampler loop-lag over this
    # triggers a flight-recorder snapshot (watchdog triggers separately
    # at its own lag_warning)


class GrainRegistry:
    """interface-name → grain class map + construction
    (GrainTypeManager/GrainTypeManager.cs:19 + DefaultGrainActivator)."""

    def __init__(self) -> None:
        self._classes: dict[str, type] = {}
        self._factories: dict[type, Callable[[], Any]] = {}

    def register(self, *grain_classes: type,
                 factory: Callable[[], Any] | None = None) -> None:
        for cls in grain_classes:
            self._classes[cls.__name__] = cls
            if factory is not None:
                self._factories[cls] = factory

    def resolve(self, interface_name: str) -> type | None:
        return self._classes.get(interface_name)

    def construct(self, cls: type) -> Any:
        f = self._factories.get(cls)
        return f() if f else cls()

    def all_classes(self) -> list[type]:
        return list(self._classes.values())


class MessageCenter:
    """Silo transport endpoint: three category-partitioned inbound queues with
    dedicated pump tasks (InboundMessageQueue + IncomingMessageAgent), and the
    outbound hand-off to the fabric (OutboundMessageQueue)."""

    def __init__(self, silo: "Silo"):
        self.silo = silo
        self.inbound: dict[Category, asyncio.Queue[Message]] = {}
        self._pumps: list[asyncio.Task] = []
        self.running = False
        # ingest stage metrics (INGEST_STATS): cached so _route pays one
        # attribute load when metrics are off
        self._istats = silo.ingest_stats
        # batched response egress (runtime.egress.EgressBatcher): set by
        # the Silo ctor when batched_egress is on, else None — the
        # per-message send path pays one attribute check
        self.egress = None

    def start(self) -> None:
        self.running = True
        loop = asyncio.get_running_loop()
        for cat in Category:
            self.inbound[cat] = asyncio.Queue()
            self._pumps.append(loop.create_task(self._pump(cat)))

    def stop(self) -> None:
        if self.egress is not None:
            # hand any accumulated response groups to the fabric before
            # the center stops accepting work (the armed flush callback
            # may never run once the loop moves on to teardown)
            self.egress.flush()
        self.running = False
        for t in self._pumps:
            t.cancel()
        self._pumps.clear()

    def deliver(self, msg: Message) -> None:
        """Called by the fabric when a message arrives for this silo."""
        if not self.running:
            return
        if msg.received_at is None and (self.silo.tracer is not None
                                        or self.silo.ingest_stats is not None
                                        or self.silo.shed_trend is not None):
            # arrival stamp: queue-wait attribution measures from HERE
            # (inbound queue + mailbox) to turn start — tracing, the
            # ingest stage metrics, and the shed trend share the one
            # envelope slot (socket arrivals were already stamped at
            # decode)
            msg.received_at = time.monotonic()
        cfg = self.silo.config
        if (cfg.load_shedding_enabled
                and msg.category == Category.APPLICATION
                and msg.direction == Direction.REQUEST
                and (msg.target_silo is None
                     or msg.target_silo != self.silo.silo_address)
                and (self.inbound[Category.APPLICATION].qsize()
                     >= cfg.load_shedding_limit
                     or self._queue_wait_trending_high())):
            # gateway ingress under overload: shed before queueing
            # (Gateway load shedding, LoadSheddingOptions; rejection type
            # Message.cs:87-93 GatewayTooBusy). Silo-to-silo traffic is
            # never shed — only client ingress. The shed signal is queue
            # depth OR the windowed ingest queue-wait trend (when
            # configured): depth misses slow-drain overload where the
            # queue stays short but every message waits long.
            self.silo.stats.increment("messaging.gateway.shed")
            lp = self.silo.loop_prof
            if lp is not None:
                # anomaly hook: a shed is exactly the moment the loop's
                # recent occupancy explains — snapshot the flight ring
                # (rate-limited per reason inside trigger)
                depth = self.inbound[Category.APPLICATION].qsize()
                lp.trigger("queue_wait_trend"
                           if depth < cfg.load_shedding_limit
                           else "load_shed", queue_depth=depth)
            if msg.sending_silo is not None:
                from ..core.message import RejectionType, make_rejection
                rej = make_rejection(msg, RejectionType.GATEWAY_TOO_BUSY,
                                     "gateway overloaded; retry")
                rej.target_silo = msg.sending_silo
                self.silo.fabric.deliver(rej)
            return
        q = self.inbound[msg.category]
        if not q.qsize() and not cfg.load_shedding_enabled:
            # (with shedding on, ingress must accumulate in the queue —
            # queue depth IS the shed signal)
            # hot-path shortcut: nothing queued ahead of this message, so
            # routing inline preserves FIFO while skipping a queue hop +
            # pump-task wakeup per message (the asyncio analog of the
            # reference's inline WorkItemGroup execution; silo-to-self
            # sends already short-circuit the same way in
            # Dispatcher.transmit). Backlogged categories keep the queue
            # so shedding and fairness still apply.
            try:
                self._route(msg)
            except Exception:  # noqa: BLE001 — same contract as the pump
                log.exception("inbound routing failed for %s",
                              msg.method_name)
            return
        q.put_nowait(msg)

    def _queue_wait_trending_high(self) -> bool:
        trend = self.silo.shed_trend
        return (trend is not None and
                trend.mean() > self.silo.config.load_shedding_queue_wait)

    def deliver_batch(self, msgs: list) -> None:
        """Batched fabric arrival: the decoded contents of one socket
        read in ONE hand-off. Routing the batch as a unit is the
        queue-wait killer — vector-tier requests coalesce into grouped
        engine enqueues (dispatcher.receive_vector_batch → one
        ``call_group`` per method) instead of N per-message hops, and
        host-tier messages keep their inline-route fast path. Falls back
        to per-message :meth:`deliver` when shedding is enabled (queue
        depth is the shed signal, so ingress must accumulate) or a
        category is backlogged (queue semantics carry fairness then)."""
        if not self.running:
            return
        if (self.silo.tracer is not None or self._istats is not None
                or self.silo.shed_trend is not None):
            now = time.monotonic()
            for m in msgs:
                if m.received_at is None:  # socket arrivals pre-stamped
                    m.received_at = now
        if not self.silo.config.batched_ingress or \
                self.silo.config.load_shedding_enabled or \
                any(q.qsize() for q in self.inbound.values()):
            # per-message fall-back: the RECEIVING silo's A/B lever is
            # honored even when a co-hosted batched-mode silo's fabric
            # pump accepted the connection and grouped the read
            for m in msgs:
                self.deliver(m)
            return
        self._route_batch(msgs)

    def _route_batch(self, msgs: list) -> None:
        """Route one ingress batch inline (FIFO-preserving: nothing is
        queued ahead — deliver_batch checked). Vector-tier requests are
        peeled into per-class groups and handed to the dispatcher as
        units; everything else takes the ordinary per-message route."""
        ist = self._istats
        silo = self.silo
        vgroups: dict[type, list] = {}
        now = time.monotonic() if ist is not None else 0.0
        my_addr = silo.silo_address
        vifaces = silo.vector_interfaces
        cat_counts: dict = {}
        # silo-to-silo responses arriving in one wire batch correlate in
        # one pass (receive_response_batch: one freelist-release sweep)
        # when the batched response path is on; per-message otherwise
        responses: list | None = [] if silo.config.batched_egress else None
        for m in msgs:
            if ist is not None and m.received_at is not None:
                # ingest enqueue stage (~0 inline) — one clock read for
                # the whole batch; re-stamped BEFORE routing, the last
                # safe touch (routing may consume the envelope)
                ist.observe(_INGEST_ENQUEUE, now - m.received_at)
                m.received_at = now
            cat_counts[m.category] = cat_counts.get(m.category, 0) + 1
            if responses is not None and m.direction == Direction.RESPONSE:
                # grouped correlation: futures resolve via call_soon
                # either way, so deferring these past the batch's
                # requests reorders nothing observable
                responses.append(m)
                continue
            if m.direction != Direction.RESPONSE and vifaces:
                vcls = vifaces.get(m.interface_name)
                if vcls is not None:
                    # device-tier call: group — ownership/recovery checks
                    # run in receive_vector_batch (the ring-owner check
                    # there IS the addressing authority for vector keys,
                    # so skipping send_message addressing changes nothing)
                    g = vgroups.get(vcls)
                    if g is None:
                        g = vgroups[vcls] = []
                    g.append(m)
                    continue
            try:
                if m.direction != Direction.RESPONSE and (
                        m.target_silo is None or m.target_silo != my_addr):
                    m.target_silo = None
                    silo.dispatcher.send_message(m)
                else:
                    silo.dispatcher.receive_message(m)
            except Exception:  # noqa: BLE001 — same contract as the pump
                log.exception("inbound routing failed for %s",
                              m.method_name)
        stats = silo.stats
        for cat, c in cat_counts.items():
            # one counter add per category per batch, not per message
            stats.increment(self._RECEIVED_STAT[cat], c)
        if responses:
            try:
                silo.runtime_client.receive_response_batch(responses)
            except Exception:  # noqa: BLE001 — same contract as the pump
                log.exception("batched response correlation failed")
        for vcls, group in vgroups.items():
            try:
                silo.dispatcher.receive_vector_batch(vcls, group)
            except Exception:  # noqa: BLE001
                log.exception("vector batch routing failed for %s",
                              vcls.__name__)

    async def _pump(self, cat: Category) -> None:
        q = self.inbound[cat]
        while True:
            msg = await q.get()
            while True:
                try:
                    self._route(msg)
                except Exception:  # noqa: BLE001
                    log.exception("inbound routing failed for %s",
                                  msg.method_name)
                # drain whatever else arrived in one wakeup (the
                # IncomingMessageAgent drains its queue per scheduling
                # round, not one message per thread turn)
                try:
                    msg = q.get_nowait()
                except asyncio.QueueEmpty:
                    break

    _RECEIVED_STAT = {c: f"messaging.received.{c.name.lower()}"
                      for c in Category}

    def _route(self, msg: Message) -> None:
        ist = self._istats
        if ist is not None and msg.received_at is not None:
            # ingest enqueue stage: decode/arrival -> leaving the inbound
            # queue (inline routing makes this ~0; a backlogged category
            # shows its queue dwell here). Observed and re-stamped BEFORE
            # routing — the dispatcher may consume (and even recycle) the
            # envelope synchronously, so this is the last safe touch.
            now = time.monotonic()
            ist.observe(_INGEST_ENQUEUE, now - msg.received_at)
            msg.received_at = now
        self.silo.stats.increment(self._RECEIVED_STAT[msg.category])
        if msg.direction != Direction.RESPONSE and (
                msg.target_silo is None
                or msg.target_silo != self.silo.silo_address):
            # Gateway ingress / misrouted: address on this silo's authority
            # (Gateway.cs:17 + Dispatcher.AddressMessage)
            msg.target_silo = None
            self.silo.dispatcher.send_message(msg)
        else:
            self.silo.dispatcher.receive_message(msg)

    def send_message(self, msg: Message) -> None:
        """Outbound to another silo/client via the fabric
        (MessageCenter.SendMessage:177-191)."""
        eg = self.egress
        if eg is not None and eg.groups:
            # per-destination FIFO guard: a response group still pending
            # for this destination must reach the fabric BEFORE this
            # per-message send, or the send overtakes responses that
            # were handed off first (per-sender FIFO per target is the
            # wire's one ordering guarantee)
            eg.flush_dest(msg.target_silo)
        self.silo.stats.increment("messaging.sent")
        # "went remote" hint: any traced leg leaving this process means
        # retention must pull peers before export; traces that never pass
        # here are provably silo-local and skip the pull fan-out
        # (silo-local traffic loops back in dispatcher.transmit and never
        # reaches this method)
        mark_remote_if_traced(self.silo.tracer, msg)
        if msg.target_silo is not None and \
                self.silo.fabric.is_dead(msg.target_silo):
            # dead target (MessageCenter SiloDeadOracle, Silo.cs:347):
            # bounce a transient rejection to the sender so callers —
            # including external clients routed through this gateway —
            # re-address instead of waiting out the response timeout
            if msg.direction == Direction.REQUEST and \
                    msg.sending_silo is not None:
                from ..core.message import RejectionType, make_rejection
                rej = make_rejection(msg, RejectionType.TRANSIENT,
                                     f"target silo {msg.target_silo} dead")
                rej.target_silo = msg.sending_silo
                self.silo.fabric.deliver(rej)
            return
        self.silo.fabric.deliver(msg)

    def send_batch(self, dest, msgs: list) -> None:
        """Batched outbound: one response group for ONE destination rides
        a single fabric hand-off (``deliver_group`` — local silos get one
        ``deliver_batch``, gateway client routes one
        ``encode_message_batch`` write, remote silos one sender-queue
        fill). Per-message ``send_message`` semantics are mirrored: the
        sent counter, the went-remote trace hint, and the dead-target
        check (responses to a dead silo drop exactly like
        ``send_message``'s non-request case — there is no caller left to
        bounce to)."""
        self.silo.stats.increment("messaging.sent", len(msgs))
        tracer = self.silo.tracer
        if tracer is not None:
            for m in msgs:
                mark_remote_if_traced(tracer, m)
        fabric = self.silo.fabric
        if dest is not None and fabric.is_dead(dest):
            return
        deliver_group = getattr(fabric, "deliver_group", None)
        if deliver_group is not None:
            deliver_group(dest, msgs)
        else:
            for m in msgs:
                fabric.deliver(m)


# direct-call marker ids come from hotlane.marker_ids: ONE negative-id
# sequence for every running-marker kind, so concurrent direct-lane and
# hot-lane turns on one activation can never collide in running_since
_DIRECT_YIELD_EVERY = 256


class _DirectCallMarker:
    """Stand-in for a Message in ActivationData.running while a
    direct-interleave call executes: enough surface for the reentrancy
    gate (is_read_only), chain building (call_chain), and the
    stuck-activation probe (id keyed into running_since)."""

    __slots__ = ("id", "call_chain")
    is_read_only = False

    def __init__(self, id: int, call_chain: tuple):
        self.id = id
        self.call_chain = call_chain


class InsideRuntimeClient(RuntimeClient):
    """Silo-interior RPC engine (InsideRuntimeClient.cs:28)."""

    def __init__(self, silo: "Silo"):
        super().__init__(response_timeout=silo.config.response_timeout)
        self.silo = silo
        self._direct_calls_since_yield = 0
        self.hot_lane_enabled = silo.config.hot_lane_enabled

    @property
    def silo_address(self) -> SiloAddress:
        return self.silo.silo_address

    def transmit(self, msg: Message) -> None:
        self.silo.dispatcher.send_message(msg)

    def transmit_batch(self, msgs: list) -> None:
        """Batched in-silo hand-off (RuntimeClient.call_batch):
        vector-interface calls peel into per-class groups and ride ONE
        ``Dispatcher.receive_vector_batch`` → grouped ``call_group``
        enqueue, exactly like batched socket ingress; everything else
        takes the ordinary per-message ``send_message`` route. This
        deliberately does NOT go through MessageCenter.deliver_batch:
        that is the GATEWAY ingress surface — in-silo application calls
        must never be load-shed as client ingress (the per-message
        ``transmit`` → dispatcher path sheds nothing), and must not be
        dropped by a message center that has not started."""
        silo = self.silo
        vifaces = silo.vector_interfaces
        vgroups: dict[type, list] = {}
        for m in msgs:
            vcls = (vifaces.get(m.interface_name)
                    if vifaces and m.direction != Direction.RESPONSE
                    else None)
            if vcls is not None:
                # the ring-owner check inside receive_vector_batch IS
                # the addressing authority for vector keys (same
                # rationale as MessageCenter._route_batch)
                vgroups.setdefault(vcls, []).append(m)
            else:
                try:
                    silo.dispatcher.send_message(m)
                except Exception as e:  # noqa: BLE001 — earlier group
                    # members already dispatched: isolate, never raise
                    self._fail_transmit([m], e)
        for vcls, group in vgroups.items():
            try:
                silo.dispatcher.receive_vector_batch(vcls, group)
            except Exception as e:  # noqa: BLE001 — same isolation
                self._fail_transmit(group, e)

    def try_hot_invoke(self, grain_id, grain_class: type,
                       interface_name: str, method_name: str,
                       args: tuple, kwargs: dict,
                       is_read_only: bool = False):
        """Hot lane for grain-to-grain calls inside this silo (see
        runtime.hotlane for the admission conditions)."""
        if not self.hot_lane_enabled:
            return None
        coro = _hot_invoke(self, self.silo, grain_id, grain_class,
                           interface_name, method_name,
                           args, kwargs, is_read_only)
        if coro is None:
            self.hot_fallbacks += 1
        else:
            self.hot_hits += 1
        return coro

    def try_direct_interleave(self, grain_id, method_name: str,
                              args: tuple, kwargs: dict):
        """Direct-coroutine fast path for ALWAYS-INTERLEAVE methods (and
        the transaction protocol's reentrant-TM internals) on a local
        activation. Sound because the mailbox gate would admit such a
        message unconditionally, so queue semantics carry nothing — only
        the invoke remains, minus per-message machinery. Copy isolation
        is preserved (args/result copied exactly as the messaging path
        does); the per-call timeout is intentionally skipped (the
        turn-length watchdog still observes via the running marker).
        Call filters are NOT skipped: when any filter would run on the
        messaging path — outgoing filters, silo incoming filters, or a
        grain-level ``on_incoming_call`` hook — this path declines and
        the call takes the messaging path, so filtered deployments see
        identical interception regardless of placement (mirrors the
        gating in dispatcher._invoke). The call IS visible to activation
        bookkeeping: a running marker keeps deactivation/idle-collection
        from tearing the activation down mid-call, and nested sends from
        inside the callee carry the caller's extended call chain and
        attribute to the callee activation."""
        if self.outgoing_call_filters or self.silo.incoming_call_filters:
            self.hot_fallbacks += 1
            return None
        acts = self.silo.catalog.by_grain.get(grain_id)
        if not acts or len(acts) != 1:
            self.hot_fallbacks += 1
            return None
        act = acts[0]
        if act.state != ActivationState.VALID:
            self.hot_fallbacks += 1
            return None
        if getattr(act.grain_instance, "on_incoming_call", None) is not None:
            self.hot_fallbacks += 1
            return None
        fn = getattr(act.grain_instance, method_name, None)
        if fn is None:
            self.hot_fallbacks += 1
            return None
        self.hot_hits += 1  # the interleave lane is part of DISPATCH_STATS
        return self._direct_interleave_call(act, fn, args, kwargs)

    async def _direct_interleave_call(self, act, fn, args: tuple,
                                      kwargs: dict):
        args, kwargs = copy_call_body(args, kwargs)
        chain = current_call_chain()
        marker = _DirectCallMarker(-next(_marker_ids), chain)
        act.record_running(marker)
        token = current_activation.set(act)
        try:
            # snapshot BEFORE the pump below runs queued turns: a result
            # aliasing grain-internal state must not pick up later writes
            result = copy_result(await fn(*args, **kwargs))
        finally:
            current_activation.reset(token)
            act.reset_running(marker)
            # regular messages that arrived during the call queued behind
            # the running marker; nothing else pumps them for a direct call
            self.silo.dispatcher.run_message_pump(act)
        # amortized fairness yield: a tight loop of non-suspending direct
        # calls must not starve background tasks (membership probes,
        # reminders) — the messaging path yields once per RPC; here one
        # yield per _DIRECT_YIELD_EVERY calls bounds starvation to a few
        # milliseconds (vs probe periods of 250ms+) while keeping the
        # fast path fast: a per-call sleep(0) measured a 2.4x transaction
        # throughput loss, and even every-32 cost ~20% by widening 2PC
        # critical sections under contention
        self._direct_calls_since_yield += 1
        if self._direct_calls_since_yield >= _DIRECT_YIELD_EVERY:
            self._direct_calls_since_yield = 0
            await asyncio.sleep(0)
        return result


class Silo:
    """One silo: the unit of hosting, addressing, and failure."""

    def __init__(self, config: SiloConfig, fabric: "InProcFabric",
                 registry: GrainRegistry, storage: StorageManager):
        refuse_unported(registry)
        self.config = config
        self.fabric = fabric
        self.registry = registry
        self.storage_manager = storage
        self.silo_address = fabric.allocate_address(config.name)
        # multi-process silo (runtime.multiproc): a SEPARATE advertised
        # gateway endpoint reserved with SO_REUSEPORT at construction
        # time (so it is printable/dialable before start). Forked
        # workers join its accept group with their own listeners; the
        # owner never accepts there and closes its copy once the
        # workers are serving. silo_address stays a normal internal
        # endpoint — all silo-to-silo traffic (membership probes,
        # directory ops, forwards) avoids the reuseport group entirely.
        self.advertised_address: SiloAddress | None = None
        # runtime.multiproc.WorkerSupervisor once start() forks
        self.workers: Any = None
        if config.worker_procs > 1:
            try:
                self.advertised_address = fabric.allocate_address(
                    config.name + "-gw", reuseport=True)
            except TypeError:
                from ..core.errors import ConfigurationError
                raise ConfigurationError(
                    "worker_procs > 1 needs a SocketFabric (SO_REUSEPORT "
                    "accept balancing is a kernel feature; the in-proc "
                    "fabric has no kernel)") from None
        self.stats = StatsRegistry()
        # ingest stage instrumentation (observability.stats.INGEST_STATS):
        # the registry when metrics are enabled, else None — every stage
        # site (socket decode, message-center enqueue, dispatcher
        # queue-wait, engine staging/transfer/tick) guards on that None,
        # so the disabled hot path pays one attribute check
        self.ingest_stats = self.stats if config.metrics_enabled else None
        # per-(grain_class, method) call-site latency/error table
        # (observability.stats.CallSiteStats): fed by the dispatcher's
        # turn epilogue when metrics are on — the drill-down an SLO
        # breach resolves to ("which grain methods are hot/slow"), and
        # the per-class load signal placement policies will consume
        self.call_sites = None
        if config.metrics_enabled:
            from ..observability.stats import CallSiteStats
            self.call_sites = CallSiteStats()
        # cost-attribution ledger (observability.ledger): charges every
        # unit of work to (grain_class, method) × hashed-key × tenant —
        # installed only when enabled, every charge site guards on the
        # None (the disabled path costs one attribute check). The
        # ledger.* gauges registered here are evaluated at snapshot time
        # only, so exposure adds no hot-path cost either.
        self.ledger = None
        if config.ledger_enabled:
            from ..observability.ledger import CostLedger
            self.ledger = CostLedger(config.ledger_top_k,
                                     config.ledger_tenant_of)
            self.ledger.register_gauges(self.stats)
        # SLO monitor (observability.slo.SloMonitor): installed at start
        # when slo_enabled; silo.slo_specs (set pre-start by a builder
        # configurator) overrides the default objective set
        self.slo = None
        self.slo_specs = None
        # queue-wait-trend shedding (observability.stats.QueueWaitTrend):
        # installed only when the knob is armed — fed by the dispatcher's
        # turn-start (and the engine's batch-start) queue-wait sites,
        # read by MessageCenter's shed decision
        self.shed_trend = None
        if config.load_shedding_enabled and config.load_shedding_queue_wait > 0:
            from ..observability.stats import QueueWaitTrend
            self.shed_trend = QueueWaitTrend(config.load_shedding_window)
        # metrics pipeline handles (installed at start when configured)
        self.metrics = None          # observability.metrics.MetricsSampler
        self.metrics_server = None   # observability.metrics.MetricsHttpServer
        self.metrics_sink = None     # observability.export.OtlpMetricsSink
        # host-loop occupancy profiler (observability.profiling.
        # LoopProfiler): installed at start when profiling_enabled — every
        # hot-path site guards on this None, so the off path costs one
        # attribute check
        self.loop_prof = None
        # multi-loop ingress pool (runtime.multiloop.IngressLoopPool):
        # created by SocketFabric.register_silo when ingress_loops >= 2,
        # closed (threads joined, rings drained) in stop()
        self.ingress_pool = None
        self._flight_hook = None     # this silo's telemetry trigger hook
        # distributed tracing (observability.tracing): None unless enabled
        # — every hot-path site guards on that None
        self.tracer = None
        if config.trace_enabled:
            from ..observability.tracing import (LatencyErrorPolicy,
                                                 SpanCollector)
            self.tracer = SpanCollector(
                config.name, config.trace_sample_rate,
                config.trace_buffer_size,
                tail=config.trace_tail_enabled,
                tail_window=config.trace_tail_window,
                policy=LatencyErrorPolicy(config.trace_tail_slow_threshold,
                                          config.trace_tail_slow_percentile,
                                          auto=config.trace_tail_auto),
                leg_ttl=config.trace_tail_leg_ttl,
                max_pending=config.trace_tail_max_pending)
            if config.trace_otlp_endpoint:
                from ..observability.export import OtlpSink
                self.tracer.sinks.append(OtlpSink(
                    config.trace_otlp_endpoint, service_name=config.name,
                    batch_size=config.trace_otlp_batch_size,
                    flush_interval=config.trace_otlp_flush_interval,
                    encoding=("protobuf" if config.trace_otlp_protobuf
                              else "json")))
            if config.trace_tail_enabled:
                # retention propagation: when THIS silo retains a trace it
                # pulls the remote legs over the control path before export
                self.tracer.remote_fetcher = self._pull_trace_legs
        # grain cancellation twins (CancellationSourcesExtension)
        self.cancellation_tokens = TokenInterner(self)

        # ctor wiring order mirrors Silo.cs:124-260
        self.runtime_client = InsideRuntimeClient(self)
        self.runtime_client.tracer = self.tracer
        self.message_center = MessageCenter(self)
        self.dispatcher = Dispatcher(self)
        if config.batched_egress:
            # batched response egress (runtime.egress): responses
            # resolved from one inbound batch group per destination and
            # ride one fabric hand-off — send_response feeds it, the
            # armed flush drains it at batch-completion boundaries
            from .egress import EgressBatcher
            self.message_center.egress = EgressBatcher(self.message_center)
            self.dispatcher._egress = self.message_center.egress
        self.catalog = Catalog(self)
        # per-(grain_class, method) invoker table (runtime.invoker): built
        # once per class, consumed by the dispatcher's invoke engine and
        # the hot lane; revalidates on filter registration / version bump
        self.invokers = InvokerTable(self)
        # hot-lane hit/fallback observability (DISPATCH_STATS): the counters
        # live as plain ints on the runtime client; gauges surface them
        rc = self.runtime_client
        self.stats.register_gauge(DISPATCH_STATS["hot_hits"],
                                  lambda: rc.hot_hits)
        self.stats.register_gauge(DISPATCH_STATS["hot_fallbacks"],
                                  lambda: rc.hot_fallbacks)
        self.grain_factory = GrainFactory(self.runtime_client)
        from ..directory.locator import DistributedLocator
        self.locator: Any = DistributedLocator(self)
        self.membership: Any = None       # installed by cluster join (L6)
        self.gsi: Any = None              # installed by add_multicluster (L12)
        self.reminders: Any = None        # installed by reminder service (L11)
        self.transactions: Any = None     # installed by add_transactions (L11)
        # device tier (installed by dispatch.add_vector_grains): interface
        # name → VectorGrain class; matching requests bypass the catalog and
        # join the vector runtime's tick (Dispatcher._handle_vector_request)
        self.vector: Any = None
        self.vector_interfaces: dict[str, type] = {}
        # incoming grain-call filter chain (InsideRuntimeClient.cs:362);
        # outgoing filters live on self.runtime_client
        self.incoming_call_filters: list = []
        self.stream_providers: dict[str, Any] = {}
        self.status = "Created"
        self._lifecycle: list[tuple[int, Callable, Callable]] = []

    # `runtime` facade seen by activations
    @property
    def runtime(self) -> "Silo":
        return self

    @property
    def gateway_endpoint(self) -> str:
        """What clients dial: the SO_REUSEPORT advertised endpoint when
        this silo runs worker processes, else the silo's own endpoint."""
        if self.advertised_address is not None:
            return self.advertised_address.endpoint
        return self.silo_address.endpoint

    def get_stream_provider(self, name: str):
        try:
            return self.stream_providers[name]
        except KeyError:
            raise KeyError(f"no stream provider named {name!r}") from None

    def subscribe_lifecycle(self, stage: int, start, stop=None) -> None:
        """ISiloLifecycle.Subscribe (Silo.cs:864-869)."""
        self._lifecycle.append((stage, start, stop or (lambda: None)))

    # ------------------------------------------------------------------
    async def start(self) -> None:
        """Staged startup (Silo.StartAsync:267; stages :377-564)."""
        from dataclasses import fields as _fields

        # options dump at boot (Runtime/OptionsLogger/)
        for f in _fields(self.config):
            log.info("SiloConfig.%s = %r", f.name,
                     getattr(self.config, f.name))
        self.status = "Joining"
        if self.config.worker_procs > 1 and self.workers is None:
            # fork FIRST — before the message center, profiler, metrics
            # or any other thread-spawning service: each child must
            # begin from a quiet interpreter (only the forking thread
            # survives a fork), and a child never touches inherited
            # loop/CUDA state
            from .multiproc import WorkerSupervisor
            self.workers = WorkerSupervisor(self)
            self.workers.fork_workers()
            self.workers.attach(asyncio.get_running_loop())
            self.fabric.gateway_drop_endpoint = \
                self.advertised_address.endpoint
        if self.config.eager_turns:
            _install_eager_factory(asyncio.get_running_loop())
            self._eager_installed = True
        if self.config.profiling_enabled:
            self._install_loop_profiler(asyncio.get_running_loop())
        self.message_center.start()          # RuntimeServices
        self.catalog.start()
        if self.config.metrics_enabled:
            from ..observability.metrics import MetricsSampler
            if self.config.metrics_otlp_endpoint:
                from ..observability.export import OtlpMetricsSink
                self.metrics_sink = OtlpMetricsSink(
                    self.config.metrics_otlp_endpoint,
                    service_name=self.config.name,
                    encoding=("protobuf"
                              if self.config.metrics_otlp_protobuf
                              else "json"))
            self.metrics = MetricsSampler(
                self, period=self.config.metrics_sample_period,
                window=self.config.metrics_window,
                otlp_sink=self.metrics_sink,
                otlp_period=self.config.metrics_otlp_period)
            self.metrics.start()
        if self.config.metrics_port is not None:
            from ..observability.metrics import MetricsHttpServer
            self.metrics_server = await MetricsHttpServer(self).start(
                self.config.metrics_port)
        if self.config.slo_enabled:
            from ..observability.slo import SloMonitor
            if not self.config.metrics_enabled and self.slo_specs is None:
                # the latency/error/shed objectives ride the metrics
                # substrate; default_specs installs ONLY the probe-RTT
                # objective without it (a ratio objective whose bad
                # counters still tick against a gated-off total would
                # fabricate 100%-bad intervals)
                log.warning("slo_enabled without metrics_enabled: only "
                            "the probe-RTT objective is installed on %s",
                            self.config.name)
            self.slo = SloMonitor(self, specs=self.slo_specs)
            self.slo.start()
        # replicated journaled grains need the notification target up
        # before any replica confirms events (eventsourcing notifications)
        for cls in self.registry.all_classes():
            if getattr(cls, "__journal_replicated__", False):
                from ..eventsourcing.journaled import (
                    JournalRelayGrain, install_journal_notifier)
                install_journal_notifier(self)
                # geo replication rides an ordinary grain reachable through
                # cluster gateways (the ProtocolGateway analog) — register
                # it wherever replicated journals are hosted
                self.registry.register(JournalRelayGrain)
                break
        if self.vector is not None:
            # vector-hosting silos must accept forwarded bulk stream items
            # even when no stream provider is configured locally — peers'
            # pulling agents route owner-partitioned sub-batches here
            from ..streams.pubsub import install_vector_stream_target
            install_vector_stream_target(self)
        start_exchange = getattr(
            getattr(self.locator, "versions", None), "start_exchange", None)
        if start_exchange is not None:
            start_exchange()  # cluster type-map refresh (TypeManager)
        start_maint = getattr(self.locator, "start_cache_maintainer", None)
        if start_maint is not None:
            start_maint()  # adaptive directory-cache refresh loop
        self.fabric.register_silo(self)
        for stage, start, _ in sorted(self._lifecycle, key=lambda x: x[0]):
            r = start()
            if asyncio.iscoroutine(r):
                await r
        if self.membership is not None:
            await self.membership.become_active()
        if self.workers is not None:
            # every worker serving its reuseport listener, then retire
            # the owner's never-accepting copy — from here the kernel
            # balances ALL client ingress across the worker processes
            await self.workers.wait_ready()
        self.status = "Running"
        log.info("silo %s running", self.silo_address)

    async def stop(self, graceful: bool = True) -> None:
        """Stop path (Silo.cs:663-802). ``graceful=False`` ≈ kill: no
        deactivations, no membership goodbye — used by liveness tests."""
        if self.status == "Stopped":
            return
        self.status = "ShuttingDown" if graceful else "Dead"
        invalidate = getattr(self.fabric, "invalidate_alive_cache", None)
        if invalidate is not None:
            invalidate()  # stop routing client ingress to this silo now
        if not graceful and self.membership is not None:
            self.membership.stop()  # kill: timers die with us, no goodbye row
        if not graceful:
            self.dispatcher.cancel_turns()
        workers_sup = None
        if self.workers is not None:
            # worker fleet first: each worker silo drains its own
            # clients/turns (final vector calls still resolve through
            # the engine, which is alive until shutdown_worker below),
            # processes join, rings sweep (pushed == drained), segments
            # unlink
            workers_sup = self.workers
            await workers_sup.stop(graceful=graceful)
            self.workers = None
            self.fabric.gateway_drop_endpoint = None
            self.fabric.route_relays.clear()
            if not graceful:
                # kill path: membership timers died above, so no more
                # table writes can land in the auto-provisioned dir
                workers_sup.cleanup_membership_dir()
        if graceful:
            if self.membership is not None:
                await self.membership.shutdown()
            # let in-flight turns finish before tearing down the catalog;
            # stragglers past the deactivation budget are cancelled
            await self.dispatcher.drain_turns(self.config.deactivation_timeout)
            await self.catalog.stop()
            # push surviving directory entries (grains hosted on OTHER
            # silos) to ring successors — without this their registrations
            # die with our partition and single-activation breaks
            # (GrainDirectoryHandoffManager on ShuttingDown)
            if hasattr(self.locator, "handoff_all"):
                await self.locator.handoff_all()
            for stage, _, stop in sorted(self._lifecycle, key=lambda x: x[0],
                                         reverse=True):
                r = stop()
                if asyncio.iscoroutine(r):
                    await r
            if self.membership is not None:
                # the goodbye's second half: peers answered our
                # unregisters and handoff while we were ShuttingDown
                await self.membership.goodbye()
            if workers_sup is not None:
                # AFTER the owner's goodbye writes: the owner's own
                # iam-alive/refresh timers and the goodbye's Dead row
                # write the shared table file until here
                workers_sup.cleanup_membership_dir()
        # background notification/retry tasks must not outlive the runtime
        for t in list(getattr(self, "_journal_notify_tasks", ())):
            t.cancel()
        stop_exchange = getattr(
            getattr(self.locator, "versions", None), "stop_exchange", None)
        if stop_exchange is not None:
            stop_exchange()
        stop_maint = getattr(self.locator, "stop_cache_maintainer", None)
        if stop_maint is not None:
            stop_maint()
        if self.tracer is not None:
            # graceful: decide + export what's buffered; kill: drop it
            await self.tracer.aclose(flush=graceful)
        if self.slo is not None:
            self.slo.stop()
            self.slo = None
        if self.metrics is not None:
            self.metrics.stop()
            if graceful and self.metrics_sink is not None:
                # final snapshot so the collector sees the end state
                self.metrics.push_snapshot()
            self.metrics = None
        if self.metrics_sink is not None:
            await self.metrics_sink.aclose(flush=graceful)
            self.metrics_sink = None
        if self.metrics_server is not None:
            await self.metrics_server.aclose()
            self.metrics_server = None
        egress_pool = getattr(self.fabric, "egress_pool", None)
        if egress_pool is not None and not egress_pool.closed and \
                (egress_pool.owner is self or len(self.fabric.silos) <= 1):
            # sharded-egress shutdown — BEFORE the ingress pool (whose
            # loops the egress shards may be borrowing) and the message
            # center: new sends fall back to the main-loop path, each
            # shard sweeps its ring and flushes its senders on its own
            # loop, standalone threads join (the clean-shutdown drain;
            # pushed == drained afterwards). Runs when the pool's owner
            # silo stops or when we are the last local silo.
            await egress_pool.aclose()
            self.fabric.egress_pool = None
        if self.ingress_pool is not None:
            # multi-loop shutdown: stop accepts + pump threads (joined),
            # then drain every SPSC ring on this loop — BEFORE the
            # message center stops, so every already-decoded message
            # still routes (the clean-shutdown drain)
            await self.ingress_pool.aclose()
            self.ingress_pool = None
        if self.vector is not None:
            # off-loop tick worker: queued batches finish FIFO, then the
            # thread exits (their loop-side completion callbacks run as
            # control returns to the loop below). Before the client
            # close so resolved ticks still reach their callers.
            self.vector.shutdown_worker()
        if self.loop_prof is not None:
            from ..observability.profiling import (loop_profiler,
                                                   uninstall_loop_profiler)
            if self._flight_hook is not None:
                try:
                    self.loop_prof.trigger_hooks.remove(self._flight_hook)
                except ValueError:
                    pass
                self._flight_hook = None
            uninstall_loop_profiler(asyncio.get_running_loop())
            self.loop_prof = None
            self.dispatcher._loop_prof = None
            self.storage_manager.loop_prof = None
            if hasattr(self.fabric, "loop_prof"):
                # co-hosted silos share ONE refcounted profiler per
                # loop: hand the fabric whatever is still installed
                # (None after the LAST uninstall) instead of clearing a
                # hook a surviving silo's egress attribution still needs
                self.fabric.loop_prof = loop_profiler(
                    asyncio.get_running_loop())
            if self.vector is not None:
                self.vector.loop_prof = None
        self.message_center.stop()
        self.runtime_client.close()
        self.fabric.unregister_silo(self, dead=not graceful)
        if getattr(self, "_eager_installed", False):
            self._eager_installed = False
            _uninstall_eager_factory(asyncio.get_running_loop())
        self.status = "Stopped"

    async def _pull_trace_legs(self, trace_id: int) -> list[dict]:
        """Retention propagation (tail tracing): fan ``ctl_trace_spans``
        out to every other alive silo so a trace retained HERE exports
        with its remote legs. SYSTEM-category RPCs never root traces, so
        the pull cannot recursively trace itself; unreachable peers just
        contribute nothing (export stays best-effort)."""
        from ..core.ids import type_code_of
        from ..management.control import SILO_CONTROL, SiloControl
        peers = [a for a in self.locator.alive_list
                 if a != self.silo_address]
        if not peers:
            return []
        calls = [self.runtime_client.send_request(
            target_grain=GrainId.system_target(type_code_of(SILO_CONTROL), a),
            grain_class=SiloControl, interface_name=SILO_CONTROL,
            method_name="ctl_trace_spans", args=(trace_id,),
            kwargs={"pull": True},
            target_silo=a, category=Category.SYSTEM, timeout=1.0)
            for a in peers]
        results = await asyncio.gather(*calls, return_exceptions=True)
        # cross-process span-level dedup: worker-process silos make the
        # duplicate pull real — a leg that was forwarded (or a span a
        # peer itself pulled and retained) can come back from more than
        # one silo in this fan-out, and export must not double-count it
        out: list[dict] = []
        seen: set = set()
        for r in results:
            if not isinstance(r, BaseException) and r:
                for d in r:
                    sid = d.get("span_id")
                    if sid is not None:
                        if sid in seen:
                            continue
                        seen.add(sid)
                    out.append(d)
        return out

    def _install_loop_profiler(self, loop) -> None:
        """Install (or join) the loop's occupancy profiler and wire this
        silo's consumers: per-category occupancy gauges, the dispatcher/
        engine/storage category hooks, the tail-retention flight trigger,
        and the telemetry sink hook. Co-hosted silos on one loop share
        one profiler (occupancy is a loop property); install is
        refcounted, so the last silo to stop removes the interposition."""
        from ..observability.profiling import (LOOP_CATEGORIES,
                                               install_loop_profiler)
        cfg = self.config
        lp = install_loop_profiler(
            loop, window=cfg.profiling_window, ring=cfg.profiling_ring,
            top_k=cfg.profiling_top_k,
            trigger_interval=cfg.profiling_trigger_interval)
        self.loop_prof = lp
        # cached refs so the hot paths pay one attribute load
        self.dispatcher._loop_prof = lp
        self.storage_manager.loop_prof = lp
        if hasattr(self.fabric, "loop_prof"):
            # socket fabric: the inline client-route encode+write books
            # its slice under "egress" (the sharded-egress A/B signal)
            self.fabric.loop_prof = lp
        if self.vector is not None:
            self.vector.loop_prof = lp
        for cat in LOOP_CATEGORIES:
            # live per-category occupancy of the LAST completed window
            # (the Prometheus gauges; cumulative shares ride ctl_loop_profile)
            self.stats.register_gauge(
                f"loop.occupancy.{cat}",
                lambda c=cat, p=lp: p.last_shares.get(c, 0.0))
        if self.tracer is not None:
            # tail-retained traces snapshot the flight recorder and stamp
            # the root span so the retained trace links to its loop state
            def _retained(root, reason, _lp=lp):
                snap = _lp.trigger(
                    "trace_retained", reason=reason,
                    trace_id=(f"{root.trace_id:x}"
                              if root is not None else None))
                if snap is not None and root is not None:
                    root.attrs = dict(root.attrs or {})
                    root.attrs["flight_snapshot"] = True
            self.tracer.on_retain = _retained
        tm = getattr(self, "telemetry", None)
        if tm is not None:
            # flight snapshots also land as telemetry events (the
            # "attach it to the telemetry sink" half of the recorder)
            def _hook(snap, _tm=tm):
                _tm.track_event("flight_recorder", reason=snap["reason"],
                                **snap["attrs"])
            self._flight_hook = _hook
            lp.trigger_hooks.append(_hook)

    def register_system_target(self, instance, name: str) -> GrainId:
        """Register a per-silo pseudo-grain at a well-known id
        (SystemTarget framework, Silo.RegisterSystemTarget Silo.cs:816-820).
        The instance's public async methods become remotely callable with
        ``target_silo`` pinned to this silo."""
        from ..core.ids import type_code_of
        from .activation import ActivationData, ActivationState
        gid = GrainId.system_target(type_code_of(name), self.silo_address)
        act = ActivationData(gid, self, type(instance))
        act.state = ActivationState.VALID
        act.grain_instance = instance
        instance._activation = act
        self.catalog.by_activation[act.activation_id] = act
        self.catalog.by_grain[gid] = [act]
        return gid

    # helper used by Catalog to run lifecycle hooks in activation context
    async def dispatcher_scoped(self, activation, coro_fn) -> None:
        token = current_activation.set(activation)
        try:
            await coro_fn()
        finally:
            current_activation.reset(token)

    def __repr__(self) -> str:
        return f"<Silo {self.silo_address} {self.status}>"


class SiloBuilder:
    """Fluent hosting builder (SiloHostBuilder.cs:13)."""

    def __init__(self) -> None:
        self.config = SiloConfig()
        self.registry = GrainRegistry()
        self.storage = StorageManager()
        self._fabric: "InProcFabric | None" = None
        self._configurators: list[Callable[[Silo], None]] = []

    def with_name(self, name: str) -> "SiloBuilder":
        self.config.name = name
        return self

    def with_config(self, **kw) -> "SiloBuilder":
        for k, v in kw.items():
            if not hasattr(self.config, k):
                raise AttributeError(f"unknown silo option {k!r}")
            setattr(self.config, k, v)
        return self

    def with_options(self, *groups) -> "SiloBuilder":
        """Typed options groups (the ``.Configure<XOptions>(...)`` idiom):
        ``builder.with_options(MessagingOptions(response_timeout=5))`` —
        validates each group, then overlays it on the flat config."""
        from ..config import apply_options

        apply_options(self.config, *groups)
        return self

    def add_grains(self, *grain_classes: type) -> "SiloBuilder":
        self.registry.register(*grain_classes)
        return self

    def with_storage(self, name: str, provider) -> "SiloBuilder":
        self.storage.add(name, provider)
        return self

    def with_fabric(self, fabric: "InProcFabric") -> "SiloBuilder":
        self._fabric = fabric
        return self

    def add_incoming_call_filter(self, *filters) -> "SiloBuilder":
        """AddIncomingGrainCallFilter: run ``async f(ctx)`` around every
        incoming grain invocation, in registration order
        (SiloHostBuilderGrainCallFilterExtensions analog)."""
        self._configurators.append(
            lambda silo: silo.incoming_call_filters.extend(filters))
        return self

    def add_outgoing_call_filter(self, *filters) -> "SiloBuilder":
        """AddOutgoingGrainCallFilter: run ``async f(ctx)`` around every
        outgoing call made from inside this silo."""
        self._configurators.append(
            lambda silo: silo.runtime_client.outgoing_call_filters
            .extend(filters))
        return self

    def configure(self, fn: Callable[[Silo], None]) -> "SiloBuilder":
        """Escape hatch mirroring ConfigureServices: run fn(silo) pre-start."""
        self._configurators.append(fn)
        return self

    def build(self) -> Silo:
        from .cluster import InProcFabric
        fabric = self._fabric or InProcFabric()
        silo = Silo(self.config, fabric, self.registry, self.storage)
        for fn in self._configurators:
            fn(silo)
        return silo
