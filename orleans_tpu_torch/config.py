"""Typed options groups + validators (the reference's config system).

Re-design of Orleans' src/Orleans.Core/Configuration/Options/*
(ClusterOptions, MessagingOptions, PerformanceTuningOptions, …), the
runtime-side groups (SiloMessagingOptions, SchedulingOptions,
GrainCollectionOptions — Runtime/Configuration/Options/), the validators
(Core/Configuration/Validators/) and the startup options dump
(Runtime/OptionsLogger/). The groups flatten into the runtime's flat
``SiloConfig`` view via :func:`flatten`; ``SiloBuilder.with_options``
consumes them fluently (the ``.Configure<XOptions>(...)`` idiom,
SiloHostBuilder.cs:13).

The port's copy of ``orleans_tpu.config``. It differs in two places:
``DispatchOptions`` has no ``exchange_capacity`` (nothing reads it); and
``apply_options`` raises for a group field whose flat ``SiloConfig`` field
is missing instead of adding it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, fields

from .core.errors import ConfigurationError
from .runtime.silo import SiloConfig

log = logging.getLogger("orleans.options")

__all__ = [
    "ClusterOptions", "MessagingOptions", "SchedulingOptions",
    "GrainCollectionOptions", "MembershipOptions", "DirectoryOptions",
    "LoadSheddingOptions", "DispatchOptions", "RebalanceOptions",
    "TracingOptions", "MetricsOptions", "ProfilingOptions", "SloOptions",
    "StreamOptions", "LedgerOptions",
    "flatten", "apply_options", "validate_options", "log_options",
    "ConfigurationError",
]


def _positive(opts, *names: str) -> None:
    for n in names:
        v = getattr(opts, n)
        if not (isinstance(v, (int, float)) and v > 0):
            raise ConfigurationError(
                f"{type(opts).__name__}.{n} must be > 0, got {v!r}")


@dataclass
class ClusterOptions:
    """ClusterOptions (Core/Configuration/Options/ClusterOptions.cs):
    cluster/service identity."""

    cluster_id: str = "default"
    service_id: str = "default"

    def validate(self) -> None:
        if not self.cluster_id or not self.service_id:
            raise ConfigurationError(
                "cluster_id and service_id must be non-empty "
                "(ClusterOptionsValidator semantics)")


@dataclass
class MessagingOptions:
    """MessagingOptions / SiloMessagingOptions: timeouts, queue limits,
    stuck-turn age limit (MaxRequestProcessingTime), and the batched
    ingress pipeline switch (``batched_ingress=False`` restores the
    per-frame decode + per-message hand-off — the A/B lever; wire bytes
    are identical either way)."""

    response_timeout: float = 30.0
    max_enqueued_requests: int = 5000
    max_request_processing_time: float = 60.0
    batched_ingress: bool = True
    # multi-loop silo ingress (runtime.multiloop): N >= 2 spawns N
    # dedicated pump threads with their own event loops (sharded
    # ingress + SPSC hand-off rings, PING/SYSTEM bypassing the rings);
    # 1 (default) keeps the single-loop in-loop pump bit for bit
    ingress_loops: int = 1
    # sharded egress (runtime.multiloop.EgressShardPool): N >= 1 moves
    # silo-peer senders and shard-owned client-route response encode +
    # writev onto shard loops fed by SPSC egress rings (borrowing the
    # ingress shards when ingress_loops >= 2 — link-ownership
    # affinity — else dedicated egress loop threads); PING/SYSTEM
    # bypasses the rings per-message. 0 (default) keeps every sender
    # and encode on the main loop bit for bit — the A/B lever
    egress_shards: int = 0
    # batched response egress (runtime.egress flush accumulator +
    # header-prefix wire template): ``batched_egress=False`` restores
    # the per-message send_response → transmit path — the A/B lever
    # symmetric with ``batched_ingress``
    batched_egress: bool = True
    # off-loop device-tick pipeline (dispatch.engine tick worker):
    # ``offloop_tick=False`` restores the loop-inline tick — the A/B
    # lever paired with ``batched_ingress``
    offloop_tick: bool = True
    # multi-process silo (runtime.multiproc): N >= 2 forks N single-GIL
    # worker processes that each bind the SAME advertised endpoint via
    # SO_REUSEPORT (kernel accept balancing; a connection pins to its
    # accepting worker for life, so the multiloop per-grain FIFO
    # argument carries over verbatim). The device engine stays in the
    # owner process; workers feed vector calls through cross-process
    # SPSC staging rings on multiprocessing.shared_memory. 1 (default)
    # keeps the single-process path bit for bit — the A/B lever
    worker_procs: int = 1

    def validate(self) -> None:
        # no cross-field rule tying max_request_processing_time to
        # response_timeout: a stuck limit shorter than the caller timeout
        # is a legitimate fast-abandon configuration (the activation is
        # rebuilt while queued callers still wait within their timeout)
        _positive(self, "response_timeout", "max_enqueued_requests",
                  "max_request_processing_time", "ingress_loops")
        if not isinstance(self.ingress_loops, int) or \
                self.ingress_loops > 64:
            raise ConfigurationError(
                f"ingress_loops must be an int in [1, 64], got "
                f"{self.ingress_loops!r}")
        if not isinstance(self.egress_shards, int) or \
                isinstance(self.egress_shards, bool) or \
                not (0 <= self.egress_shards <= 64):
            raise ConfigurationError(
                f"egress_shards must be an int in [0, 64], got "
                f"{self.egress_shards!r}")
        if not isinstance(self.worker_procs, int) or \
                isinstance(self.worker_procs, bool) or \
                not (1 <= self.worker_procs <= 64):
            raise ConfigurationError(
                f"worker_procs must be an int in [1, 64], got "
                f"{self.worker_procs!r}")
        if self.worker_procs > 1 and self.ingress_loops > 1:
            raise ConfigurationError(
                "worker_procs > 1 and ingress_loops > 1 are mutually "
                "exclusive: each worker process is already a single-GIL "
                "silo (fork workers OR shard pump loops, not both)")


@dataclass
class SchedulingOptions:
    """SchedulingOptions: turn-length warning (TurnWarningLengthThreshold,
    OrleansTaskScheduler.cs:26) + deadlock detection
    (PerformDeadlockDetection)."""

    turn_warning_length: float = 0.2
    detect_deadlocks: bool = False

    def validate(self) -> None:
        _positive(self, "turn_warning_length")


@dataclass
class GrainCollectionOptions:
    """GrainCollectionOptions: idle-activation GC ages + quantum
    (ActivationCollector.cs:15)."""

    collection_age: float = 2 * 3600.0
    collection_quantum: float = 60.0
    deactivation_timeout: float = 5.0

    def validate(self) -> None:
        _positive(self, "collection_age", "collection_quantum",
                  "deactivation_timeout")
        if self.collection_age < self.collection_quantum:
            raise ConfigurationError(
                "collection_age must be >= collection_quantum "
                "(GrainCollectionOptionsValidator semantics)")


@dataclass
class MembershipOptions:
    """MembershipOptions (Core/Configuration/Options/MembershipOptions.cs):
    probe cadence, vote thresholds, refresh periods."""

    probe_period: float = 1.0
    probe_timeout: float = 1.0
    missed_probes_limit: int = 3
    votes_needed: int = 2
    num_probed: int = 3
    iam_alive_period: float = 5.0
    refresh_period: float = 5.0
    vote_expiration: float = 10.0

    def validate(self) -> None:
        _positive(self, "probe_period", "probe_timeout",
                  "missed_probes_limit", "votes_needed", "num_probed",
                  "iam_alive_period", "refresh_period", "vote_expiration")
        if self.votes_needed > self.num_probed + 1:
            raise ConfigurationError(
                f"votes_needed ({self.votes_needed}) can never be reached "
                f"with num_probed={self.num_probed} probers")


@dataclass
class LoadSheddingOptions:
    """LoadSheddingOptions: gateway ingress shed under overload. The
    reference sheds on CPU%; the host-tier analog sheds on application
    inbound queue depth — and, when ``queue_wait_limit`` > 0, on the
    WINDOWED ingest queue-wait trend (the INGEST_STATS backpressure
    signal fed from host turn starts and device batch starts): depth
    alone misses slow-drain overload where the queue stays short but
    every message waits long."""

    enabled: bool = False
    limit: int = 10_000
    # shed while the mean observed queue-wait over the last
    # ``queue_wait_window`` seconds exceeds this many seconds; 0 disables
    # the trend signal (depth-only, the pre-trend behavior)
    queue_wait_limit: float = 0.0
    queue_wait_window: float = 5.0

    def validate(self) -> None:
        _positive(self, "limit", "queue_wait_window")
        if self.queue_wait_limit < 0:
            raise ConfigurationError(
                "load shedding queue_wait_limit must be >= 0 "
                "(0 disables the trend signal)")


@dataclass
class DirectoryOptions:
    """Grain-directory caching (GrainDirectoryOptions: CachingStrategy,
    CacheSize; adaptive per-entry TTLs per
    AdaptiveGrainDirectoryCache.cs:178 + the maintainer's refresh loop,
    AdaptiveDirectoryCacheMaintainer.cs:243)."""

    cache_size: int = 100_000
    cache_initial_ttl: float = 5.0     # seconds; doubles on revalidation
    cache_max_ttl: float = 120.0
    cache_refresh_period: float = 2.0  # maintainer sweep; 0 disables

    def validate(self) -> None:
        _positive(self, "cache_size", "cache_initial_ttl", "cache_max_ttl")
        if self.cache_initial_ttl > self.cache_max_ttl:
            raise ConfigurationError(
                "directory cache_initial_ttl must be <= cache_max_ttl "
                f"(got {self.cache_initial_ttl} > {self.cache_max_ttl})")
        if self.cache_refresh_period < 0:
            raise ConfigurationError(
                "directory cache_refresh_period must be >= 0 "
                "(0 disables the maintainer)")


@dataclass
class RebalanceOptions:
    """Live activation migration & load-aware rebalancing
    (rebalance — the DeploymentLoadPublisher +
    activation-repartitioning trajectory of the reference): plan/execute
    cadence, per-round migration budget, and the imbalance hysteresis."""

    period: float = 0.0            # seconds between rounds; 0 disables
    budget: int = 8                # max migrations per round (both tiers)
    imbalance_ratio: float = 1.2   # rebalance only when hot > ratio * mean
    # consume the cost ledger's host-tier hot-actor candidates:
    # a grain whose charged seconds run hot against the per-key mean gets
    # a migration plan even when activation COUNTS are balanced — the
    # load signal counts alone cannot see. Requires ledger_enabled.
    use_ledger: bool = False

    def validate(self) -> None:
        _positive(self, "budget")
        if self.period < 0:
            raise ConfigurationError(
                "rebalance period must be >= 0 (0 disables the loop)")
        if self.imbalance_ratio < 1.0:
            raise ConfigurationError(
                "rebalance imbalance_ratio must be >= 1.0 — a threshold "
                "below the mean would migrate on every round forever")


@dataclass
class TracingOptions:
    """Distributed request tracing (observability.tracing): enable flag,
    head-based sampling rate (the ROOT of each trace rolls once; 0 keeps
    the collector installed but records nothing), and the per-silo span
    ring-buffer capacity.

    ``tail_*`` knobs enable tail-based retention: head sampling becomes a
    record-locally pre-filter and the keep/drop decision defers until the
    trace completes (root-span close + ``tail_window`` quiescence for
    straggler legs) — keep only slow (``tail_slow_threshold`` seconds
    absolute, and/or above ``tail_slow_percentile`` of recent roots),
    errored, or force-retained traces. ``tail_leg_ttl`` bounds how long a
    silo buffers legs of traces rooted elsewhere before expiring them
    un-pulled; ``tail_max_pending`` bounds the undecided-trace buffer.

    ``otlp_endpoint`` streams retained spans as OTLP/HTTP JSON to an
    OpenTelemetry collector (export.OtlpSink) in ``otlp_batch_size``
    batches flushed every ``otlp_flush_interval`` seconds; unset = no
    sink, and an unreachable collector degrades to counted drops."""

    enabled: bool = False
    sample_rate: float = 1.0
    buffer_size: int = 4096
    tail_enabled: bool = False
    tail_window: float = 0.25
    tail_slow_threshold: float = 0.1
    tail_slow_percentile: float = 0.0
    # auto-tune tail_slow_threshold from the root-duration percentile
    # history (LatencyErrorPolicy auto mode): the threshold converges on
    # the tail_slow_percentile cut (default 0.95 when unset), so drifting
    # baselines keep retaining the slowest ~(1-p) fraction
    tail_auto: bool = False
    tail_leg_ttl: float = 2.0
    tail_max_pending: int = 256
    otlp_endpoint: str | None = None
    otlp_batch_size: int = 64
    otlp_flush_interval: float = 0.5
    # ship OTLP bodies as protobuf wire bytes (application/x-protobuf)
    # instead of the JSON mapping; requires google.protobuf importable,
    # else the sink warns and keeps JSON
    otlp_protobuf: bool = False

    def validate(self) -> None:
        _positive(self, "buffer_size", "tail_window", "tail_leg_ttl",
                  "tail_max_pending", "otlp_batch_size",
                  "otlp_flush_interval")
        if not (0.0 <= self.sample_rate <= 1.0):
            raise ConfigurationError(
                f"trace sample_rate must be within [0, 1], got "
                f"{self.sample_rate!r}")
        if not (0.0 <= self.tail_slow_percentile < 1.0):
            raise ConfigurationError(
                f"trace tail_slow_percentile must be within [0, 1), got "
                f"{self.tail_slow_percentile!r}")
        if self.tail_slow_threshold < 0:
            raise ConfigurationError(
                "trace tail_slow_threshold must be >= 0 "
                "(0 disables the absolute threshold)")


@dataclass
class MetricsOptions:
    """Live metrics pipeline (observability.metrics — the reference's
    continuous statistics surface, Core/Statistics/ + LogStatistics):
    stage-level ingest instrumentation + the queue/backpressure sampler
    loop, the per-silo Prometheus pull endpoint, and periodic OTLP
    metrics push.

    ``enabled`` turns on the ingest stage histograms (decode / enqueue /
    queue-wait / staging / transfer / tick) and the sampler; everything
    costs one attribute check per site when off. ``port`` gates the
    stdlib-HTTP ``GET /metrics`` exposition endpoint (``None`` = no
    server; ``0`` = ephemeral port). ``otlp_endpoint`` streams registry
    snapshots every ``otlp_period`` seconds via export.OtlpMetricsSink
    (same bounded-queue/retry/drop discipline as trace export)."""

    enabled: bool = False
    sample_period: float = 1.0
    window: float = 60.0
    port: int | None = None
    otlp_endpoint: str | None = None
    otlp_period: float = 5.0
    # protobuf wire encoding for the metrics push (same gate/fallback as
    # the tracing sink's otlp_protobuf)
    otlp_protobuf: bool = False

    def validate(self) -> None:
        _positive(self, "sample_period", "window", "otlp_period")
        if self.port is not None and not (0 <= int(self.port) <= 65535):
            raise ConfigurationError(
                f"metrics port must be None or 0-65535, got {self.port!r}")


@dataclass
class ProfilingOptions:
    """Host-loop occupancy profiler + flight recorder
    (observability.profiling.LoopProfiler — the Watchdog/per-component
    cycle-stats analog of the reference, grown into continuous loop
    attribution): when ``enabled`` the silo interposes on its event
    loop's scheduling entry points and buckets every callback's wall
    time into named categories (turns / device tick schedule-staging-
    transfer-SYNC / pump / storage / observability / idle) in
    ``window``-second slices, keeping a ``ring``-deep flight ring with
    the ``top_k`` slowest callbacks per window. Anomalies (load shed,
    watchdog/sampler lag over ``lag_threshold``, queue-wait-trend
    breach, tail-retained traces) snapshot the ring, rate-limited to one
    per ``trigger_interval`` seconds per reason. Disabled: nothing is
    installed — the loop keeps its class methods."""

    enabled: bool = False
    window: float = 1.0
    ring: int = 120
    top_k: int = 8
    trigger_interval: float = 1.0
    lag_threshold: float = 0.25

    def validate(self) -> None:
        _positive(self, "window", "ring", "top_k", "trigger_interval",
                  "lag_threshold")


@dataclass
class SloOptions:
    """SLO engine (observability.slo — the judging layer over the
    metrics/tracing/profiling substrate): when ``enabled`` a per-silo
    ``SloMonitor`` (observability.slo) evaluates the
    default objective set (app ingest latency, membership probe RTT,
    turn error rate, gateway shed rate — or a custom spec list set via
    ``silo.slo_specs``) every ``period`` seconds from interval-diffed
    registry snapshots, with Google-SRE multi-window burn-rate
    detection: breach when BOTH the ``fast_window`` and ``slow_window``
    burn the error budget faster than ``burn_threshold``× with at least
    ``min_events`` events in the fast window. A breach snapshots the
    flight recorder, force-retains in-flight tail traces, and bumps the
    ``slo.*`` counters/gauges; the cluster rolls up worst-burn-wins via
    ``ManagementGrain.get_cluster_slo``. Evaluation rides snapshot
    diffs — zero new hot-path instrumentation."""

    enabled: bool = False
    period: float = 1.0
    fast_window: float = 60.0
    slow_window: float = 300.0
    burn_threshold: float = 4.0
    min_events: int = 10
    # default-spec targets: latency = good fraction of ingest queue-wait
    # observations under latency_threshold seconds; probe = good fraction
    # of membership probe RTTs under the probe timeout; error/shed =
    # good fractions of turns/offered ingress
    latency_threshold: float = 0.1
    latency_target: float = 0.99
    probe_target: float = 0.99
    error_target: float = 0.999
    shed_target: float = 0.99
    # stream delivery latency (publish -> consumer-turn; fed from the
    # streams.delivery.seconds histogram the device provider observes)
    stream_target: float = 0.99
    stream_threshold: float = 0.25

    def validate(self) -> None:
        _positive(self, "period", "fast_window", "slow_window",
                  "burn_threshold", "min_events", "latency_threshold",
                  "stream_threshold")
        if self.fast_window >= self.slow_window:
            raise ConfigurationError(
                f"slo fast_window must be < slow_window "
                f"({self.fast_window} >= {self.slow_window}) — the slow "
                "window exists to CONFIRM what the fast window catches")
        for n in ("latency_target", "probe_target", "error_target",
                  "shed_target", "stream_target"):
            v = getattr(self, n)
            if not (0.0 < v < 1.0):
                raise ConfigurationError(
                    f"slo {n} must be in (0, 1), got {v!r} — a target of "
                    "1.0 leaves zero error budget")


@dataclass
class StreamOptions:
    """Device-tier streams (streams.device — the namespace fan-out
    compiled onto the bulk collectives): ``device_fanout`` arms the
    stream_fanout delivery lever on the persistent providers' vector
    path — dense bulk items ride broadcast edge exchanges instead of
    per-consumer call_batch ticks. OFF (default) keeps the per-consumer
    path bit for bit: the A/B lever, symmetric with ``batched_ingress``.
    ``device_cache_capacity`` bounds each device namespace's
    :class:`~orleans_tpu_torch.streams.cache.PooledQueueCache` in batches
    (producers backpressure at 75% occupancy through the queue-wait-
    trend shed signal)."""

    device_fanout: bool = False
    device_cache_capacity: int = 1024

    def validate(self) -> None:
        _positive(self, "device_cache_capacity")


@dataclass
class LedgerOptions:
    """Cost-attribution ledger (observability.ledger): when
    ``enabled`` the silo charges every unit of work to (grain_class,
    method) × hashed-key × tenant — host-turn exec/queue seconds, device
    row-seconds, wire bytes per route, stream deliveries — with the
    per-key and per-tenant dimensions bounded by ``top_k`` space-saving
    sketches (exact class totals + overflow counter, deterministic
    cluster merge via ``ManagementGrain.get_cluster_ledger``).
    ``tenant_of`` maps a charge label ("Class/key") to its tenant;
    host-turn charges also read the caller's ``orleans.tenant``
    RequestContext baggage. OFF (default): ``silo.ledger`` is None and
    every charge site pays one attribute check — the A/B lever
    ``ping.bench_ledger_overhead`` floors."""

    enabled: bool = False
    top_k: int = 32
    tenant_of: object = None   # Callable[[str], str | None] | None

    def validate(self) -> None:
        _positive(self, "top_k")
        if self.tenant_of is not None and not callable(self.tenant_of):
            raise ConfigurationError(
                f"ledger tenant_of must be callable or None, got "
                f"{self.tenant_of!r}")


@dataclass
class DispatchOptions:
    """The vector-dispatch tier (no reference analog — the batched
    engine's knobs): per-shard slot-pool capacity and the off-loop tick
    lever, passed as ``VectorRuntime(options=...)``."""

    capacity_per_shard: int = 1024
    # off-loop tick worker for STANDALONE VectorRuntime(options=...)
    # construction (silo-hosted runtimes take the lever from
    # SiloConfig.offloop_tick / MessagingOptions.offloop_tick instead).
    # Default False: a bare engine keeps the synchronous loop-inline
    # tick, which direct callers (tests, bulk benchmarks) rely on.
    offloop_tick: bool = False

    def validate(self) -> None:
        _positive(self, "capacity_per_shard")


# flat SiloConfig field ← (options group, group field)
_FLAT_MAP = {
    "cluster_id": (ClusterOptions, "cluster_id"),
    "service_id": (ClusterOptions, "service_id"),
    "response_timeout": (MessagingOptions, "response_timeout"),
    "max_enqueued_requests": (MessagingOptions, "max_enqueued_requests"),
    "max_request_processing_time": (MessagingOptions,
                                    "max_request_processing_time"),
    "batched_ingress": (MessagingOptions, "batched_ingress"),
    "ingress_loops": (MessagingOptions, "ingress_loops"),
    "egress_shards": (MessagingOptions, "egress_shards"),
    "worker_procs": (MessagingOptions, "worker_procs"),
    "batched_egress": (MessagingOptions, "batched_egress"),
    "offloop_tick": (MessagingOptions, "offloop_tick"),
    "turn_warning_length": (SchedulingOptions, "turn_warning_length"),
    "detect_deadlocks": (SchedulingOptions, "detect_deadlocks"),
    "collection_age": (GrainCollectionOptions, "collection_age"),
    "collection_quantum": (GrainCollectionOptions, "collection_quantum"),
    "deactivation_timeout": (GrainCollectionOptions, "deactivation_timeout"),
    "membership_probe_period": (MembershipOptions, "probe_period"),
    "membership_probe_timeout": (MembershipOptions, "probe_timeout"),
    "membership_missed_probes_limit": (MembershipOptions,
                                       "missed_probes_limit"),
    "membership_votes_needed": (MembershipOptions, "votes_needed"),
    "membership_num_probed": (MembershipOptions, "num_probed"),
    "membership_iam_alive_period": (MembershipOptions, "iam_alive_period"),
    "membership_refresh_period": (MembershipOptions, "refresh_period"),
    "membership_vote_expiration": (MembershipOptions, "vote_expiration"),
    "directory_cache_size": (DirectoryOptions, "cache_size"),
    "directory_cache_initial_ttl": (DirectoryOptions, "cache_initial_ttl"),
    "directory_cache_max_ttl": (DirectoryOptions, "cache_max_ttl"),
    "directory_cache_refresh_period": (DirectoryOptions,
                                       "cache_refresh_period"),
    "load_shedding_enabled": (LoadSheddingOptions, "enabled"),
    "load_shedding_limit": (LoadSheddingOptions, "limit"),
    "load_shedding_queue_wait": (LoadSheddingOptions, "queue_wait_limit"),
    "load_shedding_window": (LoadSheddingOptions, "queue_wait_window"),
    "rebalance_period": (RebalanceOptions, "period"),
    "rebalance_budget": (RebalanceOptions, "budget"),
    "rebalance_imbalance_ratio": (RebalanceOptions, "imbalance_ratio"),
    "rebalance_use_ledger": (RebalanceOptions, "use_ledger"),
    "trace_enabled": (TracingOptions, "enabled"),
    "trace_sample_rate": (TracingOptions, "sample_rate"),
    "trace_buffer_size": (TracingOptions, "buffer_size"),
    "trace_tail_enabled": (TracingOptions, "tail_enabled"),
    "trace_tail_window": (TracingOptions, "tail_window"),
    "trace_tail_slow_threshold": (TracingOptions, "tail_slow_threshold"),
    "trace_tail_slow_percentile": (TracingOptions, "tail_slow_percentile"),
    "trace_tail_auto": (TracingOptions, "tail_auto"),
    "trace_tail_leg_ttl": (TracingOptions, "tail_leg_ttl"),
    "trace_tail_max_pending": (TracingOptions, "tail_max_pending"),
    "trace_otlp_endpoint": (TracingOptions, "otlp_endpoint"),
    "trace_otlp_batch_size": (TracingOptions, "otlp_batch_size"),
    "trace_otlp_flush_interval": (TracingOptions, "otlp_flush_interval"),
    "trace_otlp_protobuf": (TracingOptions, "otlp_protobuf"),
    "metrics_enabled": (MetricsOptions, "enabled"),
    "metrics_sample_period": (MetricsOptions, "sample_period"),
    "metrics_window": (MetricsOptions, "window"),
    "metrics_port": (MetricsOptions, "port"),
    "metrics_otlp_endpoint": (MetricsOptions, "otlp_endpoint"),
    "metrics_otlp_period": (MetricsOptions, "otlp_period"),
    "metrics_otlp_protobuf": (MetricsOptions, "otlp_protobuf"),
    "slo_enabled": (SloOptions, "enabled"),
    "slo_period": (SloOptions, "period"),
    "slo_fast_window": (SloOptions, "fast_window"),
    "slo_slow_window": (SloOptions, "slow_window"),
    "slo_burn_threshold": (SloOptions, "burn_threshold"),
    "slo_min_events": (SloOptions, "min_events"),
    "slo_latency_threshold": (SloOptions, "latency_threshold"),
    "slo_latency_target": (SloOptions, "latency_target"),
    "slo_probe_target": (SloOptions, "probe_target"),
    "slo_error_target": (SloOptions, "error_target"),
    "slo_shed_target": (SloOptions, "shed_target"),
    "slo_stream_target": (SloOptions, "stream_target"),
    "slo_stream_threshold": (SloOptions, "stream_threshold"),
    "stream_device_fanout": (StreamOptions, "device_fanout"),
    "stream_device_cache_capacity": (StreamOptions,
                                     "device_cache_capacity"),
    "ledger_enabled": (LedgerOptions, "enabled"),
    "ledger_top_k": (LedgerOptions, "top_k"),
    "ledger_tenant_of": (LedgerOptions, "tenant_of"),
    "profiling_enabled": (ProfilingOptions, "enabled"),
    "profiling_window": (ProfilingOptions, "window"),
    "profiling_ring": (ProfilingOptions, "ring"),
    "profiling_top_k": (ProfilingOptions, "top_k"),
    "profiling_trigger_interval": (ProfilingOptions, "trigger_interval"),
    "profiling_lag_threshold": (ProfilingOptions, "lag_threshold"),
}


def validate_options(*groups) -> None:
    """Run every group's validator (the IConfigurationValidator pass the
    silo runs before start — DefaultSiloServices registers one per group)."""
    for g in groups:
        g.validate()


def flatten(*groups, name: str = "silo") -> SiloConfig:
    """Validate + flatten typed groups into the runtime's ``SiloConfig``.
    Unspecified groups keep their defaults."""
    return apply_options(SiloConfig(name=name), *groups)


def log_options(*groups, logger: logging.Logger | None = None) -> None:
    """Dump every option value at startup (Runtime/OptionsLogger/ — the
    reference logs all bound options when the silo boots)."""
    lg = logger or log
    for g in groups:
        for f in fields(g):
            lg.info("%s.%s = %r", type(g).__name__, f.name,
                    getattr(g, f.name))


def apply_options(cfg: SiloConfig, *groups) -> SiloConfig:
    """Validate the groups and overlay their values on a flat config
    (consumed by ``SiloBuilder.with_options``). Groups the silo config
    does not consume are rejected, never silently dropped."""
    validate_options(*groups)
    silo_groups = {cls for cls, _ in _FLAT_MAP.values()}
    for g in groups:
        if type(g) not in silo_groups:
            hint = (" — DispatchOptions configures the device tier; pass "
                    "it to VectorRuntime(options=...)"
                    if isinstance(g, DispatchOptions) else "")
            raise ConfigurationError(
                f"{type(g).__name__} is not consumed by the silo "
                f"config{hint}")
    by_type = {type(g): g for g in groups}
    for flat_field, (group_cls, group_field) in _FLAT_MAP.items():
        g = by_type.get(group_cls)
        if g is not None:
            if not hasattr(cfg, flat_field):
                raise ConfigurationError(
                    f"{group_cls.__name__}.{group_field} has no SiloConfig "
                    f"field {flat_field!r} in orleans_tpu_torch")
            setattr(cfg, flat_field, getattr(g, group_field))
    return cfg
