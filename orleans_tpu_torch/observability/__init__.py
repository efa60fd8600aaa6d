"""Observability of the port: statistics, distributed tracing, and the
host-loop occupancy profiler with ``torch.profiler`` device traces (the
port of ``orleans_tpu.observability``: ``stats``, ``tracing`` and
``profiling``, and the telemetry consumers with the watchdog; export,
metrics, slo and ledger are not ported)."""

from .profiling import (  # noqa: F401
    LOOP_CATEGORIES,
    LOOP_CATEGORY,
    LoopProfiler,
    Profiler,
    StepTimer,
    annotate,
    install_loop_profiler,
    loop_profiler,
    mark_loop_category,
    traced,
    uninstall_loop_profiler,
)
from .stats import (  # noqa: F401
    INGEST_STAGES,
    INGEST_STATS,
    REBALANCE_STATS,
    SLO_STATS,
    CallSiteStats,
    Histogram,
    StatsRegistry,
)
from .telemetry import (  # noqa: F401
    FileTelemetryConsumer,
    LoggingTelemetryConsumer,
    TelemetryConsumer,
    TelemetryManager,
    Watchdog,
    add_telemetry,
)
from .tracing import (  # noqa: F401
    TRACE_KEY,
    LatencyErrorPolicy,
    RetentionPolicy,
    Span,
    SpanCollector,
    critical_path_breakdown,
    current_trace,
    span_from_dict,
)
