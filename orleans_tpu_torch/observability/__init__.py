"""Observability of the port: statistics, distributed tracing, the
host-loop occupancy profiler with ``torch.profiler`` device traces, the
telemetry consumers with the watchdog, the live metrics pipeline, SLO
burn-rate monitoring, the cost-attribution ledger, and Perfetto/OTLP
export (the port of ``orleans_tpu.observability``)."""

from .export import (  # noqa: F401
    OtlpMetricsSink,
    OtlpSink,
    chrome_trace_events,
    snapshots_to_otlp_metrics,
    spans_to_otlp,
    write_chrome_trace,
)
from .metrics import (  # noqa: F401
    MetricsHttpServer,
    MetricsSampler,
    WindowedGauge,
    prometheus_exposition,
)
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
from .slo import (  # noqa: F401
    SloMonitor,
    SloSpec,
    default_specs,
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
