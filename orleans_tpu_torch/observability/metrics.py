"""Live metrics pipeline: sampler loop + Prometheus/OpenMetrics endpoint.

:mod:`.stats` is the passive registry — counters and histograms written
inline by the hot paths. This module turns it into a *pipeline*:

* :class:`MetricsSampler` — a periodic loop snapshotting the queue- and
  backpressure-shaped state that counters cannot express (inbound queue
  depths per QoS category, pending RPC callbacks, envelope/callback
  freelist occupancy, event-loop lag, tail-tracing buffer sizes, device
  queue depth) into :class:`WindowedGauge` series, so saturation is
  visible as a *trend* over the last window, not a point read. Each
  source also registers as a live gauge in the silo's
  :class:`~.stats.StatsRegistry` so snapshots/exposition see the current
  value. When an :class:`~.export.OtlpMetricsSink` is attached the
  sampler pushes full registry snapshots on ``otlp_period``.
* :func:`prometheus_exposition` — the registry snapshot (plus windows)
  rendered as Prometheus text exposition format 0.0.4 (counters, gauges,
  and histograms with cumulative ``le``-labelled buckets straight from
  ``Histogram.bucket_labels``/``cumulative_counts`` — no re-bucketing).
* :class:`MetricsHttpServer` — a stdlib-only (asyncio) HTTP pull
  endpoint serving ``GET /metrics`` per silo, gated on
  ``SiloConfig.metrics_port`` (``None`` disables; ``0`` binds an
  ephemeral port, readable back from ``server.port``).

The reference leans on exactly this continuous counter/queue-length
statistics surface (``src/Orleans.Core/Statistics/``, LogStatistics +
SiloRuntimeStatistics) to drive load shedding and tuning; here it is the
measurement substrate the ingest-wall work lands against.

The port's copy of ``orleans_tpu.observability.metrics``.
"""

from __future__ import annotations

import asyncio
import logging
import re
import time
from collections import deque
from typing import TYPE_CHECKING, Callable

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.metrics")

__all__ = ["WindowedGauge", "MetricsSampler", "MetricsHttpServer",
           "prometheus_exposition"]


class WindowedGauge:
    """Time-windowed gauge series: bounded (ts, value) samples retained
    for ``window`` seconds, summarizable as last/min/max/mean — the
    "was the queue backed up in the last minute" read a point gauge
    cannot answer."""

    __slots__ = ("window", "samples")

    def __init__(self, window: float = 60.0):
        self.window = window
        self.samples: deque[tuple[float, float]] = deque()

    def add(self, value: float, ts: float | None = None) -> None:
        ts = time.monotonic() if ts is None else ts
        self.samples.append((ts, value))
        cutoff = ts - self.window
        while self.samples and self.samples[0][0] < cutoff:
            self.samples.popleft()

    def last(self) -> float:
        return self.samples[-1][1] if self.samples else 0.0

    def series(self) -> list[tuple[float, float]]:
        return list(self.samples)

    def summary(self) -> dict:
        if not self.samples:
            return {"n": 0, "last": 0.0, "min": 0.0, "max": 0.0, "mean": 0.0}
        vals = [v for _, v in self.samples]
        return {"n": len(vals), "last": vals[-1], "min": min(vals),
                "max": max(vals), "mean": sum(vals) / len(vals)}


class MetricsSampler:
    """Periodic queue/backpressure sampler for one silo.

    Sources are ``name -> callable`` pairs read on each tick; readings
    land in a :class:`WindowedGauge` per source AND register once as live
    gauges in the silo's stats registry (so ``snapshot()``, the
    Prometheus endpoint, and ``ctl_metrics`` all see current values
    without waiting for a tick). The loop also measures its own
    scheduling lag (the watchdog's signal, folded in as
    ``sampler.loop_lag`` for silos that don't install a watchdog).
    A raising source is isolated per tick — one bad gauge never starves
    the rest."""

    def __init__(self, silo: "Silo", period: float = 1.0,
                 window: float = 60.0, otlp_sink=None,
                 otlp_period: float = 5.0):
        self.silo = silo
        self.period = period
        self.window = window
        self.otlp_sink = otlp_sink
        self.otlp_period = otlp_period
        self.ticks = 0
        self._task: asyncio.Task | None = None
        self._sources: dict[str, Callable[[], float]] = {}
        self.windows: dict[str, WindowedGauge] = {}
        self._next_push = 0.0
        self._install_default_sources()

    # -- sources -----------------------------------------------------------
    def add_source(self, name: str, fn: Callable[[], float]) -> None:
        """Register a sampled series (and a live registry gauge). The
        registry-facing read is exception-hardened: a raising source must
        not break snapshot()/exposition for every other series (the same
        isolation sample_once applies tick-side)."""
        self._sources[name] = fn
        self.windows[name] = WindowedGauge(self.window)

        def read(f=fn) -> float:
            try:
                return float(f())
            except Exception:  # noqa: BLE001 — isolate a bad source
                return 0.0

        self.silo.stats.register_gauge(name, read)

    def _install_default_sources(self) -> None:
        silo = self.silo
        from ..core import message as _msg_mod
        from ..core.message import Category
        from ..runtime import runtime_client as _rc_mod

        for cat in Category:
            name = f"queue.inbound.{cat.name.lower()}"
            self.add_source(name, lambda c=cat: self._queue_depth(c))
        self.add_source("rpc.pending_callbacks",
                        lambda: len(silo.runtime_client.callbacks))
        # freelist occupancy: a draining pool under load means shells are
        # leaking (or churn outruns the cap) — envelope allocation returns
        # to the hot path exactly when it hurts most
        self.add_source("pool.message_free",
                        lambda: len(_msg_mod._MSG_POOL))
        self.add_source("pool.callback_free",
                        lambda: len(_rc_mod._CB_POOL))
        self.add_source("turns.in_flight",
                        lambda: len(silo.dispatcher._turn_tasks))
        # storage/journal queue depths: the write-path backpressure
        # signals — operations awaiting a storage provider, and
        # unconfirmed journaled events buffered grain-side
        self.add_source("storage.inflight_ops",
                        lambda: silo.storage_manager.inflight)
        if self._has_journaled_grains():
            # the unconfirmed-events walk is O(activations) per sample
            # tick — only worth installing when a journaled class is
            # actually registered
            self.add_source("journal.unconfirmed_events",
                            self._journal_unconfirmed)
        if silo.tracer is not None:
            self.add_source("trace.pending_traces",
                            lambda: len(silo.tracer.pending))
            self.add_source("trace.retained_spans",
                            lambda: len(silo.tracer.spans))
        if silo.message_center.egress is not None:
            # batched egress: the last response flush-group size — the
            # hand-off-unit twin of vector.staging_fill (a sustained 1
            # means responses are not grouping; the pipeline engages but
            # pays its overhead without the batching win)
            self.add_source("vector.egress_group",
                            lambda: silo.message_center.egress.last_group)
        if silo.vector is not None:
            self._install_vector_sources()
        if silo.stream_providers:
            self._install_stream_sources()
        if getattr(silo, "workers", None) is not None:
            self._install_worker_sources()

    def _install_vector_sources(self) -> None:
        silo = self.silo
        self.add_source("vector.queue_depth",
                        lambda: silo.vector.queue_depth())
        # batched-ingress staging: preallocated double-buffer footprint
        # and the last batch's fill — occupancy of the staging hand-off
        self.add_source("vector.staging_lanes",
                        lambda: silo.vector.staging_lanes())
        self.add_source("vector.staging_fill",
                        lambda: silo.vector.staging_fill)

    def _install_worker_sources(self) -> None:
        """Multi-process shm-ring health gauges, read off the owner's
        WorkerSupervisor.describe() (single-writer cumulative counters,
        so each read is torn-free):

        - ``workers.alive`` — live worker processes (a drop below
          ``worker_procs`` is the page);
        - ``workers.req_pushed/req_drained/req_backlog`` — staging-ring
          totals across workers (a growing backlog means the owner's
          drain is falling behind the workers' decode);
        - ``workers.resp_pushed/resp_drained/resp_backlog`` — the return
          leg (a growing backlog means a worker pump has stalled);
        - ``workers.route_spread`` — max-min client routes per worker
          (the accept-balance spread the multiproc floor asserts on)."""
        sup = self.silo.workers

        def _field(key: str) -> float:
            return float(sum(w.get(key, 0) or 0
                             for w in sup.describe()["workers"]))

        def _spread() -> float:
            routes = [w.get("client_routes", 0)
                      for w in sup.describe()["workers"]]
            return float(max(routes) - min(routes)) if routes else 0.0

        self.add_source("workers.alive",
                        lambda: _field("alive"))
        for key in ("req_pushed", "req_drained", "req_backlog",
                    "resp_pushed", "resp_drained", "resp_backlog"):
            self.add_source(f"workers.{key}", lambda k=key: _field(k))
        self.add_source("workers.route_spread", _spread)

    def _install_stream_sources(self) -> None:
        """Stream-provider health gauges, summed over every installed
        provider that exposes the probes (the device provider does; SMS
        and persistent providers simply contribute zero):

        - ``streams.backlog`` — cached-but-unpurged batches across all
          namespaces (rises when consumers or the pump fall behind the
          publishers);
        - ``streams.cursor_lag`` — worst cursor distance from the write
          head in batches (a stuck rewound consumer shows here long
          before the backlog gauge moves, because its cursor pins the
          purge floor);
        - ``streams.delivery_group`` — rows in the last compiled delivery
          batch (edges x items): the hand-off-unit twin of
          ``vector.egress_group`` — a sustained 1 means fan-out is not
          batching and the device path pays its overhead for nothing."""
        providers = self.silo.stream_providers

        def _sum(probe: str) -> float:
            total = 0.0
            for p in providers.values():
                fn = getattr(p, probe, None)
                if fn is not None:
                    total += float(fn())
            return total

        self.add_source("streams.backlog",
                        lambda: _sum("stream_backlog"))
        self.add_source("streams.cursor_lag",
                        lambda: _sum("stream_cursor_lag"))
        self.add_source("streams.delivery_group",
                        lambda: _sum("stream_delivery_group"))

    def _has_journaled_grains(self) -> bool:
        from ..eventsourcing.journaled import JournaledGrain
        return any(isinstance(c, type) and issubclass(c, JournaledGrain)
                   for c in self.silo.registry.all_classes())

    def _journal_unconfirmed(self) -> float:
        """Unconfirmed (tentative) journaled events across every local
        activation — >0 sustained means confirm_events is outrunning the
        journal provider. Scoped to real JournaledGrain instances: an
        application grain's private ``_pending`` attribute must not
        inflate the gauge."""
        from ..eventsourcing.journaled import JournaledGrain
        total = 0
        for act in self.silo.catalog.by_activation.values():
            inst = act.grain_instance
            if isinstance(inst, JournaledGrain):
                # default for an instance still mid-activation
                total += len(getattr(inst, "_pending", ()))
        return float(total)

    def _queue_depth(self, cat) -> float:
        q = self.silo.message_center.inbound.get(cat)
        return float(q.qsize()) if q is not None else 0.0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self.silo.vector is not None and \
                "vector.queue_depth" not in self._sources:
            # the device tier may have been installed after construction
            self._install_vector_sources()
        if self.silo.stream_providers and \
                "streams.backlog" not in self._sources:
            # stream providers install via lifecycle stages that run
            # after the sampler is constructed
            self._install_stream_sources()
        if getattr(self.silo, "workers", None) is not None and \
                "workers.alive" not in self._sources:
            # the worker supervisor spawns during silo start, after the
            # sampler is constructed
            self._install_worker_sources()
        self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        from .profiling import mark_loop_category
        mark_loop_category("observability")  # this task's steps are ours
        loop_lag = WindowedGauge(self.window)
        self.windows["sampler.loop_lag"] = loop_lag
        self.silo.stats.register_gauge("sampler.loop_lag", loop_lag.last)
        lag_threshold = getattr(self.silo.config,
                                "profiling_lag_threshold", 0.25)
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(self.period)
            now = time.monotonic()
            lag = max(0.0, (now - t0) - self.period)
            loop_lag.add(lag, now)
            lp = self.silo.loop_prof
            if lp is not None and lag > lag_threshold:
                # the loop is visibly stalling: snapshot the flight
                # recorder (covers silos that run no Watchdog; the
                # watchdog has its own trigger at its lag_warning)
                lp.trigger("sampler_lag", lag=round(lag, 4))
            self.sample_once(now)
            if self.otlp_sink is not None and now >= self._next_push:
                self._next_push = now + self.otlp_period
                self.push_snapshot()

    def sample_once(self, ts: float | None = None) -> None:
        """One sampling pass (the loop body; callable directly in tests)."""
        ts = time.monotonic() if ts is None else ts
        self.ticks += 1
        for name, fn in self._sources.items():
            try:
                self.windows[name].add(float(fn()), ts)
            except Exception:  # noqa: BLE001 — isolate a bad source
                log.exception("metrics source %s failed", name)

    def push_snapshot(self) -> None:
        """Offer one full registry snapshot to the OTLP metrics sink."""
        if self.otlp_sink is None:
            return
        snap = self.silo.stats.snapshot()
        snap["silo"] = self.silo.config.name
        self.otlp_sink.offer((snap,))

    def window_snapshot(self) -> dict:
        """Per-source window summaries (management surface payload)."""
        return {name: w.summary() for name, w in self.windows.items()}


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str) -> str:
    return f"{prefix}_{_NAME_RE.sub('_', name)}"


def _fmt(v: float) -> str:
    return repr(float(v)) if isinstance(v, float) and not v.is_integer() \
        else str(int(v))


def prometheus_exposition(snapshot: dict, windows: dict | None = None,
                          prefix: str = "orleans",
                          labels: dict | None = None,
                          openmetrics: bool = False) -> str:
    """Render a ``StatsRegistry.snapshot()`` (plus optional sampler
    window summaries) as Prometheus text exposition format 0.0.4, or —
    with ``openmetrics`` — as OpenMetrics 1.0 text (``_total`` counter
    samples, ``# EOF`` terminator, and histogram-bucket exemplars).

    Histograms serve their native fixed buckets — cumulative counts with
    ``le`` labels from :meth:`Histogram.bucket_labels` — plus ``_sum``
    and ``_count``; window summaries become ``_min``/``_max``/``_avg``
    gauge triples beside the live gauge.  Exemplars (the sampled trace
    id riding a slow bucket) are only legal in the OpenMetrics format —
    the classic 0.0.4 rendering omits them so strict parsers never see
    tokens after the sample value."""
    lbl = ""
    if labels:
        def esc(v) -> str:
            return str(v).replace("\\", "\\\\").replace('"', '\\"')
        inner = ",".join(f'{k}="{esc(v)}"' for k, v in labels.items())
        lbl = "{" + inner + "}"
    lines: list[str] = []
    for name, v in sorted(snapshot.get("counters", {}).items()):
        n = _prom_name(name, prefix)
        lines.append(f"# TYPE {n} counter")
        # OpenMetrics requires counter samples to carry the _total suffix
        lines.append(f"{n}{'_total' if openmetrics else ''}{lbl} {_fmt(v)}")
    for name, v in sorted(snapshot.get("gauges", {}).items()):
        n = _prom_name(name, prefix)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n}{lbl} {_fmt(v)}")
    from .stats import Histogram
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        n = _prom_name(name, prefix)
        hist = Histogram.from_snapshot(h)
        lines.append(f"# TYPE {n} histogram")
        exemplars = hist.exemplars or {}
        for i, (le, cum) in enumerate(zip(hist.bucket_labels(),
                                          hist.cumulative_counts())):
            if lbl:
                blbl = lbl[:-1] + f',le="{le}"}}'
            else:
                blbl = f'{{le="{le}"}}'
            line = f"{n}_bucket{blbl} {cum}"
            ex = exemplars.get(i) if openmetrics else None
            if ex is not None:
                # OpenMetrics exemplar syntax: the sampled trace id on the
                # bucket its observation landed in — a slow bucket links
                # straight into the tail-retained trace that filled it.
                # Same 32-hex width as the OTLP span export so backends
                # joining exemplar -> trace by exact id string match.
                v, tid, ts = ex
                line += (f' # {{trace_id="{int(tid):032x}"}} '
                         f'{float(v):.6g} {float(ts):.3f}')
            lines.append(line)
        lines.append(f"{n}_sum{lbl} {repr(float(hist.sum))}")
        lines.append(f"{n}_count{lbl} {hist.total}")
    for name, w in sorted((windows or {}).items()):
        n = _prom_name(name, prefix)
        for suffix, key in (("_window_min", "min"), ("_window_max", "max"),
                            ("_window_avg", "mean")):
            lines.append(f"# TYPE {n}{suffix} gauge")
            lines.append(f"{n}{suffix}{lbl} {repr(float(w.get(key, 0.0)))}")
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


class MetricsHttpServer:
    """Minimal asyncio HTTP server answering ``GET /metrics`` with the
    silo's exposition (stdlib-only; one server per silo, gated on
    ``SiloConfig.metrics_port``). Port 0 binds ephemeral — the bound
    port is readable from ``.port`` after :meth:`start`."""

    def __init__(self, silo: "Silo", host: str = "127.0.0.1"):
        self.silo = silo
        self.host = host
        self.port: int | None = None
        self._server: asyncio.base_events.Server | None = None

    async def start(self, port: int = 0) -> "MetricsHttpServer":
        self._server = await asyncio.start_server(
            self._handle, self.host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("metrics endpoint for %s on http://%s:%d/metrics",
                 self.silo.config.name, self.host, self.port)
        return self

    def render(self, openmetrics: bool = False) -> str:
        windows = None
        sampler = self.silo.metrics
        if sampler is not None:
            windows = sampler.window_snapshot()
        return prometheus_exposition(
            self.silo.stats.snapshot(), windows,
            labels={"silo": self.silo.config.name},
            openmetrics=openmetrics)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await reader.readline()
            # drain headers to the blank line, watching for the scraper
            # negotiating OpenMetrics (exemplars are only legal there)
            openmetrics = False
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                if line[:7].lower() == b"accept:" and \
                        b"application/openmetrics-text" in line:
                    openmetrics = True
            parts = request_line.split()
            path = parts[1].decode("latin-1") if len(parts) >= 2 else "/"
            if len(parts) >= 1 and parts[0] == b"GET" and \
                    path.split("?", 1)[0] in ("/metrics", "/"):
                body = self.render(openmetrics).encode()
                ctype = (b"application/openmetrics-text; version=1.0.0; "
                         b"charset=utf-8" if openmetrics else
                         b"text/plain; version=0.0.4; charset=utf-8")
                head = (b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: " + ctype + b"\r\n"
                        b"Content-Length: " + str(len(body)).encode() +
                        b"\r\nConnection: close\r\n\r\n")
                writer.write(head + body)
            else:
                writer.write(b"HTTP/1.1 404 Not Found\r\n"
                             b"Content-Length: 0\r\n"
                             b"Connection: close\r\n\r\n")
            await writer.drain()
        except (ConnectionResetError, asyncio.IncompleteReadError, OSError):
            pass  # scraper went away mid-request
        except Exception:  # noqa: BLE001 — a bad request must not log-spam
            log.exception("metrics request handling failed")
        finally:
            writer.close()

    async def aclose(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
