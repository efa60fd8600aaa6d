"""Telemetry consumer fan-out + periodic statistics dump + watchdog.

Re-design of Orleans' src/Orleans.Core/Telemetry/ (ITelemetryConsumer
family, TelemetryManager.cs), Core/Statistics/LogStatistics.cs:11 (periodic
registry dump), and Silo/Watchdog.cs:10 (health tick :63-104 — detects
event-loop stalls the way the reference detects GC/thread stalls).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.telemetry")

__all__ = ["TelemetryConsumer", "LoggingTelemetryConsumer",
           "FileTelemetryConsumer", "TelemetryManager", "Watchdog",
           "add_telemetry"]


class TelemetryConsumer:
    """Sink contract (ITelemetryConsumer): receives metric snapshots and
    tracked events."""

    def record_snapshot(self, silo_name: str, snapshot: dict) -> None:
        raise NotImplementedError

    def track_event(self, name: str, properties: dict) -> None:  # noqa: B027
        pass

    def close(self) -> None:  # noqa: B027
        pass


class LoggingTelemetryConsumer(TelemetryConsumer):
    """Dumps snapshots to the logger (the LogStatistics default)."""

    def record_snapshot(self, silo_name, snapshot) -> None:
        log.info("stats[%s]: %d counters, %d histograms", silo_name,
                 len(snapshot["counters"]), len(snapshot["histograms"]))

    def track_event(self, name, properties) -> None:
        log.info("event[%s]: %s", name, properties)


class FileTelemetryConsumer(TelemetryConsumer):
    """JSON-lines sink (the file telemetry consumer analog)."""

    def __init__(self, path: str):
        self._f = open(path, "a")

    def record_snapshot(self, silo_name, snapshot) -> None:
        self._f.write(json.dumps({"silo": silo_name, **snapshot}) + "\n")
        self._f.flush()

    def track_event(self, name, properties) -> None:
        self._f.write(json.dumps({"event": name, **properties}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TelemetryManager:
    """Fan-out to registered consumers on a timer (TelemetryManager.cs)."""

    def __init__(self, silo: "Silo", period: float = 5.0):
        self.silo = silo
        self.period = period
        self.consumers: list[TelemetryConsumer] = []
        self._task: asyncio.Task | None = None

    def add_consumer(self, consumer: TelemetryConsumer) -> None:
        self.consumers.append(consumer)

    def track_event(self, name: str, **properties) -> None:
        for c in self.consumers:
            try:
                c.track_event(name, properties)
            except Exception:  # noqa: BLE001
                log.exception("telemetry consumer failed")

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        for c in self.consumers:
            c.close()

    async def _loop(self) -> None:
        from .profiling import mark_loop_category
        mark_loop_category("observability")
        while True:
            await asyncio.sleep(self.period)
            self.flush()

    def flush(self) -> None:
        snapshot = self.silo.stats.snapshot()
        for c in self.consumers:
            try:
                c.record_snapshot(self.silo.config.name, snapshot)
            except Exception:  # noqa: BLE001
                log.exception("telemetry consumer failed")


class Watchdog:
    """Event-loop health monitor (Silo/Watchdog.cs:10): measures scheduling
    lag each tick; sustained lag means a turn is hogging the loop (the
    cooperative-scheduler equivalent of a GC/thread stall)."""

    def __init__(self, silo: "Silo", period: float = 1.0,
                 lag_warning: float = 0.5):
        self.silo = silo
        self.period = period
        self.lag_warning = lag_warning
        self.last_lag = 0.0
        self.max_lag = 0.0
        self._task: asyncio.Task | None = None
        # live loop-health gauges: the histogram alone cannot answer "is
        # the loop stalled RIGHT NOW", so the management surface reads
        # these from the registry snapshot. max_lag is max-since-last-
        # snapshot: reading it resets the window, so each telemetry flush
        # reports the worst stall of its own period. Destructive read by
        # design — concurrent snapshot readers (a management poll racing
        # the telemetry flush) share one window, and whichever reads
        # first gets the stall; the loop_lag histogram keeps the full
        # record either way.
        silo.stats.register_gauge("watchdog.last_lag", lambda: self.last_lag)
        silo.stats.register_gauge("watchdog.max_lag", self._drain_max_lag)

    def _drain_max_lag(self) -> float:
        v, self.max_lag = self.max_lag, 0.0
        return v

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        from .profiling import mark_loop_category
        mark_loop_category("observability")
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(self.period)
            lag = (time.monotonic() - t0) - self.period
            self.last_lag = lag
            self.max_lag = max(self.max_lag, lag)
            self.silo.stats.observe("watchdog.loop_lag", max(lag, 0.0))
            if lag > self.lag_warning:
                self.silo.stats.increment("watchdog.lag_warnings")
                lp = getattr(self.silo, "loop_prof", None)
                if lp is not None:
                    # flight recorder: the occupancy ring at the moment
                    # of the stall IS the diagnosis the watchdog can't
                    # make alone (which category ate the loop)
                    lp.trigger("watchdog_lag", lag=round(lag, 4))
                log.warning(
                    "%s: event loop lagged %.3fs (long turn or blocked "
                    "call starving the cooperative scheduler)",
                    self.silo.silo_address, lag)


def add_telemetry(builder, *consumers, period: float = 5.0,
                  watchdog_period: float = 1.0):
    """Install telemetry fan-out + watchdog on a SiloBuilder."""

    def install(silo) -> None:
        manager = TelemetryManager(silo, period)
        for c in consumers:
            manager.add_consumer(c)
        silo.telemetry = manager
        watchdog = Watchdog(silo, watchdog_period)
        silo.watchdog = watchdog
        from ..runtime.silo import ServiceLifecycleStage
        silo.subscribe_lifecycle(ServiceLifecycleStage.RUNTIME_SERVICES,
                                 manager.start, manager.stop)
        silo.subscribe_lifecycle(ServiceLifecycleStage.RUNTIME_SERVICES,
                                 watchdog.start, watchdog.stop)

    return builder.configure(install)
