"""SLO engine: declarative objectives + multi-window burn-rate alerting.

The observability substrate (stage histograms, sampler gauges, tail
tracing, the loop profiler + flight recorder) *records*; this module
*judges*. A :class:`SloSpec` declares an objective — a latency-percentile
target over a registry histogram (route / QoS-category keyed), an
error-rate target, or a shed-rate target — with an error budget
(``1 - target``). A per-silo :class:`SloMonitor` loop evaluates every
spec from **interval-diffed snapshots** of the existing
``INGEST_STATS``/``EGRESS_STATS`` histograms and counters
(:meth:`Histogram.delta` is the primitive): zero new hot-path
instrumentation — the hot path keeps paying exactly the stamps it
already pays for metrics, and evaluation rides the observability
category of the loop at ``slo_period`` cadence.

Detection is Google-SRE-style **multi-window burn rate**: each interval's
(good, bad) event counts land in a bounded series; the *fast* window
catches spikes (a flash crowd torches the budget within seconds), the
*slow* window confirms sustained burn (a single GC pause or noisy
interval does not page). An objective breaches when BOTH windows burn
faster than ``burn_threshold`` × the budget rate with at least
``min_events`` events in the fast window; it recovers when the fast
window cools below the threshold.

The breach path is wired end-to-end:

* the **flight recorder** snapshots the loop-occupancy ring
  (trigger reason ``slo_breach``, rate-limited, carrying the breached
  objective + burn rates) — the "what occupied the loop while the SLO
  died" evidence;
* in-flight **tail traces** are force-retained
  (:meth:`SpanCollector.force_retain` over the pending map), so the
  requests that were in the air during the breach survive the tail
  keep/drop decision and export with the breach;
* ``slo.*`` **gauges/counters** land in the stats registry (Prometheus /
  OTLP / ``ctl_metrics`` see them like any other series) and a
  ``slo_breach`` **telemetry event** fans out to the consumers;
* the cluster rolls up via ``SiloControl.ctl_slo`` →
  ``ManagementGrain.get_cluster_slo`` (worst-burn-wins merge with
  per-silo drill-down, including each silo's hottest call sites from the
  :class:`~.stats.CallSiteStats` table).

Hard QoS constraint, preserved by construction: PING/SYSTEM responses
never sit behind SLO evaluation — the monitor reads a handful of named
registry series per tick (never a full registry snapshot), runs in the
``observability`` loop category, and the default spec set *asserts* the
probe path (``membership.probe.rtt.seconds``) as its own objective.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from .stats import SLO_STATS, Histogram

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.slo")

__all__ = ["SloSpec", "SloMonitor", "default_specs"]


@dataclass
class SloSpec:
    """One declarative objective.

    ``kind``:

    * ``"latency"`` — good events are observations of the ``source``
      histogram at or under ``threshold`` seconds (bucket-conservative:
      the bucket the threshold falls inside counts as bad);
    * ``"error_rate"`` — bad events are the ``bad_source`` counter's
      interval delta, total events the ``total_source`` counter's;
    * ``"shed_rate"`` — bad events are the ``bad_source`` (gateway shed)
      delta, total events bad + ``total_source`` (accepted ingress).

    ``target`` is the good fraction the objective promises (0.99 = 99%
    of events good); the error budget is ``1 - target``. Burn rate is
    the observed bad fraction over the budget — burn 1.0 spends the
    budget exactly at the promised rate, burn N spends it N× too fast.
    A breach requires BOTH windows over ``burn_threshold`` (fast catches,
    slow confirms) and ``min_events`` events in the fast window."""

    name: str
    kind: str = "latency"
    target: float = 0.99
    threshold: float = 0.1            # latency kinds: good <= this (s)
    source: str | None = None         # latency: registry histogram name
    bad_source: str | None = None     # ratio kinds: bad-event counter
    # ratio kinds: total-event counter name, or a tuple of names summed
    # (e.g. host turns + device-tier messages)
    total_source: "str | tuple[str, ...] | None" = None
    fast_window: float = 60.0
    slow_window: float = 300.0
    burn_threshold: float = 4.0
    min_events: int = 10
    # free-form labels (route/class.method/QoS category) for dashboards
    labels: dict = field(default_factory=dict)

    def validate(self) -> None:
        from ..core.errors import ConfigurationError
        if self.kind not in ("latency", "error_rate", "shed_rate"):
            raise ConfigurationError(
                f"SloSpec {self.name!r}: unknown kind {self.kind!r}")
        if not (0.0 < self.target < 1.0):
            raise ConfigurationError(
                f"SloSpec {self.name!r}: target must be in (0, 1), got "
                f"{self.target!r} — target 1.0 has zero error budget and "
                "every bad event is an infinite burn")
        if self.fast_window >= self.slow_window:
            raise ConfigurationError(
                f"SloSpec {self.name!r}: fast_window must be < "
                f"slow_window ({self.fast_window} >= {self.slow_window})")
        if self.kind == "latency" and not self.source:
            raise ConfigurationError(
                f"SloSpec {self.name!r}: latency objectives need a "
                "source histogram name")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def default_specs(config) -> list[SloSpec]:
    """The standard per-silo objective set, parameterized by the
    ``slo_*`` config knobs:

    * ``app_latency`` — ingest queue-wait (the per-message backpressure
      face every delivered message observes when metrics are on);
    * ``probe_rtt`` — membership probe round trips under the probe
      timeout (the QoS invariant as an OBJECTIVE: if PING traffic ever
      sits behind application load, this burns first);
    * ``turn_errors`` — host-turn failures over delivered application
      messages;
    * ``shed_rate`` — gateway sheds over offered client ingress.

    With metrics DISABLED only the probe-RTT objective is installed:
    the latency histogram and the turn/message totals are metrics-gated,
    and a ratio objective whose BAD counters (turn errors, gateway
    sheds) still increment against a gated-off total would read every
    bad event as a 100%-bad interval and fabricate a breach. Objectives
    whose sources simply never observe (no membership, shedding
    disabled) report zero events and never burn."""
    fw, sw = config.slo_fast_window, config.slo_slow_window
    bt, me = config.slo_burn_threshold, config.slo_min_events
    common = dict(fast_window=fw, slow_window=sw, burn_threshold=bt,
                  min_events=me)
    probe = SloSpec("probe_rtt", kind="latency",
                    target=config.slo_probe_target,
                    threshold=config.membership_probe_timeout,
                    source=SLO_STATS["probe_rtt"],
                    labels={"route": "membership.probe", "qos": "PING"},
                    **common)
    if not config.metrics_enabled:
        return [probe]
    return [
        SloSpec("app_latency", kind="latency",
                target=config.slo_latency_target,
                threshold=config.slo_latency_threshold,
                source="ingest.queue_wait.seconds",
                labels={"route": "ingest", "qos": "APPLICATION"},
                **common),
        probe,
        # turn-denominated totals: ``messaging.received.application``
        # would count inbound RESPONSES and forwarded legs too (2-3x the
        # real event count across a cluster), silently diluting burn —
        # ``ingest.turns`` + ``ingest.messages`` are observed at the
        # same owning-silo sites the bad events come from
        SloSpec("turn_errors", kind="error_rate",
                target=config.slo_error_target,
                bad_source=SLO_STATS["turn_errors"],
                total_source="ingest.turns",
                labels={"route": "turns"}, **common),
        SloSpec("shed_rate", kind="shed_rate",
                target=config.slo_shed_target,
                bad_source="messaging.gateway.shed",
                total_source=("ingest.turns", "ingest.messages"),
                labels={"route": "gateway"}, **common),
        # device-tier stream delivery: publish -> consumer-turn hand-off
        # (streams.delivery.seconds is observed by the device provider's
        # pump when the compiled fan-out round lands). Zero observations
        # when no stream provider is installed -> never burns.
        SloSpec("stream_latency", kind="latency",
                target=config.slo_stream_target,
                threshold=config.slo_stream_threshold,
                source="streams.delivery.seconds",
                labels={"route": "streams.device", "qos": "APPLICATION"},
                **common),
    ]


class _Series:
    """Bounded (ts, good, bad) interval samples with windowed sums —
    the burn-rate windows' substrate. Samples older than the slow
    window evict on every add; windowed reads walk the (small: one
    entry per monitor tick) deque."""

    __slots__ = ("max_age", "samples")

    def __init__(self, max_age: float):
        self.max_age = max_age
        self.samples: deque[tuple[float, int, int]] = deque()

    def add(self, ts: float, good: int, bad: int) -> None:
        self.samples.append((ts, good, bad))
        cutoff = ts - self.max_age
        while self.samples and self.samples[0][0] < cutoff:
            self.samples.popleft()

    def window(self, now: float, w: float) -> tuple[int, int]:
        cutoff = now - w
        good = bad = 0
        for ts, g, b in reversed(self.samples):
            if ts < cutoff:
                break
            good += g
            bad += b
        return good, bad


class _Objective:
    """Evaluation state for one spec: the interval series, the previous
    cumulative reads (histogram summary / counter values) the next
    interval diffs against, cumulative good/bad for budget accounting,
    and the breach episode state."""

    __slots__ = ("spec", "series", "prev_hist", "prev_counters",
                 "cum_good", "cum_bad", "breached", "breaches",
                 "breach_started_mono", "breach_started_wall",
                 "first_breach_mono", "episodes", "burn_fast",
                 "burn_slow", "_first_ts")

    def __init__(self, spec: SloSpec):
        self.spec = spec
        self.series = _Series(spec.slow_window)
        self.prev_hist: dict | None = None
        self.prev_counters: dict[str, int] = {}
        self.cum_good = 0
        self.cum_bad = 0
        self.breached = False
        self.breaches = 0
        self.breach_started_mono: float | None = None
        self.breach_started_wall: float | None = None
        self.first_breach_mono: float | None = None
        # monotonic start of each breach episode (bounded): harnesses
        # measure time-to-detect against the first episode AT/AFTER
        # their overload onset, not a stale warmup episode
        self.episodes: list[float] = []
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self._first_ts: float | None = None  # first evaluation tick

    # -- interval collection ------------------------------------------------
    def collect(self, stats) -> tuple[int, int]:
        """(good, bad) events since the previous tick, from the registry
        — cumulative state diffs here, never on the hot path."""
        spec = self.spec
        if spec.kind == "latency":
            h = stats.histograms.get(spec.source)
            if h is None:
                return 0, 0
            d = h.delta(self.prev_hist)
            self.prev_hist = h.summary()
            good = d.good_below(spec.threshold)
            return good, d.total - good
        bad = self._counter_delta(stats, spec.bad_source)
        total = self._counter_delta(stats, spec.total_source)
        if spec.kind == "shed_rate":
            # shed messages never execute: offered = executed + shed
            return total, bad
        return max(0, total - bad), bad

    def _counter_delta(self, stats, name) -> int:
        if not name:
            return 0
        if isinstance(name, tuple):
            return sum(self._counter_delta(stats, n) for n in name)
        cur = stats.counters.get(name, 0)
        prev = self.prev_counters.get(name, 0)
        self.prev_counters[name] = cur
        return max(0, cur - prev)

    # -- burn math -----------------------------------------------------------
    @staticmethod
    def _burn(good: int, bad: int, budget: float) -> float:
        total = good + bad
        if total <= 0:
            return 0.0
        return (bad / total) / budget

    def evaluate(self, now: float, good: int, bad: int) -> bool:
        """Fold one interval in; returns True on a NEW breach episode."""
        spec = self.spec
        if self._first_ts is None:
            self._first_ts = now
        self.series.add(now, good, bad)
        self.cum_good += good
        self.cum_bad += bad
        fg, fb = self.series.window(now, spec.fast_window)
        sg, sb = self.series.window(now, spec.slow_window)
        self.burn_fast = self._burn(fg, fb, spec.budget)
        self.burn_slow = self._burn(sg, sb, spec.budget)
        if not self.breached:
            if (fg + fb >= spec.min_events
                    # cold-start guard: until the series has SPANNED a
                    # full slow window, the slow window holds the same
                    # samples as the fast one and would rubber-stamp a
                    # single bad interval — the multi-window confirm
                    # only means something once the windows differ
                    and now - self._first_ts >= spec.slow_window
                    and self.burn_fast >= spec.burn_threshold
                    and self.burn_slow >= spec.burn_threshold):
                self.breached = True
                self.breaches += 1
                self.breach_started_mono = now
                self.breach_started_wall = time.time()
                if self.first_breach_mono is None:
                    self.first_breach_mono = now
                if len(self.episodes) < 64:
                    self.episodes.append(now)
                return True
        elif self.burn_fast < spec.burn_threshold:
            # recovery: the fast window cooled below the alert rate
            # (the slow window may still carry the episode's debris)
            self.breached = False
        return False

    @property
    def budget_burned(self) -> float:
        """Fraction of the cumulative error budget consumed since the
        monitor started (>1 = over budget for the observed volume)."""
        total = self.cum_good + self.cum_bad
        if total <= 0:
            return 0.0
        return (self.cum_bad / total) / self.spec.budget

    def status(self) -> dict:
        spec = self.spec
        out = {
            "kind": spec.kind,
            "target": spec.target,
            "burn_threshold": spec.burn_threshold,
            "fast_window": spec.fast_window,
            "slow_window": spec.slow_window,
            "met": not self.breached,
            "breached": self.breached,
            "breaches": self.breaches,
            "burn_fast": round(self.burn_fast, 4),
            "burn_slow": round(self.burn_slow, 4),
            "budget_burned": round(self.budget_burned, 4),
            "good": self.cum_good,
            "bad": self.cum_bad,
            "labels": dict(spec.labels),
        }
        if spec.kind == "latency":
            out["threshold"] = spec.threshold
            out["source"] = spec.source
        if self.breach_started_wall is not None:
            out["breach_started"] = self.breach_started_wall
            out["breach_started_mono"] = self.breach_started_mono
        if self.first_breach_mono is not None:
            out["first_breach_mono"] = self.first_breach_mono
            out["episodes"] = list(self.episodes)
        return out


class SloMonitor:
    """Per-silo SLO evaluation loop.

    Construction never touches the hot path: every tick reads the named
    registry series each objective declares (a few dict gets + one
    :meth:`Histogram.delta` per latency objective), folds the interval
    into the burn windows, refreshes the ``slo.*`` gauges, and — on a
    breach transition — fires the breach path (flight recorder,
    tail-trace force-retention, telemetry). ``evaluate_once`` is callable
    directly with an injected clock for deterministic tests and for
    harnesses that want a final read before teardown."""

    def __init__(self, silo: "Silo", specs: list[SloSpec] | None = None,
                 period: float | None = None):
        self.silo = silo
        self.period = (period if period is not None
                       else silo.config.slo_period)
        specs = list(specs) if specs else default_specs(silo.config)
        for s in specs:
            s.validate()
        self.objectives = {s.name: _Objective(s) for s in specs}
        self.ticks = 0
        self._task: asyncio.Task | None = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        from .profiling import mark_loop_category
        mark_loop_category("observability")  # evaluation is OUR tax,
        # never booked to turns/pump — and never in front of them: each
        # tick is one short callback run between loop turns
        while True:
            await asyncio.sleep(self.period)
            try:
                self.evaluate_once()
            except Exception:  # noqa: BLE001 — a bad source must not
                log.exception("SLO evaluation failed")  # kill the loop

    # -- evaluation --------------------------------------------------------
    def evaluate_once(self, now: float | None = None) -> list[str]:
        """One evaluation pass; returns the objectives that entered a
        NEW breach episode this tick (tests and harnesses read it)."""
        now = time.monotonic() if now is None else now
        stats = self.silo.stats
        self.ticks += 1
        stats.increment(SLO_STATS["evaluations"])
        newly_breached: list[str] = []
        for name, obj in self.objectives.items():
            good, bad = obj.collect(stats)
            if obj.evaluate(now, good, bad):
                newly_breached.append(name)
            stats.set_gauge(SLO_STATS["burn_fast"] % name, obj.burn_fast)
            stats.set_gauge(SLO_STATS["burn_slow"] % name, obj.burn_slow)
            stats.set_gauge(SLO_STATS["budget_burned"] % name,
                            obj.budget_burned)
            stats.set_gauge(SLO_STATS["breached"] % name,
                            1.0 if obj.breached else 0.0)
        for name in newly_breached:
            self._on_breach(self.objectives[name])
        return newly_breached

    def _on_breach(self, obj: _Objective) -> None:
        """The wired breach path: counters, flight recorder, tail-trace
        force-retention, telemetry. Every step is isolated — observing a
        breach must never make the overload worse."""
        silo = self.silo
        name = obj.spec.name
        silo.stats.increment(SLO_STATS["breaches"])
        silo.stats.increment(SLO_STATS["breach"] % name)
        # WHO was burning when the breach fired: the cost ledger's top
        # keys, tenant-annotated — attached to the flight snapshot and
        # the telemetry event so the drill-down starts named
        burners: list = []
        led = getattr(silo, "ledger", None)   # unit fakes omit the attr
        if led is not None:
            try:
                burners = led.top_burners(5)
            except Exception:  # noqa: BLE001
                log.exception("slo breach ledger read failed")
        log.warning("SLO breach on %s: %s burn fast=%.1fx slow=%.1fx "
                    "(threshold %.1fx, target %s)", silo.config.name, name,
                    obj.burn_fast, obj.burn_slow, obj.spec.burn_threshold,
                    obj.spec.target)
        lp = silo.loop_prof
        if lp is not None:
            # flight recorder: the loop-occupancy ring around the breach
            # IS the first diagnostic — snapshot it (rate-limited per
            # reason inside trigger) carrying the breached objective
            try:
                lp.trigger("slo_breach", objective=name,
                           burn_fast=round(obj.burn_fast, 2),
                           burn_slow=round(obj.burn_slow, 2),
                           target=obj.spec.target,
                           top_burners=burners)
            except Exception:  # noqa: BLE001
                log.exception("slo breach flight trigger failed")
        tracer = silo.tracer
        if tracer is not None and tracer.tail:
            # in-flight tail traces: whatever is pending RIGHT NOW was in
            # the air during the breach — pin it through the keep/drop
            # decision so the breach exports with its requests
            try:
                for tid in list(tracer.pending):
                    tracer.force_retain(tid)
            except Exception:  # noqa: BLE001
                log.exception("slo breach trace force-retention failed")
        tm = getattr(silo, "telemetry", None)
        if tm is not None:
            try:
                tm.track_event("slo_breach", objective=name,
                               burn_fast=round(obj.burn_fast, 2),
                               burn_slow=round(obj.burn_slow, 2),
                               budget_burned=round(obj.budget_burned, 4),
                               silo=silo.config.name,
                               top_burners=burners)
            except Exception:  # noqa: BLE001
                log.exception("slo breach telemetry failed")

    # -- reads -------------------------------------------------------------
    @property
    def breached(self) -> bool:
        return any(o.breached for o in self.objectives.values())

    def status(self) -> dict:
        """The management-surface payload (``ctl_slo``): every
        objective's verdict + burn state, plus the monitor's own
        cadence evidence."""
        return {
            "silo": self.silo.config.name,
            "period": self.period,
            "ticks": self.ticks,
            "breached": self.breached,
            "breaches": sum(o.breaches for o in self.objectives.values()),
            "objectives": {n: o.status()
                           for n, o in self.objectives.items()},
        }
