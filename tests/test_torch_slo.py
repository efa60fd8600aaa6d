"""The port's SLO engine (orleans_tpu_torch.observability.slo), on the
CPU: the port's copy of tests/test_slo.py — declarative specs and
multi-window burn-rate detection, the breach path (flight recorder,
tail-trace retention, ``slo.*`` series, the cluster roll-up through
``ManagementGrain.get_cluster_slo``), options validation, and the gauntlet
scenarios (diurnal, churn storm, a hot key named by the ledger) of the
JAX package's ``benchmarks/gauntlet.py``, whose source is loaded with its
imports rebound to the port. The flash-crowd scenario is not copied: its
breach verdict is marginal on a shared CPU in both packages (the
shed-rate objective's fast burn lands at 1.6-2.6 against its 2.0
threshold), so it fails some runs of either package's silo. Every async body runs under ``asyncio.wait_for(..., 30)``.
"""

import asyncio
import functools
import types
from pathlib import Path
from types import SimpleNamespace

import pytest

from orleans_tpu_torch.config import SloOptions
from orleans_tpu_torch.core.errors import ConfigurationError
from orleans_tpu_torch.management import ManagementGrain
from orleans_tpu_torch.observability.slo import SloMonitor, SloSpec
from orleans_tpu_torch.observability.stats import (SLO_STATS,
                                                   CallSiteStats, Histogram,
                                                   StatsRegistry)
from orleans_tpu_torch.runtime import Grain
from orleans_tpu_torch.testing import TestClusterBuilder


TIMEOUT = 30


def _port_gauntlet():
    """The JAX package's ``benchmarks/gauntlet.py`` scenarios over the
    port: its source with every ``orleans_tpu.`` import rebound to
    ``orleans_tpu_torch.`` (the diurnal, churn and hot-key scenarios use
    host grains, sockets, membership and management only),
    so the gauntlet drives the port's silos and SLO monitors."""
    path = Path(__file__).resolve().parent.parent / "benchmarks" / \
        "gauntlet.py"
    src = path.read_text().replace("from orleans_tpu.",
                                   "from orleans_tpu_torch.")
    mod = types.ModuleType("gauntlet_torch")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)  # noqa: S102
    return mod


def bounded(fn):
    """Run the test coroutine under ``asyncio.wait_for(..., TIMEOUT)``."""
    @functools.wraps(fn)
    async def run(*args, **kwargs):
        await asyncio.wait_for(fn(*args, **kwargs), TIMEOUT)
    return run


# ---------------------------------------------------------------------------
# Histogram.delta — the interval-diff primitive
# ---------------------------------------------------------------------------

def test_histogram_delta_basic():
    h = Histogram()
    for v in (0.001, 0.01, 0.2):
        h.observe(v)
    snap = h.summary()
    h.observe(0.3)
    h.observe(0.0005)
    d = h.delta(snap)
    assert d.total == 2
    assert abs(d.sum - 0.3005) < 1e-9
    # the delta holds ONLY the new observations, in their buckets
    assert d.good_below(0.001) == 1      # the 0.0005 one
    assert d.good_below(0.25) == 1       # 0.3 is above
    # the cumulative histogram is untouched
    assert h.total == 5


def test_histogram_delta_none_snapshot_is_copy():
    h = Histogram()
    h.observe(0.05)
    d = h.delta(None)
    assert d.total == 1 and d.counts == h.counts
    d.observe(0.05)
    assert h.total == 1  # a copy, not a view


def test_histogram_delta_mismatched_bounds_is_safe():
    """A snapshot taken with different bucket bounds folds onto the live
    histogram's bounds (the widening rule) before subtracting —
    counts never go negative and never subtract positionally against
    the wrong bucket."""
    h = Histogram()                      # default latency bounds
    for v in (0.001, 0.01, 0.2, 2.0):
        h.observe(v)
    prev = Histogram([0.005, 0.1, float("inf")])  # coarse foreign bounds
    prev.observe(0.001)
    prev.observe(0.01)
    d = h.delta(prev.summary())
    assert all(c >= 0 for c in d.counts)
    assert d.total == sum(d.counts)
    # conservative: at most the cumulative count survives
    assert d.total <= h.total


def test_histogram_good_below_is_bucket_conservative():
    h = Histogram([0.01, 0.1, 1.0, float("inf")])
    h.observe(0.005)   # bucket <=0.01
    h.observe(0.05)    # bucket <=0.1
    h.observe(5.0)     # +Inf bucket
    assert h.good_below(0.01) == 1
    # threshold INSIDE a bucket excludes that bucket (conservative)
    assert h.good_below(0.05) == 1
    assert h.good_below(0.1) == 2
    # the +Inf bucket can never prove an observation under any finite
    # threshold — 5.0 landed there, so it stays bad (conservative)
    assert h.good_below(100.0) == 2


# ---------------------------------------------------------------------------
# CallSiteStats — the breach drill-down table
# ---------------------------------------------------------------------------

def test_callsite_stats_topk_bounded_merge():
    cs = CallSiteStats(cap=3)
    for i in range(10):
        cs.note("A", "slow", 0.05)
    cs.note("A", "fast", 0.001)
    cs.note("B", "err", 0.01, error=True)
    cs.note("C", "dropped", 1.0)  # 4th site: over the cap
    assert cs.overflow == 1
    assert len(cs.sites) == 3
    top = cs.top(2, by="sum")
    assert top[0]["site"] == "A.slow" and top[0]["count"] == 10
    assert cs.top(1, by="errors")[0]["site"] == "B.err"
    # merge: counts/errors/seconds sum, max takes max
    merged = CallSiteStats.merge([cs.snapshot(), cs.snapshot()])
    assert merged["sites"]["A.slow"][0] == 20
    assert merged["sites"]["B.err"][1] == 2
    assert merged["overflow"] == 2
    # snapshot(k) bounds the payload to the top-k by seconds
    assert len(cs.snapshot(1)["sites"]) == 1


# ---------------------------------------------------------------------------
# Burn-rate math: multi-window confirm + recovery (deterministic clock)
# ---------------------------------------------------------------------------

def _stub_silo(**cfg_kw) -> SimpleNamespace:
    """The minimal surface SloMonitor touches: stats registry + config +
    the breach-path consumers (absent here — the unit tests assert the
    math; the e2e test below asserts the wiring)."""
    from orleans_tpu_torch.runtime.silo import SiloConfig
    cfg = SiloConfig(name="stub", **cfg_kw)
    return SimpleNamespace(stats=StatsRegistry(), config=cfg,
                           tracer=None, loop_prof=None, call_sites=None)


def test_multi_window_burn_confirm_and_recovery():
    """The Google-SRE shape: a fast-window spike alone does not page —
    the slow window must confirm; sustained burn breaches; cooling the
    fast window recovers."""
    silo = _stub_silo()
    spec = SloSpec("lat", kind="latency", target=0.9, threshold=0.01,
                   source="x.seconds", fast_window=2.0, slow_window=10.0,
                   burn_threshold=2.0, min_events=5)
    mon = SloMonitor(silo, specs=[spec], period=1.0)
    h = silo.stats.histogram("x.seconds")
    t = 1000.0

    # 8 ticks of healthy traffic fill the slow window with good events
    for _ in range(8):
        for _ in range(20):
            h.observe(0.001)
        assert mon.evaluate_once(t) == []
        t += 1.0
    obj = mon.objectives["lat"]
    assert obj.burn_fast == 0.0 and not obj.breached

    # one tick of pure badness: fast window burns 10x, slow window is
    # still diluted by 160 good events -> NO breach (no single-interval
    # paging)
    for _ in range(20):
        h.observe(0.5)
    assert mon.evaluate_once(t) == []
    assert obj.burn_fast >= 2.0, obj.burn_fast
    assert obj.burn_slow < 2.0
    assert not obj.breached
    t += 1.0

    # sustained badness: the slow window confirms -> breach (and the
    # slo.* counters/gauges land)
    newly = []
    for _ in range(12):
        for _ in range(20):
            h.observe(0.5)
        newly += mon.evaluate_once(t)
        t += 1.0
    assert newly == ["lat"]
    assert obj.breached and obj.breaches == 1
    assert silo.stats.get(SLO_STATS["breaches"]) == 1
    assert silo.stats.gauge(SLO_STATS["breached"] % "lat") == 1.0
    assert obj.budget_burned > 1.0  # over budget for the observed volume

    # recovery: good traffic cools the fast window below the threshold
    for _ in range(4):
        for _ in range(50):
            h.observe(0.001)
        mon.evaluate_once(t)
        t += 1.0
    assert not obj.breached
    assert obj.breaches == 1  # the episode is history, not forgotten
    assert silo.stats.gauge(SLO_STATS["breached"] % "lat") == 0.0


def test_error_and_shed_rate_objectives_from_counters():
    silo = _stub_silo()
    specs = [
        SloSpec("err", kind="error_rate", target=0.9,
                bad_source="turns.errors", total_source="turns.total",
                fast_window=2.0, slow_window=6.0, burn_threshold=2.0,
                min_events=4),
        SloSpec("shed", kind="shed_rate", target=0.9,
                bad_source="gw.shed", total_source="turns.total",
                fast_window=2.0, slow_window=6.0, burn_threshold=2.0,
                min_events=4),
    ]
    mon = SloMonitor(silo, specs=specs, period=1.0)
    t = 0.0
    # healthy: 100 turns, no errors/sheds
    silo.stats.increment("turns.total", 100)
    mon.evaluate_once(t)
    err, shed = mon.objectives["err"], mon.objectives["shed"]
    assert err.burn_fast == 0.0
    # sustained 50%-error / 50%-shed ticks (interval semantics: each
    # tick sees only the counter DELTAS): the fast window burns first,
    # the breach waits until the healthy baseline ages out of the slow
    # window — the multi-window confirm on the counter kinds
    newly: list[str] = []
    immediate = None
    for _ in range(8):
        t += 1.0
        silo.stats.increment("turns.total", 10)
        silo.stats.increment("turns.errors", 5)
        silo.stats.increment("gw.shed", 10)
        got = mon.evaluate_once(t)
        if immediate is None:
            immediate = bool(got)  # first bad tick must NOT page alone
        newly += got
    assert immediate is False
    assert "err" in newly and "shed" in newly
    assert err.breached and shed.breached
    assert err.burn_fast >= 2.0 and shed.burn_fast >= 2.0


def test_default_specs_without_metrics_is_probe_only():
    """With metrics disabled the latency histogram and turn/message
    totals never observe — but turn errors and gateway sheds still
    count, so a ratio objective would read every bad event as a
    100%-bad interval and fabricate a breach. default_specs must
    install ONLY the probe-RTT objective then."""
    from orleans_tpu_torch.observability.slo import default_specs
    from orleans_tpu_torch.runtime.silo import SiloConfig
    assert [s.name for s in default_specs(SiloConfig())] == ["probe_rtt"]
    names = [s.name for s in default_specs(SiloConfig(metrics_enabled=True))]
    assert names == ["app_latency", "probe_rtt", "turn_errors",
                     "shed_rate", "stream_latency"]


def test_slo_spec_and_options_validation():
    with pytest.raises(ConfigurationError):
        SloSpec("x", kind="nonsense").validate()
    with pytest.raises(ConfigurationError):
        SloSpec("x", target=1.0).validate()  # zero budget
    with pytest.raises(ConfigurationError):
        SloSpec("x", fast_window=10.0, slow_window=5.0).validate()
    with pytest.raises(ConfigurationError):
        SloSpec("x", kind="latency", source=None).validate()
    with pytest.raises(ConfigurationError):
        SloOptions(fast_window=300.0, slow_window=60.0).validate()
    with pytest.raises(ConfigurationError):
        SloOptions(error_target=0.0).validate()
    SloOptions().validate()


# ---------------------------------------------------------------------------
# End-to-end breach path: flight recorder + force-retention + rollup
# ---------------------------------------------------------------------------

class SlowGrain(Grain):
    async def work(self, x: int) -> int:
        await asyncio.sleep(0.02)
        return x


class FrontGrain(Grain):
    """Calls SlowGrain from inside the silo, so the nested call roots a
    SILO-side trace (the test client stays untraced) — the in-flight
    traces a breach must force-retain."""

    async def go(self, i: int) -> int:
        ref = self.get_grain(SlowGrain, i % 2)
        return await ref.work(i)


@bounded
async def test_breach_fires_flight_recorder_retention_and_rollup():
    """The acceptance path end-to-end: saturating two slow grains makes
    ingest queue-wait torch a tight latency budget; the breach must (a)
    mark the objective breached with slo.* counters, (b) snapshot the
    flight recorder with reason ``slo_breach`` carrying the objective,
    (c) force-retain the in-flight tail traces (which would ALL be
    dropped under the sky-high slow threshold otherwise), and (d) roll
    up cluster-wide through ManagementGrain.get_cluster_slo with
    worst-burn-wins + call-site drill-down."""
    b = (TestClusterBuilder(n_silos=2)
         .add_grains(SlowGrain, FrontGrain)
         .with_slo(latency_threshold=0.005, latency_target=0.9)
         .with_profiling(window=0.1, trigger_interval=0.05)
         # tail mode with an unreachable slow threshold: NOTHING retains
         # on latency/error — only the breach's force-retention keeps
         .with_tracing(tail=True, slow_threshold=999.0, client=False)
         .with_config(hot_lane_enabled=False))
    async with b.build() as cluster:
        fronts = [cluster.grain(FrontGrain, k) for k in range(8)]
        await asyncio.gather(*(g.go(0) for g in fronts))  # activate

        stop = asyncio.Event()

        async def hammer(wid: int) -> None:
            i = wid
            while not stop.is_set():
                await fronts[i % len(fronts)].go(i)
                i += 1

        tasks = [asyncio.ensure_future(hammer(w)) for w in range(16)]
        try:
            def breached() -> bool:
                return any(s.slo is not None and s.slo.status()["breaches"]
                           for s in cluster.silos)
            await cluster.wait_until(breached, timeout=15.0,
                                     msg="SLO breach under slow-grain load")
            # keep traffic in the air a moment so pending traces exist
            # at the breach instant (force-retention's subjects)
            await asyncio.sleep(0.2)
        finally:
            stop.set()
            await asyncio.gather(*tasks, return_exceptions=True)

        # (a) objective state + counters
        hot = next(s for s in cluster.silos
                   if s.slo.status()["breaches"] > 0)
        st = hot.slo.status()
        assert st["objectives"]["app_latency"]["breaches"] >= 1
        assert hot.stats.get(SLO_STATS["breaches"]) >= 1
        assert hot.stats.get(SLO_STATS["breach"] % "app_latency") >= 1

        # (b) flight recorder snapshot with the breached objective
        # (TestCluster silos share one loop -> one profiler)
        snaps = [s for s in hot.loop_prof.snapshots
                 if s["reason"] == "slo_breach"]
        assert snaps, "no slo_breach flight-recorder snapshot"
        assert snaps[0]["attrs"]["objective"] in ("app_latency",
                                                  "turn_errors",
                                                  "shed_rate", "probe_rtt")
        assert snaps[0]["attrs"]["burn_fast"] >= 2.0

        # (c) force-retention: with slow_threshold=999 and zero errors,
        # ONLY forced traces survive the tail decision
        await cluster.drain_traces()
        ret = cluster.retention_stats()
        assert ret.get("kept", 0) >= 1, ret

        # (d) cluster rollup: worst-burn-wins + per-silo drill-down
        mg = cluster.grain(ManagementGrain, 0)
        roll = await mg.get_cluster_slo()
        assert roll["breaches"] >= 1
        app = roll["objectives"]["app_latency"]
        assert app["breaches"] >= 1 and app["worst_silo"]
        assert roll["per_silo"]  # the drill-down payloads ride along
        some = next(iter(roll["per_silo"].values()))
        assert "call_sites" in some  # breach -> hot grain methods
        sites = await mg.get_cluster_call_sites(5)
        assert any(s["site"] == "SlowGrain.work" for s in sites)
        assert any(s["site"] == "FrontGrain.go" for s in sites)


@bounded
async def test_slo_disabled_costs_and_serves_nothing():
    async with TestClusterBuilder(n_silos=1).build() as cluster:
        silo = cluster.silos[0]
        assert silo.slo is None and silo.call_sites is None
        ctl = await silo.silo_control.ctl_slo()
        assert ctl == {}
        assert await silo.silo_control.ctl_call_sites() == {}
        mg = cluster.grain(ManagementGrain, 0)
        roll = await mg.get_cluster_slo()
        assert roll["objectives"] == {} and not roll["breached"]


# ---------------------------------------------------------------------------
# Perfetto flame row: top-K slow-callback records as spans
# ---------------------------------------------------------------------------

def test_chrome_trace_promotes_slow_callbacks_to_spans():
    from orleans_tpu_torch.observability.export import chrome_trace_events
    windows = [{
        "ts": 100.5, "wall_s": 0.5,
        "seconds": {"turns": 0.3, "idle": 0.2},
        "shares": {"turns": 0.6, "idle": 0.4},
        "top": [
            {"seconds": 0.2, "category": "turns", "label": "Echo.ping"},
            {"seconds": 0.05, "category": "pump", "label": "recv"},
        ],
    }]
    events = chrome_trace_events([], loop_profiles={"silo0": windows})
    rows = [e for e in events if e.get("ph") == "M"
            and e.get("name") == "thread_name"]
    assert any(e["args"]["name"] == "slow callbacks" for e in rows)
    spans = [e for e in events if e.get("ph") == "X"]
    assert {s["name"] for s in spans} == {"Echo.ping", "recv"}
    ping = next(s for s in spans if s["name"] == "Echo.ping")
    assert ping["cat"] == "turns"
    assert abs(ping["dur"] - 0.2e6) < 1.0  # microseconds, exact duration
    # records lie INSIDE their window beside the counter track
    counters = [e for e in events if e.get("ph") == "C"]
    assert counters and counters[0]["args"]["turns"] == 0.6
    win_start_us = 0.0  # earliest ts on the zeroed timeline
    assert ping["ts"] >= win_start_us
    assert ping["ts"] + ping["dur"] <= 0.5e6 + 1.0


def test_chrome_trace_flame_rows_never_overlap_across_windows():
    """A window whose top-K durations sum past its end SPILLS past the
    boundary, and the next window's records start after the spill —
    overlapping same-tid complete events would render as bogus
    nesting."""
    from orleans_tpu_torch.observability.export import chrome_trace_events
    windows = [
        {"ts": 100.5, "wall_s": 0.5, "shares": {"turns": 1.0},
         "top": [{"seconds": 0.4, "category": "turns", "label": "a"},
                 {"seconds": 0.4, "category": "turns", "label": "b"}]},
        {"ts": 101.0, "wall_s": 0.5, "shares": {"turns": 1.0},
         "top": [{"seconds": 0.1, "category": "turns", "label": "c"}]},
    ]
    events = chrome_trace_events([], loop_profiles={"s": windows})
    spans = sorted((e for e in events if e.get("ph") == "X"),
                   key=lambda e: e["ts"])
    assert [s["name"] for s in spans] == ["a", "b", "c"]
    for prev, nxt in zip(spans, spans[1:]):
        assert nxt["ts"] >= prev["ts"] + prev["dur"] - 1e-6


def test_chrome_trace_places_offset_records_exactly():
    """Records carrying a within-window start
    offset (stamped by the profiler hot path) render at window_start +
    offset — exact placement, not the end-to-end cursor layout — and
    exact records never overlap (callbacks are sequential)."""
    from orleans_tpu_torch.observability.export import chrome_trace_events
    windows = [
        {"ts": 100.5, "wall_s": 0.5, "shares": {"turns": 1.0},
         "top": [
             {"seconds": 0.05, "category": "turns", "label": "a",
              "offset": 0.30},
             {"seconds": 0.02, "category": "pump", "label": "b",
              "offset": 0.10},
         ]},
    ]
    events = chrome_trace_events([], loop_profiles={"s": windows})
    spans = {e["name"]: e for e in events if e.get("ph") == "X"}
    # window start = ts - wall = 100.0 = t0 (zeroed timeline)
    assert abs(spans["a"]["ts"] - 0.30e6) < 1.0
    assert abs(spans["b"]["ts"] - 0.10e6) < 1.0
    # exact records do not overlap even though the list is
    # duration-sorted, not time-sorted
    ordered = sorted(spans.values(), key=lambda e: e["ts"])
    for prev, nxt in zip(ordered, ordered[1:]):
        assert nxt["ts"] >= prev["ts"] + prev["dur"] - 1e-6


# ---------------------------------------------------------------------------
# Gauntlet: negative controls and the ledger drill-down
# ---------------------------------------------------------------------------

def _check_verdicts(verdicts: dict) -> None:
    assert verdicts, "no SLO verdicts emitted"
    for v in verdicts.values():
        assert {"objective", "kind", "met", "breached", "burn_fast",
                "burn_slow", "budget_burned", "events",
                "time_to_detect"} <= set(v)


@bounded
async def test_gauntlet_diurnal_is_breach_free():
    """Negative control: an ordinary (compressed) diurnal ramp must NOT
    page. The noise-tolerant threshold keeps a loaded shared core from
    flaking the control — the scenario still swings load 3x."""
    gauntlet = _port_gauntlet()
    r = await gauntlet.diurnal(seconds=1.2, short=True, threshold=0.15)
    e = r["extra"]
    _check_verdicts(e["verdicts"])
    assert e["all_met"], e["verdicts"]
    assert e["calls"] > 0


@bounded
async def test_gauntlet_churn_storm_drops_nothing():
    """Churn storm: clients connecting/calling/disconnecting in a loop
    beside base load — zero failed calls, objectives met (lenient
    threshold for suite noise), and real churn actually happened."""
    gauntlet = _port_gauntlet()
    r = await gauntlet.churn(seconds=1.2, short=True, threshold=0.15)
    e = r["extra"]
    _check_verdicts(e["verdicts"])
    assert e["errors"] == 0
    assert e["connects"] >= 2
    assert e["all_met"], e["verdicts"]


@bounded
async def test_gauntlet_hot_key_ledger_names_burner():
    """Zipf skew against a 2-silo cluster with the
    cost ledger armed — the breach drill-down NAMES the hot key and its
    tenant through get_cluster_ledger's deterministic sketch merge,
    while the QoS lane stays clean (probe SLI, zero false suspicions)."""
    gauntlet = _port_gauntlet()
    r = await gauntlet.hot_key(seconds=2.6, short=True, threshold=0.02)
    e = r["extra"]
    _check_verdicts(e["verdicts"])
    assert e["app_slo_breached"], e["verdicts"]
    # the ledger named WHO: the Zipf rank-0 key, tenant-annotated
    assert e["ledger_names_hot_key"], e["ledger_worst_burner"]
    assert e["ledger_names_tenant"], e["ledger_worst_tenant"]
    assert e["ledger_worst_burner"]["seconds"] > 0
    # and the QoS lane did not pay for the skew
    assert e["false_suspicions"] == 0
    assert e["membership_stable"]
    assert e["qos_invariant_held"], (e["probe_rtt_fast_fraction"],
                                     e["false_suspicions"])
