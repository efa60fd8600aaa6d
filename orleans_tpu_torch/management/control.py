"""SiloControl: the per-silo management command surface.

Re-design of Orleans' src/Orleans.Runtime/Silo/SiloControl.cs:214 —
a system target exposing runtime stats, activation enumeration/counts,
forced collection, version-strategy updates, and the activation debug dump
(Silo.GetDebugDump, Silo.cs:825-856). ManagementGrain fans out to these.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..runtime.silo import Silo

SILO_CONTROL = "SiloControl"

__all__ = ["SiloControl", "add_management"]


class SiloControl:
    """Per-silo control system target."""

    _activation = None

    def __init__(self, silo: "Silo"):
        self.silo = silo

    def _vector_stats(self) -> dict:
        """Device-tier runtime stats (no reference analog — the vector
        tier's management lens): per-class activation counts + tick/message
        totals."""
        rt = self.silo.vector
        if rt is None:
            return {}
        return {
            "ticks": rt.ticks,
            "messages_processed": rt.messages_processed,
            "exchange_lanes": rt.exchange_lanes,
            "conflicts_deferred": rt.conflicts_deferred,
            "queue_depth": rt.queue_depth(),
            "classes": {cls.__name__: tbl.active_count()
                        for cls, tbl in rt.tables.items()},
        }

    async def ctl_runtime_stats(self) -> dict:
        """Per-silo stats snapshot (SiloRuntimeStatistics)."""
        return {
            "silo": str(self.silo.silo_address),
            "status": self.silo.status,
            "activation_count": self.silo.catalog.activation_count(),
            "stats": self.silo.stats.snapshot(),
            "vector": self._vector_stats(),
        }

    async def ctl_activation_count(self) -> int:
        n = self.silo.catalog.activation_count()
        if self.silo.vector is not None:
            n += sum(t.active_count()
                     for t in self.silo.vector.tables.values())
        return n

    async def ctl_grain_stats(self) -> dict[str, int]:
        """Activation count per grain class (GetSimpleGrainStatistics) —
        both tiers."""
        counts: dict[str, int] = {}
        for act in self.silo.catalog.by_activation.values():
            if act.grain_id.is_system_target():
                continue  # app grains only, matching GetSimpleGrainStatistics
            name = act.grain_class.__name__ if act.grain_class else "?"
            counts[name] = counts.get(name, 0) + 1
        for cls, n in self._vector_stats().get("classes", {}).items():
            counts[cls] = counts.get(cls, 0) + n
        return counts

    async def ctl_force_collection(self, age_seconds: float = 0.0) -> int:
        """Deactivate idle activations older than ``age_seconds``
        (ForceActivationCollection)."""
        return await self.silo.catalog.collect_idle(max_age=age_seconds)

    async def ctl_debug_dump(self) -> list[dict]:
        """All activations with mailbox depth + state (GetDebugDump)."""
        out = []
        for act in self.silo.catalog.by_activation.values():
            out.append({
                "grain": str(act.grain_id),
                "activation": str(act.activation_id),
                "class": act.grain_class.__name__ if act.grain_class else "?",
                "state": str(act.state),
                "waiting": len(act.waiting),
                "running": len(act.running),
            })
        return out

    async def ctl_set_compatibility_strategy(
            self, compat: str | None = None,
            selector: str | None = None) -> bool:
        """SetCompatibilityStrategy / SetSelectorStrategy."""
        self.silo.locator.versions.set_strategy(compat, selector)
        return True

    async def ctl_cache_invalidate(self, grain_id) -> bool:
        self.silo.locator.invalidate_cache(grain_id)
        return True

    # -- distributed tracing (observability.tracing) ----------------------
    async def ctl_trace_spans(self, trace_id: int | None = None,
                              limit: int | None = None,
                              pull: bool = False) -> list[dict]:
        """This silo's collected spans (optionally one trace); [] when
        tracing is disabled. The ManagementGrain merges these
        cluster-wide for breakdowns and Perfetto export. Reads are pure —
        in tail mode a trace_id query also shows that trace's pending
        (undecided) legs without touching their fate.

        ``pull=True`` is the retention-propagation form (the rooting
        silo's `Silo._pull_trace_legs` sets it when it RETAINS a trace):
        this silo's pending legs of that trace are handed off —
        counted kept/pulled here, stored and exported by the puller —
        instead of quietly expiring. Diagnostic callers must leave it
        False so polling a live trace never mutates retention state."""
        tracer = self.silo.tracer
        if tracer is None:
            return []
        if pull and trace_id is not None and tracer.tail:
            return tracer.pull(trace_id, limit)
        return tracer.snapshot(trace_id, limit)

    async def ctl_retention_stats(self) -> dict:
        """Tail-retention + export counters (kept/dropped/pulled/buffered,
        OTLP exported/export_dropped); {} when tracing is disabled."""
        tracer = self.silo.tracer
        return {} if tracer is None else tracer.retention_stats()

    async def ctl_trace_breakdown(self, trace_id: int | None = None) -> dict:
        """Critical-path breakdown over THIS silo's spans (per-silo view;
        the cluster-wide one lives on the ManagementGrain)."""
        from ..observability.tracing import critical_path_breakdown
        return critical_path_breakdown(await self.ctl_trace_spans(trace_id))

    async def ctl_metrics(self) -> dict:
        """Full metrics payload for the cluster merge
        (ManagementGrain.get_cluster_metrics): the stats-registry snapshot
        (counters/gauges/histograms-with-buckets) plus, when the sampler
        is installed, the time-windowed queue/backpressure series
        summaries."""
        snap = self.silo.stats.snapshot()
        # the config NAME, not the address: one silo identity across the
        # metrics surface (OTLP push data points, Prometheus labels, span
        # silo attrs all use it), so dashboards join without a mapping
        snap["silo"] = self.silo.config.name
        snap["address"] = str(self.silo.silo_address)
        sampler = self.silo.metrics
        if sampler is not None:
            snap["windows"] = sampler.window_snapshot()
        return snap

    async def ctl_loop_profile(self, windows: int = 20,
                               snapshots: bool = True) -> dict:
        """Host-loop occupancy profile + flight recorder
        (observability.profiling.LoopProfiler): cumulative per-category
        seconds/shares of loop wall time (summing to ~1.0 incl. idle),
        the last ``windows`` per-window slices with their top-K slowest
        callbacks, and — when ``snapshots`` — the anomaly-triggered
        flight-recorder snapshots. {} when profiling is disabled. NOTE:
        co-hosted silos on one event loop share one profiler (occupancy
        is a loop property), so their payloads are views of the same
        loop."""
        import os
        lp = self.silo.loop_prof
        if lp is None:
            return {}
        out = lp.profile(windows, snapshots=snapshots)
        out["silo"] = self.silo.config.name
        # pid-stamp the payload AND each flight-recorder snapshot: under
        # worker_procs>1 every process profiles its own loop, and a
        # cluster merge that pools anomaly snapshots must still name the
        # process that tripped (copies — the recorder ring is live state)
        out["pid"] = os.getpid()
        if out.get("snapshots"):
            out["snapshots"] = [dict(s, pid=os.getpid())
                                for s in out["snapshots"]]
        pool = self.silo.ingress_pool
        if pool is not None:
            # multi-loop silo: the profiler installs PER LOOP, so each
            # ingress shard carries its own occupancy profile — surfaced
            # beside the main loop's for per-loop attribution (the
            # ctl_loop_profile aggregation the tentpole design promised)
            out["ingress_loops"] = await pool.loop_profiles(
                windows=min(windows, 8))
        return out

    async def ctl_critical_path(self) -> dict:
        """Per-silo critical-path leaf: loop-profiler occupancy seconds
        over its wall, the ingest / shm-ring / egress stage histograms
        (bucket-bearing summaries, so the cluster merge folds them
        losslessly via Histogram.merge), and the device-tick span count/
        seconds from the tracer's synthetic device trace.
        ManagementGrain.get_cluster_critical_path merges one of these
        per process — owner and every shm worker — into the cluster
        request waterfall."""
        import os
        from ..observability.stats import (EGRESS_STATS, INGEST_STATS,
                                           RING_STATS)
        out: dict = {"silo": self.silo.config.name, "pid": os.getpid()}
        lp = self.silo.loop_prof
        if lp is not None:
            prof = lp.profile(0, snapshots=False)
            out["loop"] = {"wall_s": prof["wall_s"],
                           "seconds": prof["seconds"]}
        hists = self.silo.stats.histograms
        stages: dict[str, dict] = {}
        for group, table in (("ingest", INGEST_STATS),
                             ("ring", RING_STATS),
                             ("egress", EGRESS_STATS)):
            g = {key: hists[name].summary()
                 for key, name in table.items() if name in hists}
            if g:
                stages[group] = g
        out["stages"] = stages
        tracer = self.silo.tracer
        if tracer is not None:
            dev = tracer.snapshot(tracer.device_trace_id)
            out["device_spans"] = {
                "count": len(dev),
                "seconds": round(sum(s["duration"] for s in dev), 6),
            }
        return out

    async def ctl_slo(self) -> dict:
        """This silo's SLO verdicts (observability.slo.SloMonitor.status:
        per-objective met/breached, multi-window burn rates, budget
        burned) plus the top call sites as the breach drill-down — the
        per-silo leaf of ManagementGrain.get_cluster_slo's
        worst-burn-wins merge. {} when the SLO engine is disabled."""
        mon = self.silo.slo
        if mon is None:
            return {}
        out = mon.status()
        cs = self.silo.call_sites
        if cs is not None:
            # which grain methods are hot/slow/erroring behind the burn
            out["call_sites"] = cs.top(10)
        led = self.silo.ledger
        if led is not None:
            # WHO is burning the budget: the cost ledger's heaviest
            # keys, tenant-annotated (the breach drill-down)
            out["ledger"] = led.top_burners(10)
        return out

    async def ctl_call_sites(self, k: int = 20) -> dict:
        """Per-(grain_class, method) call-site latency/error table
        (observability.stats.CallSiteStats.snapshot, top-``k`` by summed
        turn seconds); {} when metrics are disabled."""
        cs = self.silo.call_sites
        return {} if cs is None else cs.snapshot(k)

    async def ctl_ledger(self, k: int = 10) -> dict:
        """This silo's cost-attribution ledger snapshot
        (observability.ledger.CostLedger.snapshot: exact per-method
        turn/device/wire/stream tables plus the top-``k`` key/tenant
        sketches) — the per-silo leaf of
        ManagementGrain.get_cluster_ledger's deterministic merge. {}
        when ``ledger_enabled`` is off."""
        led = self.silo.ledger
        return {} if led is None else led.snapshot(k)

    async def ctl_workers(self) -> dict:
        """Multi-process silo topology (runtime.multiproc): per-worker
        pid/liveness/internal-endpoint, the staging/response ring
        cumulative counters (single-writer, so this read is torn-free —
        pushed == drained after a clean drain), and each worker's live
        client-route count from the relay table (the accept-balance
        spread the multiproc floor asserts on). Per-worker DEEP stats
        need no special path: workers are full cluster-member silos, so
        the existing per-silo ``ctl_*`` RPCs reach them by address.
        ``{"worker_procs": 1}`` when this silo runs single-process."""
        sup = self.silo.workers
        if sup is None:
            return {"worker_procs": 1}
        return sup.describe()

    async def ctl_histogram(self, name: str) -> dict | None:
        """One named histogram's summary (with per-bucket counts so the
        ManagementGrain can merge silos losslessly); None if unknown."""
        h = self.silo.stats.histograms.get(name)
        return None if h is None else h.summary()

    async def ctl_multicluster_stamp(self) -> float | None:
        """This silo's view of the current multi-cluster configuration
        stamp (None = no config / no oracle) — the ManagementGrain's
        lagging-silo stability check reads this before injecting a new
        configuration."""
        oracle = getattr(self.silo, "multicluster", None)
        return oracle.config_stamp() if oracle is not None else None


def add_management(builder):
    """Install SiloControl + the management grain + the load publisher on a
    SiloBuilder."""
    from .grain import ManagementGrain
    from .load_publisher import DeploymentLoadPublisher

    builder.add_grains(ManagementGrain)

    def install(silo) -> None:
        control = SiloControl(silo)
        silo.register_system_target(control, SILO_CONTROL)
        silo.silo_control = control
        publisher = DeploymentLoadPublisher(silo)
        silo.load_publisher = publisher
        from ..runtime.silo import ServiceLifecycleStage
        silo.subscribe_lifecycle(
            ServiceLifecycleStage.RUNTIME_GRAIN_SERVICES,
            publisher.start, publisher.stop)

    return builder.configure(install)
