"""ManagementGrain: cluster-wide queries and controls.

Re-design of Orleans' src/Orleans.Runtime/Core/ManagementGrain.cs:52-424
(GetHosts, GetRuntimeStatistics, GetSimpleGrainStatistics, GetTotalActivationCount,
ForceActivationCollection, SetCompatibilityStrategy, FindLaggingSilos :424) —
an ordinary grain fanning out to each silo's SiloControl system target.
"""

from __future__ import annotations

import asyncio

from ..core.ids import GrainId, SiloAddress, type_code_of
from ..core.message import Category
from ..runtime.grain import Grain
from .control import SILO_CONTROL, SiloControl

__all__ = ["ManagementGrain"]


class ManagementGrain(Grain):
    """Singleton management grain (key 0 by convention)."""

    # -- fan-out helper --------------------------------------------------
    def _silos(self) -> list[SiloAddress]:
        return list(self._activation.runtime.locator.alive_list)

    def _control(self, silo: SiloAddress, method: str, *args, **kwargs):
        runtime = self._activation.runtime
        gid = GrainId.system_target(type_code_of(SILO_CONTROL), silo)
        return runtime.runtime_client.send_request(
            target_grain=gid, grain_class=SiloControl,
            interface_name=SILO_CONTROL, method_name=method,
            args=args, kwargs=kwargs, target_silo=silo,
            category=Category.SYSTEM)

    async def _fan_out(self, method: str, *args, **kwargs) -> dict:
        silos = self._silos()
        results = await asyncio.gather(
            *(self._control(s, method, *args, **kwargs) for s in silos),
            return_exceptions=True)
        return {str(s): r for s, r in zip(silos, results)
                if not isinstance(r, BaseException)}

    # -- queries (ManagementGrain.cs:52-231) ------------------------------
    async def get_hosts(self) -> dict[str, str]:
        """Silo → status map; reads the membership oracle when installed."""
        runtime = self._activation.runtime
        if runtime.membership is not None:
            out = {str(a): "Active" for a in runtime.membership.active}
            out.update({str(a): "Dead" for a in runtime.membership.dead})
            return out
        return {str(a): "Active" for a in runtime.locator.alive_list}

    async def get_runtime_statistics(self) -> dict:
        return await self._fan_out("ctl_runtime_stats")

    async def get_simple_grain_statistics(self) -> dict[str, int]:
        """Cluster-wide activation count per grain class."""
        per_silo = await self._fan_out("ctl_grain_stats")
        totals: dict[str, int] = {}
        for counts in per_silo.values():
            for name, n in counts.items():
                totals[name] = totals.get(name, 0) + n
        return totals

    async def get_total_activation_count(self) -> int:
        per_silo = await self._fan_out("ctl_activation_count")
        return sum(per_silo.values())

    async def get_debug_dump(self) -> dict:
        return await self._fan_out("ctl_debug_dump")

    # -- controls ---------------------------------------------------------
    async def force_activation_collection(self, age_seconds: float = 0.0
                                          ) -> int:
        per_silo = await self._fan_out("ctl_force_collection", age_seconds)
        return sum(per_silo.values())

    async def set_compatibility_strategy(self, compat: str | None = None,
                                         selector: str | None = None) -> None:
        await self._fan_out("ctl_set_compatibility_strategy", compat, selector)

    # -- distributed tracing (observability.tracing) ----------------------
    async def get_trace_spans(self, trace_id: int | None = None,
                              limit: int | None = None) -> list[dict]:
        """Cluster-wide span merge: every silo's collector, one list
        (client-process spans live in the client's own collector — the
        breakdown tolerates their absence by using the span extent)."""
        per_silo = await self._fan_out("ctl_trace_spans", trace_id, limit)
        return [s for spans in per_silo.values() for s in spans]

    async def get_trace_breakdown(self, trace_id: int | None = None) -> dict:
        """Critical-path breakdown for one trace (or everything buffered):
        queue / exec / network / directory / device / migration seconds
        and fractions of the trace extent, cluster-wide."""
        from ..observability.tracing import critical_path_breakdown
        return critical_path_breakdown(await self.get_trace_spans(trace_id))

    async def get_retention_stats(self) -> dict:
        """Cluster-wide tail-retention/export counters: per-silo snapshots
        plus summed totals (kept/dropped/pulled/buffered/exported/
        export_dropped) — the operator's answer to "is tail sampling
        keeping the right amount"."""
        per_silo = await self._fan_out("ctl_retention_stats")
        totals: dict[str, int] = {}
        for snap in per_silo.values():
            for k, v in snap.items():
                if isinstance(v, bool) or not isinstance(v, int):
                    continue
                totals[k] = totals.get(k, 0) + v
        return {"totals": totals, "per_silo": per_silo}

    async def get_cluster_metrics(self) -> dict:
        """Cluster-wide metrics merge over every silo's ``ctl_metrics``:
        counters and gauges sum across silos, histograms fold losslessly
        via their per-bucket counts (Histogram.merge), and the per-silo
        snapshots (including sampler window summaries) ride along for
        drill-down — one call answers both "what is the cluster doing"
        and "which silo is the outlier"."""
        from ..observability.stats import Histogram
        per_silo = await self._fan_out("ctl_metrics")
        counters: dict[str, int] = {}
        gauges: dict[str, float] = {}
        hists: dict[str, Histogram] = {}
        for snap in per_silo.values():
            for k, v in snap.get("counters", {}).items():
                counters[k] = counters.get(k, 0) + v
            for k, v in snap.get("gauges", {}).items():
                gauges[k] = gauges.get(k, 0.0) + float(v)
            for k, h in snap.get("histograms", {}).items():
                merged = hists.get(k)
                if merged is None:
                    hists[k] = Histogram.from_snapshot(h)
                else:
                    merged.merge(Histogram.from_snapshot(h))
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {k: h.summary() for k, h in hists.items()},
            "per_silo": per_silo,
        }

    async def get_cluster_loop_profile(self, windows: int = 20) -> dict:
        """Cluster-wide host-loop occupancy merge over every silo's
        ``ctl_loop_profile``: per-category loop seconds sum across
        silos (shares recomputed over the summed wall), flight-recorder
        trigger counts sum, and the per-silo payloads — windows, top-K
        slow callbacks, and anomaly snapshots — ride along for
        drill-down. One call answers "what occupies the cluster's loops"
        and "which silo's loop is the outlier". Caveat: silos co-hosted
        on ONE event loop share one profiler, so the merged totals count
        that loop once per resident silo — read per_silo for the truth
        on shared-loop test clusters."""
        per_silo = await self._fan_out("ctl_loop_profile", windows)
        seconds: dict[str, float] = {}
        triggers: dict[str, int] = {}
        snapshots = 0
        for snap in per_silo.values():
            for k, v in (snap.get("seconds") or {}).items():
                seconds[k] = seconds.get(k, 0.0) + float(v)
            for k, v in (snap.get("triggers") or {}).items():
                triggers[k] = triggers.get(k, 0) + int(v)
            snapshots += len(snap.get("snapshots") or ())
        wall = sum(seconds.values())
        return {
            "wall_s": round(wall, 6),
            "seconds": {k: round(v, 6) for k, v in seconds.items()},
            "shares": {k: round(v / wall, 4)
                       for k, v in seconds.items()} if wall else {},
            "triggers": triggers,
            "snapshot_count": snapshots,
            "per_silo": per_silo,
        }

    async def get_cluster_critical_path(self) -> dict:
        """Cluster-wide request waterfall over every process's
        ``ctl_critical_path``: loop-profiler occupancy seconds sum per
        category across processes (owner and shm workers alike — workers
        are cluster members, so the fan-out reaches them by address) with
        shares recomputed over the summed wall, so the shares sum to
        ~1.0 of measured loop wall by construction; ingest / shm-ring /
        egress stage histograms fold losslessly via their per-bucket
        counts; device-tick span seconds sum. ``processes`` carries each
        per-process leaf (silo name + pid) for drill-down — the answer to
        "where does a cross-process request spend its wall time"."""
        from ..observability.stats import Histogram
        per_silo = await self._fan_out("ctl_critical_path")
        seconds: dict[str, float] = {}
        wall = 0.0
        stage_h: dict[str, dict[str, Histogram]] = {}
        dev_count, dev_seconds = 0, 0.0
        for snap in per_silo.values():
            loop = snap.get("loop")
            if loop:
                wall += float(loop.get("wall_s", 0.0))
                for k, v in (loop.get("seconds") or {}).items():
                    seconds[k] = seconds.get(k, 0.0) + float(v)
            for group, table in (snap.get("stages") or {}).items():
                acc = stage_h.setdefault(group, {})
                for key, h in table.items():
                    merged = acc.get(key)
                    if merged is None:
                        acc[key] = Histogram.from_snapshot(h)
                    else:
                        merged.merge(Histogram.from_snapshot(h))
            dev = snap.get("device_spans")
            if dev:
                dev_count += int(dev.get("count", 0))
                dev_seconds += float(dev.get("seconds", 0.0))
        return {
            "wall_s": round(wall, 6),
            "seconds": {k: round(v, 6) for k, v in seconds.items()},
            "shares": {k: round(v / wall, 4)
                       for k, v in seconds.items()} if wall else {},
            "stages": {group: {key: h.summary() for key, h in acc.items()}
                       for group, acc in stage_h.items()},
            "device_spans": {"count": dev_count,
                             "seconds": round(dev_seconds, 6)},
            "processes": per_silo,
        }

    async def get_cluster_slo(self) -> dict:
        """Cluster-wide SLO rollup over every silo's ``ctl_slo``:
        per-objective **worst-burn-wins** merge — burn rates and budget
        burned take the cluster max (an SLO is breached anywhere ⇒
        breached, and the worst silo defines how fast the budget dies),
        good/bad event counts sum, and ``worst_silo`` names the max-burn
        silo so a breach drills straight down to its per-silo payload
        (burn state + hottest call sites) riding in ``per_silo``. One
        call answers "is the cluster meeting its SLOs" and "which silo
        and which grain methods are killing it"."""
        per_silo = await self._fan_out("ctl_slo")
        merged: dict[str, dict] = {}
        total_breaches = 0
        for addr, snap in per_silo.items():
            if not snap:
                continue  # SLO engine disabled on that silo
            total_breaches += snap.get("breaches", 0)
            for name, obj in snap.get("objectives", {}).items():
                cur = merged.get(name)
                if cur is None:
                    cur = merged[name] = dict(obj)
                    # episode timelines are PER-SILO data: carrying the
                    # first-iterated silo's timestamps on the merged
                    # objective would attribute them cluster-wide — the
                    # drill-down lives in per_silo[worst_silo] instead
                    for k in ("breach_started", "breach_started_mono",
                              "first_breach_mono", "episodes"):
                        cur.pop(k, None)
                    cur["worst_silo"] = addr
                    continue
                if obj["burn_fast"] > cur["burn_fast"]:
                    cur["worst_silo"] = addr
                cur["burn_fast"] = max(cur["burn_fast"], obj["burn_fast"])
                cur["burn_slow"] = max(cur["burn_slow"], obj["burn_slow"])
                cur["budget_burned"] = max(cur["budget_burned"],
                                           obj["budget_burned"])
                cur["breached"] = cur["breached"] or obj["breached"]
                cur["met"] = cur["met"] and obj["met"]
                cur["breaches"] += obj["breaches"]
                cur["good"] += obj["good"]
                cur["bad"] += obj["bad"]
        return {
            "breached": any(o["breached"] for o in merged.values()),
            "breaches": total_breaches,
            "objectives": merged,
            "per_silo": per_silo,
        }

    async def get_cluster_call_sites(self, k: int = 20) -> list[dict]:
        """Cluster-wide per-(grain_class, method) call-site table: every
        silo's bounded top table folded (counts/errors/seconds sum, max
        takes the max), returned as the top-``k`` by summed turn seconds
        — the "which grain methods carry the cluster's load" read an SLO
        breach (or the future placement-policy compiler) drills into."""
        from ..observability.stats import CallSiteStats
        per_silo = await self._fan_out("ctl_call_sites", k)
        merged = CallSiteStats.merge(s for s in per_silo.values() if s)
        return CallSiteStats.format_top(merged["sites"], k)

    async def get_cluster_ledger(self, k: int = 10) -> dict:
        """Cluster-wide cost attribution over every silo's
        ``ctl_ledger``: exact per-method turn/device/wire/stream tables
        sum, the per-key and per-tenant space-saving sketches fold with
        CostLedger.merge's deterministic flat merge (silo count and merge
        order cannot change the answer — property-tested), and
        ``worst_burner``/``worst_tenant`` name the cluster's heaviest key
        and tenant from the merged ranking. Per-silo snapshots ride in
        ``per_silo`` for drill-down. One call answers "who is spending
        this cluster" — the drill-down an SLO breach (and the rebalance
        planner's host-tier candidates) starts from. The merge needs
        ``observability/ledger.py``, which the port does not hold yet:
        refused (ROADMAP Queue 1 item 17)."""
        raise NotImplementedError(
            "get_cluster_ledger needs observability/ledger.py, which "
            "orleans_tpu_torch does not port yet (ROADMAP Queue 1 item 17)")

    async def get_cluster_histogram(self, name: str) -> dict | None:
        """One named latency histogram aggregated across every silo
        (Histogram.merge over the per-bucket counts each SiloControl
        reports); None when no silo has observed it."""
        from ..observability.stats import Histogram
        per_silo = await self._fan_out("ctl_histogram", name)
        agg = None
        for snap in per_silo.values():
            if snap is not None:
                h = Histogram.from_snapshot(snap)
                agg = h if agg is None else agg.merge(h)
        return None if agg is None else agg.summary()

    # -- multi-cluster administration (ManagementGrain.cs:387-427) --------
    async def get_multicluster_configuration(self) -> dict | None:
        """The active admin-injected configuration, or None when the
        network runs zero-conf (gossip-governed membership)."""
        oracle = getattr(self._activation.runtime, "multicluster", None)
        if oracle is None:
            raise RuntimeError("multi-cluster is not configured on this "
                               "cluster (add_multicluster)")
        return oracle.active_config()

    async def inject_multicluster_configuration(
            self, clusters: list[str], comment: str = "",
            check_for_lagging_silos: bool = True) -> dict:
        """Replace the multi-cluster configuration
        (InjectMultiClusterConfiguration :392): verifies first — unless
        told not to — that every silo in THIS cluster has converged on
        the current configuration (an unreachable silo, or one still
        gossiping an older stamp, aborts the injection: injecting over a
        lagging silo could strand it on a config two generations back),
        then stamps + gossips the new cluster list. Clusters removed by
        the new configuration have their GSI entries demoted to Doubtful
        everywhere so grains re-home (see
        ClusterDirectoryGrain.demote_removed_owners)."""
        oracle = getattr(self._activation.runtime, "multicluster", None)
        if oracle is None:
            raise RuntimeError("multi-cluster is not configured on this "
                               "cluster (add_multicluster)")
        if check_for_lagging_silos:
            silos = self._silos()
            stamps = await self._fan_out("ctl_multicluster_stamp")
            cur = oracle.config_stamp()
            lagging = [s for s in map(str, silos)
                       if s not in stamps or stamps[s] != cur]
            if lagging:
                raise RuntimeError(
                    f"cannot inject multi-cluster configuration: silos "
                    f"not stabilized on the current configuration: "
                    f"{lagging}")
        return await oracle.inject_configuration(clusters, comment)

    async def find_lagging_silos(self, threshold: float = 0.5) -> list[str]:
        """Silos whose control surface responds slower than ``threshold``
        seconds (FindLaggingSilos :424)."""
        import time
        lagging = []
        for s in self._silos():
            t0 = time.monotonic()
            try:
                await self._control(s, "ctl_activation_count")
            except Exception:  # noqa: BLE001 — unreachable counts as lagging
                lagging.append(str(s))
                continue
            if time.monotonic() - t0 > threshold:
                lagging.append(str(s))
        return lagging
