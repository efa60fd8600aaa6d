"""TestCluster: N silos + client in one process, individually killable.

Re-design of Orleans' src/Orleans.TestingHost/TestCluster.cs:29 +
TestClusterBuilder.cs:14: the reference isolates silos in AppDomains so they
can be killed/restarted independently (AppDomainSiloHandle.cs:14); here each
silo is an independent object on one event loop and "kill" drops it from
fabric routing with no goodbye (the same observable semantics: peers must
detect the death via the membership protocol).

Defaults: shared in-memory membership table with fast liveness config,
shared MemoryStorage, management installed. Reminders / streams /
transactions opt in via builder methods. ``kill_silo`` = ungraceful abort,
``restart_silo`` re-hosts the same endpoint with a higher generation,
``start_additional_silo`` grows the cluster — mirroring the TestCluster API
used across the reference's liveness tests
(test/Tester/MembershipTests/LivenessTests.cs:86-88).
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable

from ..core.ids import SiloAddress
from ..management import add_management
from ..membership import InMemoryMembershipTable, join_cluster
from ..runtime import ClusterClient, InProcFabric, SiloBuilder
from ..storage import MemoryStorage

__all__ = ["TestClusterBuilder", "TestCluster"]

FAST_LIVENESS = dict(
    membership_probe_period=0.1,
    membership_probe_timeout=0.15,
    membership_missed_probes_limit=2,
    membership_votes_needed=2,
    membership_iam_alive_period=0.5,
    membership_refresh_period=0.3,
    membership_vote_expiration=5.0,
    response_timeout=3.0,
)


class TestClusterBuilder:
    """Fluent cluster factory (TestClusterBuilder.cs:14)."""

    __test__ = False  # not a pytest collectible despite the name

    def __init__(self, n_silos: int = 2):
        self.n_silos = n_silos
        self.grains: list[type] = []
        self.storage: Any = None
        self.membership_table: Any = None
        self.with_membership = True
        self.with_management = True
        self.config: dict = dict(FAST_LIVENESS)
        self._silo_configurators: list[Callable[[SiloBuilder], Any]] = []

    def add_grains(self, *grain_classes: type) -> "TestClusterBuilder":
        self.grains.extend(grain_classes)
        return self

    def with_storage(self, storage) -> "TestClusterBuilder":
        self.storage = storage
        return self

    def with_config(self, **kw) -> "TestClusterBuilder":
        self.config.update(kw)
        return self

    def without_membership(self) -> "TestClusterBuilder":
        """Fabric-broadcast liveness only (no oracle) — fastest tests."""
        self.with_membership = False
        return self

    def with_reminders(self, table=None) -> "TestClusterBuilder":
        from ..reminders import InMemoryReminderTable, add_reminders
        table = table or InMemoryReminderTable()

        def cfg(b: SiloBuilder):
            b.configure(lambda silo: add_reminders_post(silo))

        # add_reminders must run pre-start but needs the silo object;
        # register through a builder configurator
        def add_reminders_post(silo):
            add_reminders(silo, table, refresh_period=0.2)

        self._silo_configurators.append(cfg)
        return self

    def with_sms_streams(self, name: str = "sms", **kw) -> "TestClusterBuilder":
        from ..streams import add_sms_streams
        self._silo_configurators.append(
            lambda b: add_sms_streams(b, name, **kw))
        return self

    def with_persistent_streams(self, name: str = "queue", adapter=None,
                                **kw) -> "TestClusterBuilder":
        from ..streams import MemoryQueueAdapter, add_persistent_streams
        adapter = adapter or MemoryQueueAdapter(n_queues=4)
        self._shared_adapter = adapter
        self._silo_configurators.append(
            lambda b: add_persistent_streams(b, name, adapter,
                                             pull_period=0.05, **kw))
        return self

    def with_transactions(self, log_provider=None,
                          shards: int | None = None) -> "TestClusterBuilder":
        from ..transactions import add_transactions
        kw = {}
        if log_provider is not None:
            kw["log_provider"] = log_provider
        if shards is not None:
            kw["shards"] = shards
        self._silo_configurators.append(
            lambda b: add_transactions(b, **kw))
        return self

    def with_metrics(self, sample_period: float = 0.1,
                     window: float = 60.0, *,
                     port: int | None = None,
                     otlp_endpoint: str | None = None,
                     otlp_period: float = 0.25) -> "TestClusterBuilder":
        """Live metrics pipeline on every silo (ingest stage
        instrumentation + queue/backpressure sampler; optionally the
        Prometheus endpoint — ``port=0`` binds ephemeral, read back from
        ``silo.metrics_server.port`` — and OTLP metrics push). Test-sized
        defaults: the sampler ticks fast enough for short tests to see
        windows fill."""
        cfg = dict(metrics_enabled=True,
                   metrics_sample_period=sample_period,
                   metrics_window=window)
        if port is not None:
            cfg["metrics_port"] = port
        if otlp_endpoint is not None:
            cfg["metrics_otlp_endpoint"] = otlp_endpoint
            cfg["metrics_otlp_period"] = otlp_period
        self.config.update(cfg)
        return self

    def with_slo(self, period: float = 0.05, fast_window: float = 0.3,
                 slow_window: float = 0.8, burn_threshold: float = 2.0,
                 min_events: int = 3, *,
                 latency_threshold: float | None = None,
                 latency_target: float | None = None,
                 shed_target: float | None = None) -> "TestClusterBuilder":
        """SLO engine on every silo (observability.slo.SloMonitor) with
        test-sized windows: the fast/slow burn windows fill within a
        sub-second drive so short tests see breaches detected and
        recovered. Implies metrics (the latency objectives read the
        ingest stage histograms); combine with ``with_profiling`` /
        ``with_tracing(tail=True)`` to exercise the full breach path."""
        cfg = dict(slo_enabled=True, slo_period=period,
                   slo_fast_window=fast_window,
                   slo_slow_window=slow_window,
                   slo_burn_threshold=burn_threshold,
                   slo_min_events=min_events)
        if latency_threshold is not None:
            cfg["slo_latency_threshold"] = latency_threshold
        if latency_target is not None:
            cfg["slo_latency_target"] = latency_target
        if shed_target is not None:
            cfg["slo_shed_target"] = shed_target
        if not self.config.get("metrics_enabled"):
            cfg.update(metrics_enabled=True, metrics_sample_period=0.1)
        self.config.update(cfg)
        return self

    def with_profiling(self, window: float = 0.1, ring: int = 120,
                       top_k: int = 8,
                       trigger_interval: float = 0.2
                       ) -> "TestClusterBuilder":
        """Host-loop occupancy profiler + flight recorder on every silo
        (observability.profiling.LoopProfiler). Test-sized defaults: the
        window rolls fast enough for short tests to see slices, and the
        trigger rate-limit is short enough that a forced anomaly
        snapshots promptly. Note: TestCluster silos share one event loop,
        so they share ONE profiler (occupancy is a loop property)."""
        self.config.update(profiling_enabled=True,
                           profiling_window=window,
                           profiling_ring=ring,
                           profiling_top_k=top_k,
                           profiling_trigger_interval=trigger_interval)
        return self

    def with_tracing(self, sample_rate: float = 1.0,
                     buffer_size: int = 4096, *, tail: bool = False,
                     tail_window: float = 0.25,
                     slow_threshold: float | None = None,
                     slow_percentile: float | None = None,
                     leg_ttl: float | None = None,
                     otlp_endpoint: str | None = None,
                     client: bool = True) -> "TestClusterBuilder":
        """Distributed request tracing on every silo AND the test client
        (the client is the root of most test traces); spans merge via
        ``TestCluster.trace_spans`` / ``export_trace``.

        ``tail=True`` enables tail-based retention everywhere: head
        sampling records, the keep/drop decision waits for trace
        completion (slow/errored/forced survive). ``client=False`` leaves
        the test client untraced so traces root silo-side (exercises the
        silo's own retention + cross-silo control-path pull)."""
        cfg = dict(trace_enabled=True, trace_sample_rate=sample_rate,
                   trace_buffer_size=buffer_size)
        if tail:
            cfg.update(trace_tail_enabled=True,
                       trace_tail_window=tail_window)
            if slow_threshold is not None:
                cfg["trace_tail_slow_threshold"] = slow_threshold
            if slow_percentile is not None:
                cfg["trace_tail_slow_percentile"] = slow_percentile
            if leg_ttl is not None:
                cfg["trace_tail_leg_ttl"] = leg_ttl
        if otlp_endpoint is not None:
            cfg["trace_otlp_endpoint"] = otlp_endpoint
        self.config.update(cfg)
        self._client_tracing = None
        if client:
            self._client_tracing = dict(
                sample_rate=sample_rate, buffer_size=buffer_size,
                tail=tail, tail_window=tail_window,
                slow_threshold=slow_threshold,
                slow_percentile=slow_percentile, leg_ttl=leg_ttl,
                otlp_endpoint=otlp_endpoint)
        return self

    def with_rebalancer(self, period: float = 0.2, budget: int | None = None,
                        imbalance_ratio: float | None = None
                        ) -> "TestClusterBuilder":
        """Live rebalancer on every silo (rebalance.add_rebalancer) with a
        test-fast round period."""
        from ..rebalance import add_rebalancer
        self._silo_configurators.append(
            lambda b: add_rebalancer(b, period=period, budget=budget,
                                     imbalance_ratio=imbalance_ratio))
        return self

    def with_vector_grains(self, *grain_classes: type, mesh=None,
                           **kw) -> "TestClusterBuilder":
        """Device-tier grains on every silo (dispatch.add_vector_grains):
        each test silo gets its own VectorRuntime on ``mesh``; gateway
        affinity keeps one key's calls on one silo. ``mesh`` is passed
        through to every silo: None means CUDA (and raises without it),
        so a CPU cluster passes ``make_mesh(n, device="cpu")``."""
        from ..dispatch import add_vector_grains
        self._silo_configurators.append(
            lambda b: add_vector_grains(b, *grain_classes, mesh=mesh, **kw))
        return self

    def configure_silo(self, fn: Callable[[SiloBuilder], Any]
                       ) -> "TestClusterBuilder":
        self._silo_configurators.append(fn)
        return self

    def build(self) -> "TestCluster":
        return TestCluster(self)


class TestCluster:
    """A deployed in-proc cluster (TestCluster.cs:29)."""

    __test__ = False  # not a pytest collectible despite the name

    def __init__(self, builder: TestClusterBuilder):
        self.builder = builder
        self.fabric = InProcFabric()
        self.storage = builder.storage or MemoryStorage()
        self.membership_table = (builder.membership_table
                                 or InMemoryMembershipTable())
        self.silos: list = []
        self.client: ClusterClient | None = None
        self._counter = 0

    # -- deployment ------------------------------------------------------
    async def deploy(self) -> "TestCluster":
        for _ in range(self.builder.n_silos):
            await self.start_additional_silo()
        self.client = await ClusterClient(self.fabric).connect()
        tracing = getattr(self.builder, "_client_tracing", None)
        if tracing is not None:
            if isinstance(tracing, tuple):  # legacy (rate, buffer) form
                self.client.enable_tracing(*tracing)
            else:
                self.client.enable_tracing(**tracing)
                if tracing.get("tail"):
                    # the testing-host analog of the silo's control-path
                    # retention pull (Silo._pull_trace_legs): the in-proc
                    # client pulls silo legs straight off their collectors
                    async def _fetch(tid: int) -> list[dict]:
                        out: list[dict] = []
                        for s in self.silos:
                            tr = getattr(s, "tracer", None)
                            if tr is not None and s.status == "Running":
                                out.extend(tr.pull(tid) if tr.tail
                                           else tr.snapshot(tid))
                        return out
                    self.client.tracer.remote_fetcher = _fetch
        if self.builder.with_membership:
            await self.wait_for_liveness()
        return self

    def _make_silo(self, address: SiloAddress | None = None):
        i = self._counter
        self._counter += 1
        b = (SiloBuilder().with_name(f"silo{i}").with_fabric(self.fabric)
             .add_grains(*self.builder.grains)
             .with_storage("Default", self.storage)
             .with_config(**self.builder.config))
        if self.builder.with_management:
            add_management(b)
        for cfg in self.builder._silo_configurators:
            cfg(b)
        if address is None:
            silo = b.build()
        else:
            # the silo registers its system targets under its address while
            # it is built, so it is built with ``address`` (re-addressing it
            # afterwards leaves every system target unreachable)
            self.fabric.allocate_address = lambda name: address
            try:
                silo = b.build()
            finally:
                del self.fabric.allocate_address
        if self.builder.with_membership:
            join_cluster(silo, self.membership_table)
        return silo

    async def start_additional_silo(self):
        """StartAdditionalSilo: elastic grow."""
        silo = self._make_silo()
        await silo.start()
        self.silos.append(silo)
        return silo

    # -- fault injection ---------------------------------------------------
    async def kill_silo(self, silo) -> None:
        """Abrupt death (KillSilo = AppDomain unload): no goodbye, no
        handoff; peers must detect via probes/votes."""
        await silo.stop(graceful=False)

    async def stop_silo(self, silo) -> None:
        """Graceful shutdown (StopSilo): goodbye row + directory handoff."""
        await silo.stop(graceful=True)

    async def restart_silo(self, silo):
        """RestartSilo: kill, then re-host the same endpoint with a higher
        generation (the membership prior-generation sweep must retire the
        old incarnation)."""
        endpoint = silo.silo_address
        if silo.status not in ("Stopped", "Dead"):
            await silo.stop(graceful=False)
        self.silos.remove(silo)
        reborn = self._make_silo(SiloAddress(
            endpoint.host, endpoint.port, endpoint.generation + 1,
            endpoint.mesh_index))
        await reborn.start()
        self.silos.append(reborn)
        return reborn

    def partition(self, a, b) -> None:
        self.fabric.partition(a.silo_address, b.silo_address)

    def heal_partition(self, a, b) -> None:
        self.fabric.heal_partition(a.silo_address, b.silo_address)

    # -- access ------------------------------------------------------------
    def grain(self, grain_class: type, key, key_ext: str | None = None):
        return self.client.get_grain(grain_class, key, key_ext)

    # -- tracing ------------------------------------------------------------
    def trace_spans(self, trace_id: int | None = None) -> list[dict]:
        """Every span collected anywhere in the cluster (all silos + the
        test client), optionally filtered to one trace."""
        spans: list[dict] = []
        for s in self.silos:
            if getattr(s, "tracer", None) is not None:
                spans.extend(s.tracer.snapshot(trace_id))
        client_tracer = getattr(self.client, "tracer", None)
        if client_tracer is not None:
            spans.extend(client_tracer.snapshot(trace_id))
        return spans

    def clear_traces(self) -> None:
        for s in self.silos:
            if getattr(s, "tracer", None) is not None:
                s.tracer.clear()
        if getattr(self.client, "tracer", None) is not None:
            self.client.tracer.clear()

    async def drain_traces(self) -> None:
        """Deterministically settle tail retention everywhere, in two
        phases: first every collector decides its ROOTED traces (awaiting
        the cross-silo pulls those retentions trigger), then every
        collector expires whatever legs nobody pulled — expiring first
        would drop legs a peer's in-flight pull still needs. No-op for
        head-mode collectors."""
        collectors = []
        client_tracer = getattr(self.client, "tracer", None)
        if client_tracer is not None and client_tracer.tail:
            collectors.append(client_tracer)
        for s in self.silos:
            tr = getattr(s, "tracer", None)
            if tr is not None and tr.tail and s.status == "Running":
                collectors.append(tr)
        for tr in collectors:
            await tr.drain_tail(force=True, expire_legs=False)
        for tr in collectors:
            await tr.drain_tail(force=True)

    def retention_stats(self) -> dict:
        """Merged kept/dropped/... counters across client + silos (tests'
        quick view; the management surface is get_retention_stats)."""
        totals: dict[str, int] = {}
        collectors = [getattr(self.client, "tracer", None)] + \
            [getattr(s, "tracer", None) for s in self.silos]
        for tr in collectors:
            if tr is None:
                continue
            for k, v in tr.retention_stats().items():
                if isinstance(v, bool) or not isinstance(v, int):
                    continue
                totals[k] = totals.get(k, 0) + v
        return totals

    def export_trace(self, path: str, trace_id: int | None = None) -> str:
        """Merge spans from every silo + the client into one Chrome-trace/
        Perfetto JSON timeline file; returns ``path``."""
        from ..observability.export import write_chrome_trace
        return write_chrome_trace(path, self.trace_spans(trace_id))

    @property
    def alive_silos(self) -> list:
        return [s for s in self.silos if s.status == "Running"]

    # -- waiting helpers -----------------------------------------------------
    async def wait_until(self, cond: Callable[[], bool], timeout: float = 10.0,
                         msg: str = "condition") -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return
            await asyncio.sleep(0.05)
        raise AssertionError(f"TestCluster: timed out waiting for {msg}")

    async def wait_for_liveness(self, timeout: float = 10.0) -> None:
        """Every running silo agrees on the active set."""
        def converged() -> bool:
            alive = self.alive_silos
            want = {s.silo_address for s in alive}
            return all(set(s.membership.active) == want for s in alive
                       if s.membership is not None)
        await self.wait_until(converged, timeout, "membership convergence")

    async def wait_for_death(self, silo, timeout: float = 10.0) -> None:
        await self.wait_until(
            lambda: all(silo.silo_address in s.membership.dead
                        for s in self.alive_silos
                        if s.membership is not None),
            timeout, f"death of {silo.silo_address}")

    # -- teardown ------------------------------------------------------------
    async def stop_all(self) -> None:
        if self.client is not None:
            tracer = getattr(self.client, "tracer", None)
            if tracer is not None:
                # settle sink flusher/pull tasks; tests that care about
                # exported spans drain_traces() explicitly before stopping
                await tracer.aclose(flush=False)
            await self.client.close_async()
            self.client = None
        for s in list(self.silos):
            if s.status not in ("Stopped", "Dead"):
                await s.stop()

    async def __aenter__(self) -> "TestCluster":
        return await self.deploy()

    async def __aexit__(self, *exc) -> None:
        await self.stop_all()
