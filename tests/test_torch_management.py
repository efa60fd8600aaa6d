"""Parity of the port's management surface (orleans_tpu_torch.management:
ManagementGrain, SiloControl, the load publisher; observability.telemetry;
the ``manage`` CLI) with the JAX package's, on the CPU.

The nine scenarios of tests/test_management.py run through each package
one after the other, never interleaved on one loop (each package's silo
installs its own eager task factory), and what each observed must be
equal exactly. Silos are named by their index, not by the fabric's
per-package addresses; timings enter only as the reference's own
thresholds. The critical-path report runs with ``metrics_enabled`` as
the reference's does, and the cluster ledger merges each silo's
``ctl_ledger``.

``Silo._pull_trace_legs`` fans ``ctl_trace_spans`` out to the peers again
now that ``management.control`` is ported: the cross-silo leg pull and
the span-id dedup of tests/test_tail_tracing.py run through the port.
Every async body runs under ``asyncio.wait_for(..., 30)``.
"""

import asyncio
import io
import json
import os
from contextlib import redirect_stdout
from types import SimpleNamespace

import pytest

import orleans_tpu.core.ids as jids
import orleans_tpu.management as jmg
import orleans_tpu.manage as jmanage
import orleans_tpu.membership as jm
import orleans_tpu.observability.stats as jstats
import orleans_tpu.observability.telemetry as jtel
import orleans_tpu.runtime as jr
import orleans_tpu.storage as js
import orleans_tpu.testing as jt
import orleans_tpu_torch.core.ids as tids
import orleans_tpu_torch.management as tmg
import orleans_tpu_torch.manage as tmanage
import orleans_tpu_torch.membership as tm
import orleans_tpu_torch.observability.stats as tstats
import orleans_tpu_torch.observability.telemetry as ttel
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.storage as ts
import orleans_tpu_torch.testing as tt

TIMEOUT = 30


def _grains(rt, tel):
    class WorkGrain(rt.Grain):
        async def work(self):
            return 1

        async def slow(self):
            await asyncio.sleep(0)
            import time
            time.sleep(0.3)  # deliberately blocks the loop: long-turn trigger
            return 1

    class SlowEchoGrain(rt.Grain):
        async def ping(self, x: int) -> int:
            await asyncio.sleep(0.1)
            return x

    class ProxyGrain(rt.Grain):
        async def relay(self, key: int, x: int) -> int:
            return await self.get_grain(SlowEchoGrain, key).ping(x)

    class CapturingConsumer(tel.TelemetryConsumer):
        def __init__(self):
            self.snapshots = []
            self.events = []

        def record_snapshot(self, silo_name, snapshot):
            self.snapshots.append((silo_name, snapshot))

        def track_event(self, name, properties):
            self.events.append((name, properties))

    class ExplodingConsumer(tel.TelemetryConsumer):
        def __init__(self):
            self.attempts = 0

        def record_snapshot(self, silo_name, snapshot):
            self.attempts += 1
            raise RuntimeError("sink down")

        def track_event(self, name, properties):
            raise RuntimeError("sink down")

    return SimpleNamespace(Work=WorkGrain, SlowEcho=SlowEchoGrain,
                           Proxy=ProxyGrain, Capturing=CapturingConsumer,
                           Exploding=ExplodingConsumer)


J = SimpleNamespace(rt=jr, mg=jmg, mbr=jm, tel=jtel, stats=jstats,
                    storage=js, testing=jt, ids=jids, manage=jmanage,
                    g=_grains(jr, jtel))
T = SimpleNamespace(rt=tr, mg=tmg, mbr=tm, tel=ttel, stats=tstats,
                    storage=ts, testing=tt, ids=tids, manage=tmanage,
                    g=_grains(tr, ttel))


async def _parity(scenario, *args):
    got = []
    for pkg in (J, T):
        got.append(await asyncio.wait_for(scenario(pkg, *args), TIMEOUT))
    assert got[0] == got[1], (scenario.__name__, got[0], got[1])
    return got[1]


async def _start_cluster(pkg, n=2, consumer=None, **config):
    fabric = pkg.rt.InProcFabric()
    storage = pkg.storage.MemoryStorage()
    mbr = pkg.mbr.InMemoryMembershipTable()
    silos = []
    for i in range(n):
        b = (pkg.rt.SiloBuilder().with_name(f"mg{i}").with_fabric(fabric)
             .add_grains(pkg.g.Work).with_storage("Default", storage)
             .with_config(response_timeout=3.0, **config))
        pkg.mg.add_management(b)
        if consumer is not None:
            pkg.tel.add_telemetry(b, consumer, period=0.1,
                                  watchdog_period=0.05)
        silo = b.build()
        pkg.mbr.join_cluster(silo, mbr)
        await silo.start()
        silos.append(silo)
    client = await pkg.rt.ClusterClient(fabric).connect()
    return fabric, silos, client


async def _stop_all(silos, client):
    await client.close_async()
    for s in silos:
        if s.status not in ("Stopped", "Dead"):
            await s.stop()


def _index(silos):
    return {str(s.silo_address): i for i, s in enumerate(silos)}


async def _cluster_queries(pkg):
    fabric, silos, client = await _start_cluster(pkg)
    try:
        for k in range(10):
            await client.get_grain(pkg.g.Work, k).work()
        mgmt = client.get_grain(pkg.mg.ManagementGrain, 0)
        idx = _index(silos)
        host_map = await mgmt.get_hosts()
        stats = await mgmt.get_simple_grain_statistics()
        total = await mgmt.get_total_activation_count()
        runtime = await mgmt.get_runtime_statistics()
        dump = await mgmt.get_debug_dump()
        dumped = [a["class"] for recs in dump.values() for a in recs]
        lagging = await mgmt.find_lagging_silos(threshold=2.0)
        return (sorted((idx[k], v) for k, v in host_map.items()),
                stats, total,
                sorted((idx[k], r["status"], "counters" in r["stats"])
                       for k, r in runtime.items()),
                dumped.count("WorkGrain"), lagging)
    finally:
        await _stop_all(silos, client)


async def test_management_grain_cluster_queries():
    hosts, stats, total, runtime, dumped, lagging = \
        await _parity(_cluster_queries)
    assert hosts == [(0, "Active"), (1, "Active")]
    assert stats["WorkGrain"] == 10
    assert total == 10 + 1  # ManagementGrain itself is an activation too
    assert runtime == [(0, "Running", True), (1, "Running", True)]
    assert dumped == 10 and lagging == []


async def _force_collection(pkg):
    fabric, silos, client = await _start_cluster(pkg)
    try:
        for k in range(8):
            await client.get_grain(pkg.g.Work, k).work()
        mgmt = client.get_grain(pkg.mg.ManagementGrain, 0)
        before = (await mgmt.get_simple_grain_statistics())["WorkGrain"]
        collected = await mgmt.force_activation_collection(0.0)
        after = (await mgmt.get_simple_grain_statistics()).get("WorkGrain", 0)
        again = await client.get_grain(pkg.g.Work, 1).work()
        return before, collected, after, again
    finally:
        await _stop_all(silos, client)


async def test_force_collection_deactivates_idle_grains():
    assert await _parity(_force_collection) == (8, 8, 0, 1)


async def _telemetry_and_watchdog(pkg):
    consumer = pkg.g.Capturing()
    fabric, silos, client = await _start_cluster(pkg, n=1, consumer=consumer)
    try:
        for k in range(5):
            await client.get_grain(pkg.g.Work, k).work()
        await asyncio.sleep(0.3)
        flushed = bool(consumer.snapshots)
        received = consumer.snapshots[-1][1]["counters"].get(
            "messaging.received.application", 0) > 0
        await client.get_grain(pkg.g.Work, 99).slow()
        await asyncio.sleep(0.3)
        silo = silos[0]
        lag_seen = max(s["gauges"].get("watchdog.max_lag", 0.0)
                       for _, s in consumer.snapshots)
        return (flushed, received,
                silo.stats.get("scheduler.long_turns") >= 1,
                "watchdog.last_lag" in silo.stats.gauges, lag_seen > 0.1)
    finally:
        await _stop_all(silos, client)


async def test_telemetry_snapshots_and_watchdog_lag_detection():
    assert await _parity(_telemetry_and_watchdog) == (True,) * 5


async def _max_lag_resets(pkg):
    consumer = pkg.g.Capturing()
    fabric, silos, client = await _start_cluster(pkg, n=1, consumer=consumer)
    try:
        silo = silos[0]
        silo.watchdog.max_lag = 0.7  # as if a stall was observed
        first = silo.stats.snapshot()["gauges"]["watchdog.max_lag"]
        second = silo.stats.snapshot()["gauges"]["watchdog.max_lag"]
        return first, second
    finally:
        await _stop_all(silos, client)


async def test_watchdog_max_lag_resets_on_snapshot():
    assert await _parity(_max_lag_resets) == (0.7, 0.0)


async def _raising_consumer(pkg):
    bad, good = pkg.g.Exploding(), pkg.g.Capturing()
    fabric = pkg.rt.InProcFabric()
    b = (pkg.rt.SiloBuilder().with_name("tm0").with_fabric(fabric)
         .add_grains(pkg.g.Work)
         .with_storage("Default", pkg.storage.MemoryStorage()))
    pkg.tel.add_telemetry(b, bad, good, period=0.05, watchdog_period=10.0)
    silo = b.build()
    await silo.start()
    try:
        await asyncio.sleep(0.25)
        silo.telemetry.track_event("deploy", version=3)
        return (bad.attempts >= 2, len(good.snapshots) >= 2,
                ("deploy", {"version": 3}) in good.events,
                not silo.telemetry._task.done())
    finally:
        await silo.stop()


async def test_raising_consumer_does_not_starve_others_or_kill_loop():
    """One consumer failing on every snapshot/event neither stops the
    TelemetryManager loop nor starves the later consumers."""
    assert await _parity(_raising_consumer) == (True,) * 4


async def _file_roundtrip(pkg, path):
    c = pkg.tel.FileTelemetryConsumer(path)
    stats = pkg.stats.StatsRegistry()
    stats.increment("calls", 3)
    stats.observe("lat", 0.002)
    c.record_snapshot("silo-x", stats.snapshot())
    c.track_event("rebalance", {"moved": 4})
    c.close()
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    for line in lines:
        line.pop("ts", None)  # the write's wall clock
    return lines


async def test_file_telemetry_consumer_jsonl_roundtrip(tmp_path):
    got = []
    for pkg in (J, T):
        got.append(await asyncio.wait_for(_file_roundtrip(
            pkg, str(tmp_path / f"{pkg.rt.__name__}.jsonl")), TIMEOUT))
    assert got[0] == got[1]
    snap, event = got[1]
    assert snap["silo"] == "silo-x" and snap["counters"]["calls"] == 3
    h = snap["histograms"]["lat"]
    assert h["count"] == 1 and "p95" in h and sum(h["buckets"]) == 1
    assert event == {"event": "rebalance", "moved": 4}


async def _load_publisher(pkg):
    fabric, silos, client = await _start_cluster(pkg)
    try:
        for k in range(6):
            await client.get_grain(pkg.g.Work, k).work()
        await asyncio.sleep(1.2)  # one publish period
        out = []
        for s in silos:
            view = s.load_publisher.view
            out.append((set(view) == {x.silo_address for x in silos},
                        sum(r["activation_count"] for r in view.values()) >= 6))
        return out
    finally:
        await _stop_all(silos, client)


async def test_load_publisher_feeds_placement_view():
    assert await _parity(_load_publisher) == [(True, True)] * 2


async def _manage_ops(pkg):
    fabric, silos, client = await _start_cluster(pkg)
    try:
        for k in range(3):
            await client.get_grain(pkg.g.Work, k).work()
        return ((await pkg.manage.grain_stats(client))["WorkGrain"],
                len(await pkg.manage.hosts(client)),
                await pkg.manage.collect(client) >= 3)
    finally:
        await _stop_all(silos, client)


async def test_manage_cli_ops():
    assert await _parity(_manage_ops) == (3, 2, True)


def test_manage_cli_main_prints_the_op():
    """``python -m orleans_tpu_torch.manage grainstats`` prints the same
    JSON as the reference's runner."""
    out = []
    for pkg in (J, T):
        buf = io.StringIO()
        with redirect_stdout(buf):
            pkg.manage.main(["grainstats", "--silos", "2", "--grains", "4"])
        out.append(json.loads(buf.getvalue()))
    assert out[0] == out[1]
    assert out[1]["DemoGrain"] == 4


async def _critical_path(pkg):
    fabric, silos, client = await _start_cluster(
        pkg, profiling_enabled=True, profiling_window=0.05,
        metrics_enabled=True)
    try:
        for k in range(40):
            await client.get_grain(pkg.g.Work, k).work()
        await asyncio.sleep(0.12)  # at least one profiling window cut
        mgmt = client.get_grain(pkg.mg.ManagementGrain, 0)
        cp = await mgmt.get_cluster_critical_path()
        idx = _index(silos)
        return (cp["wall_s"] > 0,
                abs(sum(cp["shares"].values()) - 1.0) <= 0.02,
                sorted(idx[p] for p in cp["processes"]),
                [(p["pid"] == os.getpid(), p["loop"]["wall_s"] > 0,
                  "stages" in p) for p in cp["processes"].values()],
                sorted(cp["stages"]), cp.get("device_spans"))
    finally:
        await _stop_all(silos, client)


async def test_cluster_critical_path_report():
    """get_cluster_critical_path merges every silo's loop occupancy and
    stage histograms; the shares are per-category loop seconds over the
    summed loop wall, so they sum to about 1.0; with metrics on, the
    same ingest stages are observed in both packages."""
    wall, shares, procs, per_proc, stages, dev = \
        await _parity(_critical_path)
    assert wall and shares
    assert procs == [0, 1]
    assert per_proc == [(True, True, True)] * 2


async def _leg_pull(pkg):
    cluster = (pkg.testing.TestClusterBuilder(2)
               .add_grains(pkg.g.Proxy, pkg.g.SlowEcho)
               .with_tracing(tail=True, tail_window=0.15,
                             slow_threshold=0.05, leg_ttl=1.0,
                             client=False)
               .build())
    async with cluster:
        assert cluster.client.tracer is None  # traces root silo-side
        pair = None
        for key in range(16):
            assert await cluster.grain(pkg.g.Proxy, key).relay(key, 5) == 5
            proxy_gid = cluster.grain(pkg.g.Proxy, key).grain_id
            echo_gid = cluster.grain(pkg.g.SlowEcho, key).grain_id
            hosts = {}
            for s in cluster.silos:
                if s.catalog.by_grain.get(proxy_gid):
                    hosts["proxy"] = s
                if s.catalog.by_grain.get(echo_gid):
                    hosts["echo"] = s
            if len(hosts) == 2 and hosts["proxy"] is not hosts["echo"]:
                pair = (hosts["proxy"], hosts["echo"])
                break
        assert pair is not None, "no cross-silo placement in 16 keys"
        rooter, remote = pair
        await cluster.drain_traces()
        retained = rooter.tracer.snapshot()
        root_kept = any(s["parent_id"] is None
                        and s["attrs"].get("retained") == "slow"
                        and s["name"] == "SlowEchoGrain.ping"
                        for s in retained)
        remote_legs = [s for s in retained
                       if s["silo"] == remote.config.name
                       and s["kind"] == "server"]
        pulled_tids = {s["trace_id"] for s in remote_legs}
        return (root_kept, bool(remote_legs),
                remote.tracer.retention_stats()["pulled"] >= 1,
                [s for s in remote.tracer.snapshot()
                 if s["trace_id"] in pulled_tids])


async def test_cross_silo_leg_pull_via_control_path():
    """A silo-rooted trace retained at the rooting silo pulls the remote
    server leg through ``Silo._pull_trace_legs`` → ``ctl_trace_spans``
    (the port returned only local legs before management was ported)."""
    root_kept, pulled, counted, doubled = await _parity(_leg_pull)
    assert root_kept and pulled and counted
    assert doubled == []  # exactly one collector holds a pulled leg


async def _dedup(pkg, monkeypatch):
    silo = (pkg.rt.SiloBuilder().with_name("dedup")
            .with_config(trace_enabled=True, trace_tail_enabled=True)
            .build())
    a1 = pkg.ids.SiloAddress("127.0.0.1", 11, 1)
    a2 = pkg.ids.SiloAddress("127.0.0.1", 22, 1)
    silo.locator.alive_list = [silo.silo_address, a1, a2]

    def leg(sid):
        return {"trace_id": 7, "span_id": sid, "parent_id": None,
                "name": f"op{sid}", "kind": "server", "silo": "w",
                "start": 0.0, "duration": 0.1, "attrs": {}}

    async def fake_send_request(**kw):
        if kw["target_silo"] == a1:
            return [leg(100), leg(101)]
        return [leg(101), leg(103), {"trace_id": 7, "attrs": {}}]

    monkeypatch.setattr(silo.runtime_client, "send_request",
                        fake_send_request)
    return [d.get("span_id") for d in await silo._pull_trace_legs(7)]


async def test_pull_dedups_span_ids_across_fanout(monkeypatch):
    """The retained-trace pull keeps the first copy of each span id that
    comes back from more than one peer."""
    assert await _parity(_dedup, monkeypatch) == [100, 101, 103, None]


async def _cluster_ledger(pkg):
    fabric, silos, client = await _start_cluster(
        pkg, ledger_enabled=True, ledger_top_k=8)
    try:
        for k in range(6):
            await client.get_grain(pkg.g.Work, k % 3).work()
        mgmt = client.get_grain(pkg.mg.ManagementGrain, 0)
        led = await mgmt.get_cluster_ledger(8)
        idx = _index(silos)
        return (led["turns"]["WorkGrain.work"][0],
                sorted(led["keys"]["counts"]),
                sorted(idx[s] for s in led["per_silo"]),
                led["worst_burner"]["key"].startswith("WorkGrain/"))
    finally:
        await _stop_all(silos, client)


async def test_cluster_ledger_is_refused_until_the_ledger_is_ported():
    """The cluster ledger (refused until observability/ledger.py was
    ported): ``get_cluster_ledger`` merges every silo's ``ctl_ledger`` —
    the same turn counts, key labels and silos as the JAX package's."""
    turns, keys, silos, worst = await _parity(_cluster_ledger)
    assert turns == 6
    assert keys == ["WorkGrain/0", "WorkGrain/1", "WorkGrain/2"]
    assert silos == [0, 1] and worst
