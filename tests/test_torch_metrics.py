"""The port's live metrics pipeline (orleans_tpu_torch.observability.
metrics), on the CPU: the port's copy of tests/test_metrics.py — the
registry under concurrent turns, the sampler windows and gauges, the
Prometheus exposition and its ``GET /metrics`` server, the OTLP metrics
sink against a fake collector, ingest stages on the host and device
tiers, and the cluster merge through ``ManagementGrain``. (The metrics
counts of one call sequence through each package's silo are compared in
tests/test_torch_ledger.py.) Every async body runs under
``asyncio.wait_for(..., 30)``.
"""

import asyncio
import functools

from orleans_tpu_torch.observability.export import (
    OtlpMetricsSink,
    snapshots_to_otlp_metrics,
)
from orleans_tpu_torch.observability.metrics import (
    MetricsSampler,
    WindowedGauge,
    prometheus_exposition,
)
from orleans_tpu_torch.observability.stats import (
    COUNT_BOUNDS,
    INGEST_STATS,
    SIZE_BOUNDS,
    Histogram,
    StatsRegistry,
)
from orleans_tpu_torch.runtime import Grain
from orleans_tpu_torch.testing import TestClusterBuilder


TIMEOUT = 30


def bounded(fn):
    """Run the test coroutine under ``asyncio.wait_for(..., TIMEOUT)``."""
    @functools.wraps(fn)
    async def run(*args, **kwargs):
        await asyncio.wait_for(fn(*args, **kwargs), TIMEOUT)
    return run


class EchoGrain(Grain):
    async def ping(self, x: int) -> int:
        return x


# ----------------------------------------------------------------------
# Registry + histogram surface
# ----------------------------------------------------------------------
@bounded
async def test_registry_snapshot_under_concurrent_increments():
    """Counters written from many concurrent tasks stay exact, and a
    snapshot taken mid-flight is a consistent point read (never a torn
    dict)."""
    reg = StatsRegistry()
    N, TASKS = 200, 8

    async def writer(wid: int) -> None:
        for i in range(N):
            reg.increment("t.calls")
            reg.observe("t.lat", 0.001 * (i % 7))
            if i % 32 == 0:
                await asyncio.sleep(0)

    async def snapshotter() -> list[dict]:
        out = []
        for _ in range(20):
            out.append(reg.snapshot())
            await asyncio.sleep(0)
        return out

    results = await asyncio.gather(snapshotter(),
                                   *(writer(w) for w in range(TASKS)))
    assert reg.get("t.calls") == N * TASKS
    assert reg.histogram("t.lat").total == N * TASKS
    for snap in results[0]:
        # monotone, self-consistent mid-flight reads
        assert 0 <= snap["counters"].get("t.calls", 0) <= N * TASKS
        h = snap["histograms"].get("t.lat")
        if h is not None:
            assert sum(h["buckets"]) == h["count"]


def test_histogram_quantile_and_exposition_buckets():
    h = Histogram()
    for v in (0.0002, 0.0002, 0.003, 0.003, 0.003, 0.2):
        h.observe(v)
    assert h.quantile(0.5) == h.percentile(0.5)
    assert h.quantile(0.99) >= h.quantile(0.5)
    labels = h.bucket_labels()
    assert labels[-1] == "+Inf" and "0.0025" in labels
    cum = h.cumulative_counts()
    assert cum == sorted(cum) and cum[-1] == h.total
    # summary carries p50/p95/p99 and per-bucket counts
    s = h.summary()
    assert {"p50", "p95", "p99", "buckets"} <= set(s)


def test_histogram_custom_bounds_round_trip():
    """Size/count-bounded histograms survive snapshot → from_snapshot →
    merge (the cross-silo aggregation path) with their own buckets."""
    a, b = Histogram(SIZE_BOUNDS), Histogram(SIZE_BOUNDS)
    a.observe(100)
    b.observe(70_000)
    ra = Histogram.from_snapshot(a.summary())
    assert ra.bounds == list(SIZE_BOUNDS)
    ra.merge(Histogram.from_snapshot(b.summary()))
    assert ra.total == 2 and sum(ra.counts) == 2
    # exposition uses the carried bounds, not the latency defaults
    assert "65536" in ra.bucket_labels()


def test_registry_histogram_with_bounds_applied_once():
    reg = StatsRegistry()
    h1 = reg.histogram_with("sz", SIZE_BOUNDS)
    h2 = reg.histogram_with("sz", COUNT_BOUNDS)  # second bounds ignored
    assert h1 is h2 and h1.bounds == list(SIZE_BOUNDS)


def test_histogram_mixed_bounds_merge_widens_deterministically():
    """Cluster-merge guard: one silo created a series with SIZE_BOUNDS,
    another with the latency defaults (the first-creation-wins race
    across silos). Merging must widen deterministically — each source
    bucket folds into the target bucket containing its upper bound —
    never mis-bucket positionally or lose counts."""
    target = Histogram()           # latency defaults
    other = Histogram(SIZE_BOUNDS)
    other.observe(100.0)           # -> size bucket le=256
    other.observe(70_000.0)        # -> size bucket le=262144
    before = target.total
    target.merge(other)
    assert target.total == before + 2
    assert sum(target.counts) == 2
    # every count landed in the terminal bucket of the default bounds
    # (both SIZE upper bounds exceed the 30s latency cap -> +Inf), i.e.
    # conservative coarsening, not silent positional mis-bucketing
    assert target.counts[-1] == 2
    # mixed-bounds merge twice is stable (pure widening, no drift)
    t2 = Histogram()
    t2.merge(other).merge(other)
    assert t2.total == 4 and sum(t2.counts) == 4
    # a corrupt snapshot (bucket list disagreeing with its bounds) raises
    # instead of silently mis-stating
    bad = other.summary()
    bad["buckets"] = bad["buckets"][:-2]
    try:
        Histogram.from_snapshot(bad)
    except ValueError:
        pass
    else:  # pragma: no cover
        raise AssertionError("corrupt snapshot accepted")


def test_histogram_exemplars_ride_snapshot_merge_and_exposition():
    """Metrics exemplars: a sampled trace id attaches to the bucket its
    observation landed in, survives snapshot round-trips and cluster
    merge, and renders in OpenMetrics exemplar syntax on the endpoint."""
    h = Histogram()
    h.observe(0.003)
    h.exemplar(0.003, 0xABC)       # slow-ish bucket, trace attached
    s = h.summary()
    assert "exemplars" in s
    r = Histogram.from_snapshot(s)
    assert r.exemplars and list(r.exemplars.values())[0][1] == 0xABC
    # merge keeps the NEWEST exemplar per bucket and re-locates by value
    other = Histogram(SIZE_BOUNDS)
    other.observe(100.0)
    other.exemplar(100.0, 0xDEF)
    r.merge(other)
    assert any(t == 0xDEF for _, t, _ in r.exemplars.values())
    # OpenMetrics rendering carries the exemplar suffix on the bucket
    snap = {"counters": {"c": 1}, "gauges": {}, "histograms":
            {"qw": r.summary()}}
    text = prometheus_exposition(snap, openmetrics=True)
    # 32-hex trace id, the same width the OTLP span export uses, so
    # exemplar -> trace joins match on exact id string
    assert 'trace_id="%032x"' % 0xABC in text
    line = [ln for ln in text.splitlines() if "0abc" in ln][0]
    assert " # {" in line and line.startswith("orleans_qw_bucket")
    assert "orleans_c_total 1" in text and text.rstrip().endswith("# EOF")
    # the classic 0.0.4 rendering stays exemplar-free (strict parsers
    # reject tokens after the sample value outside OpenMetrics)
    plain = prometheus_exposition(snap)
    assert "trace_id" not in plain and "# EOF" not in plain
    assert "orleans_c 1" in plain


# ----------------------------------------------------------------------
# Sampler windowing
# ----------------------------------------------------------------------
def test_windowed_gauge_trims_and_summarizes():
    w = WindowedGauge(window=10.0)
    for i in range(5):
        w.add(float(i), ts=100.0 + i)
    assert w.summary() == {"n": 5, "last": 4.0, "min": 0.0, "max": 4.0,
                           "mean": 2.0}
    w.add(9.0, ts=113.0)  # evicts everything older than 103.0
    s = w.summary()
    assert s["n"] == 3 and s["min"] == 3.0 and s["max"] == 9.0
    assert w.last() == 9.0


@bounded
async def test_sampler_windows_fill_and_gauges_register():
    cluster = (TestClusterBuilder(1).add_grains(EchoGrain)
               .with_metrics(sample_period=0.03).build())
    async with cluster:
        for i in range(30):
            assert await cluster.grain(EchoGrain, i % 4).ping(i) == i
        await asyncio.sleep(0.15)
        silo = cluster.silos[0]
        sampler = silo.metrics
        assert isinstance(sampler, MetricsSampler) and sampler.ticks >= 2
        windows = sampler.window_snapshot()
        assert windows["queue.inbound.application"]["n"] >= 2
        assert windows["rpc.pending_callbacks"]["n"] >= 2
        assert "sampler.loop_lag" in windows
        # sources double as live registry gauges
        snap = silo.stats.snapshot()
        assert "queue.inbound.application" in snap["gauges"]
        assert "pool.message_free" in snap["gauges"]
        # stage instrumentation observed queue waits for the turns above
        qw = snap["histograms"].get(INGEST_STATS["queue_wait"])
        assert qw is not None and qw["count"] > 0


@bounded
async def test_sampler_isolates_raising_source():
    cluster = (TestClusterBuilder(1).add_grains(EchoGrain)
               .with_metrics(sample_period=0.03).build())
    async with cluster:
        sampler = cluster.silos[0].metrics

        def boom() -> float:
            raise RuntimeError("injected gauge failure")

        sampler.add_source("test.bad", boom)
        sampler.add_source("test.good", lambda: 7.0)
        sampler.sample_once()
        assert sampler.window_snapshot()["test.good"]["last"] == 7.0
        assert sampler.window_snapshot()["test.bad"]["n"] == 0


# ----------------------------------------------------------------------
# Prometheus endpoint scrape round-trip
# ----------------------------------------------------------------------
def _parse_exposition(text: str) -> dict[str, float]:
    out: dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


@bounded
async def test_prometheus_endpoint_scrape_round_trip():
    cluster = (TestClusterBuilder(1).add_grains(EchoGrain)
               .with_metrics(sample_period=0.05, port=0).build())
    async with cluster:
        for i in range(20):
            await cluster.grain(EchoGrain, 0).ping(i)
        silo = cluster.silos[0]
        port = silo.metrics_server.port
        assert port and port > 0

        async def scrape(path: str = "/metrics") -> tuple[str, str]:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
            await writer.drain()
            raw = await reader.read(-1)
            writer.close()
            head, _, body = raw.decode().partition("\r\n\r\n")
            return head, body

        head, body = await scrape()
        assert head.startswith("HTTP/1.1 200")
        assert "text/plain; version=0.0.4" in head
        series = _parse_exposition(body)
        sent = silo.stats.get("messaging.sent")
        label = f'{{silo="{silo.config.name}"}}'
        # counter round-trips exactly (scrape happened after the pings)
        assert series[f"orleans_messaging_sent{label}"] >= 1
        assert series[f"orleans_messaging_sent{label}"] <= sent + 5
        # histogram: cumulative le-buckets, _sum, _count all present
        qw = "orleans_ingest_queue_wait_seconds"
        count_key = f"{qw}_count{label}"
        assert count_key in series and series[count_key] > 0
        inf_key = f'{qw}_bucket{{silo="{silo.config.name}",le="+Inf"}}'
        assert series[inf_key] == series[count_key]
        # live gauges from the sampler sources
        assert f"orleans_rpc_pending_callbacks{label}" in series
        # window summaries exported as _window_* gauges
        assert any(k.startswith(f"{qw}") for k in series)
        head404, _ = await scrape("/nope")
        assert head404.startswith("HTTP/1.1 404")


# ----------------------------------------------------------------------
# OTLP metrics export (fake collector)
# ----------------------------------------------------------------------
from fake_otlp import FakeCollector  # noqa: E402


def _metrics_collector(fail_first: int = 0) -> FakeCollector:
    return FakeCollector(fail_first=fail_first, path="/v1/metrics")


def _snap(silo_name="s0") -> dict:
    reg = StatsRegistry()
    reg.increment("m.calls", 5)
    reg.set_gauge("m.depth", 3.0)
    reg.observe("m.lat", 0.002)
    reg.histogram_with("m.bytes", SIZE_BOUNDS).observe(300)
    snap = reg.snapshot()
    snap["silo"] = silo_name
    return snap


def test_snapshots_to_otlp_metrics_shape():
    req = snapshots_to_otlp_metrics([_snap()], service_name="svc")
    rm = req["resourceMetrics"][0]
    assert rm["resource"]["attributes"][0]["value"]["stringValue"] == "svc"
    metrics = {m["name"]: m for m in rm["scopeMetrics"][0]["metrics"]}
    assert metrics["m.calls"]["sum"]["isMonotonic"] is True
    assert metrics["m.calls"]["sum"]["dataPoints"][0]["asInt"] == "5"
    assert metrics["m.depth"]["gauge"]["dataPoints"][0]["asDouble"] == 3.0
    lat = metrics["m.lat"]["histogram"]["dataPoints"][0]
    assert lat["count"] == "1" and len(lat["bucketCounts"]) == \
        len(lat["explicitBounds"]) + 1
    # custom-bounds histogram carries ITS bounds, not the latency ones
    by = metrics["m.bytes"]["histogram"]["dataPoints"][0]
    assert 65536.0 in by["explicitBounds"]
    # the silo attribute rides per data point
    assert lat["attributes"][0]["value"]["stringValue"] == "s0"


@bounded
async def test_otlp_metrics_sink_batches_and_retries():
    col = _metrics_collector(fail_first=1)
    try:
        sink = OtlpMetricsSink(col.endpoint, retry_backoff=0.01)
        sink.offer((_snap("a"),))
        sink.offer((_snap("b"),))
        await sink.flush()
        assert sink.exported == 2 and sink.dropped == 0
        assert sink.retries >= 1  # first post failed 503, retried
        assert {"m.calls", "m.lat", "m.bytes"} <= col.metric_names()
        await sink.aclose()
    finally:
        col.close()


@bounded
async def test_otlp_metrics_sink_drops_when_unreachable():
    sink = OtlpMetricsSink("http://127.0.0.1:1/v1/metrics",
                           max_retries=0, timeout=0.2)
    sink.offer((_snap(),))
    await sink.flush()
    assert sink.exported == 0 and sink.dropped == 1
    await sink.aclose(flush=False)


@bounded
async def test_silo_pushes_snapshots_to_collector():
    """End to end: a metrics-enabled silo with an OTLP endpoint pushes
    registry snapshots on the sampler cadence; stop flushes a final one."""
    col = _metrics_collector()
    try:
        cluster = (TestClusterBuilder(1).add_grains(EchoGrain)
                   .with_metrics(sample_period=0.03,
                                 otlp_endpoint=col.endpoint,
                                 otlp_period=0.05).build())
        async with cluster:
            for i in range(10):
                await cluster.grain(EchoGrain, 0).ping(i)
            await asyncio.sleep(0.25)
        names = col.metric_names()
        assert "messaging.sent" in names
        assert INGEST_STATS["queue_wait"] in names
    finally:
        col.close()


# ----------------------------------------------------------------------
# Ingest stage attribution over the real socket path
# ----------------------------------------------------------------------
@bounded
async def test_socket_ingest_stages_observed():
    """Gateway traffic over real TCP populates the decode / enqueue /
    queue_wait stage histograms and the frame-batch size series, and the
    per-stage counts line up with the frames counter."""
    from orleans_tpu_torch.runtime import SiloBuilder
    from orleans_tpu_torch.runtime.socket_fabric import GatewayClient, SocketFabric

    fabric = SocketFabric()
    silo = (SiloBuilder().with_name("ingest-test").with_fabric(fabric)
            .add_grains(EchoGrain)
            .with_config(metrics_enabled=True).build())
    await silo.start()
    client = None
    try:
        client = await GatewayClient(
            [silo.silo_address.endpoint]).connect()
        g = client.get_grain(EchoGrain, 1)
        for i in range(40):
            assert await g.ping(i) == i
        snap = silo.stats.snapshot()
        hists = snap["histograms"]
        decode = hists[INGEST_STATS["decode"]]
        enqueue = hists[INGEST_STATS["enqueue"]]
        qwait = hists[INGEST_STATS["queue_wait"]]
        assert decode["count"] >= 40
        assert enqueue["count"] == decode["count"]
        assert qwait["count"] >= 40
        assert snap["counters"][INGEST_STATS["frames"]] == decode["count"]
        # size + batch histograms carry their custom bounds
        dbytes = hists[INGEST_STATS["decode_bytes"]]
        assert dbytes["count"] == decode["count"]
        assert dbytes["bounds"][0] == 64.0
        batch = hists[INGEST_STATS["frame_batch"]]
        assert batch["count"] >= 1 and batch["sum"] == decode["count"]
        # stages are real time: every sum is positive and finite
        for h in (decode, enqueue, qwait):
            assert 0 < h["sum"] < 60
    finally:
        if client is not None:
            await client.close_async()
        await silo.stop()


@bounded
async def test_vector_ingest_stages_observed():
    """Device-tier calls through a metrics-enabled silo populate the
    staging / transfer / tick stage histograms and the ingest.messages
    counter (the device half of the attribution)."""
    import torch

    from orleans_tpu_torch.dispatch import (VectorGrain, actor_method,
                                            add_vector_grains)
    from orleans_tpu_torch.parallel import make_mesh
    from orleans_tpu_torch.runtime import ClusterClient, SiloBuilder

    class CounterVec(VectorGrain):
        STATE = {"count": (torch.int32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"count": torch.zeros_like(key_hash)}

        @actor_method(args={"x": (torch.int32, ())})
        def add(state, args):
            return {"count": state["count"] + args["x"]}, state["count"]

    b = (SiloBuilder().with_name("vec-metrics")
         .with_config(metrics_enabled=True))
    add_vector_grains(b, CounterVec, mesh=make_mesh(1, device="cpu"))
    silo = b.build()
    await silo.start()
    client = None
    try:
        client = await ClusterClient(silo.fabric).connect()
        await asyncio.gather(*(client.get_grain(CounterVec, k).add(x=1)
                               for k in range(16)))
        snap = silo.stats.snapshot()
        hists = snap["histograms"]
        for stage in ("staging", "transfer", "tick"):
            h = hists.get(INGEST_STATS[stage])
            assert h is not None and h["count"] >= 1, stage
        assert snap["counters"][INGEST_STATS["messages"]] >= 16
        assert hists[INGEST_STATS["queue_wait"]]["count"] >= 16
    finally:
        if client is not None:
            await client.close_async()
        await silo.stop()


# ----------------------------------------------------------------------
# Cluster-wide merge via ManagementGrain
# ----------------------------------------------------------------------
@bounded
async def test_management_grain_merges_cluster_metrics():
    from orleans_tpu_torch.management import ManagementGrain

    cluster = (TestClusterBuilder(2).add_grains(EchoGrain)
               .with_metrics(sample_period=0.05).build())
    async with cluster:
        for i in range(40):
            await cluster.grain(EchoGrain, i).ping(i)
        await asyncio.sleep(0.12)
        mg = cluster.client.get_grain(ManagementGrain, 0)
        merged = await mg.get_cluster_metrics()
        per_silo = merged["per_silo"]
        assert len(per_silo) == 2
        # counters sum across silos exactly
        sent = sum(s["counters"].get("messaging.sent", 0)
                   for s in per_silo.values())
        assert merged["counters"]["messaging.sent"] == sent > 0
        # histograms fold losslessly (bucket-wise) across silos
        qw_name = INGEST_STATS["queue_wait"]
        total = sum(s["histograms"].get(qw_name, {}).get("count", 0)
                    for s in per_silo.values())
        assert merged["histograms"][qw_name]["count"] == total > 0
        # per-silo payloads carry sampler windows for drill-down
        for s in per_silo.values():
            assert "windows" in s and "rpc.pending_callbacks" in s["windows"]
        # gauges aggregate as sums (queue depth: cluster total)
        assert "rpc.pending_callbacks" in merged["gauges"]


@bounded
async def test_metrics_disabled_costs_nothing_structural():
    """With metrics off (the default), no sampler/server is installed,
    ingest_stats is None on every hot-path holder, and no ingest stage
    histograms appear."""
    cluster = TestClusterBuilder(1).add_grains(EchoGrain).build()
    async with cluster:
        silo = cluster.silos[0]
        assert silo.metrics is None and silo.metrics_server is None
        assert silo.ingest_stats is None
        assert silo.dispatcher._istats is None
        await cluster.grain(EchoGrain, 1).ping(1)
        snap = silo.stats.snapshot()
        assert INGEST_STATS["queue_wait"] not in snap["histograms"]
