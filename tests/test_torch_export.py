"""The port's Perfetto/Chrome trace and OTLP export
(orleans_tpu_torch.observability.export), on the CPU.

* The port's copies of the OTLP and export cases of
  tests/test_tail_tracing.py (payload shape, ``OtlpSink`` batching, retry,
  drop and overflow against a fake collector, a tail-retained trace
  streamed from a cluster, the protobuf wire walks, encoding selection)
  and of tests/test_tracing.py (a two-silo trace written by
  ``TestCluster.export_trace``, span links through the OTLP encoding).
* Parity with the JAX package for the same span dicts and registry
  snapshots: the OTLP JSON requests are equal, the OTLP protobuf bytes
  (traces and metrics) are byte-equal, and the Chrome trace events are
  equal.
* A client's OTLP endpoint streams its spans to a collector.

Every async body runs under ``asyncio.wait_for(..., 30)``.
"""

import asyncio
import functools
import json

import pytest

import orleans_tpu.observability.export as jx
import orleans_tpu.observability.stats as jstats
import orleans_tpu_torch.observability.export as tx
from orleans_tpu_torch.management import ManagementGrain
from orleans_tpu_torch.observability.export import OtlpSink, spans_to_otlp
from orleans_tpu_torch.observability.stats import Histogram
from orleans_tpu_torch.runtime import Grain
from orleans_tpu_torch.testing import TestClusterBuilder

from fake_otlp import FakeCollector as _FakeCollector

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


class SlowGrain(Grain):
    async def nap(self) -> str:
        await asyncio.sleep(0.12)
        return "slept"


class ProxyGrain(Grain):
    """Grain-to-grain hop: the relay forces a second client span from
    inside a turn (and usually a cross-silo network leg)."""

    async def relay(self, key: int, x: int) -> int:
        return await self.get_grain(EchoGrain, key).ping(x)


# ----------------------------------------------------------------------
# OTLP sink: batching / payload shape / retry / drop
# ----------------------------------------------------------------------

def _mk_span_dicts(n, trace_id=0xabc, error_on=None, events_on=None):
    out = []
    for i in range(n):
        d = {"trace_id": trace_id, "span_id": 100 + i,
             "parent_id": 99 if i else None, "name": f"op{i}",
             "kind": "server" if i else "client", "silo": "silo0",
             "start": 1000.0 + i, "duration": 0.25, "attrs": {"n": i}}
        if error_on is not None and i == error_on:
            d["attrs"]["error"] = "ValueError"
        if events_on is not None and i == events_on:
            d["events"] = [["resend", 1000.5, {"rejection": "TRANSIENT"}]]
        out.append(d)
    return out


def test_otlp_payload_shape():
    payload = spans_to_otlp(_mk_span_dicts(2, error_on=1, events_on=1),
                            service_name="svc")
    rs = payload["resourceSpans"][0]
    res_attrs = {a["key"]: a["value"] for a in rs["resource"]["attributes"]}
    assert res_attrs["service.name"] == {"stringValue": "svc"}
    spans = rs["scopeSpans"][0]["spans"]
    assert len(spans) == 2
    root, child = spans
    assert len(root["traceId"]) == 32 and len(root["spanId"]) == 16
    assert "parentSpanId" not in root and len(child["parentSpanId"]) == 16
    assert root["kind"] == 3 and child["kind"] == 2  # CLIENT / SERVER
    assert int(child["endTimeUnixNano"]) - int(child["startTimeUnixNano"]) \
        == int(0.25 * 1e9)
    assert child["status"] == {"code": 2, "message": "ValueError"}
    assert child["events"][0]["name"] == "resend"
    span_attrs = {a["key"] for a in child["attributes"]}
    assert {"n", "orleans.silo", "orleans.kind"} <= span_attrs


@bounded
async def test_otlp_sink_batches_to_local_collector():
    col = _FakeCollector()
    try:
        sink = OtlpSink(col.endpoint, batch_size=4, flush_interval=0.05)
        sink.offer(_mk_span_dicts(6))
        # offer kicked the background flusher (full batch) — settle on the
        # counters instead of racing it with an explicit flush
        for _ in range(200):
            if sink.stats()["exported"] >= 6:
                break
            await asyncio.sleep(0.01)
        assert col.span_count() == 6
        sizes = sorted(
            len(ss["spans"])
            for b in col.bodies for rs in b["resourceSpans"]
            for ss in rs["scopeSpans"])
        assert sizes == [2, 4]  # bounded batches, nothing lost
        st = sink.stats()
        assert st["exported"] == 6 and st["export_batches"] == 2
        assert st["export_dropped"] == 0
        await sink.aclose()
    finally:
        col.close()


@bounded
async def test_otlp_sink_retries_transient_failure():
    col = _FakeCollector(fail_first=1)
    try:
        sink = OtlpSink(col.endpoint, batch_size=8, max_retries=2,
                        retry_backoff=0.01)
        sink.offer(_mk_span_dicts(3))
        await sink.flush()
        st = sink.stats()
        assert st["exported"] == 3 and st["export_dropped"] == 0
        assert st["export_retries"] >= 1
        await sink.aclose()
    finally:
        col.close()


@bounded
async def test_otlp_sink_drops_and_counts_when_unreachable():
    # closed port: connection refused immediately, no real network
    sink = OtlpSink("http://127.0.0.1:9/v1/traces", batch_size=4,
                    max_retries=1, retry_backoff=0.01, timeout=0.2)
    sink.offer(_mk_span_dicts(5))
    await sink.flush()   # must not raise
    st = sink.stats()
    assert st["exported"] == 0 and st["export_dropped"] == 5
    await sink.aclose()


@bounded
async def test_otlp_sink_queue_overflow_drops_oldest():
    sink = OtlpSink("http://127.0.0.1:9/v1/traces", max_queue=4)
    sink.offer(_mk_span_dicts(6))
    assert sink.stats()["queued"] == 4
    assert sink.stats()["export_dropped"] == 2
    await sink.aclose(flush=False)


@bounded
async def test_tail_cluster_streams_retained_trace_to_collector():
    """End to end: tail cluster + OTLP endpoint — the retained slow trace
    (with its pulled silo legs) lands at the collector; dropped fast-clean
    traces never ship."""
    col = _FakeCollector()
    try:
        cluster = (TestClusterBuilder(1).add_grains(EchoGrain, SlowGrain)
                   .with_tracing(tail=True, tail_window=0.1,
                                 slow_threshold=0.05, leg_ttl=0.4,
                                 otlp_endpoint=col.endpoint)
                   .build())
        async with cluster:
            assert await cluster.grain(SlowGrain, 1).nap() == "slept"
            for i in range(10):
                assert await cluster.grain(EchoGrain, 1).ping(i) == i
            await cluster.drain_traces()
            shipped = [sp for b in col.bodies
                       for rs in b["resourceSpans"]
                       for ss in rs["scopeSpans"] for sp in ss["spans"]]
            names = {s["name"] for s in shipped}
            assert "SlowGrain.nap" in names
            assert not any("EchoGrain" in n for n in names)
            # the pulled silo leg shipped too (whole trace, one shipper)
            silos = {a["value"]["stringValue"] for s in shipped
                     for a in s["attributes"] if a["key"] == "orleans.silo"}
            assert "silo0" in silos
            st = cluster.client.tracer.retention_stats()
            assert st["exported"] == len(shipped) > 0
    finally:
        col.close()


def _pb_walk(data: bytes) -> list:
    """Decode one protobuf message into [(field, wire_type, value)]:
    varints as ints, length-delimited as raw bytes, fixed64 as 8 bytes.
    Raises on truncation/invalid tags — the structural validity check."""
    out = []
    i = 0
    while i < len(data):
        tag = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            tag |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wt == 1:  # fixed64
            v = data[i:i + 8]
            assert len(v) == 8
            i += 8
        elif wt == 2:  # length-delimited
            n = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                n |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            v = data[i:i + n]
            assert len(v) == n, "truncated length-delimited field"
            i += n
        else:
            raise AssertionError(f"unexpected wire type {wt}")
        out.append((field, wt, v))
    return out


def _pb_fields(data: bytes, field: int) -> list:
    return [v for f, _, v in _pb_walk(data) if f == field]


def test_otlp_trace_protobuf_wire_walk():
    """The binary trace encoding is valid protobuf mirroring the JSON
    request: ResourceSpans(resource=1, scope_spans=2) > ScopeSpans >
    Span with ids/name/kind/times/attributes, and the hex trace id
    round-trips into the Span.trace_id bytes."""
    from orleans_tpu_torch.observability.export import otlp_trace_protobuf

    req = spans_to_otlp(_mk_span_dicts(2, error_on=1, events_on=1),
                        service_name="svc")
    data = otlp_trace_protobuf(req)
    (rs,) = _pb_fields(data, 1)           # ExportTraceServiceRequest
    assert _pb_fields(rs, 1)              # resource present
    (ss,) = _pb_fields(rs, 2)             # one ScopeSpans
    spans = _pb_fields(ss, 2)
    assert len(spans) == 2
    json_root = req["resourceSpans"][0]["scopeSpans"][0]["spans"][0]
    root, child = spans
    (tid_bytes,) = _pb_fields(root, 1)
    assert tid_bytes == bytes.fromhex(json_root["traceId"])
    assert len(_pb_fields(root, 2)[0]) == 8          # span_id: 8 bytes
    assert not _pb_fields(root, 4)                   # root: no parent
    assert len(_pb_fields(child, 4)[0]) == 8         # child parented
    (name,) = _pb_fields(root, 5)
    assert name == json_root["name"].encode()
    # fixed64 start/end nanos match the JSON stamps
    import struct
    (start,) = _pb_fields(root, 7)
    assert struct.unpack("<Q", start)[0] == \
        int(json_root["startTimeUnixNano"])
    assert _pb_fields(root, 9)                       # attributes
    assert _pb_fields(child, 11)                     # child's event
    assert _pb_fields(child, 15)                     # error → status


def test_otlp_metrics_protobuf_wire_walk():
    """The binary metrics encoding carries sum/gauge/histogram points
    with the same counts and bounds as the JSON request."""
    import struct

    from orleans_tpu_torch.observability.export import (otlp_metrics_protobuf,
                                                  snapshots_to_otlp_metrics)
    from orleans_tpu_torch.observability.stats import Histogram

    h = Histogram()
    for v in (0.001, 0.01, 0.01, 0.2):
        h.observe(v)
    snap = {"ts": 1234.5, "silo": "s0",
            "counters": {"msgs": 7}, "gauges": {"backlog": 2.5},
            "histograms": {"lat": h.summary()}}
    req = snapshots_to_otlp_metrics([snap], service_name="svc")
    data = otlp_metrics_protobuf(req)
    (rm,) = _pb_fields(data, 1)
    (sm,) = _pb_fields(rm, 2)
    metrics = _pb_fields(sm, 2)
    kinds = {}
    for m in metrics:
        (name,) = _pb_fields(m, 1)
        kinds[name.decode()] = {5: "gauge", 7: "sum", 9: "histogram"}[
            next(f for f, _, _ in _pb_walk(m) if f in (5, 7, 9))]
    assert kinds == {"msgs": "sum", "backlog": "gauge",
                     "lat": "histogram"}
    hist = next(m for m in metrics if _pb_fields(m, 1)[0] == b"lat")
    (hbody,) = _pb_fields(hist, 9)
    (point,) = _pb_fields(hbody, 1)
    (count,) = _pb_fields(point, 4)                  # fixed64 count
    assert struct.unpack("<Q", count)[0] == 4
    (bucket_counts,) = _pb_fields(point, 6)          # packed fixed64
    counts = struct.unpack(f"<{len(bucket_counts) // 8}Q", bucket_counts)
    assert sum(counts) == 4 and len(counts) == len(h.counts)
    (bounds,) = _pb_fields(point, 7)                 # packed double
    n_bounds = len(bounds) // 8
    assert n_bounds == len(counts) - 1               # +Inf excluded


@bounded
async def test_otlp_sink_encoding_selection(monkeypatch):
    """encoding="protobuf" flips the Content-Type; unknown encodings are
    rejected; and when google.protobuf is absent the sink degrades to
    JSON with a warning instead of dying (the binary path is an
    optimization, never a dependency)."""
    from orleans_tpu_torch.observability import export

    sink = OtlpSink("http://127.0.0.1:9/v1/traces", encoding="protobuf")
    assert sink.encoding == "protobuf"
    assert sink.content_type == "application/x-protobuf"
    body = sink._encode(_mk_span_dicts(2))
    assert _pb_fields(body, 1)  # valid protobuf, not JSON
    await sink.aclose(flush=False)

    json_sink = OtlpSink("http://127.0.0.1:9/v1/traces")
    assert json_sink.content_type == "application/json"
    import json as _json
    assert _json.loads(json_sink._encode(_mk_span_dicts(1)))
    await json_sink.aclose(flush=False)

    with pytest.raises(ValueError):
        OtlpSink("http://127.0.0.1:9/v1/traces", encoding="msgpack")

    monkeypatch.setattr(export, "_HAS_PROTOBUF", False)
    degraded = OtlpSink("http://127.0.0.1:9/v1/traces",
                        encoding="protobuf")
    assert degraded.encoding == "json"
    assert degraded.content_type == "application/json"
    await degraded.aclose(flush=False)


# ----------------------------------------------------------------------
# Export from a cluster: the Perfetto file and span links
# ----------------------------------------------------------------------

def _last_client_trace_id(cluster) -> int:
    spans = [s for s in cluster.client.tracer.snapshot()
             if s["kind"] == "client"]
    assert spans, "client recorded no root span"
    return spans[-1]["trace_id"]


@bounded
async def test_two_silo_trace_covers_client_network_queue_exec(tmp_path):
    cluster = (TestClusterBuilder(2).add_grains(EchoGrain, ProxyGrain)
               .with_tracing().build())
    async with cluster:
        assert await cluster.grain(ProxyGrain, 1).relay(2, 42) == 42
        tid = _last_client_trace_id(cluster)
        spans = cluster.trace_spans(tid)

        # one trace_id end to end
        assert {s["trace_id"] for s in spans} == {tid}
        kinds = {s["kind"] for s in spans}
        assert {"client", "server", "network", "directory"} <= kinds

        # client invoke span is the root and covers the round trip
        roots = [s for s in spans if s["parent_id"] is None]
        assert len(roots) == 1 and roots[0]["kind"] == "client"
        assert roots[0]["name"] == "ProxyGrain.relay"

        # server spans record queue wait and execution separately; the
        # grain-to-grain hop means turns on BOTH app grains appear
        servers = [s for s in spans if s["kind"] == "server"]
        assert {"ProxyGrain.relay", "EchoGrain.ping"} <= \
            {s["name"] for s in servers}
        for s in servers:
            assert "queue_s" in s["attrs"] and "exec_s" in s["attrs"]
            assert s["duration"] >= s["attrs"]["exec_s"]

        # first call goes through directory lookup/placement
        assert any(s["kind"] == "directory" for s in spans)

        # parent links resolve within the trace (spans form one tree)
        ids = {s["span_id"] for s in spans}
        for s in spans:
            assert s["parent_id"] is None or s["parent_id"] in ids

        # critical-path breakdown is queryable via the management grain
        mgmt = cluster.grain(ManagementGrain, 0)
        bd = await mgmt.get_trace_breakdown(tid)
        assert bd["span_count"] > 0 and bd["total_s"] > 0
        assert bd["seconds"]["exec"] > 0
        assert set(bd["fractions"]) == {"queue", "exec", "network", "ring",
                                        "directory", "device", "migration"}
        assert all(0.0 <= f <= 1.0 for f in bd["fractions"].values())

        # Perfetto/Chrome export: valid JSON with complete events +
        # process/thread naming metadata
        path = cluster.export_trace(str(tmp_path / "trace.json"), tid)
        data = json.load(open(path))
        events = data["traceEvents"]
        slices = [e for e in events if e["ph"] == "X"]
        assert len(slices) == len(spans)
        for e in slices:
            assert e["dur"] > 0 and "pid" in e and "tid" in e
        meta_names = [e["args"]["name"] for e in events if e["ph"] == "M"
                      and e["name"] == "process_name"]
        assert "client" in meta_names
        assert any(n.startswith("silo") for n in meta_names)


@bounded
async def test_timer_triggered_root_links_to_arming_trace():
    """A timer registered inside a traced turn fires later and roots a
    FRESH trace (timer messages carry no headers); the new root must
    carry the arming turn's (trace_id, span_id) as a span link so
    Perfetto/OTLP show causality without merging the traces."""

    class ArmGrain(Grain):
        async def arm(self) -> int:
            self.register_timer(self._tick, 0.02, None)
            return 1

        async def _tick(self):
            await self.get_grain(EchoGrain, 7).ping(7)

    cluster = (TestClusterBuilder(1).add_grains(EchoGrain, ArmGrain)
               .with_tracing().build())
    async with cluster:
        assert await cluster.grain(ArmGrain, 1).arm() == 1
        arm_tid = _last_client_trace_id(cluster)
        await asyncio.sleep(0.2)  # timer fires, tick pings EchoGrain
        silo = cluster.silos[0]
        linked = [s for s in silo.tracer.snapshot()
                  if s.get("links") and s["parent_id"] is None]
        assert linked, "timer-rooted trace carried no span link"
        root = linked[-1]
        assert root["name"] == "EchoGrain.ping"
        assert root["trace_id"] != arm_tid  # a fresh trace, not a merge
        link_tids = {lt for lt, _ in root["links"]}
        assert arm_tid in link_tids
        # the link's span id resolves to a span of the arming trace
        arm_spans = {s["span_id"] for s in cluster.trace_spans(arm_tid)}
        assert any(ls in arm_spans for _, ls in root["links"])
        # links survive the OTLP encoding
        from orleans_tpu_torch.observability.export import spans_to_otlp
        req = spans_to_otlp([root])
        ospan = req["resourceSpans"][0]["scopeSpans"][0]["spans"][0]
        assert ospan["links"][0]["traceId"].endswith(f"{arm_tid:x}")


# ----------------------------------------------------------------------
# Parity with the JAX package: the same span dicts and snapshots encode
# to the same requests and bytes
# ----------------------------------------------------------------------

def _span_corpus() -> list:
    spans = _mk_span_dicts(5, error_on=2, events_on=3)
    spans += _mk_span_dicts(3, trace_id=0x1234567890abcdef1234)
    spans[1]["links"] = [(0xabc, 100)]
    spans[4]["attrs"].update({"f": 1.5, "flag": True, "s": "x",
                              "big": 1 << 40})
    spans[6]["silo"] = "silo1"
    return spans


def _loop_profiles() -> dict:
    return {"silo0": [{"ts": 1001.0, "wall_s": 0.5,
                       "shares": {"turns": 0.5, "pump": 0.25},
                       "top": [{"label": "EchoGrain.ping",
                                "category": "turns", "seconds": 0.01,
                                "offset_s": 0.1}]}]}


def test_otlp_trace_requests_and_protobuf_bytes_equal_the_jax_package():
    spans = _span_corpus()
    j = jx.spans_to_otlp(spans, service_name="svc")
    t = tx.spans_to_otlp(spans, service_name="svc")
    assert t == j
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert tx.spans_to_otlp(spans) == jx.spans_to_otlp(spans)
    tb = tx.otlp_trace_protobuf(t)
    assert tb == jx.otlp_trace_protobuf(j)
    assert len(_pb_fields(tb, 1)) == 1


def _registry_snapshot(stats_mod) -> dict:
    reg = stats_mod.StatsRegistry()
    reg.increment("m.calls", 5)
    reg.set_gauge("m.depth", 3.0)
    for v in (0.001, 0.002, 0.03, 0.4):
        reg.observe("m.lat", v)
    reg.histogram_with("m.bytes", stats_mod.SIZE_BOUNDS).observe(300)
    snap = reg.snapshot()
    snap["silo"] = "s0"
    snap["ts"] = 1234.5
    return snap


def test_otlp_metrics_requests_and_protobuf_bytes_equal_the_jax_package():
    from orleans_tpu_torch.observability import stats as tstats
    j = jx.snapshots_to_otlp_metrics([_registry_snapshot(jstats)],
                                     service_name="svc")
    t = tx.snapshots_to_otlp_metrics([_registry_snapshot(tstats)],
                                     service_name="svc")
    assert t == j
    tb = tx.otlp_metrics_protobuf(t)
    assert tb == jx.otlp_metrics_protobuf(j)
    assert _pb_fields(tb, 1)


def test_chrome_trace_events_equal_the_jax_package(tmp_path):
    spans = _span_corpus()
    assert tx.chrome_trace_events(spans) == jx.chrome_trace_events(spans)
    assert tx.chrome_trace_events(spans, _loop_profiles()) == \
        jx.chrome_trace_events(spans, _loop_profiles())
    tp = tx.write_chrome_trace(str(tmp_path / "t.json"), spans)
    jp = jx.write_chrome_trace(str(tmp_path / "j.json"), spans)
    assert json.load(open(tp)) == json.load(open(jp))


@bounded
async def test_client_otlp_endpoint_streams_its_spans():
    """``enable_tracing(otlp_endpoint=...)`` on a client attaches an
    ``OtlpSink``: the client's root spans reach the collector."""
    col = _FakeCollector()
    try:
        cluster = (TestClusterBuilder(1).add_grains(EchoGrain)
                   .with_tracing(client=False).build())
        async with cluster:
            tracer = cluster.client.enable_tracing(
                sample_rate=1.0, name="otlp-client",
                otlp_endpoint=col.endpoint)
            assert isinstance(tracer.sinks[-1], OtlpSink)
            for i in range(3):
                assert await cluster.grain(EchoGrain, i).ping(i) == i
            await tracer.sinks[-1].flush()
            shipped = [sp for b in col.bodies
                       for rs in b["resourceSpans"]
                       for ss in rs["scopeSpans"] for sp in ss["spans"]]
            assert sum(sp["name"] == "EchoGrain.ping"
                       for sp in shipped) >= 3
            await tracer.sinks[-1].aclose()
    finally:
        col.close()
