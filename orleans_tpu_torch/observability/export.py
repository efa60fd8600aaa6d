"""Chrome-trace / Perfetto export + streaming OTLP sink.

Turns the spans collected by :mod:`.tracing`
— typically merged from every silo of a cluster plus the client — into
one Chrome Trace Event Format file (the JSON object form with a
``traceEvents`` array) loadable in ``ui.perfetto.dev`` or
``chrome://tracing``. Each silo/client becomes a "process" row; each
trace becomes a "thread" within it, so one request's client invoke →
network → queue wait → turn execution reads left-to-right across the
process rows it touched. Span attrs (queue_s/exec_s, forward counts,
migration outcomes) land in ``args`` for the selection panel.

:class:`OtlpSink` is the live counterpart: it streams finished/retained
spans as OTLP/HTTP JSON (the `opentelemetry-proto` JSON mapping over
plain ``urllib`` — no exporter dependency) to a collector endpoint in
bounded batches with retry/backoff, so traces land in Jaeger/Tempo/any
OTel collector instead of per-test Chrome files. An unreachable
collector degrades to counted drops; it can never stall or break the
runtime that feeds it.

Device-side kernel timelines come from a ``torch.profiler`` capture
(:class:`.profiling.Profiler`, which
writes ``trace.json`` in the same Chrome Trace Event Format); the
dispatch engine opens a ``record_function`` range per tick named like the
logical tick span, so the two captures correlate by name when viewed
together.

The port's copy of ``orleans_tpu.observability.export``. Its payloads are
the JAX package's bytes for the same span dicts: the OTLP instrumentation
scope names (``orleans_tpu.observability.tracing`` and ``.metrics``) and
the default ``service.name`` are the protocol's labels a collector groups
by, so they stay the same for both packages.
"""

from __future__ import annotations

import asyncio
import importlib.util
import json
import logging
import struct
import urllib.error
import urllib.request
from collections import deque

__all__ = ["chrome_trace_events", "write_chrome_trace",
           "OtlpSink", "OtlpMetricsSink", "spans_to_otlp",
           "snapshots_to_otlp_metrics", "otlp_trace_protobuf",
           "otlp_metrics_protobuf"]

log = logging.getLogger("orleans.export")

# The binary OTLP encoding is OPT-IN (encoding="protobuf") and gated on
# the collector-side schema actually being present in the environment:
# the wire bytes below are hand-assembled (varint + length-delimited
# framing over the same dicts the JSON mapping ships — no generated
# stubs, no import of the package itself), but advertising
# application/x-protobuf only makes sense where the OTel proto toolchain
# exists, and the gate keeps JSON the universal default elsewhere.
_HAS_PROTOBUF = importlib.util.find_spec("google.protobuf") is not None


def chrome_trace_events(spans, loop_profiles: dict | None = None
                        ) -> list[dict]:
    """Convert span dicts (``Span.to_dict`` form) into Chrome trace
    events: one complete ("ph": "X") event per span plus process/thread
    naming metadata. Timestamps are microseconds relative to the earliest
    span so the timeline starts at zero.

    ``loop_profiles``: optional ``{silo_name: [occupancy slices]}`` (the
    :meth:`LoopProfiler.profile` ``windows`` lists) rendered as Perfetto
    COUNTER tracks ("ph": "C") beside the span rows — per-category loop
    occupancy shares sampled once per window, on the same zeroed
    timeline, so a span's latency lines up with what occupied the loop
    around it — plus a per-silo "slow callbacks" flame row: each
    window's top-K slowest-callback records as complete spans (labels,
    categories, and placement exact — the profiler stamps each record's
    start offset within its window; offset-less legacy records fall
    back to end-to-end cursor placement from the window start). Span
    links ride into ``args`` (``links``) for the selection panel."""
    dicts = [s if isinstance(s, dict) else s.to_dict() for s in spans]
    starts = [s["start"] for s in dicts]
    for slices in (loop_profiles or {}).values():
        starts.extend(sl["ts"] - sl.get("wall_s", 0.0) for sl in slices)
    if not starts:
        # no spans and no finalized occupancy slices (e.g. a silo too
        # young for its first profiling window) — nothing to render
        return []
    t0 = min(starts)
    pids: dict[str, int] = {}
    tids: dict[tuple[int, int], int] = {}
    events: list[dict] = []
    for s in dicts:
        silo = s.get("silo") or "?"
        pid = pids.get(silo)
        if pid is None:
            pid = pids[silo] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": silo}})
        tkey = (pid, s["trace_id"])
        tid = tids.get(tkey)
        if tid is None:
            tid = tids[tkey] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"trace {s['trace_id']:016x}"}})
        args = dict(s.get("attrs") or {})
        args["trace_id"] = f"{s['trace_id']:016x}"
        args["span_id"] = f"{s['span_id']:016x}"
        if s.get("parent_id"):
            args["parent_id"] = f"{s['parent_id']:016x}"
        if s.get("links"):
            args["links"] = [f"{int(lt):016x}/{int(ls):016x}"
                             for lt, ls in s["links"]]
        events.append({
            "name": s["name"], "cat": s["kind"], "ph": "X",
            "ts": (s["start"] - t0) * 1e6,
            # Perfetto drops true-zero slices; clamp to 1ns so every span
            # stays visible/selectable
            "dur": max(s["duration"], 1e-9) * 1e6,
            "pid": pid, "tid": tid, "args": args,
        })
    for silo, slices in (loop_profiles or {}).items():
        pid = pids.get(silo)
        if pid is None:
            pid = pids[silo] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": silo}})
        slow_tid = None
        cursor = float("-inf")  # monotone across windows: spilled
        # records must not overlap the NEXT window's records either
        for sl in slices:
            shares = sl.get("shares") or {}
            if shares:
                # one counter sample per occupancy window, at the window
                # END (when the slice was cut); Perfetto stacks the args
                events.append({
                    "ph": "C", "name": "loop occupancy", "pid": pid,
                    "tid": 0,
                    "ts": (sl["ts"] - t0) * 1e6,
                    "args": {k: v for k, v in sorted(shares.items())},
                })
            top = sl.get("top") or ()
            if not top:
                continue
            if slow_tid is None:
                # the flame row: the window's top-K slowest callbacks as
                # real spans beside the occupancy counter track, so a
                # breach/anomaly snapshot renders as "what the loop was
                # running" instead of an opaque record list
                slow_tid = len(tids) + 1
                tids[(pid, -1)] = slow_tid
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": slow_tid,
                               "args": {"name": "slow callbacks"}})
            wall = sl.get("wall_s", 0.0)
            win_start = sl["ts"] - wall
            cursor = max(cursor, win_start)
            for rec in top:
                dur = rec.get("seconds", 0.0)
                off = rec.get("offset")
                if off is not None:
                    # exact placement: the profiler stamps each record's
                    # start offset within its window (hotloop.c / the
                    # Python reference), so the record sits where the
                    # callback actually ran — no cursor approximation.
                    # Exact records cannot overlap (callbacks are
                    # sequential on one loop); the cursor still advances
                    # past them so any offset-less legacy record in the
                    # same stream stays non-overlapping.
                    start = win_start + off
                    cursor = max(cursor, start + dur)
                else:
                    # legacy records carry duration + window only — lay
                    # them end-to-end from the window start (placement
                    # approximation; durations and the owning window are
                    # exact). When durations sum past the window end,
                    # records SPILL past the boundary rather than wrap —
                    # and the cursor stays monotone into the next window
                    # — because overlapping same-tid complete events
                    # would render as bogus nesting
                    start = cursor
                    cursor += dur
                events.append({
                    "name": rec.get("label") or "?",
                    "cat": rec.get("category", "other"),
                    "ph": "X",
                    "ts": (start - t0) * 1e6,
                    "dur": max(dur, 1e-9) * 1e6,
                    "pid": pid, "tid": slow_tid,
                    "args": {"category": rec.get("category"),
                             "window_ts": sl["ts"]},
                })
    return events


def write_chrome_trace(path: str, spans,
                       loop_profiles: dict | None = None) -> str:
    """Write spans as a Chrome-trace JSON file; returns ``path``.
    ``loop_profiles`` adds per-silo loop-occupancy counter tracks
    (``{silo: profile["windows"]}``) beside the span rows.

    One-liner for a test cluster::

        cluster.export_trace("/tmp/trace.json")   # → ui.perfetto.dev
    """
    payload = {"traceEvents": chrome_trace_events(spans, loop_profiles),
               "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


# ---------------------------------------------------------------------------
# OTLP/HTTP streaming sink
# ---------------------------------------------------------------------------

# our span kinds → OTLP SpanKind enum (opentelemetry-proto trace.proto):
# 1=INTERNAL, 2=SERVER, 3=CLIENT
_OTLP_KIND = {"client": 3, "directory": 3, "server": 2}


def _otlp_value(v) -> dict:
    """One attribute value in the OTLP JSON AnyValue encoding."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}  # proto-JSON carries int64 as string
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _otlp_attrs(attrs: dict) -> list[dict]:
    return [{"key": k, "value": _otlp_value(v)} for k, v in attrs.items()]


def spans_to_otlp(span_dicts, service_name: str = "orleans_tpu") -> dict:
    """Convert ``Span.to_dict`` forms into one OTLP/HTTP JSON
    ``ExportTraceServiceRequest``. Our 63-bit ids zero-pad into OTLP's
    128-bit trace / 64-bit span hex ids; ``error`` attrs map to status
    ERROR; span events carry through as OTLP span events. The silo name
    rides per span (``orleans.silo``) because one batch can merge legs
    pulled from several silos, while the resource names the exporting
    process."""
    out_spans = []
    for s in span_dicts:
        attrs = dict(s.get("attrs") or {})
        err = attrs.pop("error", None)
        span = {
            "traceId": f"{s['trace_id']:032x}",
            "spanId": f"{s['span_id']:016x}",
            "name": s["name"],
            "kind": _OTLP_KIND.get(s["kind"], 1),
            "startTimeUnixNano": str(int(s["start"] * 1e9)),
            "endTimeUnixNano": str(
                int((s["start"] + s.get("duration", 0.0)) * 1e9)),
            "attributes": _otlp_attrs(attrs) + [
                {"key": "orleans.silo",
                 "value": {"stringValue": s.get("silo") or "?"}},
                {"key": "orleans.kind",
                 "value": {"stringValue": s["kind"]}},
            ],
            "status": ({"code": 2, "message": str(err)}
                       if err is not None else {}),
        }
        if s.get("parent_id"):
            span["parentSpanId"] = f"{s['parent_id']:016x}"
        links = s.get("links")
        if links:
            # span links (timer/reminder/stream arming context): OTLP
            # carries causality to the arming trace without merging them
            span["links"] = [{"traceId": f"{int(lt):032x}",
                              "spanId": f"{int(ls):016x}"}
                             for lt, ls in links]
        events = s.get("events")
        if events:
            span["events"] = [
                {"timeUnixNano": str(int(ts * 1e9)), "name": name,
                 "attributes": _otlp_attrs(ev_attrs or {})}
                for name, ts, ev_attrs in events]
        out_spans.append(span)
    return {"resourceSpans": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": service_name}}]},
        "scopeSpans": [{
            "scope": {"name": "orleans_tpu.observability.tracing"},
            "spans": out_spans,
        }],
    }]}


# ---------------------------------------------------------------------------
# OTLP protobuf wire encoding (opt-in; encoding="protobuf")
# ---------------------------------------------------------------------------
# Hand-assembled protobuf wire format over the SAME dicts the JSON
# mapping produces (spans_to_otlp / snapshots_to_otlp_metrics output):
# proto-JSON field names map 1:1 onto opentelemetry-proto field numbers,
# so one canonical builder feeds both encodings and they cannot drift.
# Only the shapes we emit are encoded (string/bool/int/double attrs,
# spans with events/links/status, gauge/sum/histogram metrics).

def _pb_varint(n: int) -> bytes:
    n &= 0xFFFFFFFFFFFFFFFF  # two's-complement int64, like the proto wire
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_key(field: int, wire: int) -> bytes:
    return _pb_varint((field << 3) | wire)


def _pb_len(field: int, payload: bytes) -> bytes:
    return _pb_key(field, 2) + _pb_varint(len(payload)) + payload


def _pb_str(field: int, s) -> bytes:
    return _pb_len(field, s.encode() if isinstance(s, str) else bytes(s))


def _pb_u64(field: int, n) -> bytes:
    return _pb_key(field, 0) + _pb_varint(int(n))


def _pb_fixed64(field: int, n) -> bytes:
    return _pb_key(field, 1) + struct.pack("<Q",
                                           int(n) & 0xFFFFFFFFFFFFFFFF)


def _pb_sfixed64(field: int, n) -> bytes:
    return _pb_key(field, 1) + struct.pack("<q", int(n))


def _pb_double(field: int, v) -> bytes:
    return _pb_key(field, 1) + struct.pack("<d", float(v))


def _pb_anyvalue(v: dict) -> bytes:
    if "stringValue" in v:
        return _pb_str(1, v["stringValue"])
    if "boolValue" in v:
        return _pb_u64(2, 1 if v["boolValue"] else 0)
    if "intValue" in v:
        return _pb_u64(3, int(v["intValue"]))
    if "doubleValue" in v:
        return _pb_double(4, v["doubleValue"])
    return _pb_str(1, str(v))


def _pb_attrs(field: int, attrs) -> bytes:
    return b"".join(
        _pb_len(field, _pb_str(1, kv["key"]) +
                _pb_len(2, _pb_anyvalue(kv["value"])))
        for kv in attrs or ())


def _pb_span(s: dict) -> bytes:
    out = _pb_str(1, bytes.fromhex(s["traceId"]))
    out += _pb_str(2, bytes.fromhex(s["spanId"]))
    if s.get("parentSpanId"):
        out += _pb_str(4, bytes.fromhex(s["parentSpanId"]))
    out += _pb_str(5, s["name"])
    out += _pb_u64(6, s.get("kind", 1))
    out += _pb_fixed64(7, int(s["startTimeUnixNano"]))
    out += _pb_fixed64(8, int(s["endTimeUnixNano"]))
    out += _pb_attrs(9, s.get("attributes"))
    for ev in s.get("events") or ():
        out += _pb_len(11, _pb_fixed64(1, int(ev["timeUnixNano"])) +
                       _pb_str(2, ev["name"]) +
                       _pb_attrs(3, ev.get("attributes")))
    for ln in s.get("links") or ():
        out += _pb_len(13, _pb_str(1, bytes.fromhex(ln["traceId"])) +
                       _pb_str(2, bytes.fromhex(ln["spanId"])))
    status = s.get("status")
    if status:
        body = b""
        if status.get("message"):
            body += _pb_str(2, status["message"])
        if status.get("code"):
            body += _pb_u64(3, status["code"])
        out += _pb_len(15, body)
    return out


def otlp_trace_protobuf(req: dict) -> bytes:
    """An ``ExportTraceServiceRequest`` JSON-mapping dict
    (:func:`spans_to_otlp` output) as protobuf wire bytes."""
    out = b""
    for rs in req.get("resourceSpans", ()):
        body = _pb_len(1, _pb_attrs(
            1, rs.get("resource", {}).get("attributes")))
        for ss in rs.get("scopeSpans", ()):
            sbody = _pb_len(1, _pb_str(1, ss.get("scope",
                                                 {}).get("name", "")))
            for sp in ss.get("spans", ()):
                sbody += _pb_len(2, _pb_span(sp))
            body += _pb_len(2, sbody)
        out += _pb_len(1, body)
    return out


def _pb_number_point(dp: dict) -> bytes:
    out = _pb_fixed64(3, int(dp["timeUnixNano"]))
    if "asDouble" in dp:
        out += _pb_double(4, dp["asDouble"])
    if "asInt" in dp:
        out += _pb_sfixed64(6, int(dp["asInt"]))
    out += _pb_attrs(7, dp.get("attributes"))
    return out


def _pb_hist_point(dp: dict) -> bytes:
    out = _pb_fixed64(3, int(dp["timeUnixNano"]))
    out += _pb_fixed64(4, int(dp["count"]))
    out += _pb_double(5, dp.get("sum", 0.0))
    counts = dp.get("bucketCounts") or ()
    if counts:  # packed repeated fixed64
        out += _pb_len(6, b"".join(struct.pack("<Q", int(c))
                                   for c in counts))
    bounds = dp.get("explicitBounds") or ()
    if bounds:  # packed repeated double
        out += _pb_len(7, b"".join(struct.pack("<d", float(b))
                                   for b in bounds))
    out += _pb_attrs(9, dp.get("attributes"))
    return out


def _pb_metric(m: dict) -> bytes:
    out = _pb_str(1, m["name"])
    if "gauge" in m:
        out += _pb_len(5, b"".join(
            _pb_len(1, _pb_number_point(dp))
            for dp in m["gauge"]["dataPoints"]))
    elif "sum" in m:
        s = m["sum"]
        body = b"".join(_pb_len(1, _pb_number_point(dp))
                        for dp in s["dataPoints"])
        body += _pb_u64(2, s.get("aggregationTemporality", 2))
        body += _pb_u64(3, 1 if s.get("isMonotonic") else 0)
        out += _pb_len(7, body)
    elif "histogram" in m:
        h = m["histogram"]
        body = b"".join(_pb_len(1, _pb_hist_point(dp))
                        for dp in h["dataPoints"])
        body += _pb_u64(2, h.get("aggregationTemporality", 2))
        out += _pb_len(9, body)
    return out


def otlp_metrics_protobuf(req: dict) -> bytes:
    """An ``ExportMetricsServiceRequest`` JSON-mapping dict
    (:func:`snapshots_to_otlp_metrics` output) as protobuf wire bytes."""
    out = b""
    for rm in req.get("resourceMetrics", ()):
        body = _pb_len(1, _pb_attrs(
            1, rm.get("resource", {}).get("attributes")))
        for sm in rm.get("scopeMetrics", ()):
            sbody = _pb_len(1, _pb_str(1, sm.get("scope",
                                                 {}).get("name", "")))
            for m in sm.get("metrics", ()):
                sbody += _pb_len(2, _pb_metric(m))
            body += _pb_len(2, sbody)
        out += _pb_len(1, body)
    return out


class _OtlpHttpSink:
    """Shared OTLP/HTTP export machinery with the OTel-collector queue
    discipline: bounded buffer (overflow drops oldest + counts), batches
    of ``batch_size`` flushed every ``flush_interval`` seconds or as soon
    as a full batch accumulates, per-batch retry with exponential backoff,
    and give-up-drop when the collector stays unreachable. The POST runs
    in a thread executor so the event loop never blocks on the socket.

    Subclasses provide :meth:`_encode` mapping one batch of queued items
    to the request body — :class:`OtlpSink` ships span dicts as an
    ``ExportTraceServiceRequest``, :class:`OtlpMetricsSink` ships stats
    snapshots as an ``ExportMetricsServiceRequest``. Everything else
    (queue bounds, flusher task, retry/backoff, teardown fast-drop,
    counters) is identical by construction."""

    def __init__(self, endpoint: str, *, service_name: str = "orleans_tpu",
                 batch_size: int = 64, flush_interval: float = 0.5,
                 max_queue: int = 2048, max_retries: int = 2,
                 retry_backoff: float = 0.05, timeout: float = 2.0,
                 encoding: str = "json"):
        if encoding not in ("json", "protobuf"):
            raise ValueError(f"OTLP encoding must be 'json' or 'protobuf', "
                             f"got {encoding!r}")
        if encoding == "protobuf" and not _HAS_PROTOBUF:
            # degrade, don't die: the binary encoding is an optimization,
            # and a silo must come up identically in a slimmer image
            log.warning("OTLP protobuf encoding requested but "
                        "google.protobuf is not importable; using JSON")
            encoding = "json"
        self.encoding = encoding
        self.content_type = ("application/x-protobuf"
                             if encoding == "protobuf"
                             else "application/json")
        self.endpoint = endpoint
        self.service_name = service_name
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.max_queue = max_queue
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.timeout = timeout
        self._q: deque[dict] = deque()
        self._task: asyncio.Task | None = None
        self._wake: asyncio.Event | None = None
        self._closing = False
        self.exported = 0          # spans shipped
        self.exported_batches = 0  # successful POSTs
        self.dropped = 0           # spans given up on (overflow/unreachable)
        self.retries = 0           # retry attempts (observability of flap)

    def _encode(self, batch: list[dict]) -> bytes:  # pragma: no cover
        raise NotImplementedError

    # -- producer side (called by SpanCollector, sync, hot-ish path) ------
    def offer(self, span_dicts) -> None:
        q = self._q
        for d in span_dicts:
            if len(q) >= self.max_queue:
                q.popleft()
                self.dropped += 1
            q.append(d)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (sync tests): spans wait for an explicit flush
        if self._task is None or self._task.done():
            self._task = loop.create_task(self._run())
        if self._wake is not None and len(q) >= self.batch_size:
            self._wake.set()

    # -- flusher -----------------------------------------------------------
    async def _run(self) -> None:
        from .profiling import mark_loop_category
        mark_loop_category("observability")  # flusher steps are our tax
        self._wake = wake = asyncio.Event()
        try:
            while self._q:
                try:
                    await asyncio.wait_for(wake.wait(), self.flush_interval)
                except asyncio.TimeoutError:
                    pass
                wake.clear()
                await self.flush()
        finally:
            self._wake = None

    async def flush(self) -> None:
        """Ship everything queued, one bounded batch at a time."""
        q = self._q
        while q:
            n = min(len(q), self.batch_size)
            batch = [q.popleft() for _ in range(n)]
            if await self._send(batch):
                self.exported += n
                self.exported_batches += 1
            else:
                self.dropped += n
                if self._closing:
                    # teardown with an unreachable collector: one failed
                    # probe is enough evidence — drop the rest instead of
                    # paying the timeout per batch (silo.stop must not
                    # hang minutes on a dead exporter)
                    self.dropped += len(q)
                    q.clear()

    async def _send(self, batch: list[dict]) -> bool:
        body = self._encode(batch)
        loop = asyncio.get_running_loop()
        attempts = 1 if self._closing else self.max_retries + 1
        for attempt in range(attempts):
            try:
                await loop.run_in_executor(None, self._post, body)
                return True
            except Exception as e:  # noqa: BLE001 — collector flap/absence
                if attempt + 1 >= attempts:
                    log.debug("OTLP export to %s failed after %d attempts: "
                              "%s", self.endpoint, attempt + 1, e)
                    return False
                self.retries += 1
                await asyncio.sleep(self.retry_backoff * (2 ** attempt))
        return False

    def _post(self, body: bytes) -> None:
        # sync on purpose: runs in the executor thread, never on the loop
        req = urllib.request.Request(
            self.endpoint, data=body,
            headers={"Content-Type": self.content_type})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            if resp.status >= 400:  # urlopen raises on most, belt+braces
                raise urllib.error.HTTPError(
                    self.endpoint, resp.status, "collector rejected batch",
                    resp.headers, None)

    async def aclose(self, flush: bool = True) -> None:
        self._closing = True  # single-attempt sends + drop-on-first-failure
        if flush and self._q:
            try:
                await self.flush()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
        t = self._task
        if t is not None and not t.done():
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._task = None

    def stats(self) -> dict:
        return {"exported": self.exported,
                "export_batches": self.exported_batches,
                "export_dropped": self.dropped,
                "export_retries": self.retries,
                "queued": len(self._q)}


class OtlpSink(_OtlpHttpSink):
    """Streaming OTLP/HTTP *trace* exporter. Attach to a collector:
    ``collector.sinks.append(OtlpSink(endpoint))`` — or let the silo wire
    it from ``trace_otlp_endpoint``."""

    def _encode(self, batch: list[dict]) -> bytes:
        req = spans_to_otlp(batch, self.service_name)
        if self.encoding == "protobuf":
            return otlp_trace_protobuf(req)
        return json.dumps(req).encode()


# ---------------------------------------------------------------------------
# OTLP metrics export
# ---------------------------------------------------------------------------

def _metric_points(snapshot: dict) -> list[dict]:
    """One silo's ``StatsRegistry.snapshot()`` → OTLP metric objects.
    Counters become cumulative monotonic sums, gauges become gauges,
    histograms become OTLP histograms carrying the registry's native
    bucket bounds (so the collector sees the same quantile substrate the
    Prometheus endpoint serves)."""
    from .stats import Histogram

    ts = str(int(snapshot.get("ts", 0.0) * 1e9))
    attrs = []
    silo = snapshot.get("silo")
    if silo:
        attrs = [{"key": "orleans.silo", "value": {"stringValue": silo}}]
    metrics: list[dict] = []
    for name, v in snapshot.get("counters", {}).items():
        metrics.append({"name": name, "sum": {
            "dataPoints": [{"asInt": str(int(v)), "timeUnixNano": ts,
                            "attributes": attrs}],
            "aggregationTemporality": 2,  # CUMULATIVE
            "isMonotonic": True}})
    for name, v in snapshot.get("gauges", {}).items():
        metrics.append({"name": name, "gauge": {
            "dataPoints": [{"asDouble": float(v), "timeUnixNano": ts,
                            "attributes": attrs}]}})
    for name, snap in snapshot.get("histograms", {}).items():
        h = Histogram.from_snapshot(snap)
        # explicitBounds excludes the terminal +Inf bucket (OTLP carries
        # len(bounds)+1 bucketCounts)
        bounds = [b for b in h.bounds if b != float("inf")]
        metrics.append({"name": name, "histogram": {
            "dataPoints": [{"timeUnixNano": ts, "attributes": attrs,
                            "count": str(h.total), "sum": h.sum,
                            "bucketCounts": [str(c) for c in h.counts],
                            "explicitBounds": bounds}],
            "aggregationTemporality": 2}})
    return metrics


def snapshots_to_otlp_metrics(snapshots,
                              service_name: str = "orleans_tpu") -> dict:
    """Convert stats snapshots (``StatsRegistry.snapshot()`` dicts, each
    optionally carrying a ``silo`` name) into one OTLP/HTTP JSON
    ``ExportMetricsServiceRequest``. The silo rides per data point
    (``orleans.silo``) because one batch can merge several silos'
    snapshots, while the resource names the exporting process — the same
    split :func:`spans_to_otlp` uses."""
    metrics: list[dict] = []
    for snap in snapshots:
        metrics.extend(_metric_points(snap))
    return {"resourceMetrics": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": service_name}}]},
        "scopeMetrics": [{
            "scope": {"name": "orleans_tpu.observability.metrics"},
            "metrics": metrics,
        }],
    }]}


class OtlpMetricsSink(_OtlpHttpSink):
    """Streaming OTLP/HTTP *metrics* exporter: queued items are full
    registry snapshots (the MetricsSampler offers one per push period),
    so batches stay small — same bounded-queue/retry/drop discipline as
    the span sink, tuned for snapshot-sized payloads."""

    def __init__(self, endpoint: str, *, service_name: str = "orleans_tpu",
                 batch_size: int = 4, flush_interval: float = 1.0,
                 max_queue: int = 64, max_retries: int = 2,
                 retry_backoff: float = 0.05, timeout: float = 2.0,
                 encoding: str = "json"):
        super().__init__(endpoint, service_name=service_name,
                         batch_size=batch_size,
                         flush_interval=flush_interval,
                         max_queue=max_queue, max_retries=max_retries,
                         retry_backoff=retry_backoff, timeout=timeout,
                         encoding=encoding)

    def _encode(self, batch: list[dict]) -> bytes:
        req = snapshots_to_otlp_metrics(batch, self.service_name)
        if self.encoding == "protobuf":
            return otlp_metrics_protobuf(req)
        return json.dumps(req).encode()
