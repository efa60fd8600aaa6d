"""End-to-end distributed request tracing (L13).

The reference's tracing story is ActivityId correlation riding message
headers plus hot-path counters (SURVEY §5 "Tracing / profiling" —
RequestContext carries the ActivityId; Message.DebugContext stamps hops).
This module grows that into a W3C-style trace/span model:

* a **trace context** ``(trace_id, parent_span_id, sent_at)`` rides the
  existing ``RequestContext`` message headers under :data:`TRACE_KEY`, so
  one logical request keeps one ``trace_id`` across silo hops, forwarded
  (post-migration) hops, directory RPCs, and device-tier ticks;
* spans are opened automatically at the call sites the runtime owns —
  client invoke (``runtime_client``), server turn with queue-wait vs.
  execution split (``runtime/dispatcher``), the network leg (stamped
  send-side, measured receive-side), directory lookups
  (``directory/locator``), device ticks (``dispatch/engine``), and
  rebalance migration legs (``rebalance/executor``, not ported);
* a per-silo :class:`SpanCollector` ring buffer holds finished spans with
  a head-based sampling knob (``config.TracingOptions`` /
  ``trace_sample_rate``): the ROOT of a trace rolls the sampling die once
  and unsampled requests carry no header and record nothing downstream —
  at ``sample_rate=0`` the hot path pays one attribute check per call
  (guarded by ``tests/test_perf_floors.py::test_floor_trace_overhead``).

Consumers: the management surface (``SiloControl.ctl_trace_spans`` +
``ManagementGrain.get_trace_breakdown``) for cluster-wide critical-path
queries, and the JAX package's ``observability.export`` for
Chrome-trace/Perfetto timeline files merging every silo of a cluster
(not ported).

**Tail-based retention** (the Dapper/OTel-collector tail-sampling stage):
head sampling decides what gets *recorded*; in tail mode
(``TracingOptions.tail_enabled``) the keep/drop decision is deferred until
the trace is *complete*. Closed spans buffer per-trace in a bounded
pending map; when the ROOT span closes the trace enters a quiescence
window (``tail_window``) so straggler legs — response network spans,
device ticks — still join, then a pluggable :class:`RetentionPolicy`
keeps only traces that are slow (absolute or percentile threshold),
errored, or explicitly force-retained. Kept traces promote into the
retained ring buffer (what ``snapshot``/``ctl_trace_spans``/export see)
and stream to any attached sinks (:class:`~.export.OtlpSink`); dropped
traces just bump a counter. Legs of a trace rooted *elsewhere* (a remote
silo holds only server/network spans) are buffered too: the rooting
collector pulls them at retention time through ``remote_fetcher`` (the
silo wires the ``ctl_trace_spans`` control path there), which promotes
them on the remote side via :meth:`SpanCollector.pull`; un-pulled legs
expire after ``leg_ttl`` and count dropped.

Span ``start`` times are wall-clock (``time.time()``) so spans from
different silos/processes merge onto one timeline; durations are measured
with the monotonic clock.

The port's copy of ``orleans_tpu.observability.tracing``.
"""

from __future__ import annotations

import asyncio
import bisect
import contextvars
import logging
import random
import time
from collections import deque

__all__ = [
    "TRACE_KEY", "Span", "SpanCollector", "current_trace",
    "new_trace_id", "new_span_id", "critical_path_breakdown",
    "RetentionPolicy", "LatencyErrorPolicy", "span_from_dict",
    "mark_remote_if_traced", "arm_root_link", "pending_root_link",
]

log = logging.getLogger("orleans.tracing")

# RequestContext/message-header key the trace context rides under (the
# ActivityId header analog): (trace_id, parent_span_id, sent_at_wall).
# Present if and only if the trace is sampled — head-based sampling.
TRACE_KEY = "orleans.trace"

# The span context ambient to the running turn/callsite: (trace_id,
# span_id) of the span any nested outgoing call should parent under.
# None outside sampled traces (the common case — one ContextVar.get on
# the send path is the whole cost of disabled tracing there).
current_trace: contextvars.ContextVar[tuple[int, int] | None] = (
    contextvars.ContextVar("orleans_current_trace", default=None)
)

# The arming context for deferred work (span links): a timer/reminder/
# stream registration that happens inside a traced turn records
# (trace_id, span_id) here before the deferred callback runs; when that
# callback's outgoing calls ROOT a fresh trace, the new root carries the
# arming context as a span LINK — Perfetto/OTLP show causality without
# merging the two traces. None (the default) everywhere else: roots of
# ordinary client calls pay one ContextVar.get.
pending_root_link: contextvars.ContextVar[tuple[int, int] | None] = (
    contextvars.ContextVar("orleans_pending_root_link", default=None)
)


def arm_root_link(link: tuple[int, int] | None) -> None:
    """Declare the arming context for work the CURRENT task triggers:
    new roots opened downstream link back to ``link``. Pass None to
    clear (e.g. a stream pump switching to an unlinked subscription)."""
    pending_root_link.set(link)

# span kinds a collector records; critical_path_breakdown buckets by these
# ("event" is the zero-duration annotation kind — rejections, forward hops —
# which the breakdown deliberately ignores; "ring" is the shm staging/
# response ring dwell between a worker process and the device owner —
# network-style, stamped push-side and observed pop-side, but bucketed
# separately so the cross-process hop is attributable on its own)
SPAN_KINDS = ("client", "server", "network", "directory", "device",
              "device_tick", "migration", "ring", "event")


def new_trace_id() -> int:
    """63-bit random id (unique across silos without coordination)."""
    return random.getrandbits(63) or 1


def new_span_id() -> int:
    return random.getrandbits(63) or 1


class Span:
    """One timed operation. ``start`` is wall-clock seconds; ``duration``
    is a monotonic-clock delta (set by :meth:`SpanCollector.close`)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind",
                 "silo", "start", "duration", "attrs", "events", "links",
                 "_t0")

    def __init__(self, trace_id: int, span_id: int, parent_id: int | None,
                 name: str, kind: str, silo: str, start: float,
                 duration: float = 0.0, attrs: dict | None = None,
                 events: list | None = None,
                 links: list | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.silo = silo
        self.start = start
        self.duration = duration
        self.attrs = attrs
        self.events = events
        # span links: [(trace_id, span_id), ...] — causal references to
        # OTHER traces (the arming context of timer/reminder/stream-
        # triggered roots). None for the common unlinked span.
        self.links = links
        self._t0 = 0.0

    def add_event(self, name: str, **attrs) -> None:
        """Timestamped annotation on a still-open span (the OTel span-event
        analog): rejections, transient resends, forward hops. Wall-clock
        stamped so events line up with span starts on a merged timeline."""
        if self.events is None:
            self.events = []
        self.events.append([name, time.time(), attrs])

    def to_dict(self) -> dict:
        """Wire/JSON form (what ``ctl_trace_spans`` and the exporter see).
        ``events`` appears only when present, keeping the common shape —
        and the socket-wire payload — unchanged for event-less spans."""
        d = {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "kind": self.kind, "silo": self.silo, "start": self.start,
            "duration": self.duration, "attrs": self.attrs or {},
        }
        if self.events:
            d["events"] = self.events
        if self.links:
            d["links"] = [list(lk) for lk in self.links]
        return d

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"<Span {self.kind} {self.name!r} {self.duration * 1e3:.3f}ms"
                f" trace={self.trace_id:x}>")


def span_from_dict(d: dict) -> Span:
    """Rehydrate a ``to_dict`` form (remote legs pulled over the control
    path arrive as dicts) back into a :class:`Span`."""
    return Span(d["trace_id"], d["span_id"], d.get("parent_id"),
                d["name"], d["kind"], d.get("silo") or "?",
                d["start"], d.get("duration", 0.0),
                dict(d.get("attrs") or {}) or None,
                list(d["events"]) if d.get("events") else None,
                [tuple(lk) for lk in d["links"]]
                if d.get("links") else None)


class RetentionPolicy:
    """Tail keep/drop decision over one completed trace. ``decide``
    receives the pending-trace record (``spans``, ``root``, ``error``)
    and returns ``(keep, reason)``; errored/forced traces are retained by
    the collector before the policy runs, so a policy only has to answer
    "is this trace interesting on latency grounds"."""

    def decide(self, trace: "_PendingTrace") -> tuple[bool, str | None]:
        raise NotImplementedError


class LatencyErrorPolicy(RetentionPolicy):
    """Default policy: keep traces whose root latency exceeds an absolute
    threshold (``slow_threshold`` seconds; <=0 disables) or a percentile
    of recently completed root latencies (``slow_percentile`` in (0,1);
    0 disables; needs a small warm-up history before it fires). A trace
    with no root span locally is never slow by this policy — only the
    rooting collector sees the full round trip.

    ``auto=True`` (the ``trace_tail_auto`` knob): ``slow_threshold``
    self-tunes from the same root-duration history — each decision damps
    the threshold toward the ``slow_percentile`` cut (default 0.95 when
    unset), so a workload whose baseline latency drifts keeps retaining
    roughly the slowest ``1-p`` fraction instead of whatever a hand-set
    absolute threshold happens to straddle. Until the history warms
    (``_MIN_HISTORY`` roots) the configured static threshold applies
    unchanged; retention in auto mode is strictly-above so a uniform
    workload converges to retaining nothing, not everything."""

    _AUTO_PERCENTILE = 0.95  # default cut when slow_percentile unset
    _AUTO_DAMPING = 0.2      # per-decision step toward the current cut

    def __init__(self, slow_threshold: float = 0.1,
                 slow_percentile: float = 0.0, history: int = 512,
                 auto: bool = False):
        self.slow_threshold = slow_threshold
        self.slow_percentile = slow_percentile
        self.auto = auto
        self._durations: deque[float] = deque(maxlen=history)
        self._ranked: list[float] = []  # sorted twin, maintained via bisect

    _MIN_HISTORY = 16  # percentile over fewer samples is noise

    def _observe(self, dur: float) -> None:
        # maintained sorted twin: one insort + one bisect-delete per
        # trace instead of re-sorting the whole history each decision
        if len(self._durations) == self._durations.maxlen:
            old = self._durations.popleft()
            del self._ranked[bisect.bisect_left(self._ranked, old)]
        self._durations.append(dur)
        bisect.insort(self._ranked, dur)

    def decide(self, trace: "_PendingTrace") -> tuple[bool, str | None]:
        root = trace.root
        if root is None:
            return False, None
        dur = root.duration
        if self.auto:
            self._observe(dur)
            n = len(self._ranked)
            if n >= self._MIN_HISTORY:
                p = self.slow_percentile or self._AUTO_PERCENTILE
                cut = self._ranked[min(n - 1, int(p * n))]
                t = self.slow_threshold
                self.slow_threshold = cut if t <= 0 else \
                    t + self._AUTO_DAMPING * (cut - t)
            # strictly above: the threshold converges onto the cut, and a
            # uniform workload (dur == cut) must not tail-retain everything
            if self.slow_threshold > 0 and dur > self.slow_threshold:
                return True, "slow_auto"
            return False, None
        if self.slow_threshold > 0 and dur >= self.slow_threshold:
            return True, "slow"
        p = self.slow_percentile
        if p > 0:
            self._observe(dur)
            n = len(self._ranked)
            if n >= self._MIN_HISTORY:
                cut = self._ranked[min(n - 1, int(p * n))]
                # strictly above: a uniform workload (every duration equal
                # to the cut) must not tail-retain everything
                if dur > cut:
                    return True, "slow_pctl"
        return False, None


class _PendingTrace:
    """Spans of one not-yet-decided trace buffered in tail mode."""

    __slots__ = ("spans", "root", "root_closed_mono", "last_mono",
                 "error", "force", "remote")

    def __init__(self, now: float):
        self.spans: list[Span] = []
        self.root: Span | None = None
        self.root_closed_mono: float | None = None
        self.last_mono = now
        self.error = False
        self.force = False
        # "went remote" hint (mark_remote): any leg of this trace left the
        # local process, so retention must pull peers before export. False
        # = provably silo-local — the ctl_trace_spans fan-out is skipped.
        self.remote = False


class SpanCollector:
    """Per-silo (or per-client) span sink: bounded ring buffer + the
    head-based sampling decision. Cheap enough for the hot path — an
    unsampled call never reaches it, and a sampled span costs two clock
    reads, one random id, and a deque append (plus, in tail mode, one
    dict get and a list append into the pending buffer)."""

    def __init__(self, name: str, sample_rate: float = 1.0,
                 buffer_size: int = 4096, *, tail: bool = False,
                 tail_window: float = 0.25,
                 policy: RetentionPolicy | None = None,
                 leg_ttl: float = 2.0, max_pending: int = 256):
        self.name = name
        self.sample_rate = sample_rate
        self.spans: deque[Span] = deque(maxlen=buffer_size)
        # synthetic trace grouping device ticks not tied to one request
        self.device_trace_id = new_trace_id()
        # one-shot pre-rolled head-sampling decision (the hot lane rolls
        # the die itself and hands the outcome to the messaging path so
        # the rate is never squared nor doubled): None = not rolled,
        # True/False = rolled, consume instead of re-rolling
        self.presampled: bool | None = None
        # -- tail-based retention (off: none of this is touched) ----------
        self.tail = tail
        self.tail_window = tail_window
        self.policy = policy or LatencyErrorPolicy()
        self.leg_ttl = leg_ttl
        self.max_pending = max_pending
        self.pending: dict[int, _PendingTrace] = {}
        # streaming exporters (export.OtlpSink shape: offer/flush/aclose)
        self.sinks: list = []
        # async ``fetch(trace_id) -> list[span dict]`` pulling remote legs
        # of a trace this collector retained (silo: ctl_trace_spans fan-out)
        self.remote_fetcher = None
        # ``fn(root_span | None, reason)`` called once per RETAINED trace
        # before export — the silo wires the flight recorder here so a
        # tail-retained slow trace snapshots the loop-occupancy ring it
        # was slow IN (and may stamp attrs on the root before it ships)
        self.on_retain = None
        self._ret = {"kept": 0, "dropped": 0, "pulled": 0,
                     "pull_skipped": 0}
        # insertion-ordered so the bound evicts the OLDEST pin, not all
        self._forced: dict[int, None] = {}
        # "went remote" hints for traces with no pending entry yet (the
        # root span usually closes LAST, after the outbound send that
        # proves remoteness) — bounded, oldest-evicted like _forced
        self._remote_hints: dict[int, None] = {}
        self._tasks: set = set()
        self._sweeper = None
        self._pump_at = 0.0

    # -- sampling (root decision; propagated via header presence) --------
    def sample(self) -> bool:
        r = self.sample_rate
        if r >= 1.0:
            return True
        if r <= 0.0:
            return False
        return random.random() < r

    def consume_head_roll(self) -> bool:
        """The root sampling decision, honoring a die already rolled by
        the hot lane this same synchronous step (see ``presampled``)."""
        p = self.presampled
        if p is not None:
            self.presampled = None
            return p
        return self.sample()

    def new_trace_id(self) -> int:
        return new_trace_id()

    # -- span lifecycle ---------------------------------------------------
    def open(self, name: str, kind: str, trace_id: int,
             parent_id: int | None) -> Span:
        span = Span(trace_id, new_span_id(), parent_id, name, kind,
                    self.name, time.time())
        span._t0 = time.monotonic()
        return span

    def close(self, span: Span, duration: float | None = None,
              **attrs) -> Span:
        span.duration = (time.monotonic() - span._t0
                         if duration is None else duration)
        if attrs:
            span.attrs = attrs
        self._ingest(span)
        return span

    def record(self, trace_id: int, parent_id: int | None, name: str,
               kind: str, start: float, duration: float, **attrs) -> Span:
        """Record a span whose timing was measured externally (e.g. the
        network leg: stamped send-side, observed receive-side)."""
        span = Span(trace_id, new_span_id(), parent_id, name, kind,
                    self.name, start, max(0.0, duration), attrs or None)
        self._ingest(span)
        return span

    def event(self, trace_id: int, parent_id: int | None, name: str,
              **attrs) -> Span:
        """Zero-duration annotation span (kind ``event``) for call sites
        that only know the trace/span IDS of the active invoke span, not
        the Span object — dispatcher-side rejections and forward hops.
        Parents under the given span so it lands inside the invoke/turn
        in the trace tree; the critical-path breakdown ignores it."""
        return self.record(trace_id, parent_id, name, "event",
                           time.time(), 0.0, **attrs)

    # span-count bound per pending trace: a "trace" accumulating more was
    # never going to be a useful retention unit (and an unbounded spans
    # list is a memory hazard) — drop the whole entry, count it
    _MAX_TRACE_SPANS = 1024

    # -- tail retention stage ---------------------------------------------
    def _ingest(self, span: Span) -> None:
        if not self.tail or span.trace_id == self.device_trace_id:
            # the synthetic device-tick trace bypasses the tail stage even
            # in tail mode: its parent-less tick spans arrive forever (each
            # would re-arm the quiescence window, so the pending entry
            # could never finalize and would grow without bound) and tick
            # telemetry is not a request whose tail matters — it lands in
            # the bounded ring. Deliberately NOT offered to sinks in tail
            # mode (head mode streams every span): tail exists to cut
            # export volume, and full-rate tick telemetry would flood the
            # collector; the ring/management surface still serves it.
            self.spans.append(span)
            if self.sinks and not self.tail:
                d = (span.to_dict(),)
                for s in self.sinks:
                    s.offer(d)
            return
        now = time.monotonic()
        e = self.pending.get(span.trace_id)
        if e is None:
            if len(self.pending) >= self.max_pending:
                # bounded memory: evict the oldest undecided trace. A
                # root-closed victim gets its tail decision NOW (window cut
                # short) — overload is exactly when the errored/slow traces
                # retention exists for show up, so they must not shed
                # undecided; leg-only victims just count dropped.
                tid = next(iter(self.pending))
                victim = self.pending.pop(tid)
                if victim.root_closed_mono is not None:
                    self._finalize(tid, victim)
                else:
                    self._ret["dropped"] += 1
            e = self.pending[span.trace_id] = _PendingTrace(now)
            if self._remote_hints.pop(span.trace_id, 0) is None:
                # a send-side hook marked this trace remote before any of
                # its spans closed locally (stored value is None; miss is 0)
                e.remote = True
        elif len(e.spans) >= self._MAX_TRACE_SPANS and \
                span.parent_id is not None:
            # cap the entry but KEEP it so the trace still gets exactly one
            # tail decision: non-root spans past the bound are discarded
            # (truncated telemetry beats unbounded memory); the root always
            # lands, or the decision/quiescence would never trigger. The
            # ERROR signal survives even when the span doesn't — a failing
            # leg past the cap must still make the trace retainable.
            e.last_mono = now
            attrs = span.attrs
            if attrs is not None and "error" in attrs:
                e.error = True
            log.debug("tail trace %x exceeded %d spans; truncating",
                      span.trace_id, self._MAX_TRACE_SPANS)
            return
        e.spans.append(span)
        e.last_mono = now
        attrs = span.attrs
        if attrs is not None and "error" in attrs:
            e.error = True
        if span.parent_id is None:
            # root closed: quiescence window starts — stragglers (response
            # network legs, device ticks) join until it elapses
            e.root = span
            e.root_closed_mono = now
        self._ensure_sweeper()
        if now >= self._pump_at:  # amortized: don't scan per span
            self._pump_at = now + max(0.02, self.tail_window / 4)
            self._pump(now)

    def _pump(self, now: float, force: bool = False,
              expire_legs: bool | None = None) -> None:
        """Finalize quiesced root-closed traces; expire never-rooted legs.
        ``force`` decides root-closed traces immediately; ``expire_legs``
        (defaults to ``force``) drops leg-only traces now — kept separate
        so a cluster-wide drain can settle every collector's roots (and
        their cross-silo pulls) BEFORE any collector expires legs a peer's
        pull still needs."""
        if expire_legs is None:
            expire_legs = force
        done: list[tuple[int, _PendingTrace]] = []
        for tid, e in self.pending.items():
            if e.root_closed_mono is not None:
                if force or now - e.root_closed_mono >= self.tail_window:
                    done.append((tid, e))
            elif expire_legs or now - e.last_mono >= self.leg_ttl:
                done.append((tid, e))
        for tid, e in done:
            del self.pending[tid]
            if e.root_closed_mono is None:
                # legs of a trace rooted elsewhere, never pulled: the
                # rooting collector dropped it (or died) — expire
                self._ret["dropped"] += 1
                self._forced.pop(tid, None)
                self._remote_hints.pop(tid, None)
                continue
            self._finalize(tid, e)

    def _finalize(self, tid: int, e: _PendingTrace) -> None:
        keep, reason = True, None
        if e.force or tid in self._forced:
            reason = "forced"
        elif e.error:
            reason = "error"
        else:
            keep, reason = self.policy.decide(e)
        self._forced.pop(tid, None)
        went_remote = e.remote or \
            self._remote_hints.pop(tid, 0) is None
        if not keep:
            self._ret["dropped"] += 1
            return
        if self.remote_fetcher is not None:
            if not went_remote:
                # silo-local trace (no leg ever left this process): every
                # span is already here — skip the ctl_trace_spans fan-out
                # to every peer, which would return nothing and cost one
                # SYSTEM RPC per silo per retained trace
                self._ret["pull_skipped"] += 1
            else:
                try:
                    loop = asyncio.get_running_loop()
                except RuntimeError:
                    loop = None
                if loop is not None:
                    t = loop.create_task(
                        self._retain_with_pull(tid, e, reason))
                    self._tasks.add(t)
                    t.add_done_callback(self._tasks.discard)
                    return
        self._commit(e.spans, (), reason, e.root)

    async def _retain_with_pull(self, tid: int, e: _PendingTrace,
                                reason: str | None) -> None:
        """Retention propagation: this collector decided to keep the
        trace, but cross-silo legs live in other collectors' pending
        buffers — pull them (ctl_trace_spans path) before committing, so
        the exported trace is whole."""
        # the task copied its creator's context — which can hold a LIVE
        # ambient trace (finalize can run from _ingest inside a traced
        # turn). The pull RPC must not join it: phantom control-path spans
        # would pollute an unrelated trace's tree. SYSTEM calls never ROOT
        # traces, but they do join ambient ones — so clear it here.
        current_trace.set(None)
        remote: list[dict] = []
        try:
            remote = list(await self.remote_fetcher(tid)) or []
        except Exception as ex:  # noqa: BLE001 — export best-effort
            log.debug("remote leg pull failed for trace %x: %s", tid, ex)
        seen = {s.span_id for s in e.spans}
        remote = [d for d in remote if d.get("span_id") not in seen]
        self._commit(e.spans, remote, reason, e.root)

    def _commit(self, spans: list[Span], remote_dicts, reason,
                root: Span | None) -> None:
        self._ret["kept"] += 1
        if reason is not None and root is not None:
            root.attrs = dict(root.attrs or {})
            root.attrs["retained"] = reason
        if self.on_retain is not None:
            # BEFORE the sink batch is built: the hook may stamp attrs on
            # the root (flight-snapshot marker) that must ride the export
            try:
                self.on_retain(root, reason)
            except Exception:  # noqa: BLE001 — a hook must not break commit
                log.exception("on_retain hook failed")
        self.spans.extend(spans)
        remote_spans = [span_from_dict(d) for d in remote_dicts]
        self.spans.extend(remote_spans)
        if self.sinks:
            batch = [s.to_dict() for s in spans] + list(remote_dicts)
            for s in self.sinks:
                s.offer(batch)

    def pull(self, trace_id: int, limit: int | None = None) -> list[dict]:
        """Remote-retention hand-off: return every span this collector
        holds for ``trace_id`` — retained ring AND pending buffer — and
        HAND OFF pending LEG-ONLY entries (legs of a trace rooted
        elsewhere: the puller decided the trace matters and becomes their
        owner of record). Handed-off legs count kept/pulled here — the
        cluster-wide decision was "keep" — but are NOT copied into this
        ring nor offered to this collector's sinks: exactly one collector
        (the pulling one) stores and exports the merged trace, so
        cluster-wide span merges never double-count. An entry rooted HERE
        is returned read-only and stays pending: its own tail decision
        (and sink export, if kept) must still run — a puller peeking at a
        live trace id must not steal it from the export path."""
        out = [s.to_dict() for s in self.spans if s.trace_id == trace_id]
        e = self.pending.get(trace_id)
        if e is not None:
            if e.root_closed_mono is None:
                del self.pending[trace_id]
                self._ret["kept"] += 1
                self._ret["pulled"] += 1
                self._forced.pop(trace_id, None)
                self._remote_hints.pop(trace_id, None)
            out.extend(s.to_dict() for s in e.spans)
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def mark_remote(self, trace_id: int) -> None:
        """Record that a leg of ``trace_id`` left this process (stamped by
        the send paths: MessageCenter egress, client transmit). Retention
        only fans ``ctl_trace_spans`` out to peers for marked traces —
        silo-local traces skip the pull entirely (``pull_skipped``)."""
        if not self.tail:
            return
        e = self.pending.get(trace_id)
        if e is not None:
            e.remote = True
            return
        if trace_id in self._remote_hints:
            return
        if len(self._remote_hints) >= 4096:
            # bounded: evict the OLDEST hint — a lost hint degrades to a
            # skipped pull (best-effort completeness), never an error
            self._remote_hints.pop(next(iter(self._remote_hints)))
        self._remote_hints[trace_id] = None

    def force_retain(self, trace_id: int) -> None:
        """Pin a trace through the tail decision regardless of policy
        (operator 'keep whatever this request does' hook)."""
        e = self.pending.get(trace_id)
        if e is not None:
            e.force = True
            return
        if len(self._forced) >= 4096:
            # bounded: evict the OLDEST pin only — clearing wholesale
            # would silently unpin every live operator hold at once
            self._forced.pop(next(iter(self._forced)))
        self._forced[trace_id] = None

    def _ensure_sweeper(self) -> None:
        s = self._sweeper
        if s is not None and not s.done():
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # loop-less (unit tests): lazy pump via _ingest/flush
        self._sweeper = loop.create_task(self._sweep())

    async def _sweep(self) -> None:
        # idle-exit loop: runs only while traces are pending; the next
        # _ingest restarts it. Period is fine-grained enough that a trace
        # finalizes within ~1.5 windows of its root closing.
        # Clear any inherited ambient trace (the task can be created from
        # inside a traced turn): pulls triggered by this sweeper must not
        # join — and permanently pin — whatever trace was live at spawn.
        current_trace.set(None)
        from .profiling import mark_loop_category
        mark_loop_category("observability")  # sweeper steps are our tax
        period = max(0.01, min(self.tail_window, self.leg_ttl) / 2)
        while self.pending:
            await asyncio.sleep(period)
            self._pump(time.monotonic())

    def flush_tail(self, force: bool = False,
                   expire_legs: bool | None = None) -> None:
        """Synchronously run the tail decision for quiesced traces
        (``force=True``: decide root-closed traces now; ``expire_legs``
        defaults to ``force`` — see :meth:`_pump`). Remote pulls still
        complete asynchronously — use :meth:`drain_tail` to await them."""
        if self.tail:
            self._pump(time.monotonic(), force=force,
                       expire_legs=expire_legs)

    async def drain_tail(self, force: bool = True,
                         expire_legs: bool | None = None) -> None:
        """Decide + commit everything pending, await in-flight pulls, and
        flush sinks — the deterministic settle point for tests/teardown."""
        self.flush_tail(force=force, expire_legs=expire_legs)
        while self._tasks:
            # snapshot-and-remove: gather over already-done tasks resolves
            # without yielding, so waiting on the discard callbacks alone
            # could spin — remove what we await ourselves
            tasks = list(self._tasks)
            self._tasks.difference_update(tasks)
            await asyncio.gather(*tasks, return_exceptions=True)
        for s in self.sinks:
            await s.flush()

    async def aclose(self, flush: bool = True) -> None:
        """Teardown: graceful (decide + export what's buffered) or abrupt
        (drop pending, cancel tasks). Sinks close either way."""
        if self.tail:
            if flush:
                await self.drain_tail(force=True)
            else:
                self.pending.clear()
                for t in list(self._tasks):
                    t.cancel()
        s = self._sweeper
        if s is not None and not s.done():
            s.cancel()
        self._sweeper = None
        for sink in self.sinks:
            await sink.aclose(flush=flush)

    def retention_stats(self) -> dict:
        """Tail/export counters (kept/dropped/pulled/buffered + sink
        exported/dropped sums) — the management-surface payload."""
        out = {
            "tail": self.tail,
            "kept": self._ret["kept"],
            "dropped": self._ret["dropped"],
            "pulled": self._ret["pulled"],
            "pull_skipped": self._ret["pull_skipped"],
            "buffered": len(self.pending),
            "retained_spans": len(self.spans),
            "exported": 0, "export_dropped": 0,
        }
        for s in self.sinks:
            st = s.stats()
            out["exported"] += st.get("exported", 0)
            out["export_dropped"] += st.get("export_dropped", 0)
        return out

    # -- reads -------------------------------------------------------------
    def snapshot(self, trace_id: int | None = None,
                 limit: int | None = None) -> list[dict]:
        spans = list(self.spans)
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
            if self.pending:
                # a specific trace's pending (undecided) legs are visible
                # read-only — diagnostics must not wait out the window
                e = self.pending.get(trace_id)
                if e is not None:
                    spans.extend(e.spans)
        if limit is not None and len(spans) > limit:
            spans = spans[-limit:]
        return [s.to_dict() for s in spans]

    def trace_ids(self) -> list[int]:
        seen: dict[int, None] = {}
        for s in self.spans:
            seen.setdefault(s.trace_id, None)
        return list(seen)

    def clear(self) -> None:
        self.spans.clear()
        self.pending.clear()
        self._remote_hints.clear()


def context_from_headers(request_context: dict | None
                         ) -> tuple[int, int, float] | None:
    """Extract ``(trace_id, parent_span_id, sent_at)`` from message
    baggage; None when the request is untraced/unsampled OR the header is
    malformed. RequestContext is app-writable, so every runtime consumer
    parses through this single hardened path — garbage baggage must never
    break a turn or drop a message, it just goes untraced."""
    if not request_context:
        return None
    hdr = request_context.get(TRACE_KEY)
    if hdr is None:
        return None
    try:
        # tolerate list-decoded tuples from portable codecs
        t, p, s = hdr
        return (int(t), int(p), float(s))
    except (TypeError, ValueError):
        return None


def mark_remote_if_traced(tracer, msg) -> None:
    """Stamp the "went remote" retention hint for a traced message about
    to leave its process — the ONE implementation behind every send-side
    hook (silo fabric egress in MessageCenter.send_message; client
    transmits in ClusterClient/GatewayClient). No-op outside tail mode
    or for untraced messages; hardened header parsing like every other
    runtime consumer of the baggage."""
    if tracer is not None and tracer.tail and msg.request_context:
        hdr = context_from_headers(msg.request_context)
        if hdr is not None:
            tracer.mark_remote(hdr[0])


def restamp_header(request_context: dict | None) -> dict | None:
    """Refresh the header's ``sent_at`` for a message leaving AGAIN
    (transparent resend, forward hop): without this the receiver's
    network span would absorb retry backoff and the previous silo's
    handling time — mis-attributing exactly the slow requests tracing
    exists to explain. Returns a new dict (headers may be shared)."""
    ctx = context_from_headers(request_context)
    if ctx is None:
        return request_context
    out = dict(request_context)
    out[TRACE_KEY] = (ctx[0], ctx[1], time.time())
    return out


# ---------------------------------------------------------------------------
# Critical-path breakdown
# ---------------------------------------------------------------------------

_BREAKDOWN_KEYS = ("queue", "exec", "network", "directory", "device",
                   "migration", "ring")


def critical_path_breakdown(spans) -> dict:
    """Where a trace's wall time went, as seconds and fractions of the
    trace extent: queue wait vs. turn execution (from server-span attrs),
    network legs, directory lookups, device ticks, and migration legs.

    ``spans``: Span objects or ``to_dict`` forms, typically one trace
    (pre-filter by trace_id) but tolerant of mixed input — the management
    grain feeds it the cluster-wide merge. Fractions can overlap (a
    directory RPC's network leg counts in both) and need not sum to 1;
    each answers "how much of the trace extent did this layer occupy".
    """
    dicts = [s if isinstance(s, dict) else s.to_dict() for s in spans]
    if not dicts:
        return {"total_s": 0.0, "span_count": 0,
                "seconds": {k: 0.0 for k in _BREAKDOWN_KEYS},
                "fractions": {k: 0.0 for k in _BREAKDOWN_KEYS}}
    t0 = min(s["start"] for s in dicts)
    t1 = max(s["start"] + s["duration"] for s in dicts)
    total = max(t1 - t0, 1e-9)
    seconds = {k: 0.0 for k in _BREAKDOWN_KEYS}
    for s in dicts:
        kind = s["kind"]
        if kind == "server":
            attrs = s.get("attrs") or {}
            seconds["queue"] += attrs.get("queue_s", 0.0)
            seconds["exec"] += attrs.get("exec_s", s["duration"])
        elif kind == "network":
            seconds["network"] += s["duration"]
        elif kind == "directory":
            seconds["directory"] += s["duration"]
        elif kind in ("device", "device_tick"):
            seconds["device"] += s["duration"]
        elif kind == "migration":
            seconds["migration"] += s["duration"]
        elif kind == "ring":
            seconds["ring"] += s["duration"]
    return {
        "total_s": total,
        "span_count": len(dicts),
        "seconds": seconds,
        "fractions": {k: min(1.0, v / total) for k, v in seconds.items()},
    }
