"""Cost-attribution ledger: who is spending this silo.

The substrate can already say that it is unhealthy (slo.py burn rates)
and where loop time goes (profiling.py occupancy) — this module says
**who**: every unit of work is charged to a (grain_class, method) row,
a hashed-key label, and a tenant, across both tiers:

* **host turns** — exec + queue-wait seconds, charged in the
  dispatcher's turn epilogue and the hot lane's inline turn;
* **device ticks** — row-seconds per class (rows_in_batch × tick wall),
  charged at the engine's batch epilogue, with the per-slot twin
  accumulated ON DEVICE next to the table's hit counters
  (``ShardedActorTable.record_cost``) and folded by
  ``ops.segment_reduce.masked_reduce``;
* **wire bytes** — in/out per route, charged where sizes are already
  measured (ingress pumps, egress senders, client writes);
* **stream deliveries** — the device stream provider's pump.

**Bounded by construction.** Exact totals are kept only per
(grain_class, method) row (capped, CallSiteStats-style overflow
counter); the per-key and per-tenant dimensions ride space-saving
top-K sketches (Metwally et al.: evicting the min entry charges its
count to the newcomer as ``err``), so a million-actor silo costs O(K)
memory and the cluster merge is a deterministic flat fold.

**Thread contract.** Like every registry in this package the ledger is
loop-confined: plain dicts, no locks. Off-loop producers (the tick
worker, ingress/egress shards) stamp charge payloads into plain lists
and replay them loop-side — engine._complete_job and the shard stat
rings carry the stamps, the OTPU007 rule verifies the discipline.

**Tenancy.** The tenant of a charge comes from the ``tenant_of`` config
hook (label → tenant, covers batched device traffic, which carries no
per-call context) or, for host turns, the ``orleans.tenant``
RequestContext baggage tag the caller attached.

The port's copy of ``orleans_tpu.observability.ledger``. On the card a
device tick ends with its host copy, so the tick wall that
``charge_tick`` takes covers the device work it charges.
"""

from __future__ import annotations

from typing import Callable, Iterable

__all__ = ["CostLedger", "SpaceSavingSketch", "LEDGER_STATS",
           "TENANT_KEY", "WIRE_STAMP"]

# cross-thread wire-charge stamp sentinel: egress shards may not touch
# the loop-confined ledger, so they append ``(WIRE_STAMP, (route,
# nbytes))`` to their stat-ring stamps and the main-loop drain replays
# the charge (the engine's _LEDGER tick stamp, for the wire tier)
WIRE_STAMP = object()

# RequestContext baggage key carrying the caller's tenant (the TXN_KEY
# naming pattern): read in the turn epilogue BEFORE the context clears
TENANT_KEY = "orleans.tenant"

# exact per-(class, method) rows kept before overflow counting starts
# (the CallSiteStats cap discipline: first-come rows stay exact)
_MAX_ROWS = 512

LEDGER_STATS = {
    "turn_seconds": "ledger.turn.seconds",
    "queue_seconds": "ledger.queue.seconds",
    "row_seconds": "ledger.device.row_seconds",
    "wire_rx": "ledger.wire.rx_bytes",
    "wire_tx": "ledger.wire.tx_bytes",
    "stream_deliveries": "ledger.streams.delivered",
    "charges": "ledger.charges",
    "tracked_keys": "ledger.keys.tracked",
    "key_overflow": "ledger.keys.overflow",
}


class SpaceSavingSketch:
    """Bounded heavy-hitter counter (space-saving, Metwally et al.).

    At most ``k`` tracked labels. A charge to an untracked label while
    full evicts the minimum entry: the newcomer inherits the evicted
    count as both its starting count and its ``err`` bound (true count
    ∈ [count - err, count]), and ``overflow`` counts evictions. The
    guarantee this buys: any label whose true total exceeds total/k is
    present — exactly the "name the hot key" contract the SLO
    drill-down needs, at O(k) memory for any key cardinality.
    """

    __slots__ = ("k", "counts", "overflow")

    def __init__(self, k: int):
        self.k = max(1, int(k))
        # label -> [count, err]; labels are plain strings so snapshots
        # survive the management wire without key re-encoding
        self.counts: dict[str, list[float]] = {}
        self.overflow = 0

    def add(self, label: str, amount: float = 1.0) -> None:
        c = self.counts.get(label)
        if c is not None:
            c[0] += amount
            return
        if len(self.counts) < self.k:
            self.counts[label] = [amount, 0.0]
            return
        victim = min(self.counts, key=self._min_key)
        floor = self.counts.pop(victim)[0]
        self.overflow += 1
        self.counts[label] = [floor + amount, floor]

    def _min_key(self, label: str):
        # deterministic eviction: ties on count break on the label, so
        # two silos fed identical streams evict identically
        return (self.counts[label][0], label)

    def top(self, k: int | None = None) -> list[tuple[str, float, float]]:
        """[(label, count, err)] sorted by (-count, label) — the
        deterministic ranking every surface shows."""
        rows = sorted(((label, c[0], c[1])
                       for label, c in self.counts.items()),
                      key=lambda r: (-r[1], r[0]))
        return rows if k is None else rows[:k]

    def snapshot(self) -> dict:
        return {"k": self.k, "overflow": self.overflow,
                "counts": {label: list(c)
                           for label, c in self.counts.items()}}

    @staticmethod
    def merge(snapshots: Iterable[dict], k: int | None = None) -> dict:
        """Deterministic flat merge: sum (count, err) per label across
        ALL snapshots at once, keep the top-k by (-count, label).
        Order-independence falls out of the commutative sums + total
        ranking — merging 4 silos pairwise or flat gives one answer
        (property-tested). A dropped label's count lands in ``err``
        semantics implicitly: dropping is counted in ``overflow``."""
        snapshots = list(snapshots)
        if k is None:
            k = max((int(s.get("k", 1)) for s in snapshots), default=1)
        per: dict[str, list[tuple[float, float]]] = {}
        overflow = 0
        for s in snapshots:
            overflow += int(s.get("overflow", 0))
            for label, (count, err) in s.get("counts", {}).items():
                per.setdefault(label, []).append((float(count), float(err)))
        # canonicalize float-add order per label: the merged counts are
        # bit-identical no matter which order the per-silo snapshots
        # arrived in (the order-independence the property test pins)
        acc: dict[str, list[float]] = {}
        for label, contribs in per.items():
            contribs.sort()
            acc[label] = [sum(c for c, _ in contribs),
                          sum(e for _, e in contribs)]
        ranked = sorted(acc.items(), key=lambda kv: (-kv[1][0], kv[0]))
        overflow += max(0, len(ranked) - k)
        return {"k": k, "overflow": overflow,
                "counts": {label: c for label, c in ranked[:k]}}


class CostLedger:
    """Per-silo cost accounting (loop-confined; see module docstring).

    ``tenant_of``: optional label → tenant hook; host-turn charges fall
    back to the caller's ``orleans.tenant`` RequestContext baggage.
    """

    def __init__(self, top_k: int = 32,
                 tenant_of: "Callable[[str], str | None] | None" = None):
        self.top_k = max(1, int(top_k))
        self.tenant_of = tenant_of
        # exact per-(interface, method) rows:
        # [calls, exec_seconds, queue_seconds]
        self.turns: dict[tuple[str, str], list[float]] = {}
        # exact per-(class, method) device rows:
        # [batches, rows, row_seconds]
        self.device: dict[tuple[str, str], list[float]] = {}
        self.row_overflow = 0          # charges past the _MAX_ROWS cap
        self.wire: dict[str, list[int]] = {}   # route -> [rx, tx]
        # exact per-originating-process device rows (the cross-process
        # attribution): origin label ("worker-N") ->
        # [rows, row_seconds] — which worker's traffic is burning the
        # owner's device. Fed by the engine payload's optional origins
        # column; empty in single-process silos.
        self.procs: dict[str, list[float]] = {}
        self.streams: dict[str, int] = {}      # namespace -> deliveries
        self.keys = SpaceSavingSketch(self.top_k)     # label -> seconds
        self.tenants = SpaceSavingSketch(self.top_k)  # tenant -> seconds
        self.charges = 0               # charge calls accepted (all verbs)
        # bound once: a per-charge `from ..runtime import` re-resolves
        # the module on every turn (~1.4 us — more than the rest of the
        # charge combined); construction happens post-import, so the
        # late bind here cannot cycle
        from ..runtime.context import RequestContext
        self._baggage_get = RequestContext.get

    # -- tenancy --------------------------------------------------------
    def _tenant(self, label: str | None, baggage: bool) -> str | None:
        if label is not None and self.tenant_of is not None:
            t = self.tenant_of(label)
            if t is not None:
                return t
        if baggage:
            return self._baggage_get(TENANT_KEY)
        return None

    def _charge_key(self, label: str | None, seconds: float,
                    baggage: bool) -> None:
        if label is None:
            return
        self.keys.add(label, seconds)
        tenant = self._tenant(label, baggage)
        if tenant is not None:
            self.tenants.add(str(tenant), seconds)

    # -- charge verbs (each one loop-side; off-loop producers stamp) ----
    def charge_turn(self, interface: str, method: str, exec_s: float,
                    queue_s: float = 0.0, key: str | None = None) -> None:
        """One host turn (dispatcher epilogue / hot-lane inline turn).
        ``key``: the grain label ("Class/key") for the per-key sketch."""
        self.charges += 1
        row = self.turns.get((interface, method))
        if row is not None:
            row[0] += 1
            row[1] += exec_s
            row[2] += queue_s
        elif len(self.turns) < _MAX_ROWS:
            self.turns[(interface, method)] = [1, exec_s, queue_s]
        else:
            self.row_overflow += 1
        self._charge_key(key, exec_s + queue_s, baggage=True)

    def charge_tick(self, payload: tuple) -> None:
        """One device tick, as stamped by the engine:
        ``(cls_name, method, rows, tick_seconds, key_labels[, origins])``
        — row-seconds = rows × tick wall; each key label is charged its
        per-row share. Batched traffic carries no per-call baggage, so
        tenancy comes from the ``tenant_of`` hook only. The optional
        ``origins`` column (parallel to ``key_labels``) attributes each
        row's device time to the originating worker process — the
        cross-process batch case; 5-tuples (in-process) skip it."""
        cls_name, method, rows, tick_s, key_labels = payload[:5]
        self.charges += 1
        row = self.device.get((cls_name, method))
        if row is not None:
            row[0] += 1
            row[1] += rows
            row[2] += rows * tick_s
        elif len(self.device) < _MAX_ROWS:
            self.device[(cls_name, method)] = [1, rows, rows * tick_s]
        else:
            self.row_overflow += 1
        if key_labels:
            share = tick_s  # each row occupied the whole tick's wall
            for label in key_labels:
                self._charge_key(label, share, baggage=False)
        if len(payload) > 5 and payload[5]:
            for origin in payload[5]:
                if origin is None:
                    continue
                prow = self.procs.get(origin)
                if prow is not None:
                    prow[0] += 1
                    prow[1] += tick_s
                elif len(self.procs) < _MAX_ROWS:
                    self.procs[origin] = [1, tick_s]
                else:
                    self.row_overflow += 1

    def charge_wire(self, route: str, rx: int = 0, tx: int = 0) -> None:
        """Bytes moved on one route (peer endpoint / client address /
        ingress shard), charged where the sizes were already measured."""
        self.charges += 1
        row = self.wire.get(route)
        if row is not None:
            row[0] += rx
            row[1] += tx
        elif len(self.wire) < _MAX_ROWS:
            self.wire[route] = [rx, tx]
        else:
            self.row_overflow += 1

    def charge_stream(self, namespace: str, delivered: int) -> None:
        """One device-stream delivery round (streams/device.py pump)."""
        self.charges += 1
        self.streams[namespace] = \
            self.streams.get(namespace, 0) + delivered

    # -- read side ------------------------------------------------------
    def total_turn_seconds(self) -> float:
        return sum(r[1] for r in self.turns.values())

    def total_queue_seconds(self) -> float:
        return sum(r[2] for r in self.turns.values())

    def total_row_seconds(self) -> float:
        return sum(r[2] for r in self.device.values())

    def total_wire(self) -> tuple[int, int]:
        rx = sum(r[0] for r in self.wire.values())
        tx = sum(r[1] for r in self.wire.values())
        return rx, tx

    def top_burners(self, k: int = 5) -> list[dict]:
        """The window's heaviest keys, tenant-annotated — what an SLO
        breach attaches to its flight snapshot and what ``ctl_slo``
        names in the drill-down."""
        out = []
        for label, seconds, err in self.keys.top(k):
            out.append({"key": label, "seconds": round(seconds, 6),
                        "err": round(err, 6),
                        "tenant": self._tenant(label, baggage=False)})
        return out

    def register_gauges(self, stats) -> None:
        """Surface ``ledger.*`` on the registry. Gauge callables are
        evaluated only at snapshot time (Prometheus/OTLP/ctl_metrics
        pull), so exposure costs the hot path nothing."""
        stats.register_gauge(LEDGER_STATS["turn_seconds"],
                             self.total_turn_seconds)
        stats.register_gauge(LEDGER_STATS["queue_seconds"],
                             self.total_queue_seconds)
        stats.register_gauge(LEDGER_STATS["row_seconds"],
                             self.total_row_seconds)
        stats.register_gauge(LEDGER_STATS["wire_rx"],
                             lambda: self.total_wire()[0])
        stats.register_gauge(LEDGER_STATS["wire_tx"],
                             lambda: self.total_wire()[1])
        stats.register_gauge(LEDGER_STATS["stream_deliveries"],
                             lambda: sum(self.streams.values()))
        stats.register_gauge(LEDGER_STATS["charges"], lambda: self.charges)
        stats.register_gauge(LEDGER_STATS["tracked_keys"],
                             lambda: len(self.keys.counts))
        stats.register_gauge(LEDGER_STATS["key_overflow"],
                             lambda: self.keys.overflow)

    def snapshot(self, k: int | None = None) -> dict:
        """Wire-safe dict (tuple row keys joined with '.') — what
        ``ctl_ledger`` returns and ``merge`` consumes."""
        k = self.top_k if k is None else int(k)
        return {
            "turns": {f"{i}.{m}": list(r)
                      for (i, m), r in self.turns.items()},
            "device": {f"{c}.{m}": list(r)
                       for (c, m), r in self.device.items()},
            "row_overflow": self.row_overflow,
            "wire": {route: list(r) for route, r in self.wire.items()},
            "procs": {origin: list(r)
                      for origin, r in self.procs.items()},
            "streams": dict(self.streams),
            "keys": self.keys.snapshot(),
            "tenants": self.tenants.snapshot(),
            "top_burners": self.top_burners(k),
            "charges": self.charges,
        }

    @staticmethod
    def merge(snapshots: Iterable[dict]) -> dict:
        """Cluster fold of per-silo snapshots: exact tables sum, the
        sketches merge deterministically (flat fold — silo count and
        merge order cannot change the answer), and the worst burner /
        worst tenant are named from the merged ranking."""
        snapshots = [s for s in snapshots if s]
        turns: dict[str, list[float]] = {}
        device: dict[str, list[float]] = {}
        wire: dict[str, list[int]] = {}
        procs: dict[str, list[float]] = {}
        streams: dict[str, int] = {}
        row_overflow = 0
        charges = 0
        for s in snapshots:
            row_overflow += int(s.get("row_overflow", 0))
            charges += int(s.get("charges", 0))
            for name, row in s.get("turns", {}).items():
                acc = turns.setdefault(name, [0, 0.0, 0.0])
                for i in range(3):
                    acc[i] += row[i]
            for name, row in s.get("device", {}).items():
                acc = device.setdefault(name, [0, 0, 0.0])
                for i in range(3):
                    acc[i] += row[i]
            for route, row in s.get("wire", {}).items():
                acc = wire.setdefault(route, [0, 0])
                acc[0] += row[0]
                acc[1] += row[1]
            for origin, row in s.get("procs", {}).items():
                acc = procs.setdefault(origin, [0, 0.0])
                acc[0] += row[0]
                acc[1] += row[1]
            for ns, n in s.get("streams", {}).items():
                streams[ns] = streams.get(ns, 0) + n
        keys = SpaceSavingSketch.merge(
            [s.get("keys", {}) for s in snapshots])
        tenants = SpaceSavingSketch.merge(
            [s.get("tenants", {}) for s in snapshots])
        out = {
            "turns": turns, "device": device, "wire": wire,
            "procs": procs,
            "streams": streams, "row_overflow": row_overflow,
            "charges": charges, "keys": keys, "tenants": tenants,
            "worst_burner": None, "worst_tenant": None,
        }
        kc = keys.get("counts", {})
        if kc:
            label, (count, err) = min(
                kc.items(), key=lambda kv: (-kv[1][0], kv[0]))
            out["worst_burner"] = {"key": label,
                                   "seconds": round(count, 6),
                                   "err": round(err, 6)}
        tc = tenants.get("counts", {})
        if tc:
            tenant, (count, err) = min(
                tc.items(), key=lambda kv: (-kv[1][0], kv[0]))
            out["worst_tenant"] = {"tenant": tenant,
                                   "seconds": round(count, 6),
                                   "err": round(err, 6)}
        return out
