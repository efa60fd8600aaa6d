"""Hot-spot telemetry: fold both tiers' load signals into one report.

The device half lives where the heat is generated: every dispatch tick
scatter-adds its batch into the table's per-slot hit counters ON DEVICE
(``ShardedActorTable.record_hits`` — no host sync on the hot path), and
this module only reads them out at planner rate. The host half is the
catalog/mailbox view the reference's ``DeploymentLoadPublisher`` publishes
(DeploymentLoadPublisher.cs:85); the publisher folds :func:`load_report`
into every broadcast so peers' planners see queue depth and device-shard
heat, not just activation counts.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_report", "vector_shard_hits", "queue_depth",
           "hot_hashed_keys"]


def vector_shard_hits(silo) -> dict[str, list[int]]:
    """Per-class per-shard invocation totals since the last planner reset
    (empty until ``enable_load_tracking``)."""
    rt = getattr(silo, "vector", None)
    if rt is None or not rt.track_load:
        return {}
    return {cls.__name__: [int(x) for x in hits]
            for cls, hits in rt.shard_loads().items()}


def queue_depth(silo) -> int:
    """Backlogged work on this silo: application inbound queue + parked
    activation mailboxes + device-tier pending (incl. conflict-deferred)
    — the queue-depth load signal next to the activation count."""
    from ..core.message import Category

    depth = 0
    q = silo.message_center.inbound.get(Category.APPLICATION)
    if q is not None:
        depth += q.qsize()
    depth += sum(len(a.waiting) + len(a.activating_backlog)
                 for a in silo.catalog.by_activation.values())
    rt = getattr(silo, "vector", None)
    if rt is not None:
        depth += rt.queue_depth()
    return depth


def load_report(silo) -> dict:
    """The extended per-silo load report (what the publisher broadcasts)."""
    return {
        "activation_count": silo.catalog.activation_count(),
        "queue_depth": queue_depth(silo),
        "vector_hits": vector_shard_hits(silo),
    }


def hot_hashed_keys(tbl, shard: int, limit: int,
                    slot_hits: np.ndarray | None = None) -> np.ndarray:
    """Hashed-regime keys resident on ``shard``, hottest first, at most
    ``limit`` — the victim pool for a device-tier shard drain. Dense-regime
    rows never appear (their re-range is the explicit ``reshard_dense``
    snapshot path). Pass ``slot_hits`` (a prior ``tbl.slot_hits()``) to
    avoid a second full device→host counter transfer per round."""
    resident = [(kh, slot) for kh, (sh, slot) in tbl.key_to_slot.items()
                if sh == shard]
    if not resident:
        return np.zeros(0, dtype=np.int64)
    hits = (tbl.slot_hits() if slot_hits is None else slot_hits)[shard]
    resident.sort(key=lambda ks: int(hits[ks[1]]), reverse=True)
    return np.asarray([kh for kh, _ in resident[:limit]], dtype=np.int64)
