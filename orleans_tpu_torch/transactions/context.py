"""Transaction ambient context: a TransactionInfo rides RequestContext so
it flows through nested grain calls exactly like the reference's
TransactionInfo message header (scope opened in InsideRuntimeClient.Invoke,
Orleans' src/Orleans.Runtime/Core/InsideRuntimeClient.cs:313-438).

Participants are collected CALLER-SIDE as the call tree runs (each
TransactionalState first-touch registers its grain into the ambient info;
callee-side joins ride back to the caller on the response's
``transaction_info`` header) — so starting a transaction and joining it
cost zero TM round trips; the TM hears about the transaction exactly once,
at commit, with the full participant set. This is the reference's own
evolution of the design (the 2.0-preview per-call TM chatter was replaced
by agent-side collection), and it is what makes the TM a sequencer rather
than a bottleneck.

The port's copy of ``orleans_tpu.transactions.context``.
"""

from __future__ import annotations

import itertools
import random
import time
from typing import TYPE_CHECKING

from ..runtime.context import TXN_KEY, RequestContext

if TYPE_CHECKING:
    from ..core.ids import GrainId

__all__ = ["TXN_KEY", "TransactionInfo", "ambient_txn", "set_ambient_txn",
           "clear_ambient_txn"]

# txn ids: random 8-hex head (spreads txns over TM shards) + process tag +
# counter (uniqueness) — ~20× cheaper than uuid4 on the commit hot path
_proc_tag = f"{random.getrandbits(48):012x}"
_txn_counter = itertools.count(1)


class TransactionInfo:
    """One transaction's identity + collected participant set."""

    __slots__ = ("id", "deadline", "participants", "ts")

    def __init__(self, id: str | None = None,
                 deadline: float | None = None,
                 participants: dict | None = None,
                 ts: tuple | None = None):
        self.id = id or (f"{random.getrandbits(32):08x}"
                         f"{_proc_tag}{next(_txn_counter):x}")
        self.deadline = deadline if deadline is not None else \
            time.time() + 10.0
        # wound-wait priority timestamp: totally ordered cluster-wide
        # (wall clock, then process tag, then sequence breaks ties).
        # Conflict retries REUSE the original ts (manager.transactional)
        # so a repeatedly-dying transaction ages into the oldest — and
        # therefore winning — one: livelock-free by construction.
        self.ts: tuple = ts if ts is not None else \
            (time.time(), _proc_tag, next(_txn_counter))
        # str(grain_id) -> (GrainId, interface_name)
        self.participants: dict[str, tuple["GrainId", str]] = \
            participants or {}

    def join(self, grain_id: "GrainId", iface: str) -> None:
        self.participants[str(grain_id)] = (grain_id, iface)

    def merge(self, participants: dict) -> None:
        """Fold a callee's joins (piggybacked on its response) into the
        caller's set — idempotent, so the in-proc shared-object case and
        the cross-process serialized case behave identically."""
        self.participants.update(participants)

    # pickled into response headers for the cross-process merge
    def __reduce__(self):
        return (TransactionInfo, (self.id, self.deadline,
                                  dict(self.participants), self.ts))

    def __repr__(self) -> str:
        return (f"TransactionInfo({self.id[:8]}, "
                f"{len(self.participants)} participants)")


def ambient_txn() -> TransactionInfo | None:
    return RequestContext.get(TXN_KEY)


def set_ambient_txn(info: TransactionInfo) -> None:
    RequestContext.set(TXN_KEY, info)


def clear_ambient_txn() -> None:
    RequestContext.remove(TXN_KEY)
