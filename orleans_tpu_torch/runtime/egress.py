"""Batched response egress: the per-destination flush accumulator.

The egress twin of the batched-ingress pipeline's hand-off layer. Every
inbound batch that resolves N futures in one completion — a device-tick
``_complete_job``, a ``receive_vector_batch`` error bounce, the eager
host turns of one delivered batch — used to fan out N per-message
``send_response`` → ``transmit`` → ``MessageCenter.send_message`` hops
on the way back. The accumulator groups those responses per origin
(silo address / gateway connection) and hands each group to the fabric
as ONE unit (``MessageCenter.send_batch`` → one ``encode_message_batch``
write per destination).

Flush discipline — latency-neutral by construction:

* ``add`` arms a ``call_soon`` flush on the FIRST response of a burst.
  Future resolutions and eager turn completions of one batch all run
  inside one ready-queue cycle, and the armed flush lands AFTER them in
  the loop's ready deque (it was scheduled during that cycle), so the
  whole burst groups into one flush without any explicit begin/end
  bracketing — and a singleton response flushes alone one callback
  later, before any newly-ready IO callbacks (selector wakeups append
  behind it). Nothing is ever held across a loop turn.
* ``flush_dest`` is the per-destination FIFO guard:
  ``MessageCenter.send_message`` drains a pending group for a
  destination before any per-message send to it, so a response handed
  to the accumulator can never be overtaken by a later message on the
  same link (all the wire ever guaranteed: per-sender FIFO per target).

Scope: APPLICATION responses only. PING/SYSTEM responses (membership
probes, directory/management control RPCs) keep the per-message path —
they are latency-critical and low-volume, and the armed flush runs at
the END of the loop's current ready run, which under saturation can
exceed a probe timeout (observed as a false-death vote spiral in the
chaos soak before the split). This is the same QoS split the
category-partitioned inbound queues exist for.

``SiloConfig.batched_egress=False`` never constructs one of these —
``Dispatcher.send_response`` then takes the per-message path bit for
bit, the A/B lever symmetric with ``batched_ingress``.

The port's copy of ``orleans_tpu.runtime.egress``.
"""

from __future__ import annotations

import asyncio
import time

from ..core import message as _msg_mod
from ..observability.stats import COUNT_BOUNDS, EGRESS_STATS

_BUILD = EGRESS_STATS["build"]
_DWELL = EGRESS_STATS["dwell"]
_GROUP = EGRESS_STATS["group"]
_RESPONSES = EGRESS_STATS["responses"]

__all__ = ["EgressBatcher"]


class EgressBatcher:
    """Per-destination response groups with an armed end-of-burst flush
    (see module docstring). One per MessageCenter when
    ``batched_egress`` is on; the dispatcher's ``send_response`` feeds
    it for every remote-bound response."""

    __slots__ = ("center", "groups", "_armed", "stats", "last_group",
                 "_sharded_dest")

    def __init__(self, center):
        self.center = center
        self.groups: dict = {}       # destination SiloAddress -> [Message]
        self._armed = False
        # same gating as the ingest stages: the silo's registry when
        # metrics_enabled, else None — add/flush pay one None check
        self.stats = center.silo.ingest_stats
        self.last_group = 0          # last flush-group size (sampler gauge)
        # sharded egress (SocketFabric.sharded_dest): a destination
        # whose encode runs on an egress shard keeps its dwell stamps
        # through the hand-off — the SHARD observes dwell at encode
        # time (accumulator + ring + sender-queue wait, replayed
        # loop-side), strictly more truthful than flush-time here
        self._sharded_dest = getattr(
            getattr(center.silo, "fabric", None), "sharded_dest", None)

    def add(self, dest, msg) -> None:
        """Join ``msg`` to the pending group for ``dest`` and arm the
        end-of-burst flush."""
        if _msg_mod._DEBUG_POOL:
            # pool poisoning: accumulating a recycled shell would put
            # another call's response on the wire at flush
            _msg_mod.assert_live(msg, "egress.add")
        if self.stats is not None:
            # dwell stamp: the received_at slot is wire-excluded and
            # dead on an outbound response (receivers re-stamp on
            # arrival); cleared again at flush so in-proc deliveries
            # never mistake the send-side stamp for an arrival
            msg.received_at = time.monotonic()
        g = self.groups.get(dest)
        if g is None:
            g = self.groups[dest] = []
        g.append(msg)
        if not self._armed:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                # no running loop (sync harness/unit contexts): hand off
                # immediately — correctness over grouping
                self.flush()
                return
            self._armed = True
            loop.call_soon(self.flush)

    def _observe_group(self, dest, msgs: list) -> None:
        """Shared per-group bookkeeping for both flush paths: group-size
        histogram, responses counter, and per-message dwell (observed and
        cleared BEFORE the hand-off — encode/transport time belongs to
        the ``encode`` stage, not here). A sharded destination keeps its
        dwell stamps: the egress shard observes them at encode time
        (dwell then spans accumulator + ring + sender queue) and replays
        loop-side."""
        st = self.stats
        n = len(msgs)
        self.last_group = n
        if st is None:
            return
        st.histogram_with(_GROUP, COUNT_BOUNDS).observe(n)
        st.increment(_RESPONSES, n)
        sd = self._sharded_dest
        if sd is not None and sd(dest):
            return  # dwell observed (and cleared) shard-side
        now = time.monotonic()
        for m in msgs:
            if m.received_at is not None:
                st.observe(_DWELL, now - m.received_at)
                m.received_at = None

    def flush(self) -> None:
        """Hand every pending group to the message center, one
        ``send_batch`` per destination (the batch-completion boundary)."""
        self._armed = False
        groups = self.groups
        if not groups:
            return
        self.groups = {}
        st = self.stats
        center = self.center
        if st is None:
            for dest, msgs in groups.items():
                self.last_group = len(msgs)
                center.send_batch(dest, msgs)
            return
        # the build window covers ONLY the grouping/bookkeeping work —
        # the hand-off below runs outside it so the stage decomposition
        # stays non-overlapping (encode times itself in the wire layer,
        # transport write is not an egress stage)
        t0 = time.perf_counter()
        for dest, msgs in groups.items():
            self._observe_group(dest, msgs)
        st.observe(_BUILD, time.perf_counter() - t0)
        for dest, msgs in groups.items():
            center.send_batch(dest, msgs)

    def flush_dest(self, dest) -> None:
        """FIFO guard: drain the pending group for ONE destination now
        (called before a per-message send to it — see module docstring)."""
        msgs = self.groups.pop(dest, None)
        if not msgs:
            return
        self._observe_group(dest, msgs)
        self.center.send_batch(dest, msgs)
