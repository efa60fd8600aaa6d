"""Names the device tier's hooks report under.

The port's copy of the strings the engine writes through its duck-typed
hooks (``VectorRuntime.stats``/``ledger``/``tracer``/``loop_prof``):
the ingest stage metric names of ``orleans_tpu.observability.stats``
that the engine emits, and the loop-occupancy category context variable
of ``orleans_tpu.observability.profiling``. The hooks themselves stay
None until a host tier sets them.
"""

from __future__ import annotations

import contextvars

__all__ = ["INGEST_STATS", "LOOP_CATEGORY"]

# queue_wait: engine enqueue -> batch start; staging: pending invocations
# -> host arrays; transfer: host arrays -> device operands; tick: kernel +
# device execution + host materialize; messages: invocations processed.
INGEST_STATS = {
    "queue_wait": "ingest.queue_wait.seconds",
    "staging": "ingest.staging.seconds",
    "transfer": "ingest.transfer.seconds",
    "tick": "ingest.tick.seconds",
    "messages": "ingest.messages",
}

# The loop-occupancy category of the current task or callback: the
# off-loop worker's completions run in a context where it is
# "tick_schedule", so a host-tier profiler books them there.
LOOP_CATEGORY: contextvars.ContextVar[str] = contextvars.ContextVar(
    "orleans_loop_category", default="other")
