"""ActivationData: per-activation state machine, mailbox, turn gate.

Re-design of Orleans' src/Orleans.Runtime/Catalog/ActivationData.cs
(mailbox ``EnqueueMessage:566``, running-state ``RecordRunning:475``, overload
``CheckOverloaded:616``, waiting queue :662-697) fused with the reentrancy
gate from ``Dispatcher.ActivationMayAcceptRequest/CanInterleave``
(Dispatcher.cs:313-336).

The asyncio re-design: instead of a WorkItemGroup + ActivationTaskScheduler
pair (two-level scheduler over OS threads, Scheduler/WorkItemGroup.cs:12),
single-threaded-turn semantics fall out of the event loop — a turn is one
awaited request coroutine; the gate below decides whether an incoming request
starts now or waits, which is exactly the serial/interleaved decision the
reference makes, minus the thread machinery.

The port's copy of ``orleans_tpu.runtime.activation``.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from enum import IntEnum
from typing import TYPE_CHECKING, Any

from ..core.errors import GrainOverloadedError
from ..core.ids import ActivationAddress, ActivationId, GrainId
from ..core.message import Message

if TYPE_CHECKING:
    from .silo import SiloRuntime


class ActivationState(IntEnum):
    """``ActivationData.State`` machine (ActivationData.cs)."""

    CREATE = 0
    ACTIVATING = 1
    VALID = 2
    DEACTIVATING = 3
    INVALID = 4


DEFAULT_MAX_ENQUEUED = 5000  # LimitManager default analog for overload check


class GrainTimerHandle:
    """Disposable timer registration (GrainTimer.cs:11). Ticks are routed
    through the activation gate so they respect turn semantics.

    ``link`` is the ARMING trace context — the (trace_id, span_id) of the
    turn that registered the timer, when that turn was sampled. Tick
    turns root fresh traces (timer messages carry no headers); arming the
    link in this task's context makes every such root carry a span LINK
    back to the arming trace (observability.tracing.pending_root_link),
    so Perfetto/OTLP show causality without merging the traces."""

    def __init__(self, activation: "ActivationData", callback, due: float,
                 period: float | None, link: tuple | None = None):
        self._activation = activation
        self._callback = callback
        self._period = period
        self._link = link
        self._cancelled = False
        self._task = asyncio.get_running_loop().create_task(self._run(due))

    async def _run(self, due: float) -> None:
        try:
            if self._link is not None:
                # The task context COPIED the arming turn's ambient trace
                # at create_task time; left in place, every tick's calls
                # would join (and keep re-opening) a trace whose root
                # closed long ago — exactly the stale-span pollution tail
                # retention cannot decide. Clear it so tick work roots
                # FRESH traces, and arm the link so each new root carries
                # the arming context as a span link instead.
                from ..observability.tracing import (arm_root_link,
                                                     current_trace)
                current_trace.set(None)
                arm_root_link(self._link)
            await asyncio.sleep(due)
            while not self._cancelled:
                if self._activation.state not in (
                        ActivationState.VALID, ActivationState.ACTIVATING):
                    return
                try:
                    await self._activation.run_timer_turn(self._callback)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — a failing tick must not
                    # kill the periodic timer (GrainTimer logs and continues)
                    logging.getLogger("orleans.timers").exception(
                        "timer tick failed on %s", self._activation.grain_id)
                if self._period is None:
                    return
                await asyncio.sleep(self._period)
        except asyncio.CancelledError:
            pass

    def cancel(self) -> None:
        self._cancelled = True
        self._task.cancel()

    # C#-style alias
    dispose = cancel


class ActivationData:
    """One in-memory activation of a grain."""

    def __init__(self, grain_id: GrainId, runtime: "SiloRuntime",
                 grain_class: type, *, max_enqueued: int = DEFAULT_MAX_ENQUEUED):
        self.grain_id = grain_id
        self.activation_id = ActivationId.new()
        self.runtime = runtime
        self.grain_class = grain_class
        self.grain_instance: Any = None
        self.state = ActivationState.CREATE
        self.storage_bridge = None  # set by Catalog for StatefulGrain
        # class flags resolved once (the reentrancy gate reads these per
        # message, and per-call getattr walks were measurable on the hot
        # lane); plain attributes shadowing what used to be properties
        self.is_reentrant: bool = getattr(
            grain_class, "__orleans_reentrant__", False)
        self.is_stateless_worker: bool = getattr(
            grain_class, "__orleans_stateless_worker__", 0) > 0

        # Turn gate state (ActivationData running/waiting)
        self.running: list[Message] = []          # currently-executing requests
        self.running_since: dict[int, float] = {}  # msg.id → turn start
        self.waiting: collections.deque[Message] = collections.deque()
        self.max_enqueued = max_enqueued

        # Idle collection bookkeeping (ActivationCollector tickets)
        self.last_busy = time.monotonic()
        self.keep_alive_until = 0.0
        self._deactivate_on_idle = False

        self.timers: list[GrainTimerHandle] = []
        # Requests buffered while ACTIVATING (the reference's "dummy
        # activation queues messages while real init runs", Catalog.cs:487-502)
        self.activating_backlog: collections.deque[Message] = collections.deque()

    # ------------------------------------------------------------------
    @property
    def address(self) -> ActivationAddress:
        return ActivationAddress(self.runtime.silo_address, self.grain_id,
                                 self.activation_id)

    # -- reentrancy gate (Dispatcher.cs:313-336) ------------------------
    def may_accept_request(self, msg: Message) -> bool:
        if not self.running:
            return True
        return self.can_interleave(msg)

    def can_interleave(self, msg: Message) -> bool:
        """``Dispatcher.CanInterleave:326``: reentrant class, AlwaysInterleave
        method, read-only request among read-only turns, or call-chain
        reentrancy (the incoming call originates from our own pending call
        chain — running it avoids self-deadlock, Dispatcher.cs:346-357)."""
        if self.is_reentrant or msg.is_always_interleave:
            return True
        if msg.is_read_only and all(m.is_read_only for m in self.running):
            return True
        if self.grain_id in msg.call_chain:
            return True
        return False

    def check_overloaded(self) -> None:
        """``ActivationData.CheckOverloaded:616`` → Overloaded rejection."""
        if len(self.waiting) >= self.max_enqueued:
            raise GrainOverloadedError(
                f"{self.grain_id}: {len(self.waiting)} requests enqueued "
                f"(limit {self.max_enqueued})")

    # -- running-state bookkeeping (RecordRunning:475) -------------------
    def record_running(self, msg: Message) -> None:
        self.running.append(msg)
        self.running_since[msg.id] = time.monotonic()
        self.last_busy = time.monotonic()

    def reset_running(self, msg: Message) -> None:
        try:
            self.running.remove(msg)
        except ValueError:
            pass
        self.running_since.pop(msg.id, None)
        self.last_busy = time.monotonic()

    def oldest_running_age(self) -> float:
        """Age of the longest-running turn (stuck-activation probe,
        ActivationData.cs:583-593)."""
        if not self.running_since:
            return 0.0
        return time.monotonic() - min(self.running_since.values())

    @property
    def is_inactive(self) -> bool:
        return not self.running and not self.waiting

    def idle_for(self) -> float:
        return time.monotonic() - self.last_busy

    # -- deactivation hints ---------------------------------------------
    def deactivate_on_idle(self) -> None:
        self._deactivate_on_idle = True

    @property
    def wants_deactivation(self) -> bool:
        return self._deactivate_on_idle and self.is_inactive

    def delay_deactivation(self, seconds: float) -> None:
        self.keep_alive_until = max(self.keep_alive_until,
                                    time.monotonic() + seconds)

    # -- timers ----------------------------------------------------------
    def register_timer(self, callback, due: float,
                       period: float | None) -> GrainTimerHandle:
        from ..observability.tracing import current_trace
        h = GrainTimerHandle(self, callback, due, period,
                             link=current_trace.get())
        self.timers.append(h)
        return h

    def stop_timers(self) -> None:
        for t in self.timers:
            t.cancel()
        self.timers.clear()

    async def run_timer_turn(self, callback) -> None:
        """Run a timer tick as a turn: waits until the gate admits it (timer
        ticks are non-reentrant w.r.t. messages, GrainTimer semantics)."""
        await self.runtime.dispatcher.run_closed_turn(self, callback)

    def __repr__(self) -> str:
        return (f"<Activation {self.grain_id} {self.state.name} "
                f"run={len(self.running)} wait={len(self.waiting)}>")
