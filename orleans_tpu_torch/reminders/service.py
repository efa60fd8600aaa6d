"""Local reminder service: ticks the durable reminders this silo owns.

Re-design of Orleans' src/Orleans.Runtime/ReminderService/
LocalReminderService.cs:12 (RegisterOrUpdateReminder:81, per-reminder timers,
range-based load + re-read on ring change) over the virtual-bucket ring
(VirtualBucketsRingProvider.cs:15,29). Start is gated on membership the same
way the reference gates on ring stability (Silo.cs:534-546): the service
(re)computes its owned ranges from the locator's alive view and subscribes
to the membership oracle when one is installed.

A reminder tick is an ordinary grain call to ``receive_reminder(name,
status)`` (IRemindable.ReceiveReminder) — the grain re-activates anywhere in
the cluster if needed, which is exactly how reminders survive deactivation
and silo death.

The port's copy of ``orleans_tpu.reminders.service``.
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING

from ..core.errors import ReminderError
from ..core.ids import GrainId, type_code_of
from ..core.message import Category
from ..directory.ring import VirtualBucketRing
from .table import ReminderEntry, ReminderTable

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.reminders")

REMINDER_TARGET = "ReminderTarget"

__all__ = ["TickStatus", "LocalReminderService", "ReminderHandle",
           "add_reminders"]


@dataclass(frozen=True)
class TickStatus:
    """Passed to receive_reminder (TickStatus in the reference API)."""

    first_tick_time: float
    period: float
    current_tick_time: float


@dataclass(frozen=True)
class ReminderHandle:
    """Opaque registration token returned to grains (IGrainReminder)."""

    grain_id: GrainId
    name: str
    etag: int


class ReminderTarget:
    """Per-silo system target: remote refresh hints from peers that just
    wrote a table row owned by this silo."""

    _activation = None

    def __init__(self, service: "LocalReminderService"):
        self.service = service

    async def rem_refresh(self) -> None:
        self.service.schedule_refresh()


class _ReminderTimer:
    """One ticking reminder (the per-entry timer inside the local range)."""

    def __init__(self, service: "LocalReminderService", entry: ReminderEntry):
        self.service = service
        self.entry = entry
        self.task = asyncio.get_running_loop().create_task(self._run())

    def stop(self) -> None:
        self.task.cancel()

    async def _run(self) -> None:
        e = self.entry
        while True:
            now = time.time()
            if now < e.start_at:
                fire_at = e.start_at
            else:
                k = math.floor((now - e.start_at) / e.period) + 1
                fire_at = e.start_at + k * e.period
            await asyncio.sleep(max(0.0, fire_at - time.time()))
            status = TickStatus(e.start_at, e.period, fire_at)
            try:
                await self.service.deliver_tick(e, status)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — log and keep the schedule
                log.exception("reminder %s tick failed for %s",
                              e.name, e.grain_id)


class LocalReminderService:
    """One per silo; installed as ``silo.reminders``."""

    def __init__(self, silo: "Silo", table: ReminderTable,
                 buckets_per_silo: int = 30, refresh_period: float = 5.0):
        self.silo = silo
        self.table = table
        self.ring = VirtualBucketRing(buckets_per_silo)
        self.refresh_period = refresh_period
        self.local: dict[tuple[GrainId, str], _ReminderTimer] = {}
        # (grain_id, name) -> the registering turn's (trace_id, span_id):
        # span-link arming context for tick-rooted traces (bounded by the
        # table rows this silo ever registered; popped on unregister)
        self._arm_links: dict[tuple[GrainId, str], tuple] = {}
        self.target = ReminderTarget(self)
        silo.register_system_target(self.target, REMINDER_TARGET)
        self._refresh_wanted = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._stopped = False

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self.silo.membership is not None:
            self.silo.membership.subscribe(
                lambda alive, dead: self.schedule_refresh())
        self._task = asyncio.get_running_loop().create_task(self._loop())
        self.schedule_refresh()

    def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            self._task = None
        for t in self.local.values():
            t.stop()
        self.local.clear()

    def schedule_refresh(self) -> None:
        self._refresh_wanted.set()

    async def _loop(self) -> None:
        while not self._stopped:
            try:
                await asyncio.wait_for(self._refresh_wanted.wait(),
                                       timeout=self.refresh_period)
            except asyncio.TimeoutError:
                pass
            self._refresh_wanted.clear()
            try:
                await self._refresh()
            except Exception:  # noqa: BLE001
                log.exception("reminder range refresh failed")

    async def _refresh(self) -> None:
        """Reload the rows in my ranges; start/stop/restart local timers
        (the read-my-range + re-read-on-range-change behavior)."""
        self.ring.update(self.silo.locator.alive_list)
        me = self.silo.silo_address
        rows = await self.table.read_all()
        mine = {(e.grain_id, e.name): e for e in rows
                if self.ring.owns(me, e.grain_id.uniform_hash)}
        for key, timer in list(self.local.items()):
            cur = mine.get(key)
            if cur is None or cur.etag != timer.entry.etag:
                timer.stop()
                del self.local[key]
        for key, entry in mine.items():
            if key not in self.local:
                self.local[key] = _ReminderTimer(self, entry)

    # -- grain-facing API (Grain.register_reminder et al.) ----------------
    async def register_or_update(self, grain_id: GrainId, name: str,
                                 due: float, period: float) -> ReminderHandle:
        if period < 0.05:
            raise ReminderError(
                f"reminder period {period}s below minimum (reference floor "
                "is 1 minute; scaled-down floor here is 50ms)")
        iface = self._interface_of(grain_id)
        entry = ReminderEntry(
            grain_id=grain_id, interface_name=iface, name=name,
            start_at=time.time() + due, period=period)
        from ..observability.tracing import current_trace
        link = current_trace.get()
        if link is not None:
            # arming context for span links: tick-rooted traces on THIS
            # silo link back to the registering turn's trace. Best-effort
            # and silo-local by design — the link does not ride the table
            # row, so a tick fired by a different owner roots unlinked.
            self._arm_links[(grain_id, name)] = link
        etag = await self.table.upsert_row(entry)
        await self._notify_owner(grain_id)
        return ReminderHandle(grain_id, name, etag)

    async def unregister(self, grain_id: GrainId, name: str) -> None:
        removed = await self.table.remove_row(grain_id, name)
        self._arm_links.pop((grain_id, name), None)
        if not removed:
            raise ReminderError(f"no reminder {name!r} for {grain_id}")
        await self._notify_owner(grain_id)

    async def get(self, grain_id: GrainId, name: str) -> ReminderHandle | None:
        e = await self.table.read_row(grain_id, name)
        return ReminderHandle(grain_id, name, e.etag) if e else None

    async def list(self, grain_id: GrainId) -> list[ReminderHandle]:
        rows = await self.table.read_grain_rows(grain_id)
        return [ReminderHandle(grain_id, e.name, e.etag) for e in rows]

    # -- internals -------------------------------------------------------
    def _interface_of(self, grain_id: GrainId) -> str:
        for cls in self.silo.registry.all_classes():
            if type_code_of(cls.__name__) == grain_id.type_code:
                return cls.__name__
        raise ReminderError(
            f"no registered grain class for type code {grain_id.type_code}")

    async def _notify_owner(self, grain_id: GrainId) -> None:
        """Kick the owning silo's service so the new row ticks promptly
        (instead of waiting out a refresh period)."""
        self.ring.update(self.silo.locator.alive_list)
        owner = self.ring.owner(grain_id.uniform_hash)
        if owner is None or owner == self.silo.silo_address:
            self.schedule_refresh()
            return
        gid = GrainId.system_target(type_code_of(REMINDER_TARGET), owner)
        try:
            self.silo.runtime_client.send_request(
                target_grain=gid, grain_class=ReminderTarget,
                interface_name=REMINDER_TARGET, method_name="rem_refresh",
                args=(), kwargs={}, is_one_way=True, target_silo=owner,
                category=Category.SYSTEM)
        except Exception:  # noqa: BLE001 — periodic refresh is the backstop
            log.debug("reminder owner notify to %s failed", owner)

    async def deliver_tick(self, entry: ReminderEntry,
                           status: TickStatus) -> None:
        """One tick = one ordinary grain call (IRemindable.ReceiveReminder)."""
        cls = self.silo.registry.resolve(entry.interface_name)
        if cls is None:
            log.warning("reminder %s: grain class %s not registered here",
                        entry.name, entry.interface_name)
            return
        self.silo.stats.increment("reminders.ticks")
        from ..observability.tracing import arm_root_link
        # tick turns root fresh traces; carry the registering turn's
        # context as a span link on the new root (set each tick — the
        # timer task's context persists, and an unlinked entry must
        # clear a predecessor's link)
        arm_root_link(self._arm_links.get((entry.grain_id, entry.name)))
        fut = self.silo.runtime_client.send_request(
            target_grain=entry.grain_id, grain_class=cls,
            interface_name=entry.interface_name,
            method_name="receive_reminder",
            args=(entry.name, status), kwargs={})
        await fut


def add_reminders(silo: "Silo", table: ReminderTable,
                  **kw) -> LocalReminderService:
    """Install the reminder service on a silo pre-start (Silo.cs:534-546)."""
    service = LocalReminderService(silo, table, **kw)
    silo.reminders = service
    from ..runtime.silo import ServiceLifecycleStage
    silo.subscribe_lifecycle(ServiceLifecycleStage.RUNTIME_GRAIN_SERVICES,
                             service.start, service.stop)
    return service
