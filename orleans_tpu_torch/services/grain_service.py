"""GrainService: per-silo partitioned services with a ring range.

Re-design of Orleans' src/Orleans.Core.Abstractions/Services/
IGrainService.cs + src/Orleans.Runtime/Services/ (GrainService base gets a
ring range; GrainServiceClient routes by key → range owner) and the
creation-from-config path (Silo.cs:566-595). The reminder service follows
the same pattern (LocalReminderService is the reference's canonical
GrainService).

A service instance runs on every silo as a system target named after its
class; ``owned_range``/``on_range_change`` track the one-point consistent
ring over the alive set. Clients route a key to the silo owning
``stable_hash64(key)`` and invoke the service method there.

The port's copy of ``orleans_tpu.services.grain_service``. The tasks that
run a coroutine ``on_start``/``on_stop`` are held in ``_hooks`` until they
end (the JAX package leaves them to the loop's weak references).
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING

from ..core.ids import GrainId, SiloAddress, stable_hash64, type_code_of
from ..core.message import Category
from ..directory.ring import ConsistentRing, RingRange

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.services")

__all__ = ["GrainService", "GrainServiceClient", "add_grain_service"]


class GrainService:
    """Base class: subclass with public async methods; they become the
    remote service surface (like grain methods, pinned per-silo)."""

    _activation = None
    refresh_period = 1.0

    def __init__(self, silo: "Silo"):
        self.silo = silo
        self.ring = ConsistentRing(silo.locator.alive_list)
        self._range: RingRange | None = self.ring.my_range(silo.silo_address)
        self._task: asyncio.Task | None = None
        self._hooks: set[asyncio.Task] = set()

    # -- lifecycle (wired by add_grain_service) --------------------------
    def start(self) -> None:
        if self.silo.membership is not None:
            self.silo.membership.subscribe(lambda a, d: self._update_ring())
        self._task = asyncio.get_running_loop().create_task(self._loop())
        self._update_ring()
        self._run_hook(self.on_start())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self._run_hook(self.on_stop())

    def _run_hook(self, r) -> None:
        if asyncio.iscoroutine(r):
            t = asyncio.ensure_future(r)
            self._hooks.add(t)
            t.add_done_callback(self._hooks.discard)

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.refresh_period)
            self._update_ring()

    def _update_ring(self) -> None:
        self.ring.update(self.silo.locator.alive_list)
        new = self.ring.my_range(self.silo.silo_address)
        if new != self._range:
            old, self._range = self._range, new
            try:
                self.on_range_change(old, new)
            except Exception:  # noqa: BLE001
                log.exception("%s.on_range_change failed",
                              type(self).__name__)

    # -- overridables ----------------------------------------------------
    def on_start(self) -> None:  # noqa: B027
        pass

    def on_stop(self) -> None:  # noqa: B027
        pass

    def on_range_change(self, old: RingRange | None,
                        new: RingRange | None) -> None:  # noqa: B027
        """Partition moved (the reminder-reload analog)."""

    # -- helpers ---------------------------------------------------------
    @property
    def owned_range(self) -> RingRange | None:
        return self._range

    def owns_key(self, key) -> bool:
        r = self._range
        return r is not None and r.contains(stable_hash64(f"gsvc|{key}"))


class GrainServiceClient:
    """Routes service calls by key to the owning silo
    (GrainServiceClient<T> in the reference)."""

    def __init__(self, silo: "Silo", service_cls: type):
        self.silo = silo
        self.service_cls = service_cls
        self.name = service_cls.__name__

    def _owner(self, key) -> SiloAddress:
        ring = ConsistentRing(self.silo.locator.alive_list)
        owner = ring.owner(stable_hash64(f"gsvc|{key}"))
        return owner or self.silo.silo_address

    def call(self, key, method: str, *args, **kwargs):
        """Invoke ``method`` on the service instance owning ``key``."""
        owner = self._owner(key)
        gid = GrainId.system_target(type_code_of(self.name), owner)
        return self.silo.runtime_client.send_request(
            target_grain=gid, grain_class=self.service_cls,
            interface_name=self.name, method_name=method,
            args=args, kwargs=kwargs, target_silo=owner,
            category=Category.SYSTEM)


def add_grain_service(builder, service_cls: type, *factory_args):
    """Register a GrainService subclass on a SiloBuilder: one instance per
    silo, started at the grain-services lifecycle stage (Silo.cs:566-595)."""

    def install(silo) -> None:
        service = service_cls(silo, *factory_args)
        silo.register_system_target(service, service_cls.__name__)
        if not hasattr(silo, "grain_services"):
            silo.grain_services = {}
        silo.grain_services[service_cls.__name__] = service
        from ..runtime.silo import ServiceLifecycleStage
        silo.subscribe_lifecycle(
            ServiceLifecycleStage.RUNTIME_GRAIN_SERVICES,
            service.start, service.stop)

    return builder.configure(install)
