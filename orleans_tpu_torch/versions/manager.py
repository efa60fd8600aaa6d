"""Interface versioning: compat directors + selectors gating placement.

Re-design of Orleans' src/Orleans.Runtime/Versions/: per-interface
version (codegen [Version(n)] attribute → ``@grain_version(n)`` here),
compatibility directors (``Compatibility/BackwardCompatilityDirector.cs``,
``StrictVersionCompatibilityDirector.cs``, ``AllVersionsCompatibilityDirector.cs``)
and selectors (``Selector/MinimumVersionSelector.cs``, ``LatestVersionSelector``,
``AllCompatibleVersions``), enforced where the reference enforces at
addressing time (``Dispatcher.cs:725-732``): the directory owner filters
placement candidates to silos hosting a compatible version
(``CachedVersionSelectorManager.cs``).

The cluster version map is exchanged the way the reference's TypeManager
does it (``GrainTypeManager/TypeManager.cs:15`` — a per-silo system target
plus a refresh timer): every silo serves its local interface→version map
from :class:`TypeManagerTarget`, and :class:`VersionManager` pulls peers'
maps on a refresh loop + on membership change. In-proc fabrics can still
read peer registries directly as a freshness shortcut, but gating no
longer silently passes when no info is reachable — an unknown silo simply
is not a placement candidate until its map arrives.

The port's copy of ``orleans_tpu.versions.manager``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import TYPE_CHECKING, Callable

from ..core.ids import SiloAddress

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.versions")

__all__ = ["grain_version", "version_of", "VersionManager",
           "TypeManagerTarget", "TYPE_MANAGER_TARGET"]

TYPE_MANAGER_TARGET = "type-manager"
MAP_REFRESH_PERIOD = 2.0


def grain_version(version: int) -> Callable[[type], type]:
    """Class decorator declaring the grain interface version ([Version(n)])."""

    def deco(cls: type) -> type:
        cls.__orleans_version__ = version
        return cls

    return deco


def version_of(cls: type | None) -> int:
    return getattr(cls, "__orleans_version__", 0) if cls else 0


# -- compatibility directors -------------------------------------------------

def backward_compatible(requested: int, available: int) -> bool:
    """BackwardCompatilityDirector: a silo can serve any request compiled
    against its version or older."""
    return available >= requested


def strict_compatible(requested: int, available: int) -> bool:
    """StrictVersionCompatibilityDirector: exact match only."""
    return available == requested


def all_compatible(requested: int, available: int) -> bool:
    """AllVersionsCompatibilityDirector: anything goes."""
    return True


_COMPAT = {
    "backward": backward_compatible,
    "strict": strict_compatible,
    "all": all_compatible,
}

_SELECTORS = ("all_compatible", "latest_version", "minimum_version")


class TypeManagerTarget:
    """Per-silo system target serving the local interface→version map
    (the TypeManager system target, TypeManager.cs:15)."""

    def __init__(self, manager: "VersionManager"):
        self.manager = manager

    async def type_map(self) -> dict[str, int]:
        return self.manager.local_map()


class VersionManager:
    """Per-silo versioning policy: filter placement candidates for an
    interface+requested-version pair, against exchanged type maps."""

    def __init__(self, silo: "Silo", compat: str = "backward",
                 selector: str = "all_compatible"):
        if compat not in _COMPAT:
            raise ValueError(f"unknown compatibility strategy {compat!r}")
        if selector not in _SELECTORS:
            raise ValueError(f"unknown version selector {selector!r}")
        self.silo = silo
        self.compat = compat
        self.selector = selector
        # exchanged cluster type map: silo → {interface: version}
        self.remote_maps: dict[SiloAddress, dict[str, int]] = {}
        self._refresh_task: asyncio.Task | None = None
        self._fetch_tasks: set[asyncio.Task] = set()
        self.target = TypeManagerTarget(self)

    # -- exchange (TypeManager refresh timer) ----------------------------
    def local_map(self) -> dict[str, int]:
        out = {cls.__name__: version_of(cls)
               for cls in self.silo.registry.all_classes()}
        for name, cls in getattr(self.silo, "vector_interfaces", {}).items():
            out.setdefault(name, version_of(cls))
        return out

    def start_exchange(self) -> None:
        if self._refresh_task is None:
            self._refresh_task = asyncio.get_running_loop().create_task(
                self._refresh_loop())

    def stop_exchange(self) -> None:
        if self._refresh_task is not None:
            self._refresh_task.cancel()
            self._refresh_task = None
        for t in list(self._fetch_tasks):
            t.cancel()

    def forget(self, silo: SiloAddress) -> None:
        self.remote_maps.pop(silo, None)

    def schedule_fetch(self, silo: SiloAddress) -> None:
        """Fetch one peer's map now (membership-change hook)."""
        if silo == self.silo.silo_address:
            return
        t = asyncio.ensure_future(self._fetch(silo))
        self._fetch_tasks.add(t)
        t.add_done_callback(self._fetch_tasks.discard)

    async def _refresh_loop(self) -> None:
        while True:
            await asyncio.sleep(MAP_REFRESH_PERIOD)
            try:
                peers = [s for s in self.silo.locator.alive_list
                         if s != self.silo.silo_address]
                for peer in peers:
                    await self._fetch(peer)
                for known in list(self.remote_maps):
                    if known not in peers:
                        self.remote_maps.pop(known, None)
            except Exception:  # noqa: BLE001
                log.debug("type-map refresh round failed", exc_info=True)

    async def _fetch(self, peer: SiloAddress) -> None:
        from ..core.ids import GrainId, type_code_of
        from ..core.message import Category
        target = GrainId.system_target(
            type_code_of(TYPE_MANAGER_TARGET), peer)
        try:
            m = await self.silo.runtime_client.send_request(
                target_grain=target, grain_class=TypeManagerTarget,
                interface_name="TypeManagerTarget", method_name="type_map",
                args=(), kwargs={}, target_silo=peer,
                category=Category.SYSTEM, timeout=5.0)
            self.remote_maps[peer] = dict(m)
        except Exception:  # noqa: BLE001 — peer mid-death/mid-start; the
            # refresh loop re-tries, and unknown silos aren't candidates
            log.debug("type-map fetch from %s failed", peer)

    def set_strategy(self, compat: str | None = None,
                     selector: str | None = None) -> None:
        """Runtime strategy update (ManagementGrain.SetCompatibilityStrategy)."""
        if compat is not None:
            if compat not in _COMPAT:
                raise ValueError(f"unknown compatibility strategy {compat!r}")
            self.compat = compat
        if selector is not None:
            if selector not in _SELECTORS:
                raise ValueError(f"unknown version selector {selector!r}")
            self.selector = selector

    def available_version(self, silo: SiloAddress,
                          interface_name: str) -> int | None:
        """Version of ``interface_name`` hosted by ``silo`` (None = class not
        registered there, or the silo's type map has not arrived yet —
        either way it is not a candidate)."""
        if silo == self.silo.silo_address:
            cls = self.silo.registry.resolve(interface_name)
            if cls is None:
                cls = self.silo.vector_interfaces.get(interface_name)
            return None if cls is None else version_of(cls)
        # in-proc fabric shortcut: the peer's live registry IS the map
        peer = getattr(self.silo.fabric, "silos", {}).get(silo)
        if peer is not None:
            cls = peer.registry.resolve(interface_name)
            if cls is None:
                cls = peer.vector_interfaces.get(interface_name)
            return None if cls is None else version_of(cls)
        # cross-process: the exchanged map (TypeManager)
        m = self.remote_maps.get(silo)
        return None if m is None else m.get(interface_name)

    def compatible_silos(self, interface_name: str, requested: int,
                         candidates: list[SiloAddress]) -> list[SiloAddress]:
        ok = _COMPAT[self.compat]
        versions = {}
        for s in candidates:
            v = self.available_version(s, interface_name)
            if v is not None and ok(requested, v):
                versions[s] = v
        if not versions:
            return []
        if self.selector == "latest_version":
            pick = max(versions.values())
        elif self.selector == "minimum_version":
            pick = min(versions.values())
        else:
            return list(versions)
        return [s for s, v in versions.items() if v == pick]
