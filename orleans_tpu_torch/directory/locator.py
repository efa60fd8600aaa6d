"""Distributed grain locator: ring-partitioned directory + placement.

Re-design of Orleans' src/Orleans.Runtime/GrainDirectory/:
``LocalGrainDirectory.cs:16`` (ring :23, CalculateTargetSilo :477-546,
RegisterAsync :576, UnregisterAsync :673, LookupAsync :878),
``GrainDirectoryPartition.cs:207`` (AddSingleActivation :304 — first-wins
registration), the LRU cache (``LRUBasedGrainDirectoryCache.cs``) with
invalidation on forward, ``RemoteGrainDirectory.cs`` (directory ops as
system-target messages), and ``GrainDirectoryHandoffManager.cs`` (partition
re-ranging on membership change).

One DistributedLocator per silo replaces SingleSiloLocator when the silo
joins a multi-silo fabric. Directory ownership: ``ring.owner(grain_hash)``;
ops for grains owned elsewhere become SYSTEM-category messages to the
owner's DirectoryTarget.

The port's copy of ``orleans_tpu.directory.locator``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING

from ..core.ids import ActivationAddress, GrainId, SiloAddress
from ..core.message import Category, Message
from ..placement import PlacementManager
from .ring import ConsistentRing

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.directory")

DIRECTORY_TARGET = "DirectoryTarget"
CACHE_SIZE_DEFAULT = 100_000


class DirectoryTarget:
    """Per-silo directory system target (RemoteGrainDirectory.cs:110): the
    remote surface of this silo's partition."""

    _activation = None

    def __init__(self, locator: "DistributedLocator"):
        self.locator = locator

    async def dir_lookup_or_place(self, grain_id: GrainId,
                                  placement: str | None,
                                  requester: SiloAddress,
                                  interface_name: str | None = None,
                                  requested_version: int = 0):
        return self.locator.local_lookup_or_place(
            grain_id, placement, requester, interface_name,
            requested_version)

    async def dir_register(self, address: ActivationAddress):
        return self.locator.local_register(address)

    async def dir_migrate_register(self, address: ActivationAddress,
                                   prev_activation):
        return self.locator.local_migrate_register(address, prev_activation)

    async def dir_cache_invalidate(self, grain_id: GrainId) -> bool:
        """Drop a stale LRU cache entry on THIS silo — the receive half of
        invalidation-on-forward (the reference piggybacks the invalidation
        on the forwarded message's response path; here it is an explicit
        one-way system message from the forwarding silo). Without this, a
        sender whose cache points at an activation's PREVIOUS silo (e.g.
        after a live migration) pays a forward hop on every message until
        the entry's TTL expires."""
        self.locator.cache.pop(grain_id, None)
        return True

    async def dir_unregister(self, address: ActivationAddress):
        self.locator.local_unregister(address)
        return True

    async def dir_drop_stale(self, grain_id: GrainId, silo: SiloAddress,
                             live_activations: list) -> bool:
        """Drop a registration that points at ``silo`` unless it names one
        of the activations ``silo`` reports live — the directory half of
        UnregisterAfterNonexistingActivation (Catalog.cs:29 rejection →
        LocalGrainDirectory cleanup): without this, an entry left behind
        by a dead activation (e.g. planted by a re-range handoff that
        raced a deactivation) ping-pongs every lookup into the forward
        limit forever."""
        cur = self.locator.partition.get(grain_id)
        if cur is not None and cur.silo == silo and \
                cur.activation not in live_activations:
            self.locator.partition.pop(grain_id, None)
            self.locator.cache.pop(grain_id, None)
            return True
        return False

    async def dir_handoff(self, entries: list):
        """Bulk-receive partition entries from a re-ranging peer
        (GrainDirectoryHandoffManager)."""
        for addr in entries:
            self.locator.local_register(addr)
        return True

    async def dir_lookup_many(self, grain_ids: list) -> list:
        """Batched owner lookup for the adaptive-cache maintainer
        (AdaptiveDirectoryCacheMaintainer.cs:243 batches per owner):
        current hosting silo per grain, None where no live registration
        exists."""
        out = []
        for gid in grain_ids:
            reg = self.locator.partition.get(gid)
            out.append(reg.silo if reg is not None
                       and reg.silo in self.locator.alive_set else None)
        return out


class DistributedLocator:
    """Implements the silo locator protocol over a ring-partitioned
    directory (drop-in replacement for SingleSiloLocator)."""

    def __init__(self, silo: "Silo"):
        self.silo = silo
        self.ring = ConsistentRing([silo.silo_address])
        self.alive_set: set[SiloAddress] = {silo.silo_address}
        self.alive_list: list[SiloAddress] = [silo.silo_address]
        self.partition: dict[GrainId, ActivationAddress] = {}
        from .adaptive_cache import AdaptiveDirectoryCache
        self.cache = AdaptiveDirectoryCache(
            silo.config.directory_cache_size,
            initial_ttl=silo.config.directory_cache_initial_ttl,
            max_ttl=silo.config.directory_cache_max_ttl)
        self.cache_size = silo.config.directory_cache_size
        self._maintainer_task = None  # started by Silo.start
        self.placement = PlacementManager(load_of=self._load_of)
        from ..versions import VersionManager
        from ..versions.manager import TYPE_MANAGER_TARGET
        self.versions = VersionManager(silo)
        self.target = DirectoryTarget(self)
        self.target_id = silo.register_system_target(
            self.target, DIRECTORY_TARGET)
        silo.register_system_target(self.versions.target,
                                    TYPE_MANAGER_TARGET)

    # ------------------------------------------------------------------
    def _load_of(self, silo: SiloAddress) -> int:
        """Activation-count stats feed: prefer the DeploymentLoadPublisher
        view (cross-host capable); fall back to the in-proc fabric shortcut
        of reading the peer catalog directly."""
        publisher = getattr(self.silo, "load_publisher", None)
        if publisher is not None:
            v = publisher.load_of(silo)
            if v is not None:
                return v
        s = self.silo.fabric.silos.get(silo)
        return s.catalog.activation_count() if s is not None else 1 << 30

    def _alive(self) -> list[SiloAddress]:
        return self.alive_list or [self.silo.silo_address]

    def _target_ref(self, silo: SiloAddress, method: str, *args):
        """Invoke a directory op on a peer's system target."""
        gid = GrainId.system_target(
            _dir_type_code(), silo)
        return self.silo.runtime_client.send_request(
            target_grain=gid, grain_class=DirectoryTarget,
            interface_name="DirectoryTarget", method_name=method,
            args=args, kwargs={}, target_silo=silo,
            category=Category.SYSTEM)

    # ------------------------------------------------------------------
    # Locator protocol
    # ------------------------------------------------------------------
    def try_locate_sync(self, msg: Message, grain_class: type | None
                        ) -> SiloAddress | None:
        """Synchronously-resolvable addressing: system targets, stateless
        workers, cache hits, and locally-owned directory partitions. The
        dispatcher uses this to skip a task round trip per send — only the
        remote-owner directory hop needs the async path. Returns None when
        a remote hop is required."""
        grain_id = msg.target_grain
        if grain_id.is_system_target() or grain_id.is_client():
            return msg.target_silo or self.silo.silo_address
        if grain_class is None:
            grain_class = self.silo.registry.resolve(msg.interface_name)
        if grain_class is not None and \
                getattr(grain_class, "__orleans_stateless_worker__", 0):
            return self.silo.silo_address  # stateless workers host locally
        cached = self.cache.get(grain_id)  # TTL-aware: expired reads miss
        if cached is not None and cached in self.alive_set:
            return cached
        owner = self.ring.owner(grain_id.uniform_hash) or self.silo.silo_address
        if owner != self.silo.silo_address:
            return None  # remote directory hop — async path
        placement_name = getattr(grain_class, "__orleans_placement__",
                                 None) if grain_class else None
        # traced directory work: the remote hop records as a client span
        # of the DirectoryTarget RPC; this locally-owned lookup/placement
        # would otherwise be invisible to the trace ("directory lookup on
        # first call" must show up either way)
        dspan = None
        tracer = getattr(self.silo, "tracer", None)
        if tracer is not None:
            from ..observability.tracing import context_from_headers
            hdr = context_from_headers(msg.request_context)
            if hdr is not None:
                dspan = tracer.open("directory.lookup_or_place",
                                    "directory", hdr[0], hdr[1])
        try:
            silo, is_new = self.local_lookup_or_place(
                grain_id, placement_name, self.silo.silo_address,
                msg.interface_name, msg.interface_version)
        except BaseException:
            if dspan is not None:
                tracer.close(dspan, error=True)
            raise
        if dspan is not None:
            tracer.close(dspan, placed=is_new, host=str(silo))
        msg.is_new_placement = is_new
        self._cache_put(grain_id, silo)
        return silo

    async def locate(self, msg: Message, grain_class: type | None) -> SiloAddress:
        """AddressMessage:715 — resolve the hosting silo for a request."""
        target = self.try_locate_sync(msg, grain_class)
        if target is not None:
            return target
        grain_id = msg.target_grain
        if grain_class is None:
            grain_class = self.silo.registry.resolve(msg.interface_name)
        placement_name = getattr(grain_class, "__orleans_placement__",
                                 None) if grain_class else None
        owner = self.ring.owner(grain_id.uniform_hash) or self.silo.silo_address
        silo, is_new = await self._target_ref(
            owner, "dir_lookup_or_place", grain_id, placement_name,
            self.silo.silo_address, msg.interface_name,
            msg.interface_version)
        msg.is_new_placement = is_new
        self._cache_put(grain_id, silo)
        return silo

    def should_host(self, grain_id: GrainId, grain_class: type,
                    msg: Message) -> bool:
        if getattr(grain_class, "__orleans_stateless_worker__", 0):
            return True
        if msg.is_new_placement:
            return True
        reg = self.partition.get(grain_id)
        return reg is not None and reg.silo == self.silo.silo_address

    async def register(self, address: ActivationAddress
                       ) -> ActivationAddress | None:
        """RegisterAsync:576 → first-wins AddSingleActivation on the owner."""
        owner = self.ring.owner(address.grain.uniform_hash)
        if owner is None or owner == self.silo.silo_address:
            return self.local_register(address)
        return await self._target_ref(owner, "dir_register", address)

    async def unregister(self, address: ActivationAddress) -> None:
        owner = self.ring.owner(address.grain.uniform_hash)
        self.cache.pop(address.grain, None)
        if owner is None or owner == self.silo.silo_address:
            self.local_unregister(address)
        else:
            try:
                await self._target_ref(owner, "dir_unregister", address)
            except Exception:  # noqa: BLE001 — owner may be mid-death
                log.debug("remote unregister failed for %s", address.grain)

    async def migrate_register(self, address: ActivationAddress,
                               prev_activation) -> ActivationAddress:
        """Re-register a grain mid-migration: REPLACE the registration the
        migrating activation holds with the new address (ordinary
        ``register`` is first-wins and would keep pointing at the source).
        ``prev_activation``: the ActivationId being migrated away — the
        guard that a racing re-creation's registration is never usurped.
        Returns the winning address (≠ ``address`` means the migration
        lost and must abort)."""
        owner = self.ring.owner(address.grain.uniform_hash)
        self.cache.pop(address.grain, None)
        if owner is None or owner == self.silo.silo_address:
            return self.local_migrate_register(address, prev_activation)
        return await self._target_ref(owner, "dir_migrate_register",
                                      address, prev_activation)

    def invalidate_cache(self, grain_id: GrainId) -> None:
        self.cache.pop(grain_id, None)

    def notify_cache_invalidate(self, peer: SiloAddress,
                                grain_id: GrainId) -> None:
        """Invalidation-on-forward, cross-silo half: fire-and-forget a
        cache drop to ``peer`` (the silo whose stale cache routed a
        message here). Best-effort — a lost notice only costs the peer
        forward hops until its entry's TTL expires."""
        try:
            self.silo.runtime_client.send_request(
                target_grain=GrainId.system_target(_dir_type_code(), peer),
                grain_class=DirectoryTarget,
                interface_name=DIRECTORY_TARGET,
                method_name="dir_cache_invalidate", args=(grain_id,),
                kwargs={}, is_one_way=True, target_silo=peer,
                category=Category.SYSTEM)
        except Exception:  # noqa: BLE001 — peer may be mid-death
            log.debug("cache-invalidate notice to %s failed", peer)

    async def unregister_after_nonexistent(self, grain_id: GrainId) -> None:
        """This silo received a message for ``grain_id`` but hosts no such
        activation: tell the directory owner to drop any registration
        pointing here (unless it names an activation that is in fact
        live — a re-creation racing this report keeps its entry)."""
        live = [a.activation_id
                for a in self.silo.catalog.by_grain.get(grain_id, [])]
        owner = self.ring.owner(grain_id.uniform_hash)
        me = self.silo.silo_address
        try:
            if owner is None or owner == me:
                cur = self.partition.get(grain_id)
                if cur is not None and cur.silo == me and \
                        cur.activation not in live:
                    self.partition.pop(grain_id, None)
                    self.cache.pop(grain_id, None)
            else:
                await self._target_ref(owner, "dir_drop_stale", grain_id,
                                       me, live)
        except Exception:  # noqa: BLE001 — best-effort heal; the next
            # miss reports again
            log.debug("stale-entry report failed for %s", grain_id)

    # ------------------------------------------------------------------
    # Owner-side partition ops
    # ------------------------------------------------------------------
    def local_lookup_or_place(self, grain_id: GrainId,
                              placement_name: str | None,
                              requester: SiloAddress,
                              interface_name: str | None = None,
                              requested_version: int = 0):
        reg = self.partition.get(grain_id)
        if reg is not None and reg.silo in self.alive_set:
            return reg.silo, False
        director = self.placement.director_by_name(placement_name)
        candidates = self._alive()
        if interface_name is not None:
            # version gate at addressing time (Dispatcher.cs:725-732).
            # Cross-process silos are covered by the exchanged type map
            # (TypeManager); a silo whose map has not arrived is simply
            # not a candidate — gating never silently passes.
            compat = self.versions.compatible_silos(
                interface_name, requested_version, candidates)
            if compat:
                candidates = compat
            elif any(s != self.silo.silo_address
                     and s not in self.versions.remote_maps
                     and getattr(self.silo.fabric, "silos", {}).get(s) is None
                     for s in candidates):
                # some candidate's type map hasn't arrived yet (startup /
                # join window): transient — the caller's resend retries
                # after the exchange lands, rather than failing hard
                from ..core.errors import TransientPlacementError
                raise TransientPlacementError(
                    f"type maps still exchanging for {interface_name}; "
                    "retry")
            else:
                from ..core.errors import OrleansError
                raise OrleansError(
                    f"no silo hosts a version of {interface_name} compatible "
                    f"with requested v{requested_version}")
        silo = director.place(grain_id, requester, candidates)
        return silo, True

    def local_register(self, address: ActivationAddress) -> ActivationAddress:
        """AddSingleActivation (GrainDirectoryPartition.cs:304): first
        registration wins; returns the winning address."""
        cur = self.partition.get(address.grain)
        if cur is not None and cur.silo in self.alive_set:
            return cur
        self.partition[address.grain] = address
        return address

    def local_migrate_register(self, address: ActivationAddress,
                               prev_activation) -> ActivationAddress:
        """Owner-side migrate re-registration: replaces the entry when it
        names the migrating activation (or is dead/absent); an unrelated
        LIVE registration wins instead — same first-wins discipline as
        AddSingleActivation, with the migrating activation's claim carried
        by ``prev_activation``. The owner's own cache entry is dropped so
        lookups it answers from cache never resurrect the old address."""
        cur = self.partition.get(address.grain)
        if cur is not None and cur.silo in self.alive_set and \
                cur.activation != prev_activation and \
                cur.activation != address.activation:
            return cur
        self.partition[address.grain] = address
        self.cache.pop(address.grain, None)
        return address

    def local_unregister(self, address: ActivationAddress) -> None:
        cur = self.partition.get(address.grain)
        if cur is not None and cur.activation == address.activation:
            self.partition.pop(address.grain, None)

    def _cache_put(self, grain_id: GrainId, silo: SiloAddress) -> None:
        self.cache.put(grain_id, silo)

    # ------------------------------------------------------------------
    # Adaptive-cache maintainer (AdaptiveDirectoryCacheMaintainer.cs:243)
    # ------------------------------------------------------------------
    def start_cache_maintainer(self) -> None:
        if self._maintainer_task is None and \
                self.silo.config.directory_cache_refresh_period > 0:
            self._maintainer_task = asyncio.get_running_loop().create_task(
                self._maintainer_loop())

    def stop_cache_maintainer(self) -> None:
        if self._maintainer_task is not None:
            self._maintainer_task.cancel()
            self._maintainer_task = None

    async def _maintainer_loop(self) -> None:
        period = self.silo.config.directory_cache_refresh_period
        while True:
            await asyncio.sleep(period)
            try:
                await self._refresh_hot_entries(period)
            except Exception:  # noqa: BLE001 — next sweep retries
                log.debug("directory cache refresh failed", exc_info=True)

    async def _refresh_hot_entries(self, horizon: float) -> None:
        """Refresh entries accessed since the last sweep that are expired
        or expiring within one period: batch per directory owner, fold
        answers back (same silo → TTL doubles; moved → reset; gone →
        drop). Hot routes stay fresh instead of paying staleness in
        forward hops."""
        gids = self.cache.sweep_candidates(horizon)
        if not gids:
            return
        me = self.silo.silo_address
        by_owner: dict[SiloAddress, list[GrainId]] = {}
        for gid in gids:
            owner = self.ring.owner(gid.uniform_hash)
            if owner is not None:
                by_owner.setdefault(owner, []).append(gid)
        for owner, batch in by_owner.items():
            if owner == me:
                results = await self.target.dir_lookup_many(batch)
            else:
                try:
                    results = await self._target_ref(
                        owner, "dir_lookup_many", batch)
                except Exception:  # noqa: BLE001 — owner mid-death: the
                    # membership sweep clears its range; skip this batch
                    continue
            for gid, silo in zip(batch, results, strict=True):
                self.cache.refresh_result(gid, silo)
            self.silo.stats.increment("directory.cache.refreshed",
                                      len(batch))

    # ------------------------------------------------------------------
    # Membership events (LocalGrainDirectory.cs:431-460 + handoff manager)
    # ------------------------------------------------------------------
    def on_membership_change(self, silos: list[SiloAddress],
                             dead: list[SiloAddress]) -> None:
        # Catalog.OnSiloStatusChange (Catalog.cs:175,1400 via the
        # directory callback, LocalGrainDirectory.cs:274-326): local
        # activations whose directory registration lived on a dead silo's
        # partition lost that registration with the partition — the next
        # remote call would mint a duplicate activation elsewhere and the
        # two would race on storage etags. Deactivate them first (checked
        # against the pre-update ring, which still maps the dead silo's
        # range); the next call re-creates and re-registers cleanly.
        if dead:
            dead_set = set(dead)
            catalog = self.silo.catalog
            for gid, acts in list(catalog.by_grain.items()):
                if gid.is_system_target():
                    continue
                reg_owner = self.ring.owner(gid.uniform_hash)
                if reg_owner in dead_set:
                    for act in list(acts):
                        # stateless workers are never directory-registered
                        # (catalog._init_activation skips them) — nothing
                        # of theirs died with the partition
                        if not act.is_stateless_worker:
                            catalog.schedule_deactivation(act)
        self.ring.update(silos)
        alive = set(silos)
        self.alive_set = alive
        self.alive_list = self.ring.silos
        # type-map exchange bookkeeping (TypeManager refresh on change)
        for d in dead:
            self.versions.forget(d)
        for s in silos:
            if s != self.silo.silo_address and \
                    s not in self.versions.remote_maps:
                self.versions.schedule_fetch(s)
        # drop directory entries for activations on dead silos: the next
        # call re-creates the grain elsewhere (virtual-actor guarantee)
        for gid, addr in list(self.partition.items()):
            if addr.silo not in alive:
                self.partition.pop(gid, None)
        for gid, silo in list(self.cache.items()):
            if silo not in alive:
                self.cache.pop(gid, None)
        # re-range: replicate entries we no longer own to the new owner.
        # The entry is popped only after the new owner acks — during the
        # transfer window both silos answer lookups consistently (the old
        # owner still holds the registration); failed pushes keep the entry
        # here for retry at the next membership change.
        moved: dict[SiloAddress, list] = {}
        for gid, addr in self.partition.items():
            owner = self.ring.owner(gid.uniform_hash)
            if owner is not None and owner != self.silo.silo_address:
                moved.setdefault(owner, []).append((gid, addr))
        for owner, entries in moved.items():
            asyncio.ensure_future(self._handoff_entries(owner, entries))

    async def _handoff_entries(self, owner: SiloAddress, entries: list) -> None:
        try:
            await self._target_ref(owner, "dir_handoff",
                                   [addr for _, addr in entries])
        except Exception:  # noqa: BLE001 — keep entries; retried on next change
            log.debug("re-range handoff to %s failed; entries retained", owner)
            return
        for gid, addr in entries:
            cur = self.partition.get(gid)
            if cur is not None and cur.activation == addr.activation:
                self.partition.pop(gid, None)

    async def handoff_all(self) -> None:
        """Graceful-stop handoff: push the whole partition to successors
        (GrainDirectoryHandoffManager on ShuttingDown). Without this,
        registrations for grains hosted on OTHER silos die with this
        partition and single-activation breaks (duplicate activations)."""
        others = [s for s in self._alive() if s != self.silo.silo_address]
        if not others:
            return
        ring = ConsistentRing(others)
        moved: dict[SiloAddress, list[ActivationAddress]] = {}
        for gid, addr in self.partition.items():
            if addr.silo == self.silo.silo_address:
                continue  # our activations die with us
            owner = ring.owner(gid.uniform_hash)
            if owner is not None:
                moved.setdefault(owner, []).append(addr)
        for owner, entries in moved.items():
            try:
                await self._target_ref(owner, "dir_handoff", entries)
            except Exception:  # noqa: BLE001
                log.debug("handoff to %s failed", owner)
        self.partition.clear()


async def _swallow(fut):
    try:
        await fut
    except Exception:  # noqa: BLE001
        pass


def _dir_type_code() -> int:
    from ..core.ids import type_code_of
    return type_code_of(DIRECTORY_TARGET)
