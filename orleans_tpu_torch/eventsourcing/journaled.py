"""JournaledGrain: grain state as a fold over an event log.

Re-design of Orleans' src/Orleans.EventSourcing/:
``JournaledGrain.cs:18,40`` (RaiseEvent/ConfirmEvents, TentativeState vs
confirmed State, TransitionState), the three ``ILogViewAdaptor`` providers —
``LogStorage/LogViewAdaptor.cs:389`` (full event log persisted),
``StateStorage/LogViewAdaptor.cs:362`` (snapshot + version),
``CustomStorage/LogViewAdaptor.cs:378`` (user-defined read/apply) — and the
CAS-retry write loop of ``Common/PrimaryBasedLogViewAdaptor.cs:907`` (on
etag conflict: reload the primary, replay pending entries, write again).

**Replication + notifications** (the notification-tracking half of
``PrimaryBasedLogViewAdaptor.cs:907``): a ``@replicated_journal`` grain
hosts one replica per silo (reads scale out; writes serialize through the
storage CAS). After a replica confirms events it broadcasts
``(from_version, events, new_version)`` to every peer silo's journal
notification target; receivers fold in-order notifications directly into
their confirmed view — no storage re-read — buffer out-of-order ones, and
catch up from storage only when a gap persists. Failed notification sends
are re-driven by a writer-side retry worker with backoff (the reference's
notification worker loop).

The port's copy of ``orleans_tpu.eventsourcing.journaled``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Any

from ..core.errors import InconsistentStateError, OrleansError
from ..core.serialization import deep_copy
from ..runtime.grain import Grain

if TYPE_CHECKING:
    pass

log = logging.getLogger("orleans.eventsourcing")

__all__ = ["JournaledGrain", "log_consistency", "replicated_journal",
           "LogViewAdaptor", "LogStorageAdaptor", "StateStorageAdaptor",
           "CustomStorageAdaptor"]

MAX_WRITE_RETRIES = 16
# out-of-order notifications buffered before falling back to a storage read
MAX_NOTIFICATION_BUFFER = 64
# a version gap older than this triggers a storage catch-up even if the
# buffer is small (a dropped notification would otherwise stall the
# replica forever at low write rates)
GAP_CATCH_UP_DELAY = 1.0
NOTIFY_RETRIES = 3
NOTIFY_RETRY_BASE = 0.1
JOURNAL_NOTIFY_TARGET = "journal-notify"


class LogViewAdaptor:
    """Consistency-provider contract (ILogViewAdaptor): load the confirmed
    view, append confirmed events."""

    def __init__(self, storage_name: str = "Default"):
        self.storage_name = storage_name

    def _provider(self, grain: "JournaledGrain"):
        provider = grain._activation.runtime.storage_manager.get(
            self.storage_name)
        if provider is None:
            raise OrleansError(
                f"no storage provider {self.storage_name!r} for journal")
        return provider

    async def load(self, grain: "JournaledGrain") -> tuple[Any, int]:
        raise NotImplementedError

    async def append(self, grain: "JournaledGrain", events: list
                     ) -> tuple[Any, int]:
        """Persist ``events``; returns (new confirmed state, new version).
        Must be CAS-safe against concurrent writers (duplicate activation
        races): conflict → reload + replay + retry."""
        raise NotImplementedError

    def notify(self, grain: "JournaledGrain", events: list) -> None:
        """Multi-cluster notification hook (notification tracking in
        PrimaryBasedLogViewAdaptor) — no-op in single-cluster scope."""


class LogStorageAdaptor(LogViewAdaptor):
    """Persists the complete event log; the view is a fold."""

    def _key(self, grain) -> str:
        return f"journal-log:{type(grain).__name__}"

    async def load(self, grain):
        provider = self._provider(grain)
        data, etag = await provider.read(self._key(grain), grain.grain_id)
        grain.__journal_etag__ = etag
        events = data["log"] if data else []
        state = grain.initial_state()
        for e in events:
            state = grain.apply_event(state, e)
        return state, len(events)

    async def append(self, grain, events):
        provider = self._provider(grain)
        for _ in range(MAX_WRITE_RETRIES):
            data, etag = await provider.read(self._key(grain), grain.grain_id)
            logged = data["log"] if data else []
            try:
                new_etag = await provider.write(
                    self._key(grain), grain.grain_id,
                    {"log": logged + list(events)}, etag=etag)
            except InconsistentStateError:
                continue  # raced another writer: reload + retry
            grain.__journal_etag__ = new_etag
            state = grain.initial_state()
            for e in logged + list(events):
                state = grain.apply_event(state, e)
            return state, len(logged) + len(events)
        raise OrleansError("journal append: CAS retry exhausted")


class StateStorageAdaptor(LogViewAdaptor):
    """Persists (snapshot, version) only — events are not retained."""

    def _key(self, grain) -> str:
        return f"journal-state:{type(grain).__name__}"

    async def load(self, grain):
        provider = self._provider(grain)
        data, etag = await provider.read(self._key(grain), grain.grain_id)
        grain.__journal_etag__ = etag
        if data is None:
            return grain.initial_state(), 0
        return data["snapshot"], data["version"]

    async def append(self, grain, events):
        provider = self._provider(grain)
        for _ in range(MAX_WRITE_RETRIES):
            data, etag = await provider.read(self._key(grain), grain.grain_id)
            if data is None:
                state, version = grain.initial_state(), 0
            else:
                state, version = data["snapshot"], data["version"]
            for e in events:
                state = grain.apply_event(state, e)
            version += len(events)
            try:
                new_etag = await provider.write(
                    self._key(grain), grain.grain_id,
                    {"snapshot": state, "version": version}, etag=etag)
            except InconsistentStateError:
                continue
            grain.__journal_etag__ = new_etag
            return state, version
        raise OrleansError("journal snapshot write: CAS retry exhausted")


class CustomStorageAdaptor(LogViewAdaptor):
    """Delegates persistence to the grain (ICustomStorageInterface):
    ``read_state_from_storage() -> (state, version)`` and
    ``apply_updates_to_storage(events, expected_version) -> bool``."""

    async def load(self, grain):
        return await grain.read_state_from_storage()

    async def append(self, grain, events):
        for _ in range(MAX_WRITE_RETRIES):
            ok = await grain.apply_updates_to_storage(
                list(events), grain.version)
            if ok:
                state = grain._confirmed
                for e in events:
                    state = grain.apply_event(state, e)
                return state, grain.version + len(events)
            # version conflict: reload and retry on top of the new view
            state, version = await grain.read_state_from_storage()
            grain._confirmed, grain._version = state, version
        raise OrleansError("custom-storage append: retry exhausted")


_ADAPTORS = {
    "log_storage": LogStorageAdaptor,
    "state_storage": StateStorageAdaptor,
    "custom": CustomStorageAdaptor,
}


def replicated_journal(cls: type) -> type:
    """Class decorator: host one replica of this journaled grain per silo
    (stateless-worker placement, cap 1) and keep replicas converged via
    confirmed-event notifications instead of storage re-reads — the
    replica/notification model of PrimaryBasedLogViewAdaptor.cs:907
    applied across silos. Writes from any replica remain safe: the
    adaptors' CAS append serializes them through storage."""
    cls.__journal_replicated__ = True
    cls.__orleans_stateless_worker__ = 1  # one local replica per silo
    return cls


class JournalNotificationTarget:
    """Per-silo system target receiving confirmed-event notifications and
    folding them into local replicas as gated turns (the receiving half
    of the reference's notification tracking)."""

    def __init__(self, silo) -> None:
        self.silo = silo

    async def journal_notify(self, class_name: str, key, key_ext,
                             from_version: int, events: list,
                             new_version: int) -> bool:
        from ..core.ids import GrainId, GrainType
        gid = GrainId.for_grain(GrainType.of(class_name), key, key_ext)
        acts = self.silo.catalog.by_grain.get(gid)
        if not acts:
            return False   # no local replica: it will load from storage
        for act in list(acts):
            inst = act.grain_instance
            if isinstance(inst, JournaledGrain):
                # run as a gated turn so the fold never interleaves with
                # a half-finished grain turn on the same activation
                await self.silo.dispatcher.run_closed_turn(
                    act, lambda i=inst: i._fold_notification(
                        from_version, list(events), new_version))
        return True


def install_journal_notifier(silo) -> None:
    """Idempotently register the notification system target on a silo
    (called from Silo.start when a replicated journal class is hosted)."""
    if getattr(silo, "_journal_notifier", None) is None:
        silo._journal_notifier = JournalNotificationTarget(silo)
        silo.register_system_target(silo._journal_notifier,
                                    JOURNAL_NOTIFY_TARGET)


async def _notify_silo(silo, peer, class_name: str, key, key_ext,
                       from_version: int, events: list,
                       new_version: int) -> bool:
    """One journal_notify system-target call to ``peer`` (may be this
    silo). Shared by the intra-cluster broadcast and the geo relay."""
    from ..core.ids import GrainId, type_code_of
    from ..core.message import Category
    target = GrainId.system_target(
        type_code_of(JOURNAL_NOTIFY_TARGET), peer)
    return await silo.runtime_client.send_request(
        target_grain=target, grain_class=JournalNotificationTarget,
        interface_name="JournalNotificationTarget",
        method_name="journal_notify",
        args=(class_name, key, key_ext, from_version, list(events),
              new_version),
        kwargs={}, target_silo=peer, category=Category.SYSTEM)


class JournalRelayGrain(Grain):
    """Cross-cluster journal gateway (the ProtocolGateway analog,
    Orleans' src/Orleans.Runtime/LogConsistency/ProtocolGateway.cs):
    a writer cluster pushes confirmed-event notifications to each remote
    cluster's relay grain over the cluster gateway; the relay fans them
    out to every silo of ITS cluster through the same notification target
    the intra-cluster broadcast uses. Keyed by the journaled grain's
    identity so relays for different grains parallelize."""

    async def journal_relay(self, class_name: str, key, key_ext,
                            from_version: int, events: list,
                            new_version: int) -> int:
        silo = self._activation.runtime
        peers = list(getattr(silo.locator, "alive_list", [])) or \
            [silo.silo_address]
        delivered = 0
        for peer in peers:
            try:
                if await _notify_silo(silo, peer, class_name, key, key_ext,
                                      from_version, events, new_version):
                    delivered += 1
            except Exception:  # noqa: BLE001 — a dying silo's replica
                # reloads from storage on next activation
                log.debug("journal relay to %s failed", peer, exc_info=True)
        return delivered


def log_consistency(provider: str, storage_name: str = "Default"):
    """Class decorator choosing the consistency provider
    ([LogConsistencyProvider] attribute analog)."""
    if provider not in _ADAPTORS:
        raise ValueError(f"unknown log-consistency provider {provider!r}; "
                         f"choose from {sorted(_ADAPTORS)}")

    def deco(cls: type) -> type:
        cls.__log_consistency__ = (provider, storage_name)
        return cls

    return deco


class JournaledGrain(Grain):
    """Event-sourced grain base (JournaledGrain<TState,TEvent>).

    Subclasses override ``initial_state()`` and ``apply_event(state, event)``
    (the TransitionState hook) and call ``raise_event``/``confirm_events``.
    """

    __log_consistency__ = ("log_storage", "Default")

    # -- user surface ----------------------------------------------------
    def initial_state(self) -> Any:
        return {}

    def apply_event(self, state: Any, event: Any) -> Any:
        """Default transition: events are dicts merged into a dict state
        (override for real domains)."""
        merged = dict(state)
        merged.update(event)
        return merged

    def raise_event(self, event: Any) -> None:
        """Queue an event (RaiseEvent): reflected in tentative_state now,
        durable after confirm_events."""
        self._pending.append(deep_copy(event))

    def raise_events(self, events: list) -> None:
        for e in events:
            self.raise_event(e)

    async def confirm_events(self) -> None:
        """Persist all pending events (ConfirmEvents)."""
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        try:
            state, version = await self._adaptor.append(self, batch)
        except BaseException:
            # deliberate post-await re-read: events raised DURING the
            # failed append must survive behind the restored batch — the
            # current value is wanted, not the pre-await one
            # otpu: ignore[OTPU003]
            self._pending = batch + self._pending  # keep tentative view
            raise
        self._confirmed, self._version = state, version
        self._adaptor.notify(self, batch)
        if getattr(type(self), "__journal_replicated__", False):
            self._broadcast_confirmed(batch, version)

    # -- replica notifications (PrimaryBasedLogViewAdaptor.cs:907) -------
    def _fold_notification(self, from_version: int, events: list,
                           new_version: int) -> None:
        """Apply a peer's confirmed events without re-reading storage:
        in-order → fold directly; out-of-order → buffer; persistent gap →
        schedule a storage catch-up."""
        if new_version <= self._version:
            return                       # duplicate / already seen
        self._notif_buffer[from_version] = (events, new_version)
        while self._version in self._notif_buffer:
            ev, nv = self._notif_buffer.pop(self._version)
            st = self._confirmed
            for e in ev:
                st = self.apply_event(st, e)
            self._confirmed, self._version = st, nv
        # prune buffered entries the fold has passed
        for fv in [v for v in self._notif_buffer if v < self._version]:
            self._notif_buffer.pop(fv, None)
        if len(self._notif_buffer) > MAX_NOTIFICATION_BUFFER:
            self._notif_buffer.clear()
            # a pending delayed catch-up would see the cleared buffer and
            # declare the gap healed — replace it with an immediate one
            if self._catch_up_task is not None and \
                    not self._catch_up_task.done():
                self._catch_up_task.cancel()
                self._catch_up_task = None
            self._schedule_catch_up(delay=0.0)
        elif self._notif_buffer:
            # a gap exists (a notification was lost or is late): if it
            # persists past GAP_CATCH_UP_DELAY, read storage — without
            # this a dropped notification stalls the replica forever at
            # low write rates
            self._schedule_catch_up(delay=GAP_CATCH_UP_DELAY)

    def _schedule_catch_up(self, delay: float) -> None:
        if self._catch_up_task is not None and not self._catch_up_task.done():
            return
        version_at_schedule = self._version
        act = self._activation

        async def catch_up() -> None:
            if delay:
                await asyncio.sleep(delay)
                if self._version > version_at_schedule or \
                        not self._notif_buffer:
                    return              # the gap healed on its own
            try:
                # run gated on the activation (like the fold) so the load
                # cannot interleave with a grain turn mid-await
                await act.runtime.dispatcher.run_closed_turn(
                    act, self.refresh_now)
            except Exception:  # noqa: BLE001
                log.exception("journal catch-up failed for %s",
                              self.grain_id)

        self._catch_up_task = asyncio.ensure_future(catch_up())

    def _broadcast_confirmed(self, batch: list, new_version: int) -> None:
        """Writer side: push (from_version, events, new_version) to every
        peer silo's notification target, and — when this silo is part of a
        multi-cluster deployment — to every known remote cluster's relay
        grain over the cluster gateways (geo replication: the
        notification-worker half of PrimaryBasedLogViewAdaptor.cs:907
        riding ProtocolGateway.cs). Failures retry with backoff; a cluster
        that stays unreachable catches up from primary storage via the
        replicas' gap machinery once notifications resume."""
        silo = self._activation.runtime
        from_version = new_version - len(batch)
        cname = type(self).__name__
        gid = self.grain_id
        peers = [s for s in getattr(silo.locator, "alive_list", [])
                 if s != silo.silo_address]

        async def notify_one(peer) -> None:
            for attempt in range(NOTIFY_RETRIES):
                try:
                    await _notify_silo(silo, peer, cname, gid.key,
                                       gid.key_ext, from_version,
                                       list(batch), new_version)
                    return
                except Exception:  # noqa: BLE001 — peer may be mid-death;
                    # its replica reloads from storage on next activation
                    await asyncio.sleep(NOTIFY_RETRY_BASE * (2 ** attempt))
            log.warning("journal notification to %s gave up for %s",
                        peer, gid)

        async def notify_cluster(cid: str) -> None:
            for attempt in range(NOTIFY_RETRIES):
                try:
                    client = await silo.gsi._client_for(cid)
                    relay = client.get_grain(
                        JournalRelayGrain, str(gid.key),
                        key_ext=f"{cname}|{gid.key_ext or ''}")
                    await relay.journal_relay(
                        cname, gid.key, gid.key_ext, from_version,
                        list(batch), new_version)
                    return
                except Exception:  # noqa: BLE001 — partition/restart: the
                    # remote replicas' gap catch-up reads primary storage
                    await asyncio.sleep(NOTIFY_RETRY_BASE * (2 ** attempt))
            log.warning("geo journal notification to cluster %s gave up "
                        "for %s", cid, gid)

        tasks = getattr(silo, "_journal_notify_tasks", None)
        if tasks is None:
            tasks = silo._journal_notify_tasks = set()

        def spawn(coro) -> None:
            t = asyncio.ensure_future(coro)
            tasks.add(t)
            t.add_done_callback(tasks.discard)

        for peer in peers:
            spawn(notify_one(peer))
        oracle = getattr(silo, "multicluster", None)
        if oracle is not None and getattr(silo, "gsi", None) is not None:
            for cid in oracle.known_clusters():
                if cid != oracle.cluster_id:
                    spawn(notify_cluster(cid))

    @property
    def state(self) -> Any:
        """Confirmed view (State)."""
        return self._confirmed

    @property
    def tentative_state(self) -> Any:
        """Confirmed + unconfirmed events (TentativeState)."""
        s = deep_copy(self._confirmed)
        for e in self._pending:
            s = self.apply_event(s, e)
        return s

    @property
    def version(self) -> int:
        """Confirmed version = number of confirmed events."""
        return self._version

    @property
    def unconfirmed_events(self) -> list:
        return list(self._pending)

    async def refresh_now(self) -> None:
        """Re-read the confirmed view from storage (RetrieveConfirmedState).
        The in-memory view only moves forward: CAS appends mean the stored
        version is monotone, so a load older than what we already confirmed
        (a read that raced a concurrent local append) is discarded."""
        state, version = await self._adaptor.load(self)
        if version > self._version:
            self._confirmed, self._version = state, version
            for fv in [v for v in self._notif_buffer if v < version]:
                self._notif_buffer.pop(fv, None)

    # -- lifecycle -------------------------------------------------------
    async def on_activate(self) -> None:
        provider, storage_name = type(self).__log_consistency__
        self._adaptor = _ADAPTORS[provider](storage_name)
        self._pending: list = []
        # out-of-order notification buffer: from_version → (events, new_v)
        self._notif_buffer: dict[int, tuple[list, int]] = {}
        self._catch_up_task: asyncio.Task | None = None
        self._confirmed, self._version = await self._adaptor.load(self)

    async def on_deactivate(self) -> None:
        if self._catch_up_task is not None:
            self._catch_up_task.cancel()
            self._catch_up_task = None
