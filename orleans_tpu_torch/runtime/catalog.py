"""Catalog: activation lifecycle + local activation directory + idle GC.

Re-design of Orleans' src/Orleans.Runtime/Catalog/Catalog.cs:26
(``GetOrCreateActivation:443-518``, ``InitActivation:540-576``, deactivation
:780-917), ``ActivationDirectory.cs`` (local map), and
``ActivationCollector.cs:15`` (idle GC, here a periodic sweep task instead of
a ticking wheel — activation counts per silo are far smaller than the
reference's because the million-actor tier lives in the vectorized tables of
orleans_tpu.dispatch, not in per-object activations).

The port's copy of ``orleans_tpu.runtime.catalog``.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import TYPE_CHECKING

from ..core.errors import InconsistentStateError, NonExistentActivationError
from ..core.ids import ActivationId, GrainId
from ..core.message import Message
from .activation import ActivationData, ActivationState
from .grain import StatefulGrain

if TYPE_CHECKING:
    from .silo import Silo

log = logging.getLogger("orleans.catalog")

DEFAULT_COLLECTION_AGE = 2 * 3600.0  # GrainCollectionOptions default (2h)
DEFAULT_COLLECTION_QUANTUM = 60.0


class Catalog:
    def __init__(self, silo: "Silo"):
        self.silo = silo
        # ActivationDirectory: local maps (ActivationDirectory.cs)
        self.by_activation: dict[ActivationId, ActivationData] = {}
        self.by_grain: dict[GrainId, list[ActivationData]] = {}
        self._collector_task: asyncio.Task | None = None
        self.collection_quantum = silo.config.collection_quantum
        self.deactivation_tasks: set[asyncio.Task] = set()

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._collector_task = asyncio.get_running_loop().create_task(
            self._collector_loop())

    async def stop(self) -> None:
        if self._collector_task:
            self._collector_task.cancel()
        # graceful: deactivate all activations (Silo stop path Silo.cs:663-802)
        acts = list(self.by_activation.values())
        await asyncio.gather(
            *(self._deactivate(a) for a in acts), return_exceptions=True)

    # ------------------------------------------------------------------
    # Get-or-create (GetOrCreateActivation:443-518)
    # ------------------------------------------------------------------
    def get_or_create_activation(self, msg: Message) -> ActivationData:
        grain_id = msg.target_grain
        # targeted at a specific activation? (response routing / forwarding)
        if msg.target_activation is not None:
            act = self.by_activation.get(msg.target_activation)
            if act is not None:
                return act
            # dead-target: the caller must re-address (NonExistentActivation)
            raise NonExistentActivationError(
                f"activation {msg.target_activation} not here")
        acts = self.by_grain.get(grain_id)
        if acts:
            if len(acts) == 1 and not self._is_stateless(acts[0].grain_class):
                return acts[0]
            # stateless worker: pick the least-loaded local replica; if all
            # are busy and the cap allows, scale out with a fresh replica
            # (StatelessWorkerDirector.cs:8 + StatelessWorkerPlacement max)
            def load(a: ActivationData) -> int:
                return (len(a.running) + len(a.waiting)
                        + len(a.activating_backlog))
            best = min(acts, key=load)
            cap = getattr(best.grain_class, "__orleans_stateless_worker__", 0)
            if load(best) > 0 and len(acts) < cap:
                return self._create_activation(grain_id, best.grain_class)
            return best
        grain_class = self.silo.registry.resolve(msg.interface_name)
        if grain_class is None:
            raise NonExistentActivationError(
                f"no grain class registered for {msg.interface_name!r}")
        if self._is_stateless(grain_class):
            return self._create_activation(grain_id, grain_class)
        # Single-activation grains: only create here if this silo is the
        # directory-designated host; otherwise the message was misrouted.
        if not self.silo.locator.should_host(grain_id, grain_class, msg):
            raise NonExistentActivationError(
                f"{grain_id} is not placed on this silo")
        return self._create_activation(grain_id, grain_class)

    def maybe_add_stateless_replica(self, grain_id: GrainId,
                                    grain_class: type) -> None:
        """StatelessWorker auto-scale: add a replica if all are busy and the
        local cap allows (StatelessWorkerPlacement max_local)."""
        cap = getattr(grain_class, "__orleans_stateless_worker__", 0)
        acts = self.by_grain.get(grain_id, [])
        if 0 < len(acts) < cap and all(a.running for a in acts):
            self._create_activation(grain_id, grain_class)

    def _is_stateless(self, grain_class: type) -> bool:
        return getattr(grain_class, "__orleans_stateless_worker__", 0) > 0

    def _create_activation(self, grain_id: GrainId,
                           grain_class: type) -> ActivationData:
        # warm the per-class invoker table at activation-class registration
        # (runtime.invoker): the first hot-lane call to this class must not
        # pay the build, and the build itself caches remote_methods on cls
        self.silo.invokers.entry(grain_class)
        act = ActivationData(grain_id, self.silo.runtime, grain_class,
                             max_enqueued=self.silo.config.max_enqueued_requests)
        act.state = ActivationState.ACTIVATING
        self.by_activation[act.activation_id] = act
        self.by_grain.setdefault(grain_id, []).append(act)
        asyncio.get_running_loop().create_task(self._init_activation(act))
        return act

    async def _init_activation(self, act: ActivationData) -> None:
        """InitActivation:540-576: register in the distributed directory,
        construct the grain, run on_activate, then drain the backlog."""
        try:
            if not act.is_stateless_worker and not act.grain_id.is_system_target():
                winner = await self.silo.locator.register(act.address)
                if winner is not None and winner.activation != act.activation_id:
                    # duplicate-activation race: another silo won
                    # (Catalog duplicate resolution) — forward backlog there.
                    self._destroy(act)
                    for m in act.activating_backlog:
                        m.target_silo = winner.silo
                        m.target_activation = None
                        self.silo.dispatcher.transmit(m)
                    act.activating_backlog.clear()
                    return
            instance = self.silo.registry.construct(act.grain_class)
            instance._activation = act
            act.grain_instance = instance
            if isinstance(instance, StatefulGrain):
                act.storage_bridge = self.silo.storage_manager.bridge_for(act)
                await instance.read_state()
            await self.silo.dispatcher_scoped(act, instance.on_activate)
            act.state = ActivationState.VALID
            self.silo.stats.increment("catalog.activations.created")
            backlog, act.activating_backlog = act.activating_backlog, type(act.activating_backlog)()
            for m in backlog:
                self.silo.dispatcher.receive_request(act, m)
        except Exception as e:  # noqa: BLE001 — init failure rejects backlog
            log.exception("activation init failed for %s", act.grain_id)
            self._destroy(act)
            from ..core.message import RejectionType
            for m in act.activating_backlog:
                self.silo.dispatcher._reject(
                    m, RejectionType.TRANSIENT, f"activation init failed: {e}")
            act.activating_backlog.clear()

    # ------------------------------------------------------------------
    # Live migration, inbound half (orleans_tpu.rebalance — the
    # reference's activation-repartitioning rehydrate: Orleans 7 grain
    # migration dehydrates state at the source and rehydrates here)
    # ------------------------------------------------------------------
    async def rehydrate_activation(self, grain_id: GrainId,
                                   grain_class: type, state_payload,
                                   prev_activation) -> ActivationData:
        """Create a VALID activation carrying migrated in-memory state.

        Mirrors ``_create_activation`` + ``_init_activation`` with three
        deltas: registration goes through the locator's migrate path
        (REPLACING the source's entry instead of losing first-wins to it);
        storage is still read first so the etag arms, but the migrated
        state overwrites the stored snapshot (the in-memory rows are newer
        than the last persisted write); and the method is awaited by the
        migration RPC, so the source only destroys its copy after this
        silo is serving. Raises on any failure — the source rolls back."""
        from ..core.errors import OrleansError

        if self.by_grain.get(grain_id):
            raise OrleansError(
                f"{grain_id} already has an activation on this silo")
        self.silo.invokers.entry(grain_class)  # warm the invoker table
        act = ActivationData(grain_id, self.silo.runtime, grain_class,
                             max_enqueued=self.silo.config.max_enqueued_requests)
        act.state = ActivationState.ACTIVATING
        self.by_activation[act.activation_id] = act
        self.by_grain.setdefault(grain_id, []).append(act)
        registered = False
        try:
            winner = await self.silo.locator.migrate_register(
                act.address, prev_activation)
            if winner is not None and \
                    winner.activation != act.activation_id:
                raise OrleansError(
                    f"migration of {grain_id} lost to a live "
                    f"registration on {winner.silo}")
            registered = True
            instance = self.silo.registry.construct(grain_class)
            instance._activation = act
            act.grain_instance = instance
            if isinstance(instance, StatefulGrain):
                act.storage_bridge = self.silo.storage_manager.bridge_for(act)
                await instance.read_state()  # arm the etag
                if state_payload is not None:
                    instance.state = state_payload
            await self.silo.dispatcher_scoped(act, instance.on_activate)
            act.state = ActivationState.VALID
            self.silo.stats.increment("catalog.activations.migrated_in")
        except BaseException:
            self._destroy(act)
            if registered:
                # surrender the claimed entry so the source's rollback
                # re-registration wins cleanly instead of losing
                # first-wins to our dead claim
                try:
                    await self.silo.locator.unregister(act.address)
                except Exception:  # noqa: BLE001 — stale-entry heal covers
                    pass
            # requests that raced in while we were ACTIVATING re-address
            # against the directory (which still/again names the source)
            for m in act.activating_backlog:
                m.target_silo = None
                m.target_activation = None
                self.silo.dispatcher.send_message(m)
            act.activating_backlog.clear()
            raise
        backlog, act.activating_backlog = \
            act.activating_backlog, type(act.activating_backlog)()
        for m in backlog:
            self.silo.dispatcher.receive_request(act, m)
        return act

    # ------------------------------------------------------------------
    # Deactivation (Catalog.cs:780-917)
    # ------------------------------------------------------------------
    def schedule_deactivation(self, act: ActivationData,
                              stuck: bool = False) -> None:
        t = asyncio.get_running_loop().create_task(
            self._deactivate(act, stuck=stuck))
        self.deactivation_tasks.add(t)
        t.add_done_callback(self.deactivation_tasks.discard)

    async def _deactivate(self, act: ActivationData,
                          stuck: bool = False) -> None:
        if act.state in (ActivationState.DEACTIVATING, ActivationState.INVALID):
            return
        act.state = ActivationState.DEACTIVATING
        act.stop_timers()
        if not stuck:  # stuck: no drain wait and no hook — both would hang
            # wait for running turns to drain (bounded)
            deadline = time.monotonic() + self.silo.config.deactivation_timeout
            while act.running and time.monotonic() < deadline:
                await asyncio.sleep(0.005)
            try:
                hook = getattr(act.grain_instance, "on_deactivate", None)
                if hook is not None:
                    await hook()
            except Exception:  # noqa: BLE001
                log.exception("on_deactivate failed for %s", act.grain_id)
        if not act.is_stateless_worker and not act.grain_id.is_system_target():
            try:
                await self.silo.locator.unregister(act.address)
            except Exception:  # noqa: BLE001
                log.exception("directory unregister failed for %s", act.grain_id)
        self._destroy(act)
        self.silo.stats.increment("catalog.activations.destroyed")
        # re-dispatch any stragglers: virtual-actor guarantee — next call
        # recreates elsewhere (Dispatcher forwarding semantics). Internal
        # turns (__timer__ ticks) die with the activation: re-dispatching
        # would resurrect it with a callback bound to the destroyed instance.
        for m in act.waiting:
            if m.method_name == "__timer__":
                _, done = m.body
                if done is not None and not done.done():
                    done.cancel()
                continue
            m.target_silo = None
            m.target_activation = None
            self.silo.dispatcher.send_message(m)
        act.waiting.clear()

    def on_invoke_error(self, act: ActivationData, exc: BaseException) -> None:
        """InconsistentStateException → deactivate so the next call rebuilds
        from storage (InsideRuntimeClient.cs:390-402)."""
        if isinstance(exc, InconsistentStateError):
            self.schedule_deactivation(act)

    def _destroy(self, act: ActivationData) -> None:
        act.state = ActivationState.INVALID
        act.stop_timers()
        self.by_activation.pop(act.activation_id, None)
        lst = self.by_grain.get(act.grain_id)
        if lst:
            try:
                lst.remove(act)
            except ValueError:
                pass
            if not lst:
                self.by_grain.pop(act.grain_id, None)

    # ------------------------------------------------------------------
    # Idle collection (ActivationCollector.cs:15)
    # ------------------------------------------------------------------
    async def _collector_loop(self) -> None:
        while True:
            await asyncio.sleep(self.collection_quantum * (0.9 + 0.2 * random.random()))
            now = time.monotonic()
            stuck_limit = self.silo.config.max_request_processing_time
            for act in list(self.by_activation.values()):
                if act.grain_id.is_system_target():
                    continue  # system targets live as long as the silo
                if act.state != ActivationState.VALID:
                    continue
                if not act.is_inactive:
                    # stuck-activation detection (DeactivateStuckActivation,
                    # ActivationData.cs:583-593, Catalog.cs:787): a turn
                    # exceeding the request-age limit will never finish —
                    # abandon the activation so the next call rebuilds it
                    # elsewhere (the hung coroutine is orphaned; its late
                    # response, if any, is dropped by the callback registry)
                    if act.oldest_running_age() > stuck_limit:
                        log.error(
                            "stuck activation %s: turn running %.1fs "
                            "(limit %.1fs) — deactivating", act.grain_id,
                            act.oldest_running_age(), stuck_limit)
                        self.silo.stats.increment(
                            "catalog.activations.stuck")
                        self.schedule_deactivation(act, stuck=True)
                    continue
                if now < act.keep_alive_until:
                    continue
                age_limit = getattr(act.grain_class,
                                    "__orleans_collection_age__",
                                    self.silo.config.collection_age)
                if act.idle_for() > age_limit:
                    self.schedule_deactivation(act)

    async def collect_idle(self, max_age: float = 0.0) -> int:
        """Forced collection (ManagementGrain.ForceActivationCollection):
        deactivate idle application activations idle ≥ ``max_age``."""
        n = 0
        for act in list(self.by_activation.values()):
            if act.grain_id.is_system_target():
                continue
            if act.state != ActivationState.VALID or not act.is_inactive:
                continue
            if act.idle_for() >= max_age:
                await self._deactivate(act)
                n += 1
        return n

    # ------------------------------------------------------------------
    def activation_count(self) -> int:
        """Application activations (system targets excluded, matching the
        management-grain activation-count semantics)."""
        return sum(1 for a in self.by_activation.values()
                   if not a.grain_id.is_system_target())

    def on_silo_dead(self, silo_address) -> None:
        """Kill activations whose directory registration lived on a dead silo
        (Catalog.OnSiloStatusChange, Catalog.cs:175,1400) — handled by the
        locator invalidating its partition; local activations stay valid."""
