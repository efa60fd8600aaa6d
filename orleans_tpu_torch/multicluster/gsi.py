"""Global-Single-Instance (GSI) registration protocol.

Re-design of Orleans' src/Orleans.Runtime/GrainDirectory/
MultiClusterRegistration/: ``GlobalSingleInstanceRegistrar.cs`` +
``ClusterGrainDirectory.cs:86-140`` — ownership states
RequestedOwnership/Owned/Doubtful/Cached/RaceLoser with lexicographic race
resolution, and ``GlobalSingleInstanceActivationMaintainer`` retrying
Doubtful entries.

The cross-cluster query is abstracted as ``peer_query(cluster_id, grain_id)
-> (state, owner_cluster)``; in-proc multi-fabric tests bind it directly,
a DCN deployment binds it to remote cluster-gateway calls.

The port's copy of ``orleans_tpu.multicluster.gsi``, with one repair: the
configuration hook's demotion task is held in ``GsiRuntime._tasks`` until
it ends. The JAX package creates it with no strong reference, and the
event loop holds tasks weakly, so a demotion awaiting a future that only
it references can be collected mid-flight.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from dataclasses import dataclass
from enum import Enum
from typing import Awaitable, Callable

from ..core.ids import GrainId

log = logging.getLogger("orleans.multicluster.gsi")

__all__ = ["GsiState", "GsiEntry", "GlobalSingleInstanceRegistrar"]


class GsiState(str, Enum):
    """Ownership states (ActivationStatus in the reference protocol)."""

    REQUESTED_OWNERSHIP = "RequestedOwnership"
    OWNED = "Owned"
    DOUBTFUL = "Doubtful"
    CACHED = "Cached"
    RACE_LOSER = "RaceLoser"


@dataclass
class GsiEntry:
    grain_id: GrainId
    state: GsiState
    owner_cluster: str


PeerQuery = Callable[[str, GrainId], Awaitable[tuple[GsiState | None, str | None]]]


class GlobalSingleInstanceRegistrar:
    """One per cluster: decides cluster-level ownership of grain ids."""

    def __init__(self, cluster_id: str, known_clusters: Callable[[], list[str]],
                 peer_query: PeerQuery):
        self.cluster_id = cluster_id
        self.known_clusters = known_clusters
        self.peer_query = peer_query
        self.entries: dict[GrainId, GsiEntry] = {}

    def status_of(self, grain_id: GrainId) -> tuple[GsiState | None, str | None]:
        """The remote-query surface (ClusterGrainDirectory.ProcessRequest)."""
        e = self.entries.get(grain_id)
        return (e.state, e.owner_cluster) if e else (None, None)

    async def register(self, grain_id: GrainId) -> GsiEntry:
        """Try to own ``grain_id`` globally (GSI protocol rounds):

        1. mark RequestedOwnership locally;
        2. query every other cluster;
        3. any OWNED elsewhere → we become CACHED at that owner;
           a concurrent RequestedOwnership elsewhere → lexicographically
           smaller cluster id wins, loser becomes RACE_LOSER then CACHED;
           peers unreachable → DOUBTFUL (owned-but-retry, maintainer job).
        """
        cur = self.entries.get(grain_id)
        if cur is not None and cur.state in (GsiState.OWNED, GsiState.CACHED):
            return cur
        entry = GsiEntry(grain_id, GsiState.REQUESTED_OWNERSHIP,
                         self.cluster_id)
        self.entries[grain_id] = entry
        peers = [c for c in self.known_clusters() if c != self.cluster_id]
        unreachable = False
        for peer in peers:
            try:
                state, owner = await self.peer_query(peer, grain_id)
            except Exception:  # noqa: BLE001
                unreachable = True
                continue
            if state == GsiState.OWNED:
                entry.state = GsiState.CACHED
                entry.owner_cluster = owner or peer
                return entry
            if state == GsiState.REQUESTED_OWNERSHIP:
                # simultaneous race: lexicographic winner
                if peer < self.cluster_id:
                    entry.state = GsiState.RACE_LOSER
                    entry.owner_cluster = peer
                    # loser re-queries later; the winner transitions to OWNED
                    return entry
        entry.state = GsiState.DOUBTFUL if unreachable else GsiState.OWNED
        entry.owner_cluster = self.cluster_id
        return entry

    async def retry_doubtful(self) -> list[GrainId]:
        """GlobalSingleInstanceActivationMaintainer: re-run the protocol for
        Doubtful and RaceLoser entries. Returns the grain ids that ceded
        ownership (became CACHED) — their local activations must die."""
        ceded: list[GrainId] = []
        for gid, e in list(self.entries.items()):
            if e.state in (GsiState.DOUBTFUL, GsiState.RACE_LOSER):
                del self.entries[gid]
                new = await self.register(gid)
                if new.state == GsiState.CACHED:
                    ceded.append(gid)
        return ceded

    def unregister(self, grain_id: GrainId) -> None:
        self.entries.pop(grain_id, None)


# ---------------------------------------------------------------------------
# Cluster-level wiring: the directory grain, the cross-cluster bridge, the
# Doubtful-retry maintainer, and incoming-call forwarding
# ---------------------------------------------------------------------------

def global_single_instance(cls: type) -> type:
    """Class decorator: one activation of each key across ALL clusters
    ([GlobalSingleInstance]). Calls arriving in a non-owner cluster are
    forwarded to the owner cluster's gateway (return-to-origin forwarding,
    Dispatcher.cs:534-546)."""
    cls.__orleans_global_single_instance__ = True
    return cls


def _make_grain_base():
    """Build the per-cluster directory grain (one activation, key="gsi"):
    authoritative GSI ownership state + the grain-call surface remote
    clusters query (ClusterGrainDirectory.cs:86-140). Built lazily to
    avoid a module import cycle with the runtime.

    The ownership map is the protocol's truth, so it must not vanish with
    an idle sweep or a host-silo death: the grain is pinned against idle
    collection AND persists its entries (StatefulGrain) — a reactivation
    anywhere rebuilds the registrar from storage before answering."""
    from ..runtime.grain import StatefulGrain, collection_age

    from ..runtime.grain import reentrant

    # Reentrant like the reference's interleaving ClusterGrainDirectory
    # SystemTarget: acquire() awaits cross-cluster peer queries, and two
    # clusters' simultaneous first-touches would otherwise deadlock each
    # other's directory turns into response-timeout DOUBTFULs (duplicate
    # owners on a healthy network).
    @reentrant
    @collection_age(10 * 365 * 24 * 3600.0)   # pinned: never idle-collect
    class _ClusterDirectoryGrain(StatefulGrain):
        def _registrar_ref(self) -> GlobalSingleInstanceRegistrar:
            reg = getattr(self, "_registrar", None)
            if reg is None:
                gsi = self._activation.runtime.gsi
                reg = self._registrar = GlobalSingleInstanceRegistrar(
                    gsi.cluster_id, gsi.known_clusters, gsi.peer_query)
                for gid, state, owner in self.state.get("entries", []):
                    reg.entries[gid] = GsiEntry(gid, GsiState(state), owner)
            return reg

        async def _persist(self) -> None:
            reg = self._registrar_ref()
            self.state["entries"] = [
                (gid, e.state.value, e.owner_cluster)
                for gid, e in reg.entries.items()]
            try:
                await self.write_state()
            except Exception:  # noqa: BLE001 — best-effort durability;
                # in-memory state still serves until the next mutation
                log.exception("GSI directory persist failed")

        async def acquire(self, grain_id: GrainId) -> tuple[str, str]:
            reg = self._registrar_ref()
            before = reg.entries.get(grain_id)
            e = await reg.register(grain_id)
            if before is None or before.state != e.state:
                await self._persist()
            return (e.state.value, e.owner_cluster)

        async def status(self, grain_id: GrainId
                         ) -> tuple[str | None, str | None]:
            state, owner = self._registrar_ref().status_of(grain_id)
            return (state.value if state else None, owner)

        async def release(self, grain_id: GrainId) -> None:
            self._registrar_ref().unregister(grain_id)
            await self._persist()

        async def retry_doubtful(self) -> list:
            reg = self._registrar_ref()
            had_doubt = any(e.state in (GsiState.DOUBTFUL,
                                        GsiState.RACE_LOSER)
                            for e in reg.entries.values())
            ceded = await reg.retry_doubtful()
            if had_doubt:
                await self._persist()
            return ceded

        async def cached_grains(self) -> list:
            """Grain ids this cluster holds as CACHED (owned elsewhere) —
            the maintainer's duplicate-deactivation sweep input."""
            return [gid for gid, e in self._registrar_ref().entries.items()
                    if e.state == GsiState.CACHED]

        async def demote_removed_owners(self, active: list) -> int:
            """Admin-config removal semantics: entries whose owner
            cluster was removed from the multi-cluster configuration
            become DOUBTFUL, so the maintainer re-runs the protocol
            against the REMAINING clusters and the grains re-home
            (typically to this cluster, now that the old owner is no
            longer queried). Entries we own ourselves are untouched."""
            reg = self._registrar_ref()
            active_set = set(active)
            demoted = 0
            for e in reg.entries.values():
                # CACHED/RACE_LOSER only: already-Doubtful entries are the
                # maintainer's job regardless — recounting them here would
                # re-persist and re-log on every later config event
                if e.owner_cluster != reg.cluster_id \
                        and e.owner_cluster not in active_set \
                        and e.state in (GsiState.CACHED,
                                        GsiState.RACE_LOSER):
                    e.state = GsiState.DOUBTFUL
                    demoted += 1
            if demoted:
                await self._persist()
            return demoted

    _ClusterDirectoryGrain.__name__ = "ClusterDirectoryGrain"
    return _ClusterDirectoryGrain


_grain_cls_cache: list = []


def cluster_directory_grain_class() -> type:
    if not _grain_cls_cache:
        _grain_cls_cache.append(_make_grain_base())
    return _grain_cls_cache[0]


class GsiRuntime:
    """Per-silo GSI services (installed as ``silo.gsi``): the cross-cluster
    peer-query bridge over cluster gateways, an incoming-call decision
    cache, and the Doubtful-retry maintainer
    (GlobalSingleInstanceActivationMaintainer)."""

    def __init__(self, silo, oracle, maintainer_period: float = 1.0):
        self.silo = silo
        self.oracle = oracle
        self.cluster_id = oracle.cluster_id
        self.maintainer_period = maintainer_period
        self._clients: dict[str, object] = {}   # cluster_id -> GatewayClient
        self._client_locks: dict[str, asyncio.Lock] = {}
        self._maintainer: asyncio.Task | None = None
        # configuration-change tasks, held until they end (the loop keeps
        # only weak references)
        self._tasks: set[asyncio.Task] = set()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self._maintainer is None:
            self._maintainer = asyncio.get_running_loop().create_task(
                self._maintainer_loop())
        if self._on_config not in self.oracle.config_listeners:
            self.oracle.config_listeners.append(self._on_config)

    async def stop(self) -> None:
        if self._maintainer is not None:
            self._maintainer.cancel()
            self._maintainer = None
        with contextlib.suppress(ValueError):
            self.oracle.config_listeners.remove(self._on_config)
        for c in self._clients.values():
            try:
                # close_async tears down the reconnect loop + sockets;
                # the sync close() only breaks pending callbacks
                await c.close_async()
            except Exception:  # noqa: BLE001
                pass
        self._clients.clear()

    def known_clusters(self) -> list[str]:
        return self.oracle.known_clusters()

    def _on_config(self, config: dict) -> None:
        """A new admin configuration landed (injected here or learned via
        gossip): demote GSI entries owned by removed clusters so the
        maintainer re-homes them, and drop cached gateway clients to
        clusters no longer in the network."""
        if config is None:
            return
        active = list(config["clusters"])
        loop = asyncio.get_running_loop()

        async def apply() -> None:
            for cid in [c for c in self._clients if c not in active]:
                client = self._clients.pop(cid, None)
                if client is not None:
                    try:
                        await client.close_async()
                    except Exception:  # noqa: BLE001
                        pass
            if self.silo.status != "Running":
                return
            try:
                n = await self._directory().demote_removed_owners(active)
                if n:
                    log.info("multicluster config change: %d GSI entries "
                             "demoted to Doubtful for re-homing", n)
            except Exception:  # noqa: BLE001
                log.exception("removed-owner demotion failed")

        task = loop.create_task(apply())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    # -- local directory surface -----------------------------------------
    def _directory(self):
        return self.silo.grain_factory.get_grain(
            cluster_directory_grain_class(), "gsi")

    async def acquire(self, grain_id: GrainId) -> tuple[str, str]:
        return tuple(await self._directory().acquire(grain_id))

    async def status(self, grain_id: GrainId):
        return tuple(await self._directory().status(grain_id))

    # -- cross-cluster bridge --------------------------------------------
    async def _client_for(self, cluster_id: str):
        client = self._clients.get(cluster_id)
        if client is not None and getattr(client, "connected", False):
            return client
        lock = self._client_locks.setdefault(cluster_id, asyncio.Lock())
        async with lock:  # dedup concurrent connects; one client per peer
            client = self._clients.get(cluster_id)
            if client is not None and getattr(client, "connected", False):
                return client
            if client is not None:
                try:  # replaced stale client: tear down its reconnector
                    await client.close_async()
                except Exception:  # noqa: BLE001
                    pass
                self._clients.pop(cluster_id, None)
            gateways = self.oracle.gateways_of(cluster_id)
            if not gateways:
                raise ConnectionError(f"no known gateways for {cluster_id}")
            from ..runtime.socket_fabric import GatewayClient
            client = GatewayClient([g.endpoint for g in gateways],
                                   response_timeout=5.0)
            await client.connect()
            self._clients[cluster_id] = client
            return client

    async def peer_query(self, cluster_id: str, grain_id: GrainId
                         ) -> tuple[GsiState | None, str | None]:
        """Query another cluster's directory over its gateway (the
        cross-cluster half of ClusterGrainDirectory.ProcessRequest)."""
        client = await self._client_for(cluster_id)
        state, owner = await client.get_grain(
            cluster_directory_grain_class(), "gsi").status(grain_id)
        return (GsiState(state) if state else None, owner)

    async def forward_call(self, owner_cluster: str, msg) -> object:
        """Return-to-origin forwarding: run the grain call in the owner
        cluster via its gateway and hand back the result."""
        client = await self._client_for(owner_cluster)
        args, kwargs = msg.body if msg.body is not None else ((), {})
        return await client.send_request(
            target_grain=msg.target_grain, grain_class=None,
            interface_name=msg.interface_name, method_name=msg.method_name,
            args=args, kwargs=kwargs)

    # -- maintainer ------------------------------------------------------
    async def _maintainer_loop(self) -> None:
        while True:
            await asyncio.sleep(self.maintainer_period)
            if self.silo.status != "Running":
                continue
            try:
                await self._directory().retry_doubtful()
                # duplicate-deactivation sweep: any LOCAL activation of a
                # grain the cluster directory marks CACHED (owned by
                # another cluster) lost an ownership race — it must die.
                # Every silo sweeps its own catalog, so duplicates die
                # wherever they live, not just on the silo whose poll
                # triggered the cede.
                for gid in await self._directory().cached_grains() or []:
                    for act in list(self.silo.catalog.by_grain.get(gid, [])):
                        self.silo.catalog.schedule_deactivation(act)
            except Exception:  # noqa: BLE001
                log.debug("GSI maintainer round failed", exc_info=True)
