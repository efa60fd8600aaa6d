"""Membership oracle: liveness protocol over a shared CAS table.

Re-design of Orleans' src/Orleans.Runtime/MembershipService/
MembershipOracle.cs:12 — ring-successor probing (probe-target selection
:741-776), vote-based suspect→dead declaration (TryToSuspectOrKill:949),
IAmAlive heartbeat timestamps (:192-208), gossip as a "re-read the table"
hint (:322-336), and status fan-out to subscribers; view bookkeeping from
MembershipOracleData.cs.

Differences from the reference, by design:
  - probes ride the fabric as PING-category system-target requests (the
    Categories.Ping lane) instead of raw sockets, so network partitions
    injected at the fabric affect probes exactly like application traffic;
  - the oracle pushes its merged view to the silo's DistributedLocator
    (ring/directory) and to any ``subscribe``-d listener (reminder service,
    stream balancers) — the SiloStatusChangeNotification fan-out.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import TYPE_CHECKING, Callable

from ..core.ids import GrainId, SiloAddress, type_code_of
from ..core.message import Category
from .table import (
    MembershipEntry,
    MembershipTable,
    SiloStatus,
    TableSnapshot,
)

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.membership")

MEMBERSHIP_TARGET = "MembershipTarget"

# probe round-trip latency histogram (observability.stats.SLO_STATS):
# the PING-lane QoS objective's source
from ..observability.stats import SLO_STATS as _SLO  # noqa: E402

_PROBE_RTT = _SLO["probe_rtt"]

__all__ = ["MembershipOracle", "MembershipTarget", "join_cluster"]


class MembershipTarget:
    """Per-silo membership system target: the remote surface probed and
    gossiped to by peers (the Ping message handler + gossip receiver)."""

    _activation = None

    def __init__(self, oracle: "MembershipOracle"):
        self.oracle = oracle

    async def mbr_ping(self, from_silo: SiloAddress) -> bool:
        return True

    async def mbr_gossip(self, from_silo: SiloAddress) -> None:
        """Gossip is a hint to re-read the table (MembershipOracle.cs:322)."""
        self.oracle.schedule_refresh()


class MembershipOracle:
    """One oracle per silo; installed as ``silo.membership``."""

    def __init__(self, silo: "Silo", table: MembershipTable):
        self.silo = silo
        self.table = table
        cfg = silo.config
        self.probe_period = cfg.membership_probe_period
        self.probe_timeout = getattr(cfg, "membership_probe_timeout",
                                     cfg.membership_probe_period)
        self.missed_limit = cfg.membership_missed_probes_limit
        self.votes_needed = cfg.membership_votes_needed
        self.num_probed = getattr(cfg, "membership_num_probed", 3)
        self.iam_alive_period = getattr(cfg, "membership_iam_alive_period", 5.0)
        self.refresh_period = getattr(cfg, "membership_refresh_period", 5.0)
        self.vote_expiration = getattr(cfg, "membership_vote_expiration",
                                       10 * cfg.membership_probe_period)

        self.target = MembershipTarget(self)
        silo.register_system_target(self.target, MEMBERSHIP_TARGET)

        self.active: dict[SiloAddress, MembershipEntry] = {}
        self.dead: set[SiloAddress] = set()
        self.missed_probes: dict[SiloAddress, int] = {}
        self.declared_dead = False
        self._listeners: list[Callable[[list[SiloAddress], list[SiloAddress]], None]] = []
        self._tasks: list[asyncio.Task] = []
        self._refresh_wanted = asyncio.Event()
        self._stopped = False

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    async def become_active(self) -> None:
        """Join: CAS-insert own row as Active, adopt the table view, start
        the heartbeat/probe/refresh loops (BecomeActive, Silo.cs:478-488)."""
        now = time.time()
        entry = MembershipEntry(
            address=self.silo.silo_address, status=SiloStatus.ACTIVE,
            start_time=now, iam_alive_time=now)
        for _ in range(32):
            snap = await self.table.read_all()
            # prior incarnation at our endpoint must be declared dead first
            prior = [
                (e, tag) for e, tag in snap.entries
                if e.address.same_endpoint(self.silo.silo_address)
                and e.address.generation < self.silo.silo_address.generation
                and e.status != SiloStatus.DEAD
            ]
            if prior:
                e, tag = prior[0]
                e = e.copy()
                e.status = SiloStatus.DEAD
                await self.table.update_row(e, tag, snap.version.next())
                continue
            if await self.table.insert_row(entry, snap.version.next()):
                break
        else:
            raise RuntimeError("membership table join: CAS retry exhausted")
        await self.refresh(gossip=True)
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._iam_alive_loop()),
            loop.create_task(self._probe_loop()),
            loop.create_task(self._refresh_loop()),
        ]

    async def shutdown(self) -> None:
        """Graceful goodbye: own row → ShuttingDown → Dead, gossip out
        (Silo stop path)."""
        self._stopped = True
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()
        for _ in range(16):
            snap = await self.table.read_all()
            mine = snap.get(self.silo.silo_address)
            if mine is None:
                break
            e, tag = mine
            e = e.copy()
            e.status = SiloStatus.DEAD
            if await self.table.update_row(e, tag, snap.version.next()):
                break
        self._gossip_all()

    def stop(self) -> None:
        """Hard stop (kill path): no table write, just cancel timers."""
        self._stopped = True
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()

    # ------------------------------------------------------------------
    # View + fan-out
    # ------------------------------------------------------------------
    def subscribe(self, listener: Callable[[list[SiloAddress], list[SiloAddress]], None]) -> None:
        """SiloStatusChangeNotification subscription (Silo.cs:346-356)."""
        self._listeners.append(listener)

    def active_silos(self) -> list[SiloAddress]:
        return sorted(self.active, key=lambda a: a.uniform_hash)

    def is_dead(self, silo: SiloAddress) -> bool:
        return silo in self.dead

    def _process_snapshot(self, snap: TableSnapshot) -> None:
        new_active: dict[SiloAddress, MembershipEntry] = {}
        new_dead: set[SiloAddress] = set(self.dead)
        for e, _tag in snap.entries:
            if e.status == SiloStatus.ACTIVE:
                new_active[e.address] = e
            elif e.status == SiloStatus.DEAD:
                new_dead.add(e.address)
        for d in new_dead:
            new_active.pop(d, None)

        me = self.silo.silo_address
        if me in new_dead and not self.declared_dead:
            # the cluster voted us dead (partition survivor side won):
            # a dead silo must never come back — fast-kill ourselves
            # (MembershipOracle KillMyself semantics)
            self.declared_dead = True
            log.warning("%s: declared dead by the cluster; stopping", me)
            asyncio.ensure_future(self.silo.stop(graceful=False))

        died = [d for d in new_dead if d not in self.dead]
        changed = (set(new_active) != set(self.active)) or died
        self.active = new_active
        self.dead = new_dead
        for d in died:
            self.missed_probes.pop(d, None)
        if changed:
            alive = self.active_silos()
            if me not in alive and not self.declared_dead:
                alive = sorted({*alive, me}, key=lambda a: a.uniform_hash)
            self.silo.locator.on_membership_change(alive, died)
            for d in died:
                self.silo.runtime_client.break_outstanding_to_dead_silo(d)
            for listener in list(self._listeners):
                try:
                    listener(alive, died)
                except Exception:  # noqa: BLE001
                    log.exception("membership listener failed")

    async def refresh(self, gossip: bool = False) -> None:
        snap = await self.table.read_all()
        self._process_snapshot(snap)
        if gossip:
            self._gossip_all()

    def schedule_refresh(self) -> None:
        self._refresh_wanted.set()

    # ------------------------------------------------------------------
    # Heartbeats + probing
    # ------------------------------------------------------------------
    async def _iam_alive_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(self.iam_alive_period)
            try:
                await self.table.update_iam_alive(
                    self.silo.silo_address, time.time())
            except Exception:  # noqa: BLE001
                log.exception("IAmAlive update failed")

    async def _refresh_loop(self) -> None:
        while not self._stopped:
            try:
                await asyncio.wait_for(self._refresh_wanted.wait(),
                                       timeout=self.refresh_period)
            except asyncio.TimeoutError:
                pass
            self._refresh_wanted.clear()
            try:
                await self.refresh()
            except Exception:  # noqa: BLE001
                log.exception("membership refresh failed")

    def _probe_targets(self) -> list[SiloAddress]:
        """Ring successors of this silo (probe-target selection,
        MembershipOracle.cs:741-776)."""
        ring = self.active_silos()
        me = self.silo.silo_address
        if me not in ring:
            return []
        i = ring.index(me)
        succ = [ring[(i + k) % len(ring)] for k in range(1, len(ring))]
        return succ[: self.num_probed]

    async def _probe_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(self.probe_period)
            targets = self._probe_targets()
            await asyncio.gather(
                *(self._probe_one(t) for t in targets),
                return_exceptions=True)

    async def _probe_one(self, target: SiloAddress) -> None:
        gid = GrainId.system_target(type_code_of(MEMBERSHIP_TARGET), target)
        t0 = time.monotonic()
        try:
            fut = self.silo.runtime_client.send_request(
                target_grain=gid, grain_class=MembershipTarget,
                interface_name=MEMBERSHIP_TARGET, method_name="mbr_ping",
                args=(self.silo.silo_address,), kwargs={},
                timeout=self.probe_timeout, target_silo=target,
                category=Category.PING)
            await fut
        except Exception:  # noqa: BLE001 — timeout/rejection = missed probe
            # a miss IS a slow probe to the RTT objective — clamped UP
            # to the probe timeout, because a fast failure (connection
            # refused, immediate rejection) is at least as bad as a
            # timeout: observing its ~0 elapsed would count an outage's
            # probes as GOOD events and keep the objective green
            self.silo.stats.observe(
                _PROBE_RTT, max(time.monotonic() - t0, self.probe_timeout))
            missed = self.missed_probes.get(target, 0) + 1
            self.missed_probes[target] = missed
            self.silo.stats.increment("membership.probe.missed")
            if missed >= self.missed_limit and target in self.active:
                await self.try_suspect_or_kill(target)
        else:
            # probe round-trip latency (a few observations per second at
            # most — the QoS-category SLO source: if PING traffic ever
            # sits behind application load or batching accumulators,
            # this histogram's tail shows it BEFORE silos get voted dead)
            self.silo.stats.observe(_PROBE_RTT, time.monotonic() - t0)
            self.missed_probes[target] = 0

    # ------------------------------------------------------------------
    # Suspicion + kill (TryToSuspectOrKill, MembershipOracle.cs:949)
    # ------------------------------------------------------------------
    async def try_suspect_or_kill(self, target: SiloAddress) -> None:
        for _ in range(8):
            snap = await self.table.read_all()
            row = snap.get(target)
            if row is None:
                return
            entry, tag = row
            if entry.status == SiloStatus.DEAD:
                self.schedule_refresh()
                return
            now = time.time()
            entry = entry.copy()
            votes = entry.fresh_votes(self.vote_expiration, now)
            my_vote = self.silo.silo_address.endpoint
            if my_vote not in (v for v, _ in votes):
                votes.append((my_vote, now))
            entry.suspect_times = votes
            # enough distinct voters (capped by cluster size) → declare dead
            needed = min(self.votes_needed, max(1, len(self.active) - 1))
            if len(votes) >= needed:
                entry.status = SiloStatus.DEAD
                log.warning("%s: declaring %s dead (%d votes)",
                            self.silo.silo_address, target, len(votes))
            if await self.table.update_row(entry, tag, snap.version.next()):
                await self.refresh(gossip=True)
                return
            # CAS lost: someone else voted concurrently — retry with new etag

    # ------------------------------------------------------------------
    def _gossip_all(self) -> None:
        """One-way gossip hint to every active peer."""
        me = self.silo.silo_address
        for peer in list(self.active):
            if peer == me:
                continue
            gid = GrainId.system_target(type_code_of(MEMBERSHIP_TARGET), peer)
            try:
                self.silo.runtime_client.send_request(
                    target_grain=gid, grain_class=MembershipTarget,
                    interface_name=MEMBERSHIP_TARGET, method_name="mbr_gossip",
                    args=(me,), kwargs={}, is_one_way=True,
                    target_silo=peer, category=Category.PING)
            except Exception:  # noqa: BLE001
                pass


def join_cluster(silo: "Silo", table: MembershipTable) -> MembershipOracle:
    """Install a membership oracle on a silo (must be called before
    ``silo.start()``; the silo's start path calls ``become_active``)."""
    oracle = MembershipOracle(silo, table)
    silo.membership = oracle
    return oracle
