"""Transactional grain state: versioned values with 2PC participation.

Re-design of Orleans' src/Orleans.Transactions/State/
TransactionalState.cs:611 (ITransactionalState<T> — versioned copies per
transaction, read-version validation, prepare/commit/abort participation)
plus the grain-facing facet. The reference validates at a central TM with
version ranges; here validation is pushed to the participant (optimistic
read-version check + short prepare lock), with the TM (manager.py) running
the 2PC rounds — same outcome: serializable multi-grain transactions.

Usage::

    class AccountGrain(TransactionalGrain):
        def __init__(self):
            super().__init__()
            self.balance = TransactionalState("balance", default=0)

        @transactional
        async def deposit(self, amount):
            v = await self.balance.get()
            await self.balance.set(v + amount)

The port's copy of ``orleans_tpu.transactions.state``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any

from ..core.errors import TransactionAbortedError, TransactionConflictError
from ..core.serialization import deep_copy
from ..runtime.grain import Grain, always_interleave
from .context import ambient_txn

__all__ = ["TransactionalState", "TransactionalGrain"]

PREPARE_LOCK_TTL = 10.0  # steal an expired lock: TM died mid-2PC
# how long a non-transactional read keeps retrying resolution of an
# in-doubt prepared write (TM failover window) before serving the last
# committed value
IN_DOUBT_READ_TIMEOUT = 5.0
# a prepare lock held this long is queried against the TM's decision log
# from the entry wait loop (the outcome may be logged but undelivered);
# past IN_DOUBT_FORCE_AFTER the query forces a durable presumed-abort for
# an unknown txn — without this, every waiter sits out the full
# PREPARE_LOCK_TTL after a TM dies mid-2PC, and those 10s stalls are long
# enough to false-kill healthy silos via missed liveness probes
IN_DOUBT_QUERY_AFTER = 0.25
IN_DOUBT_FORCE_AFTER = 1.0
# A workspace blocks other transactions' entry (wound-wait) only this long
# after first touch. Entry blocking is a conflict-avoidance optimization —
# the read-version check at prepare is what guarantees serializability —
# so a root that died without aborting (silo kill) stalls waiters for at
# most this window instead of its full transaction deadline.
INTENT_TTL = 1.0

# Wound registry (wound-wait deadlock avoidance): an OLDER transaction
# arriving at a state held by a YOUNGER one marks the younger txn wounded;
# the wounded txn aborts at its next entry/prepare checkpoint and retries
# at the root with its original priority. Silo-local by design — a wound
# that fails to reach a remote participant merely downgrades that conflict
# to the optimistic read-version abort at prepare (safety is never the
# wound's job). Entries are pruned by age; retries use fresh txn ids, so
# stale wounds can never hit a live transaction.
_wounded: dict[str, float] = {}
_WOUND_TTL = 5.0


def _prune_wounds(now: float) -> None:
    if len(_wounded) > 256:
        for tid, t in list(_wounded.items()):
            if now - t > _WOUND_TTL:
                _wounded.pop(tid, None)


class TransactionalState:
    """One versioned value owned by a grain."""

    def __init__(self, name: str, default: Any = None,
                 storage_name: str = "Default"):
        self.name = name
        self.default = default
        self.storage_name = storage_name
        self.committed: Any = default
        self.committed_version: int = 0
        self.owner: "TransactionalGrain | None" = None
        # txn id -> {"value", "read_version", "written"}
        self.workspace: dict[str, dict] = {}
        self.lock: tuple[str, float] | None = None  # (txn id, deadline)
        self._etag: str | None = None  # storage etag of the committed row
        # durably-prepared write awaiting its outcome: {"txn", "value",
        # "read_version", "written": True}. Persisted at prepare time so a
        # participant crash between prepare and commit cannot lose a write
        # the TM logged as committed (the prepare-record half of
        # TransactionalState.cs's persistence protocol).
        self.pending_prepare: dict | None = None
        self._prep_etag: str | None = None
        self._release_event: asyncio.Event | None = None

    # -- grain-facing API (PerformRead/PerformUpdate) -------------------
    async def get(self) -> Any:
        info = ambient_txn()
        if info is None:
            if self.pending_prepare is not None and self.owner is not None:
                # An in-doubt prepared write is outstanding: the value a
                # logged commit may be about to replace must not be
                # served. One resolution attempt is not enough right
                # after a failover — the TM shard may still be
                # reactivating (its first decision_of can fail on stale
                # directory routes) — so retry briefly; the loop ends the
                # moment the decision applies (or the prepare is dropped
                # as aborted). After sustained TM unreachability we fall
                # through to the committed value: availability over
                # blocking forever, and the prepare stays held for the
                # next reader/prepare to resolve.
                deadline = time.time() + IN_DOUBT_READ_TIMEOUT
                while self.pending_prepare is not None:
                    await self.owner._resolve_in_doubt(time.time(),
                                                       force_query=True)
                    if self.pending_prepare is None or \
                            time.time() >= deadline:
                        break
                    await asyncio.sleep(0.05)
            return deep_copy(self.committed)
        ws = await self._enter(info)
        return ws["value"]

    async def set(self, value: Any) -> None:
        info = ambient_txn()
        if info is None:
            raise TransactionAbortedError(
                f"state {self.name!r} can only be written inside a "
                "transaction (wrap the method with @transactional)")
        ws = await self._enter(info)
        ws["value"] = value
        ws["written"] = True

    def _signal_release(self) -> None:
        ev = self._release_event
        if ev is not None:
            ev.set()

    def _entry_blocked(self, info, now: float) -> bool:
        """Wound-wait entry gate. Returns True while ``info`` must wait:
        a fresh prepare lock (mid-2PC, settles within a round) or another
        transaction's live workspace blocks entry. An OLDER arrival wounds
        every younger holder on its way into the wait — the wounded txn
        aborts at its next checkpoint and retries — so every wait edge
        that survives points young→old and cycles are impossible.
        Workspaces past their deadline are abandoned debris (crashed or
        timed-out root) and are swept; intents older than INTENT_TTL stop
        blocking (dead-root bound) — the read-version check at prepare
        remains the safety net for both relaxations."""
        if self.lock is not None and self.lock[0] != info.id and \
                self.lock[1] > now:
            return True
        blocked = False
        for oid, ows in list(self.workspace.items()):
            if oid == info.id:
                continue
            if ows["deadline"] <= now:
                # past its deadline: wound rather than delete. Deleting
                # would let a prepare that races the deadline see "no
                # workspace → vote True" and commit with this write
                # silently dropped; wounding forces its prepare to vote
                # False. The workspace itself is only reaped well past
                # the deadline (TM deadline checks make a commit
                # impossible by then).
                _wounded.setdefault(oid, now)
                if ows["deadline"] <= now - _WOUND_TTL:
                    self.workspace.pop(oid, None)
                continue
            if now - ows["entered"] >= INTENT_TTL:
                continue  # stale intent (dead root?): enter optimistically
            if oid in _wounded:
                continue  # dying txn: never wait on it (it cannot commit)
            if info.ts < ows["ts"]:
                # older wounds younger holder AND proceeds immediately —
                # the wounded txn can no longer pass prepare(), so entering
                # alongside its doomed workspace is safe (read-version
                # validation is the formal guarantee) and keeps the wound's
                # ≤poll-interval discovery latency off OUR critical path
                _wounded.setdefault(oid, now)
                continue
            blocked = True
        return blocked

    async def _enter(self, info) -> dict:
        ws = self.workspace.get(info.id)
        if ws is None:
            # Pessimistic entry with wound-wait deadlock avoidance (the
            # lock-queue role of the reference's TransactionalState,
            # State/TransactionalState.cs:611): one transaction owns a
            # state's workspace at a time; requesters WAIT for release
            # (young waiting for old is always safe; old waiting for
            # young first wounds it, see _entry_blocked), and wounded
            # transactions abort at this checkpoint to retry at the root
            # with their original priority (context.TransactionInfo.ts) —
            # the oldest transaction is never wounded and never waits on
            # a cycle, so the system always makes progress. (Round 2's
            # optimistic entry measured ~6.5 attempts per commit at
            # concurrency 32 on the contended bank workload; pessimistic
            # entry converts those doomed 2PC rounds into short waits.)
            while True:
                now = time.time()
                if info.id in _wounded:
                    raise TransactionConflictError(
                        f"transaction {info.id} wounded by an older "
                        f"transaction at state {self.name!r}")
                if not self._entry_blocked(info, now):
                    break
                if now >= info.deadline:
                    raise TransactionConflictError(
                        f"transaction {info.id} deadline passed waiting "
                        f"for state {self.name!r}")
                if self.lock is not None and self.lock[0] != info.id and \
                        self.pending_prepare is not None and \
                        self.owner is not None:
                    # blocked on a mid-2PC prepare: the decision may be
                    # logged but undelivered (TM died / slow fan-out) —
                    # resolve through the decision log instead of sitting
                    # out the lock TTL
                    lock_age = PREPARE_LOCK_TTL - (self.lock[1] - now)
                    if lock_age > IN_DOUBT_QUERY_AFTER:
                        await self.owner._resolve_in_doubt(
                            now, force_query=True,
                            resolve_fresh=lock_age > IN_DOUBT_FORCE_AFTER)
                        if not self._entry_blocked(info, time.time()) \
                                and info.id not in _wounded:
                            break  # settled: enter now
                        # else fall through to the paced wait
                ev = self._release_event
                if ev is None or ev.is_set():
                    ev = self._release_event = asyncio.Event()
                try:
                    await asyncio.wait_for(
                        ev.wait(), min(0.05, info.deadline - now))
                except asyncio.TimeoutError:
                    pass  # re-check: TTL expiry / debris sweep
            self.owner._txn_join(info)
            ws = self.workspace[info.id] = {
                "value": deep_copy(self.committed),
                "read_version": self.committed_version,
                "written": False,
                "ts": info.ts,
                "deadline": info.deadline,
                "entered": time.time(),
            }
        return ws

    # -- 2PC participation ----------------------------------------------
    def prepare(self, txn: str, now: float) -> bool:
        ws = self.workspace.get(txn)
        if ws is None:
            return True  # joined via another state of the same grain
        if txn in _wounded:
            return False  # wounded by an older transaction: give way
        if self.lock is not None and self.lock[1] > now and \
                self.lock[0] != txn:
            return False  # another transaction is mid-commit on this state
        if self.pending_prepare is not None and \
                self.pending_prepare["txn"] != txn:
            # an in-doubt durable prepare survived resolution (TM
            # unreachable): its write may still commit — refuse to
            # validate over it even though the lock expired
            return False
        if ws["read_version"] != self.committed_version:
            return False  # someone committed since we read
        self.lock = (txn, now + PREPARE_LOCK_TTL)
        return True

    def commit(self, txn: str, commit_version: int) -> bool:
        """Apply; returns True when the value changed (needs persist)."""
        ws = self.workspace.pop(txn, None)
        if self.lock is not None and self.lock[0] == txn:
            self.lock = None
        if self.pending_prepare is not None and \
                self.pending_prepare["txn"] == txn:
            if ws is None:
                # crash-recovered prepare: the in-memory workspace died
                # with the previous activation, but the durable prepare
                # record carries the write
                ws = self.pending_prepare
            self.pending_prepare = None
        self._signal_release()
        if ws is None or not ws["written"]:
            return False
        self.committed = ws["value"]
        self.committed_version = commit_version
        return True

    def abort(self, txn: str) -> None:
        self.workspace.pop(txn, None)
        now = time.time()
        _wounded.pop(txn, None)
        _prune_wounds(now)
        if self.lock is not None and self.lock[0] == txn:
            self.lock = None
        if self.pending_prepare is not None and \
                self.pending_prepare["txn"] == txn:
            self.pending_prepare = None
        self._signal_release()


class TransactionalGrain(Grain):
    """Base for grains holding TransactionalState: wires state discovery,
    persistence, and the 2PC surface the TM calls (the participant half of
    TransactionAgent.cs:98)."""

    @property
    def _txn_joined(self) -> set[str]:
        # lazy so subclasses need not call super().__init__()
        return self.__dict__.setdefault("_txn_joined_set", set())

    def _txn_states(self) -> list[TransactionalState]:
        out = []
        for v in vars(self).values():
            if isinstance(v, TransactionalState):
                if v.owner is None:
                    v.owner = self
                out.append(v)
        return out

    # -- lifecycle: recover committed values + in-doubt prepares ---------
    async def on_activate(self) -> None:
        silo = self._activation.runtime
        now = time.time()
        for st in self._txn_states():
            provider = silo.storage_manager.get(st.storage_name)
            if provider is None:
                continue
            data, etag = await provider.read(
                self._txn_storage_type(st), self.grain_id)
            st._etag = etag
            if data is not None:
                st.committed = data["value"]
                st.committed_version = data["version"]
            prep, petag = await provider.read(
                self._txn_prep_type(st), self.grain_id)
            st._prep_etag = petag
            if prep is not None and \
                    prep["read_version"] >= st.committed_version:
                # the previous activation died between prepare and
                # outcome: hold the prepare (locked) and ask the TM
                # (a prepare whose read_version is already stale lost
                # its transaction — the commit round would have bumped
                # committed_version past it — so it is droppable)
                st.pending_prepare = prep
                st.lock = (prep["txn"], now + PREPARE_LOCK_TTL)
        await self._resolve_in_doubt(now, force_query=True)

    def _txn_storage_type(self, st: TransactionalState) -> str:
        return f"txn:{type(self).__name__}:{st.name}"

    def _txn_prep_type(self, st: TransactionalState) -> str:
        return f"txnprep:{type(self).__name__}:{st.name}"

    async def _resolve_in_doubt(self, now: float,
                                force_query: bool = False,
                                resolve_fresh: bool = False) -> None:
        """Resolve held prepares whose outcome never arrived by asking
        the transaction's TM shard (``decision_of`` against the durable
        decision log) — committed → apply the prepared write; aborted →
        drop it; unknown after the lock expired → presumed abort (the TM
        logs before announcing, so an unknown txn can never later commit
        without a fresh prepare round). ``force_query=True`` (reactivation)
        queries even while the lock is fresh, so a decision the previous
        incarnation missed applies immediately; an unknown outcome is then
        held until expiry in case the 2PC is still in flight.
        ``resolve_fresh=True`` escalates: an unknown txn is durably
        presumed-aborted even while the lock is fresh — used by the entry
        wait loop once a lock has been in-doubt past IN_DOUBT_FORCE_AFTER
        (first-decision-wins at the log makes this safe: a late commit
        attempt for that txn finds the abort already decided)."""
        silo = self._activation.runtime
        agent = getattr(silo, "transactions", None)
        for st in self._txn_states():
            pending = st.pending_prepare
            if pending is None:
                continue
            expired = (st.lock is None or st.lock[1] <= now
                       or st.lock[0] != pending["txn"])
            if not expired and not force_query:
                continue                  # outcome may still be in flight
            decision = None
            reachable = False
            if agent is not None:
                try:
                    # resolve=True on expiry: the TM logs a durable
                    # presumed-abort for an unknown txn, so a slow 2PC
                    # can no longer commit after we drop the prepare
                    decision = await agent.decision_of(
                        pending["txn"], resolve=expired or resolve_fresh)
                    reachable = True
                except Exception:  # noqa: BLE001 — TM unreachable: leave
                    # the prepare held; the next prepare/retry re-asks
                    continue
            if decision is not None and decision[0] == "committed":
                if st.commit(pending["txn"], decision[1]):
                    await self._persist_committed(st, silo)
                await self._clear_prepare(st, silo)
            elif decision is not None:
                st.abort(pending["txn"])
                await self._clear_prepare(st, silo)
            elif reachable and (expired or resolve_fresh):
                # the authoritative shard has no record: presumed abort
                st.abort(pending["txn"])
                await self._clear_prepare(st, silo)
            # else: unknown but lock still fresh — hold for the outcome

    async def _persist_committed(self, st: TransactionalState, silo) -> None:
        provider = silo.storage_manager.get(st.storage_name)
        if provider is not None:
            st._etag = await provider.write(
                self._txn_storage_type(st), self.grain_id,
                {"value": st.committed, "version": st.committed_version},
                etag=st._etag)

    async def _persist_prepare(self, st: TransactionalState, silo,
                               prep: dict) -> None:
        provider = silo.storage_manager.get(st.storage_name)
        if provider is not None:
            st._prep_etag = await provider.write(
                self._txn_prep_type(st), self.grain_id, prep,
                etag=st._prep_etag)

    async def _clear_prepare(self, st: TransactionalState, silo) -> None:
        provider = silo.storage_manager.get(st.storage_name)
        if provider is not None and st._prep_etag is not None:
            await provider.clear(self._txn_prep_type(st), self.grain_id,
                                 st._prep_etag)
            st._prep_etag = None

    # -- join: register into the ambient participant set (caller-side
    # collection — zero TM round trips; the set rides back to the root
    # on response headers, see transactions/context.py) ------------------
    def _txn_join(self, info) -> None:
        if info.id in self._txn_joined:
            return
        self._txn_joined.add(info.id)
        info.join(self.grain_id, type(self).__name__)

    # -- 2PC surface called by the TM (interleave: the root caller is
    # blocked awaiting commit while these arrive) ------------------------
    @always_interleave
    async def _txn_prepare(self, txn: str) -> bool:
        now = time.time()
        if txn not in self._txn_joined:
            # No trace of this transaction on this activation. The
            # per-state "ws is None → vote True" below is for multi-state
            # grains where the txn touched a sibling state — but a
            # participant that CRASHED after entering its workspace
            # reactivates with no workspace at all, and voting True here
            # lets the TM commit a transfer whose write evaporated with
            # the old activation (measured: one unmatched transfer leg
            # per ~10 kill runs before this guard). No join trace → the
            # write is gone → the transaction must abort and retry.
            return False
        states = self._txn_states()
        if any(st.pending_prepare is not None
               and (st.lock is None or st.lock[1] <= now
                    or st.lock[0] != st.pending_prepare["txn"])
               for st in states):
            # an earlier transaction's outcome never arrived and its lock
            # expired: resolve it via the TM's durable decision before
            # voting — stealing the lock blind would let this transaction
            # validate against a read_version the in-doubt commit is
            # about to bump (the divergence the decision log exists to
            # prevent)
            await self._resolve_in_doubt(now)
        votes = [st.prepare(txn, now) for st in states]
        if not all(votes):
            for st in states:
                st.abort(txn)
            self._txn_joined.discard(txn)
            return False
        silo = self._activation.runtime
        try:
            for st in states:
                ws = st.workspace.get(txn)
                if ws is not None and ws["written"]:
                    prep = {"txn": txn, "value": ws["value"],
                            "read_version": ws["read_version"],
                            "written": True}
                    st.pending_prepare = prep
                    await self._persist_prepare(st, silo, prep)
        except Exception:  # noqa: BLE001 — durable prepare failed: vote no
            for st in states:
                st.abort(txn)
            self._txn_joined.discard(txn)
            return False
        return True

    @always_interleave
    async def _txn_commit(self, txn: str, commit_version: int) -> None:
        silo = self._activation.runtime
        for st in self._txn_states():
            had_prepare = st.pending_prepare is not None and \
                st.pending_prepare["txn"] == txn
            if st.commit(txn, commit_version):
                await self._persist_committed(st, silo)
            if had_prepare:
                await self._clear_prepare(st, silo)
        self._txn_joined.discard(txn)

    @always_interleave
    async def _txn_abort(self, txn: str) -> None:
        silo = self._activation.runtime
        for st in self._txn_states():
            had_prepare = st.pending_prepare is not None and \
                st.pending_prepare["txn"] == txn
            st.abort(txn)
            if had_prepare:
                await self._clear_prepare(st, silo)
        self._txn_joined.discard(txn)
