"""Transaction manager + per-silo agent + the @transactional scope.

Re-design of Orleans' src/Orleans.Transactions/InClusterTM/
TransactionManager.cs:709 (in-cluster sequencer + commit log),
src/Orleans.Runtime/Transactions/TransactionAgent.cs:98 (per-silo agent),
and TransactionLog.cs (durable commit log — see log.py).

Departures from the 2.0-preview reference, for throughput:

- **Zero-chatter starts/joins.** Starting a transaction and joining
  participants are silo-local (the TransactionInfo rides requests via
  RequestContext; callee joins ride back on response headers — see
  context.py). The TM hears about a transaction exactly once, at commit,
  with the full participant set — one grain call per transaction instead
  of 2+P.
- **Sharded, reentrant TMs.** N TM grains (txn-id hash picks one), each
  ``@reentrant`` so hundreds of 2PC rounds interleave on the mailbox
  instead of serializing behind one in-flight commit. Commit versions are
  shard-namespaced (version ≡ shard (mod n_shards)) so they stay globally
  distinct while each shard's sequence is monotone — all the
  read-version validation in state.py needs.
- **Gathered 2PC rounds.** Prepare / commit-apply / abort fan out with
  ``asyncio.gather`` instead of sequential awaits.
- **Write-ahead decision log.** A decision is durable (appended + synced
  via the TransactionLog provider) BEFORE any participant learns it;
  a recovered TM replays the log, so in-doubt participants resolve via
  ``decision_of`` after a TM silo dies (the recovery contract of
  TransactionLog.cs + TransactionManager.cs checkpointing).

The port's copy of ``orleans_tpu.transactions.manager``.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import random
import time
from typing import TYPE_CHECKING

from ..core.errors import (TransactionAbortedError, TransactionConflictError,
                           TransactionError)
from ..core.ids import GrainId
from ..runtime.grain import Grain, reentrant
from .context import (
    TransactionInfo,
    ambient_txn,
    clear_ambient_txn,
    set_ambient_txn,
)
from .log import InMemoryTransactionLog, TransactionLog

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.transactions")

__all__ = ["TransactionManagerGrain", "TransactionAgent", "transactional",
           "add_transactions"]

DEFAULT_TXN_TIMEOUT = 10.0
DEFAULT_TM_SHARDS = 4
# undelivered-outcome redelivery cadence + log compaction policy
RETRY_PERIOD = 0.5
ACK_RETENTION = 30.0       # keep acked decisions this long for duplicate
                           # client retries (well past PREPARE_LOCK_TTL)
COMPACT_MIN_PRUNABLE = 256


@reentrant
class TransactionManagerGrain(Grain):
    """One TM shard (grain key = shard index): sequencer + 2PC
    coordinator over a durable decision log. Reentrant: concurrent
    commits interleave across their prepare/apply awaits."""

    def __init__(self) -> None:
        self._seq: int | None = None       # last version this shard issued
        # txn -> (decision, commit_version); version 0 for aborts
        self._decisions: dict[str, tuple[str, int]] = {}
        self._deciding: dict[str, asyncio.Future] = {}
        # txn -> [(gid, iface, method, args)] outcome notifications that
        # failed delivery; re-driven by the redelivery worker so a
        # participant that missed its commit never holds a stale lock
        # past one retry period (TransactionManager.cs:709's notification
        # re-drive)
        self._undelivered: dict[str, list] = {}
        # txn -> monotonic time every participant acked the outcome;
        # compaction prunes acked decisions after ACK_RETENTION
        self._acked_at: dict[str, float] = {}
        self._worker: asyncio.Task | None = None
        # compaction barrier: while set, new decisions wait and the
        # compactor waits for in-flight appends — otherwise a decision
        # logged during the rewrite is erased from both disk and memory
        self._compact_gate: asyncio.Event | None = None
        self._appends_inflight = 0

    @property
    def _cfg(self) -> "TransactionAgent":
        agent = self._activation.runtime.transactions
        if agent is None:
            raise TransactionError("no transaction agent installed")
        return agent

    async def on_activate(self) -> None:
        # recovery: replay the durable log (TM failover — the new
        # activation continues the shard's sequence and can answer
        # decision_of for every past transaction)
        shard = int(self.grain_id.key)
        self._seq, self._decisions = await self._cfg.log.replay(shard)
        if self._decisions:
            log.info("TM shard %d recovered %d decisions (seq=%d)",
                     shard, len(self._decisions), self._seq)
            # replayed decisions are already-settled history: their
            # participants resolved (or will via decision_of) long ago.
            # Mark them acked from replay time so compaction's retention
            # window still bounds the log after a failover.
            now = time.monotonic()
            for txn in self._decisions:
                self._acked_at.setdefault(txn, now)
        self._worker = asyncio.ensure_future(self._redelivery_loop())

    async def on_deactivate(self) -> None:
        if self._worker is not None:
            self._worker.cancel()
            try:
                await self._worker
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._worker = None

    async def commit_transaction(self, txn: str, participants: list,
                                 deadline: float) -> bool:
        """The whole 2PC: prepare round → durable decision → apply round.
        ``participants``: [(GrainId, interface_name)] collected by the
        caller's agent."""
        prior = self._decisions.get(txn)
        if prior is not None:
            # duplicate commit (client resend — e.g. the original TM
            # incarnation died between logging the decision and finishing
            # the fanout): the decision stands, but the outcome must be
            # RE-DRIVEN — participants may never have heard it, and the
            # old incarnation's undelivered-outcome queue died with it.
            # Deliveries are idempotent (applied txns no-op).
            if prior[0] == "committed":
                await self._fanout(txn, participants, "_txn_commit", txn,
                                   prior[1])
                return True
            await self._fanout(txn, participants, "_txn_abort", txn)
            return False
        if time.time() > deadline:
            decision, version = await self._decide(txn, "aborted")
            if decision == "committed":
                # a duplicate incarnation already committed this txn: the
                # log's decision stands regardless of our local deadline
                await self._fanout(txn, participants, "_txn_commit", txn,
                                   version)
                return True
            await self._fanout(txn, participants, "_txn_abort", txn)
            return False
        votes = await _collect(
            [self._call(gid, iface, "_txn_prepare", txn)
             for gid, iface in participants])
        if all(v is True for v in votes):
            shard = int(self.grain_id.key)
            n = self._cfg.shards
            # shard-namespaced monotone sequence, reserved synchronously
            # (no await between read and advance): globally distinct
            self._seq = (self._seq + n) if self._seq else (shard + n)
            decision, version = await self._decide(txn, "committed",
                                                   self._seq)
            if decision == "committed":
                await self._fanout(txn, participants, "_txn_commit", txn,
                                   version)
                return True
            await self._fanout(txn, participants, "_txn_abort", txn)
            return False
        decision, version = await self._decide(txn, "aborted")
        if decision == "committed":      # lost race with a duplicate commit
            await self._fanout(txn, participants, "_txn_commit", txn, version)
            return True
        await self._fanout(txn, participants, "_txn_abort", txn)
        return False

    async def abort_transaction(self, txn: str, participants: list) -> None:
        decision, version = await self._decide(txn, "aborted")
        if decision == "committed":
            # late/duplicate abort for an already-committed txn: the
            # logged decision wins — redeliver the commit instead of
            # overwriting it (a recovered TM must never replay a commit
            # as an abort)
            await self._fanout(txn, participants, "_txn_commit", txn, version)
            return
        await self._fanout(txn, participants, "_txn_abort", txn)

    async def decision_of(self, txn: str,
                          resolve: bool = False) -> tuple[str, int] | None:
        """(decision, commit_version) or None. The version lets an
        in-doubt participant apply a missed commit, not just learn of it.

        ``resolve=True`` (participant in-doubt resolution) makes presumed
        abort DURABLE: an unknown transaction is logged as aborted before
        answering, so a commit racing this inquiry (e.g. a 2PC whose vote
        gather outlived the prepare-lock TTL) loses to the recorded abort
        instead of committing on participants that already dropped their
        prepares."""
        prior = self._decisions.get(txn)
        if prior is not None:
            return prior
        pending = self._deciding.get(txn)
        if pending is not None:
            return await pending
        if resolve:
            rec = await self._decide(txn, "aborted")
            # the inquiring participant IS the resolution — no fanout
            # will ever ack this record, so mark it prunable now
            self._acked_at[txn] = time.monotonic()
            return rec
        return None

    # -- internals -------------------------------------------------------
    async def _decide(self, txn: str, decision: str,
                      version: int = 0) -> tuple[str, int]:
        """Write-ahead: the log append IS the commit point
        (TransactionLog.cs) — participants are only told afterwards.
        Idempotent: a prior decision (in-memory or being appended) always
        wins; returns the winning (decision, version)."""
        prior = self._decisions.get(txn)
        if prior is not None:
            return prior
        pending = self._deciding.get(txn)
        if pending is not None:          # concurrent commit/abort race
            return await pending
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._deciding[txn] = fut
        try:
            while self._compact_gate is not None:   # wait out compaction
                await self._compact_gate.wait()
            self._appends_inflight += 1
            try:
                # first-decision-wins at the LOG, not just this
                # activation's memory: a concurrent duplicate TM
                # incarnation (membership-transition window) may have
                # already decided this txn — its record must win or a
                # presumed abort could race a commit onto different
                # participants
                rec = await self._cfg.log.decide(
                    int(self.grain_id.key), txn, decision, version)
            finally:
                self._appends_inflight -= 1
            if rec[1] > (self._seq or 0):
                # the winning record came from another incarnation ahead
                # of us: adopt its sequence so later commits stay monotone
                # (same shard → same residue mod n_shards, congruence holds)
                self._seq = rec[1]
            self._decisions[txn] = rec
            fut.set_result(rec)
            return rec
        except BaseException as e:
            fut.set_exception(e)
            fut.exception()              # consumed; avoid unretrieved warn
            raise
        finally:
            self._deciding.pop(txn, None)

    async def _fanout(self, txn: str, participants: list, method: str,
                      *args) -> None:
        failed: list = []
        outcomes = await _collect(
            [self._call(gid, iface, method, *args)
             for gid, iface in participants])
        for (gid, iface), out in zip(participants, outcomes):
            if isinstance(out, BaseException):
                # decision is logged; queue for redelivery (plus
                # participant-side decision_of resolution on lock
                # expiry / reactivation)
                log.warning("%s delivery failed for %s: %r", method, gid,
                            out)
                failed.append((gid, iface, method, args))
        if failed:
            self._undelivered.setdefault(txn, []).extend(failed)
        else:
            self._acked_at[txn] = time.monotonic()

    async def _redelivery_loop(self) -> None:
        """Re-drive undelivered outcome notifications and compact the
        decision log once acked decisions age out (the reference's
        truncation below the stable mark)."""
        while True:
            await asyncio.sleep(RETRY_PERIOD)
            if self._activation.runtime.status not in ("Running", "Joining"):
                return  # silo killed/stopped: a dead silo must not keep
                        # driving 2PC outcomes (on_deactivate never ran)
            for txn in list(self._undelivered):
                queue = self._undelivered.pop(txn, [])
                still: list = []
                for gid, iface, method, args in queue:
                    try:
                        await self._call(gid, iface, method, *args)
                    except Exception:  # noqa: BLE001
                        still.append((gid, iface, method, args))
                if still:
                    self._undelivered[txn] = still
                else:
                    self._acked_at[txn] = time.monotonic()
            await self._maybe_compact()

    async def _maybe_compact(self) -> None:
        now = time.monotonic()
        prunable = [t for t, at in self._acked_at.items()
                    if now - at > ACK_RETENTION]
        if len(prunable) < COMPACT_MIN_PRUNABLE:
            return
        if self._compact_gate is not None:
            return
        gate = self._compact_gate = asyncio.Event()
        try:
            # quiesce: no snapshot until in-flight appends land, and no
            # new appends until the rewrite finishes (the gate in _decide)
            while self._appends_inflight:
                await asyncio.sleep(0.001)  # executor fsync may take ms
            pruned = set(prunable)
            live = {t: d for t, d in self._decisions.items()
                    if t not in pruned}
            await self._cfg.log.rewrite(int(self.grain_id.key), live,
                                        self._seq or 0)
            self._decisions = live
            for t in prunable:
                self._acked_at.pop(t, None)
            log.info("TM shard %s compacted %d decisions (%d live)",
                     self.grain_id.key, len(prunable), len(live))
        finally:
            self._compact_gate = None
            gate.set()

    def _call(self, grain_id: GrainId, iface: str, method: str, *args):
        silo = self._activation.runtime
        direct = silo.runtime_client.try_direct_interleave(
            grain_id, method, args, {})
        if direct is not None:
            return direct
        cls = silo.registry.resolve(iface)
        if cls is None:
            raise TransactionError(f"participant class {iface} unknown")
        return silo.runtime_client.send_request(
            target_grain=grain_id, grain_class=cls, interface_name=iface,
            method_name=method, args=args, kwargs={},
            is_always_interleave=True)


async def _collect(calls: list) -> list:
    """Await every call, mapping exceptions to values (the
    gather(return_exceptions=True) contract) WITHOUT wrapping each call
    in a Task: the 2PC rounds are mostly direct local coroutines, where
    sequential awaits do the same work minus a task creation per
    participant; remote calls are already-transmitted futures, so their
    round trips still overlap."""
    out = []
    for idx, c in enumerate(calls):
        try:
            out.append(await c)
        except asyncio.CancelledError:
            # parent turn cancelled (silo stop/kill): propagate — a
            # cancelled 2PC round must not keep driving the protocol
            # against a tearing-down runtime. Close not-yet-awaited
            # coroutines so they don't leak "never awaited" warnings.
            for rest in calls[idx + 1:]:
                if asyncio.iscoroutine(rest):
                    rest.close()
            raise
        except BaseException as e:  # noqa: BLE001
            out.append(e)
    return out


class TransactionAgent:
    """Per-silo agent (TransactionAgent.cs:98): creates transaction scopes
    locally and routes commits to the txn's TM shard; installed as
    ``silo.transactions``."""

    def __init__(self, silo: "Silo", log_provider: TransactionLog,
                 shards: int):
        self.silo = silo
        self.log = log_provider
        self.shards = shards

    def _tm_call(self, txn_id: str, method: str, *args):
        """Route to the txn's TM shard: direct coroutine when the shard's
        activation is local (the TM is reentrant), message otherwise."""
        from ..runtime.grain import grain_type_of
        shard = int(txn_id[:8], 16) % self.shards
        gid = GrainId.for_grain(grain_type_of(TransactionManagerGrain),
                                shard)
        direct = self.silo.runtime_client.try_direct_interleave(
            gid, method, args, {})
        if direct is not None:
            return direct
        ref = self.silo.grain_factory.get_grain(
            TransactionManagerGrain, shard)
        return getattr(ref, method)(*args)

    def start(self, timeout: float = DEFAULT_TXN_TIMEOUT,
              priority_ts: tuple | None = None) -> TransactionInfo:
        """Silo-local: no TM round trip (the agent-collected design).
        ``priority_ts`` carries a retrying transaction's original wound-wait
        priority so it ages instead of rejuvenating."""
        self.silo.stats.increment("transactions.started")
        return TransactionInfo(deadline=time.time() + timeout,
                               ts=priority_ts)

    async def commit(self, info: TransactionInfo) -> bool:
        ok = await self._tm_call(info.id, "commit_transaction", info.id,
                                 list(info.participants.values()),
                                 info.deadline)
        self.silo.stats.increment(
            "transactions.committed" if ok else "transactions.aborted")
        return ok

    async def abort(self, info: TransactionInfo) -> None:
        self.silo.stats.increment("transactions.aborted")
        await self._tm_call(info.id, "abort_transaction", info.id,
                            list(info.participants.values()))

    async def decision_of(self, txn_id: str,
                          resolve: bool = False) -> tuple[str, int] | None:
        return await self._tm_call(txn_id, "decision_of", txn_id, resolve)


def transactional(fn=None, *, option: str = "required"):
    """Method decorator opening a transaction scope ([Transaction(...)];
    scope semantics of InsideRuntimeClient.Invoke:313-438).

    options: "required" (join ambient or start new — default),
    "requires_new" (always start a fresh transaction),
    "suppress" (run outside any transaction).
    """

    def deco(fn):
        @functools.wraps(fn)
        async def wrapper(self, *args, **kwargs):
            cur = ambient_txn()
            if option == "suppress":
                clear_ambient_txn()
                try:
                    return await fn(self, *args, **kwargs)
                finally:
                    if cur is not None:
                        set_ambient_txn(cur)
            if cur is not None and option == "required":
                return await fn(self, *args, **kwargs)  # join ambient scope
            agent = self._activation.runtime.transactions
            if agent is None:
                raise TransactionError(
                    "no transaction agent installed (add_transactions)")
            # Root scope: conflicts retry until the original deadline.
            # Wait-die entry (state.TransactionalState._enter) makes
            # conflicts surface EARLY as TransactionConflictError —
            # before any doomed prepare/commit round — and retries reuse
            # the original priority ts so the transaction ages into the
            # winner. Validation aborts at commit (the read-version
            # safety net) retry the same way. Application exceptions
            # abort once and propagate.
            retry_deadline = time.time() + DEFAULT_TXN_TIMEOUT
            attempt = 0
            priority_ts = None
            while True:
                info = agent.start(priority_ts=priority_ts)
                priority_ts = info.ts
                set_ambient_txn(info)
                try:
                    result = await fn(self, *args, **kwargs)
                except TransactionConflictError:
                    clear_ambient_txn()
                    await agent.abort(info)  # release everything we hold
                    attempt += 1
                    if time.time() >= retry_deadline:
                        raise
                    # brief jittered pause: the older holder we died
                    # against is typically mid-2PC; let it finish
                    await asyncio.sleep(0.0003 * (0.5 + random.random()))
                    continue
                except BaseException:
                    clear_ambient_txn()
                    await agent.abort(info)
                    raise
                clear_ambient_txn()
                if await agent.commit(info):
                    return result
                attempt += 1
                if time.time() >= retry_deadline:
                    raise TransactionAbortedError(
                        f"transaction {info.id} aborted after {attempt} "
                        "attempts (conflict or participant failure)")
                # jittered backoff: colliding retries must desynchronize
                await asyncio.sleep(
                    min(0.0005 * (2 ** min(attempt, 5)), 0.01)
                    * (0.5 + random.random()))

        wrapper.__orleans_transaction__ = option
        # Transactional calls interleave (the reference marks transactional
        # methods interleavable for exactly this reason): a lock wait inside
        # TransactionalState._enter must suspend only ITS transaction, not
        # the activation's whole mailbox — otherwise waits-for edges form
        # through turn queues where wound-wait cannot see or break them.
        # Isolation is the transactional states' job (workspace exclusivity
        # + read-version validation), not the turn gate's.
        #
        # SEMANTIC CAVEAT (divergence from the reference, which marks only
        # the 2PC participant-extension methods [AlwaysInterleave]): plain
        # instance attributes touched inside a @transactional method are
        # NOT turn-protected — two transactions on the same activation can
        # interleave at any await, so read-modify-write of ordinary fields
        # can race. Keep all transactional data in TransactionalState
        # facets (which serialize through the wound-wait lock); plain
        # fields inside transactional methods are safe only for
        # idempotent/monotonic writes. Documented in MIGRATION.md.
        wrapper.__orleans_always_interleave__ = True
        return wrapper

    return deco(fn) if fn is not None else deco


def add_transactions(builder, log_provider: TransactionLog | None = None,
                     shards: int = DEFAULT_TM_SHARDS):
    """Register the TM shard grains + install the per-silo agent.

    ``log_provider``: durable commit log (default: in-memory — share one
    instance across silos for TM failover in tests; use File/Sqlite for
    real durability). ``shards``: number of TM grains commits spread over.
    """
    builder.add_grains(TransactionManagerGrain)
    log_provider = log_provider or InMemoryTransactionLog()

    def install(silo) -> None:
        silo.transactions = TransactionAgent(silo, log_provider, shards)

    return builder.configure(install)
