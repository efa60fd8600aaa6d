"""Migration executor: apply a MigrationPlan live, with fences + rollback.

Host tier — one activation at a time, the dehydrate/transfer/rehydrate
protocol of Orleans grain migration (the activation-repartitioning
trajectory the reference grew after DeploymentLoadPublisher):

1. **fence** — flip the activation to DEACTIVATING so the dispatcher parks
   every arriving message in its mailbox (no turn may observe state that
   is mid-copy), then drain running turns (bounded).
2. **transfer** — ship (grain id, class, in-memory state, activation id)
   to the destination's RebalanceTarget over the silo fabric.
3. **rehydrate + re-register** — the destination builds the activation,
   arms the storage etag, overlays the migrated state, and REPLACES the
   directory registration through ``locator.migrate_register`` (with
   cache invalidation; stale peer caches heal via invalidation-on-forward).
4. **commit** — only after the destination acks does the source destroy
   its copy and re-dispatch the parked mailbox (the messages that raced
   the move re-address against the updated directory — zero lost, zero
   duplicated: none of them ever started a turn here).
5. **rollback** — any transfer failure re-registers the source (it never
   unregistered; ``register`` is first-wins and the entry still names it),
   flips back to VALID and pumps the mailbox locally.

Device tier — batched: the packed ShardMoves are fenced against the
engine's pending queue (a queued invocation caches its (shard, slot); its
key must not move under it), then applied as ONE functional gather+scatter
over the table (``ShardedActorTable.move_rows``) with the directory maps
re-pointed only after the device copy commits.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..core.ids import GrainId, type_code_of
from ..core.message import Category
from ..observability.stats import REBALANCE_STATS
from ..runtime.activation import ActivationState
from ..runtime.grain import StatefulGrain

log = logging.getLogger("orleans.rebalance")

REBALANCE_TARGET = "RebalanceTarget"

__all__ = ["MigrationExecutor", "REBALANCE_TARGET"]


class MigrationExecutor:
    def __init__(self, silo):
        self.silo = silo

    # ------------------------------------------------------------------
    # Host tier
    # ------------------------------------------------------------------
    async def migrate_activation(self, act, dest) -> bool:
        """Live-migrate one local activation to silo ``dest``. Returns
        True on commit; False leaves the activation serving locally (or,
        if a racing re-creation won the directory while we were fenced,
        completes the deactivation instead). Each leg records a
        "migration" span when the silo traces, so rebalance cost shows on
        the same timeline as the request latency it perturbs."""
        tracer = self.silo.tracer
        if tracer is None or not tracer.sample():
            return await self._migrate_activation(act, dest)
        span = tracer.open(f"migrate {act.grain_id}", "migration",
                           tracer.new_trace_id(), None)
        committed = False
        try:
            committed = await self._migrate_activation(act, dest)
            return committed
        finally:
            tracer.close(span, dest=str(dest), committed=committed)

    async def _migrate_activation(self, act, dest) -> bool:
        silo = self.silo
        if act.state != ActivationState.VALID or \
                act.grain_id.is_system_target() or act.is_stateless_worker:
            return False
        act.state = ActivationState.DEACTIVATING  # fence: arrivals park
        deadline = time.monotonic() + silo.config.deactivation_timeout
        while act.running and time.monotonic() < deadline:
            await asyncio.sleep(0.005)
        if act.running:
            # a turn would not drain: the state is still being written —
            # abort before anything was copied
            self._rollback_local(act)
            silo.stats.increment(REBALANCE_STATS["rolled_back"])
            return False
        if act.timers:
            # re-check AFTER the drain, not just at plan time: a turn that
            # ran between planning and the fence may have armed a timer,
            # and committing would silently kill it (timer continuity
            # across a move is a ROADMAP follow-on)
            self._rollback_local(act)
            silo.stats.increment(REBALANCE_STATS["rolled_back"])
            return False
        state_payload = act.grain_instance.state \
            if isinstance(act.grain_instance, StatefulGrain) else None
        try:
            target = GrainId.system_target(
                type_code_of(REBALANCE_TARGET), dest)
            from .service import RebalanceTarget
            accepted = await silo.runtime_client.send_request(
                target_grain=target, grain_class=RebalanceTarget,
                interface_name=REBALANCE_TARGET,
                method_name="accept_activation",
                args=(act.grain_id, act.grain_class.__name__,
                      state_payload, act.activation_id),
                kwargs={}, target_silo=dest, category=Category.SYSTEM)
        except Exception as e:  # noqa: BLE001 — dest down/refused: roll back
            log.info("migration of %s to %s failed: %s",
                     act.grain_id, dest, e)
            silo.stats.increment(REBALANCE_STATS["refused"])
            await self._rollback(act)
            return False
        if not accepted:
            silo.stats.increment(REBALANCE_STATS["refused"])
            await self._rollback(act)
            return False
        # commit: the destination is VALID and owns the registration — the
        # local copy is now the duplicate (timer-free: the post-drain
        # re-check above refused anything with live timers). No unregister
        # (that would drop the DESTINATION's entry).
        silo.catalog._destroy(act)
        silo.stats.increment("catalog.activations.migrated_out")
        self._redispatch_mailbox(act)
        return True

    async def _rollback(self, act) -> None:
        """Transfer failed: take the registration back (first-wins; the
        entry normally still names us — a failed rehydrate surrendered any
        claim it briefly held) and resume serving."""
        silo = self.silo
        winner = None
        try:
            winner = await silo.locator.register(act.address)
        except Exception:  # noqa: BLE001 — owner unreachable: serve on;
            # the registration was never replaced
            pass
        if winner is not None and winner.activation != act.activation_id:
            # a racing re-creation registered while we were fenced: our
            # copy is the duplicate now — finish as a deactivation and
            # bounce the mailbox to the winner
            act.stop_timers()
            silo.catalog._destroy(act)
            self._redispatch_mailbox(act)
            silo.stats.increment(REBALANCE_STATS["rolled_back"])
            return
        self._rollback_local(act)
        silo.stats.increment(REBALANCE_STATS["rolled_back"])

    def _rollback_local(self, act) -> None:
        act.state = ActivationState.VALID
        self.silo.dispatcher.run_message_pump(act)

    def _redispatch_mailbox(self, act) -> None:
        """Re-address everything that parked behind the fence. Internal
        timer turns die with the local copy (same rule as Catalog
        deactivation: re-dispatching would resurrect a callback bound to
        the destroyed instance)."""
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

    # ------------------------------------------------------------------
    # Device tier
    # ------------------------------------------------------------------
    def execute_shard_moves(self, moves) -> int:
        """Apply one class's packed shard moves on the local vector
        runtime. Runs synchronously on the event loop — between the fence
        check and the table commit there is no await, so no new pending
        entry can appear for a moving key mid-flight."""
        rt = self.silo.vector
        if rt is None:
            return 0
        tbl = rt.tables.get(moves.cls)
        if tbl is None:
            return 0
        fenced = rt.pending_key_hashes(moves.cls)
        keep = [i for i, k in enumerate(moves.keys) if int(k) not in fenced]
        if not keep:
            return 0
        tracer = self.silo.tracer
        span = None
        if tracer is not None and tracer.sample():
            span = tracer.open(f"shard_moves {moves.cls.__name__}",
                               "migration", tracer.new_trace_id(), None)
        try:
            n = tbl.move_rows(moves.keys[keep], moves.dest_shards[keep])
            if span is not None:
                tracer.close(span, rows=n)
            return n
        except Exception:  # noqa: BLE001 — move_rows only commits its
            # bookkeeping after the device copy succeeds, so a failure
            # here left the table untouched; count and carry on
            log.exception("shard move failed for %s", moves.cls.__name__)
            self.silo.stats.increment(REBALANCE_STATS["rolled_back"])
            if span is not None:
                tracer.close(span, rows=0, error=True)
            return 0
