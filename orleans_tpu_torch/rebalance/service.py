"""Rebalancer service: the telemetry → plan → execute loop, per silo.

The runtime piece that turns static placement + the offline
``reshard_dense`` snapshot path into a self-balancing system: every
``rebalance_period`` seconds each silo reads the cluster load view
(DeploymentLoadPublisher broadcasts, extended with queue depth and
device-shard heat by ``rebalance.telemetry``), asks the planner for a
budget-bounded migration plan, and executes it live — host activations
over the fabric, device rows as batched shard copies. Per-round outcomes
land in ``observability.stats`` under the ``REBALANCE_STATS`` names.

``add_rebalancer(builder)`` is the hosting hook; the loop only runs when
``rebalance_period > 0`` (config.RebalanceOptions), and a silo with the
service installed always hosts the RebalanceTarget so it can RECEIVE
migrations even when its own loop is disabled.
"""

from __future__ import annotations

import asyncio
import logging

from ..observability.stats import REBALANCE_STATS
from .executor import REBALANCE_TARGET, MigrationExecutor
from .planner import RebalancePlanner

log = logging.getLogger("orleans.rebalance")

__all__ = ["Rebalancer", "RebalanceTarget", "add_rebalancer",
           "REBALANCE_TARGET"]


class RebalanceTarget:
    """Per-silo system target: the receive half of a live migration."""

    _activation = None

    def __init__(self, silo):
        self.silo = silo

    async def accept_activation(self, grain_id, class_name: str,
                                state_payload, prev_activation) -> bool:
        """Rehydrate a migrating activation here. Raises (failing the
        migration RPC, so the source rolls back) rather than returning
        False for every refusal — the source treats both the same, but an
        exception carries the reason."""
        from ..core.errors import OrleansError

        if self.silo.status != "Running":
            raise OrleansError(
                f"silo {self.silo.silo_address} is {self.silo.status}; "
                "not accepting migrations")
        grain_class = self.silo.registry.resolve(class_name)
        if grain_class is None:
            raise OrleansError(
                f"grain class {class_name!r} is not registered on "
                f"{self.silo.silo_address}")
        await self.silo.catalog.rehydrate_activation(
            grain_id, grain_class, state_payload, prev_activation)
        return True


class Rebalancer:
    """Periodic plan/execute loop (one per silo)."""

    def __init__(self, silo, period: float | None = None,
                 budget: int | None = None,
                 imbalance_ratio: float | None = None):
        self.silo = silo
        self.period = period if period is not None \
            else silo.config.rebalance_period
        self.planner = RebalancePlanner(silo, budget=budget,
                                        imbalance_ratio=imbalance_ratio)
        self.executor = MigrationExecutor(silo)
        self.rounds = 0
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        # the device tier only pays for telemetry once a consumer exists:
        # a receive-only rebalancer (period 0, hosting the target so peers
        # can migrate IN) must not tax every tick with counters nobody
        # resets — callers of manual rounds enable tracking themselves
        if self.period > 0:
            if self.silo.vector is not None:
                self.silo.vector.enable_load_tracking()
            if self._task is None:
                self._task = asyncio.get_running_loop().create_task(
                    self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.period)
            if self.silo.status != "Running":
                continue
            try:
                await self.run_round()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — next round retries
                log.exception("rebalance round failed")

    def _cluster_device_hot_ratio(self) -> float:
        """Hottest silo's per-class device hit total over the cluster mean
        — the consumer of the ``vector_hits`` field every silo broadcasts
        in its load report. Intra-silo shard skew is handled by this
        round's shard moves; a ratio persistently above the hysteresis
        here means one SILO's device tier runs hot, which only cross-silo
        row migration (ROADMAP follow-on) can fix — surface it so
        operators see the gap."""
        from .telemetry import vector_shard_hits

        totals: dict[str, list[float]] = {}
        for cls_name, hits in vector_shard_hits(self.silo).items():
            totals.setdefault(cls_name, []).append(float(sum(hits)))
        publisher = getattr(self.silo, "load_publisher", None)
        if publisher is not None:
            me = self.silo.silo_address
            for peer in self.silo.locator.alive_list:
                if peer == me:
                    continue
                report = publisher.report_of(peer)
                for cls_name, hits in (report or {}).get(
                        "vector_hits", {}).items():
                    totals.setdefault(cls_name, []).append(float(sum(hits)))
        ratio = 0.0
        for per_silo in totals.values():
            mean = sum(per_silo) / len(per_silo)
            if mean > 0:
                ratio = max(ratio, max(per_silo) / mean)
        return ratio

    async def run_round(self) -> dict:
        """One telemetry → plan → execute round. Returns the outcome
        (also mirrored into the stats registry)."""
        stats = self.silo.stats
        plan = self.planner.plan()
        stats.set_gauge(REBALANCE_STATS["device_hot_ratio"],
                        self._cluster_device_hot_ratio())
        rt = self.silo.vector
        if rt is not None:
            # reset immediately after planning, even on a no-op round:
            # every round plans against the load since the previous one,
            # and an always-balanced cluster must not accumulate the
            # int32 counters toward overflow
            for tbl in rt.tables.values():
                tbl.reset_hits()
        self.rounds += 1
        stats.increment(REBALANCE_STATS["rounds"])
        stats.set_gauge(REBALANCE_STATS["last_imbalance"], plan.imbalance)
        outcome = {"planned": plan.total, "migrated": 0, "rows_moved": 0,
                   "imbalance": plan.imbalance}
        if not plan:
            stats.set_gauge(REBALANCE_STATS["last_moved"], 0)
            return outcome
        stats.increment(REBALANCE_STATS["planned"], plan.total)
        # device moves first: synchronous, and draining the hot shard
        # cheapens any host moves that follow in the same round
        dropped = 0
        for moves in plan.shard_moves:
            outcome["rows_moved"] += self.executor.execute_shard_moves(moves)
            dropped += moves.dropped
        if dropped:
            # truncation must be visible: a round that planned more than
            # the budget admits reports how much heat it left behind
            stats.increment(REBALANCE_STATS["dropped"], dropped)
            outcome["dropped"] = dropped
        for mv in plan.activation_moves:
            if await self.executor.migrate_activation(mv.act, mv.dest):
                outcome["migrated"] += 1
        stats.increment(REBALANCE_STATS["migrated"], outcome["migrated"])
        stats.increment(REBALANCE_STATS["rows_moved"], outcome["rows_moved"])
        stats.set_gauge(REBALANCE_STATS["last_moved"],
                        outcome["migrated"] + outcome["rows_moved"])
        if outcome["migrated"] or outcome["rows_moved"]:
            log.info("rebalance round %d: %d activations, %d device rows "
                     "moved (imbalance %.2f)", self.rounds,
                     outcome["migrated"], outcome["rows_moved"],
                     plan.imbalance)
        return outcome


def add_rebalancer(builder, period: float | None = None,
                   budget: int | None = None,
                   imbalance_ratio: float | None = None):
    """Install the rebalancer on a SiloBuilder. Explicit arguments
    override the silo config's ``rebalance_*`` knobs (which come from
    ``config.RebalanceOptions``); with neither, the target is hosted but
    the loop stays off (period 0)."""

    def install(silo) -> None:
        target = RebalanceTarget(silo)
        silo.register_system_target(target, REBALANCE_TARGET)
        silo.rebalancer = Rebalancer(silo, period=period, budget=budget,
                                     imbalance_ratio=imbalance_ratio)
        from ..runtime.silo import ServiceLifecycleStage

        silo.subscribe_lifecycle(
            ServiceLifecycleStage.APPLICATION_SERVICES,
            silo.rebalancer.start, silo.rebalancer.stop)

    return builder.configure(install)
