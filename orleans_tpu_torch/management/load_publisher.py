"""DeploymentLoadPublisher: periodic per-silo load broadcast.

Re-design of Orleans' src/Orleans.Runtime/Placement/
DeploymentLoadPublisher.cs:17 (publish :85): each silo periodically pushes
its runtime stats (activation count, queue depths) to every peer; placement
directors read the freshest view. The in-proc fabric shortcut (reading the
peer catalog directly) remains the fallback when no publisher runs.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import TYPE_CHECKING

from ..core.ids import GrainId, SiloAddress, type_code_of
from ..core.message import Category

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.management.load")

LOAD_TARGET = "LoadPublisherTarget"

__all__ = ["DeploymentLoadPublisher"]


class _LoadTarget:
    """System target receiving peer load reports."""

    _activation = None

    def __init__(self, publisher: "DeploymentLoadPublisher"):
        self.publisher = publisher

    async def load_report(self, silo: SiloAddress, report: dict) -> None:
        self.publisher.view[silo] = report


class DeploymentLoadPublisher:
    """Publishes this silo's load; aggregates peers' reports in ``view``."""

    def __init__(self, silo: "Silo", period: float = 1.0):
        self.silo = silo
        self.period = period
        self.view: dict[SiloAddress, dict] = {}
        self.target = _LoadTarget(self)
        silo.register_system_target(self.target, LOAD_TARGET)
        self._task: asyncio.Task | None = None

    def load_of(self, silo: SiloAddress) -> int | None:
        report = self.report_of(silo)
        # stale/absent: None — caller falls back to the fabric read
        return None if report is None else report["activation_count"]

    def report_of(self, silo: SiloAddress) -> dict | None:
        """Full freshest report for a peer (activation count, queue depth,
        per-class device-shard heat) — the rebalance planner's view."""
        report = self.view.get(silo)
        if report is None or time.time() - report["ts"] > 10 * self.period:
            return None
        return report

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        while True:
            try:
                self._publish()
            except Exception:  # noqa: BLE001
                log.exception("load publish failed")
            await asyncio.sleep(self.period)

    def _publish(self) -> None:
        # the extended load report (activation count + queue depth +
        # per-class device-shard heat) comes from rebalance.telemetry so
        # planners on every peer see one consistent schema
        from ..rebalance.telemetry import load_report

        report = load_report(self.silo)
        report["ts"] = time.time()
        me = self.silo.silo_address
        self.view[me] = report
        for peer in self.silo.locator.alive_list:
            if peer == me:
                continue
            gid = GrainId.system_target(type_code_of(LOAD_TARGET), peer)
            try:
                self.silo.runtime_client.send_request(
                    target_grain=gid, grain_class=_LoadTarget,
                    interface_name=LOAD_TARGET, method_name="load_report",
                    args=(me, report), kwargs={}, is_one_way=True,
                    target_silo=peer, category=Category.SYSTEM)
            except Exception:  # noqa: BLE001
                pass
