"""Live activation migration & load-aware rebalancing.

The runtime re-distribution tier: hot-spot telemetry accumulated on device
inside the dispatch tick (``dispatch.table``/``dispatch.engine``) and
folded into the silo load broadcast (``management.load_publisher``), a
planner that turns the cluster load view into a budget-bounded batched
migration plan (``ops.route.pack_by_dest`` packing + ``placement``
directors for destination choice), and a live executor — fence →
dehydrate → transfer → rehydrate → directory re-registration with cache
invalidation → mailbox re-dispatch, with rollback on failure.

Reference trajectory: DeploymentLoadPublisher +
ActivationCountPlacementDirector, later Orleans's activation
repartitioning; device half per "Memory-efficient array redistribution
through portable collective communication" (PAPERS.md).
"""

from .executor import REBALANCE_TARGET, MigrationExecutor  # noqa: F401
from .planner import (  # noqa: F401
    ActivationMove,
    MigrationPlan,
    RebalancePlanner,
    ShardMoves,
)
from .service import RebalanceTarget, Rebalancer, add_rebalancer  # noqa: F401
from .telemetry import load_report, queue_depth, vector_shard_hits  # noqa: F401

__all__ = [
    "Rebalancer", "RebalanceTarget", "add_rebalancer", "REBALANCE_TARGET",
    "MigrationExecutor", "RebalancePlanner", "MigrationPlan",
    "ActivationMove", "ShardMoves", "load_report", "queue_depth",
    "vector_shard_hits",
]
