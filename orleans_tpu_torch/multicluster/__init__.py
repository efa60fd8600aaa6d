"""Multi-cluster / geo federation (reference src/Orleans.Runtime/
MultiClusterNetwork/ + GrainDirectory/MultiClusterRegistration/).

Gossip rides pluggable channels (in-memory / file / sqlite — the
Azure-table channel stand-ins) so clusters in separate processes
federate; the GSI ownership protocol runs over real cluster gateways
(GatewayClient over the socket fabric), with calls to remotely-owned
grains forwarded to the owner cluster and a Doubtful-retry maintainer
resolving partition-era ownership conflicts."""

from .gossip import (
    FileGossipChannel,
    InMemoryGossipChannel,
    MultiClusterData,
    MultiClusterOracle,
    SqliteGossipChannel,
    add_multicluster,
)
from .gsi import (
    GlobalSingleInstanceRegistrar,
    GsiRuntime,
    GsiState,
    cluster_directory_grain_class,
    global_single_instance,
)

__all__ = [
    "MultiClusterData", "InMemoryGossipChannel", "FileGossipChannel",
    "SqliteGossipChannel", "MultiClusterOracle", "add_multicluster",
    "GsiState", "GlobalSingleInstanceRegistrar", "GsiRuntime",
    "global_single_instance", "cluster_directory_grain_class",
]
