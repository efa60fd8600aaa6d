"""Cluster membership: CAS table + probe/vote liveness oracle (reference L6,
src/Orleans.Runtime/MembershipService/)."""

from .oracle import MembershipOracle, join_cluster
from .table import (
    FileMembershipTable,
    InMemoryMembershipTable,
    MembershipEntry,
    MembershipTable,
    SiloStatus,
    SqliteMembershipTable,
    TableSnapshot,
    TableVersion,
)

__all__ = [
    "MembershipOracle", "join_cluster", "MembershipTable",
    "InMemoryMembershipTable", "FileMembershipTable", "SqliteMembershipTable",
    "MembershipEntry", "SiloStatus", "TableSnapshot", "TableVersion",
]
