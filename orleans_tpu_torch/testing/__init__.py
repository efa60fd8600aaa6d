"""In-process multi-silo test clusters (reference L14,
src/Orleans.TestingHost/)."""

from .cluster import TestCluster, TestClusterBuilder

__all__ = ["TestCluster", "TestClusterBuilder"]
