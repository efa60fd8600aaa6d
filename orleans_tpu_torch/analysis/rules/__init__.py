"""Rule modules — importing this package registers every rule.

The port's copy of ``orleans_tpu.analysis.rules``.
"""

from . import (  # noqa: F401
    concurrency, interfaces, pool, rings, state, traced, turns,
)

__all__ = ["concurrency", "interfaces", "pool", "rings", "state",
           "traced", "turns"]
