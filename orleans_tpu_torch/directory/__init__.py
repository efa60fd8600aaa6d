"""Distributed grain directory + consistent rings (reference L5).

The port's copy of ``orleans_tpu.directory``.
"""

from .locator import DistributedLocator  # noqa: F401
from .ring import (  # noqa: F401
    ConsistentRing,
    EquallyDividedRing,
    RingRange,
    VirtualBucketRing,
)
