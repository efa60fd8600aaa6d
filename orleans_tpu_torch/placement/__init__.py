"""Placement strategies (reference L7).

The port's copy of ``orleans_tpu.placement``.
"""

from .strategies import (  # noqa: F401
    ActivationCountP2CPlacement,
    ActivationCountPlacement,
    PlacementDirector,
    PlacementManager,
)
