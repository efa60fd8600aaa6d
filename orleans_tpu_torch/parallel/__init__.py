"""Mesh and exchange helpers (the port of ``orleans_tpu.parallel``)."""

from .mesh import SILO_AXIS, Mesh, make_mesh  # noqa: F401
from .transport import build_exchange  # noqa: F401
