"""Mesh and exchange helpers (the port of ``orleans_tpu.parallel``)."""

from .mesh import (SILO_AXIS, GroupMeshError, Mesh,  # noqa: F401
                   all_reduce, make_mesh)
from .transport import build_exchange  # noqa: F401
