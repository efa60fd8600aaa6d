"""Mesh and exchange helpers (the port of ``orleans_tpu.parallel``)."""

from .mesh import (SILO_AXIS, GroupMeshError, Mesh, agree,  # noqa: F401
                   all_reduce, gather, make_mesh)
from .transport import build_exchange  # noqa: F401
