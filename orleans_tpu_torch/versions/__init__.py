"""Interface versioning (reference src/Orleans.Runtime/Versions/).

The port's copy of ``orleans_tpu.versions``.
"""

from .manager import (
    TypeManagerTarget,
    VersionManager,
    grain_version,
    version_of,
)

__all__ = ["grain_version", "version_of", "VersionManager",
           "TypeManagerTarget"]
