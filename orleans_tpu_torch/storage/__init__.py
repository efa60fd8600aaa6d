"""Grain persistence providers and device-tier checkpoint/resume
(``torch.save`` table snapshots, write-behind row persistence): the port
of ``orleans_tpu.storage``."""

from .checkpoint import VectorCheckpointer, VectorStorageBridge  # noqa: F401
from .core import (  # noqa: F401
    ErrorInjectionStorage,
    FileStorage,
    GrainStorage,
    LatencyStorage,
    MemoryStorage,
    StateStorageBridge,
    StorageManager,
)
