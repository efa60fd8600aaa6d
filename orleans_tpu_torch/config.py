"""Options of the port's device tier.

The port's copy of ``orleans_tpu.config.DispatchOptions``: the knobs of
the batched engine, passed as ``VectorRuntime(options=...)``.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ConfigurationError", "DispatchOptions"]


class ConfigurationError(ValueError):
    """Invalid options rejected by a validator."""


@dataclass
class DispatchOptions:
    """Per-shard slot-pool capacity and the off-loop tick lever.

    ``offloop_tick=True`` runs claimed per-key batches on a worker thread
    of the engine (staging fill, upload, kernel, sync); the default keeps
    the tick inline on the event loop."""

    capacity_per_shard: int = 1024
    offloop_tick: bool = False

    def validate(self) -> None:
        v = self.capacity_per_shard
        if not (isinstance(v, (int, float)) and v > 0):
            raise ConfigurationError(
                f"DispatchOptions.capacity_per_shard must be > 0, got {v!r}")
