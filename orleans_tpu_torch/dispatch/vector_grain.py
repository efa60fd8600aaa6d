"""VectorGrain: device-tier grains with torch handlers.

The port of ``orleans_tpu.dispatch.vector_grain``. Instead of scheduling
one turn per message on a thread, all pending invocations of one grain
class are coalesced each tick into ONE vectorized actor-update over a slot
table of activation state (dispatch.table / dispatch.engine). A tick
applies at most one message per activation.

A VectorGrain declares:
* ``STATE`` — dict of field → (torch dtype, shape): the activation row.
* ``initial_state(key_hash)`` — int32 scalar tensor → state row dict (the
  ``OnActivateAsync`` analog fused into the tick).
* handler methods decorated ``@actor_method``: pure
  ``(state_row, args_row) -> (new_state_row, result)`` functions on ONE
  row, which the engine vmaps with ``torch.func.vmap``. Torch ops only,
  no Python side effects, no data-dependent control flow.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..interop import torch_dtype

__all__ = ["ActorMethod", "VectorGrain", "actor_method", "vector_methods"]


class ActorMethod:
    """Descriptor wrapper marking a vmappable torch handler."""

    def __init__(self, fn: Callable, args_schema: dict | None,
                 read_only: bool):
        self.fn = fn
        self.name = fn.__name__
        # args schema: field → (torch dtype, shape); inferred from the
        # first call when not declared
        self.args_schema = None if args_schema is None else {
            k: (torch_dtype(dt), tuple(shape))
            for k, (dt, shape) in args_schema.items()}
        self.read_only = read_only

    def __get__(self, obj, objtype=None):
        # accessed on the class: return self so the engine can find it
        return self

    def infer_schema(self, args: dict[str, Any], lead: int = 1) -> dict:
        """Schema from host arrays or tensors with ``lead`` leading batch
        axes ([M, ...] for one tick, [K, M, ...] for K rounds)."""
        if self.args_schema is None:
            self.args_schema = {
                k: (torch_dtype(v.dtype if isinstance(v, torch.Tensor)
                                else np.asarray(v).dtype),
                    tuple(v.shape[lead:]))
                for k, v in args.items()}
        return self.args_schema


def actor_method(fn: Callable | None = None, *, args: dict | None = None,
                 read_only: bool = False):
    """Mark a VectorGrain handler.

    ``@actor_method`` or ``@actor_method(args={"pos": (torch.float16,
    (2,))})``. ``read_only=True`` handlers skip the state write-back.
    """
    def wrap(f: Callable) -> ActorMethod:
        return ActorMethod(f, args, read_only)
    if fn is not None:
        return wrap(fn)
    return wrap


class VectorGrain:
    """Base marker class for device-tier grains.

    Subclasses are never instantiated: state lives in a
    ShardedActorTable; handlers are static pure functions.
    """

    STATE: dict[str, tuple] = {}

    @staticmethod
    def initial_state(key_hash):  # pragma: no cover — must override
        """key_hash: int32 scalar tensor (the key reduced to 31 bits) →
        state row dict matching STATE."""
        raise NotImplementedError

    # Idle collection age for table slots (host-driven); None = never.
    COLLECTION_AGE: float | None = None


def vector_methods(cls: type) -> dict[str, ActorMethod]:
    out = {}
    for name in dir(cls):
        v = getattr(cls, name)
        if isinstance(v, ActorMethod):
            out[name] = v
    return out
