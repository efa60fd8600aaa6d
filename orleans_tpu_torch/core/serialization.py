"""Serialization & payload schemas (L1).

The reference has a 9,369-LoC three-tier serializer stack (codegen'd → IL-emitted
→ fallback; Orleans' src/Orleans.Core/Serialization/SerializationManager.cs:50,133)
because every message crosses a socket. The TPU build's tiers are different:

1. **Device tier** — payloads for vectorized grains are *array schemas*: fixed
   dtype/shape pytrees that pack directly into batched kernel operands. This is
   the analog of codegen'd serializers: zero-copy into the dispatch tick.
2. **Host tier** — in-process messages are passed by reference; Orleans instead
   deep-copies arguments for isolation (``SerializationManager.DeepCopy``,
   registration :173-201). We keep that semantic behind :func:`deep_copy`
   honoring an ``Immutable`` wrapper (``Concurrency/Immutable.cs``).
3. **Wire tier** — cross-process control-plane bytes use a self-describing
   pickle-based codec with a type allowlist hook (the fallback-serializer slot).

The port's copy of ``orleans_tpu.core.serialization``, with two
changes: :func:`deep_copy` copies torch tensors (they are mutable, where
the JAX package's arrays are not), and the wire tier is the pickle codec
only. The native ``hotwire`` codec belongs to the socket transport and
is not ported: :func:`deserialize` refuses a hotwire frame, and the wire
allowlist names ``orleans_tpu_torch`` instead of the JAX package.
"""

from __future__ import annotations

import copy
import io
import pickle
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "Immutable", "deep_copy", "serialize", "deserialize",
    "allow_wire_modules", "ArrayField", "ArraySchema", "register_copier",
    "register_wire_codec", "unregister_wire_codec",
]


@dataclass(frozen=True)
class Immutable:
    """Marker wrapper: the sender promises not to mutate ``value`` so the
    runtime may skip deep-copy isolation (``Immutable<T>``)."""

    value: Any


_copiers: dict[type, Callable[[Any], Any]] = {}


def register_copier(typ: type, fn: Callable[[Any], Any]) -> None:
    """Plug-in point mirroring ``SerializationManager.Register`` for deep-copy."""
    _copiers[typ] = fn


_SHALLOW_SAFE = (int, float, str, bytes, bool, type(None), frozenset, complex)


def deep_copy(obj: Any) -> Any:
    """Copy-isolation for in-silo calls (``SerializationManager.DeepCopy``).

    Immutable wrappers, scalars and numpy arrays pass through untouched;
    torch tensors are cloned (a tensor is mutable in place, and the
    caller's tensor must not alias the callee's); everything else is
    deep-copied.
    """
    if isinstance(obj, Immutable):
        return obj.value
    if isinstance(obj, _SHALLOW_SAFE):
        return obj
    t = type(obj)
    if t in _copiers:
        return _copiers[t](obj)
    # numpy arrays are mutable, but treating them as values is the
    # framework contract for batched payloads (they are consumed by
    # stacking, never mutated in place). Torch tensors get no such pass:
    # handlers and engines write tensors in place, so a tensor crossing a
    # call boundary is copied.
    if isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    # Exact container types only — namedtuples / dict subclasses keep their
    # type by falling through to copy.deepcopy.
    if t is tuple:
        return tuple(deep_copy(x) for x in obj)
    if t is list:
        return [deep_copy(x) for x in obj]
    if t is dict:
        return {deep_copy(k): deep_copy(v) for k, v in obj.items()}
    return copy.deepcopy(obj)


_SCALAR_TYPES = frozenset((int, float, str, bytes, bool, type(None),
                           complex))


def copy_call_body(args: tuple, kwargs: dict) -> tuple:
    """Copy-isolate an RPC body. The dominant call shape — a few scalar
    positional args, no kwargs — shares by reference (scalars are
    immutable); anything else takes the full deep-copy walk. This is the
    hand-rolled analog of the reference's codegen'd per-signature copiers
    (SerializationManager.cs:173-201)."""
    if not kwargs:
        for a in args:
            if type(a) not in _SCALAR_TYPES:
                break
        else:
            return args, kwargs
    return deep_copy((args, kwargs))


def copy_result(result: Any) -> Any:
    """Copy-isolate an RPC result; scalars pass through untouched."""
    if type(result) in _SCALAR_TYPES:
        return result
    return deep_copy(result)


# -- external-serializer seam ------------------------------------------------
# The reference swaps whole serializers per type (Orleans.Serialization.Bond/
# Orleans.Serialization.Protobuf, registered through
# SerializationManager.cs:173-201). Here a registered codec routes its type
# through custom bytes WHEREVER values cross the wire tier: the pickle path
# uses a reducer_override.
# Decoding reconstructs via _ext_restore (an orleans_tpu_torch function, so the
# restricted unpickler admits it); a frame naming a codec the receiving
# process has not registered fails LOUDLY at decode.

_ext_codecs: dict[str, tuple[type, Callable[[Any], bytes],
                             Callable[[bytes], Any]]] = {}
_ext_by_type: dict[type, str] = {}
# exact-type → __reduce__-shaped fn, installed as a Pickler dispatch_table:
# C-speed per-type lookup, so unregistered payloads keep plain-pickle speed
_ext_dispatch: dict[type, Callable] = {}

# types the picklers/hotwire encode via built-in fast paths that never
# consult a dispatch table — a codec registered for one of these would be
# silently ignored, so reject it loudly instead
_EXT_UNROUTABLE = (list, dict, tuple, set, frozenset, str, bytes,
                   bytearray, int, float, bool, complex, type(None))


def register_wire_codec(name: str, typ: type,
                        encode: Callable[[Any], bytes],
                        decode: Callable[[bytes], Any]) -> None:
    """Route ``typ`` through a custom wire codec (the external-serializer
    registration seam). ``encode(obj) -> bytes`` / ``decode(bytes) -> obj``
    must be registered under the same ``name`` on every process that
    decodes such frames (exactly the reference's per-type serializer
    registration contract). Exact-type match — subclasses are not
    implicitly routed. One name per type; builtin container/scalar types
    are rejected (their fast paths bypass any dispatch).

    Scope: the WIRE/blob tier only. Same-silo calls copy-isolate through
    :func:`deep_copy`; a type that cannot survive ``copy.deepcopy`` (C
    handles, mmaps) needs a separate :func:`register_copier`."""
    if typ in _EXT_UNROUTABLE:
        raise ValueError(
            f"cannot route builtin type {typ.__name__} through a wire "
            f"codec: the pickler/hotwire fast paths never consult the "
            f"dispatch table for it")
    if name in _ext_codecs and _ext_codecs[name][0] is not typ:
        raise ValueError(f"wire codec {name!r} already registered for "
                         f"{_ext_codecs[name][0].__name__}")
    prior = _ext_by_type.get(typ)
    if prior is not None and prior != name:
        raise ValueError(
            f"{typ.__name__} already routes through codec {prior!r}; one "
            f"codec per type (unregister it first)")
    _ext_codecs[name] = (typ, encode, decode)
    _ext_by_type[typ] = name

    def reduce_(obj, _n=name, _e=encode):
        return (_ext_restore, (_n, _e(obj)))

    _ext_dispatch[typ] = reduce_


def unregister_wire_codec(name: str) -> None:
    entry = _ext_codecs.pop(name, None)
    if entry is not None and _ext_by_type.get(entry[0]) == name:
        _ext_by_type.pop(entry[0], None)
        _ext_dispatch.pop(entry[0], None)


def _ext_restore(name: str, payload: bytes) -> Any:
    entry = _ext_codecs.get(name)
    if entry is None:
        raise pickle.UnpicklingError(
            f"frame uses wire codec {name!r}, which this process has not "
            f"registered (register_wire_codec on every decoding silo)")
    return entry[2](payload)


def _pickle_dumps(obj: Any) -> bytes:
    """Pickle with the external-codec seam applied (identical to plain
    pickle.dumps when no codecs are registered)."""
    if not _ext_dispatch:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    buf = io.BytesIO()
    p = pickle.Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL)
    p.dispatch_table = _ext_dispatch
    p.dump(obj)
    return buf.getvalue()


def serialize(obj: Any) -> bytes:
    """Wire-tier encode (fallback-serializer slot, ``SerializationManager.cs:50``):
    C-speed pickle with the external-codec seam. The JAX package's native
    ``hotwire`` codec is not ported; the port writes pickle frames only."""
    return _pickle_dumps(obj)


# Module roots the wire-tier decoder will instantiate. Anything else is
# rejected — the analog of the reference's serializer registration gate
# (``SerializationManager.Register``): only known types cross the wire.
_wire_allowlist: set[str] = {
    "builtins", "collections", "datetime", "uuid", "decimal", "fractions",
    "numpy", "orleans_tpu_torch",
}

# builtins is special-cased: only value-constructor names, never eval/exec/
# getattr/__import__ (any of which turns unpickling into code execution).
_SAFE_BUILTINS = frozenset({
    "complex", "bytearray", "bytes", "dict", "frozenset", "list", "set",
    "str", "int", "float", "bool", "tuple", "range", "slice", "object",
    "Exception", "BaseException", "ValueError", "TypeError", "KeyError",
    "IndexError", "AttributeError", "RuntimeError", "OSError", "IOError",
    "TimeoutError", "StopIteration", "ArithmeticError", "ZeroDivisionError",
    "NotImplementedError", "AssertionError", "LookupError",
})


def allow_wire_modules(*prefixes: str) -> None:
    """Extend the wire-decode type allowlist (application grain payload types
    must be registered, mirroring serializer registration in the reference)."""
    _wire_allowlist.update(prefixes)


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".", 1)[0]
        if root not in _wire_allowlist:
            raise pickle.UnpicklingError(
                f"wire type {module}.{name} not in allowlist; call "
                f"allow_wire_modules({root!r}) to register it")
        if root == "builtins" and name not in _SAFE_BUILTINS:
            raise pickle.UnpicklingError(
                f"builtins.{name} is not wire-decodable")
        return super().find_class(module, name)


def _restricted_pickle_loads(data: bytes) -> Any:
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def serialize_portable(obj: Any) -> bytes:
    """Encode for *durable* blobs (grain state, checkpoints): always pickle
    (the same bytes as :func:`serialize` in the port, which has no native
    codec; the function stays so storage providers read as in the JAX
    package).
    Wire frames die with the connection; storage blobs outlive the encoding
    process, so they must not depend on the toolchain being present.
    Registered external codecs apply here too — their registration is part
    of the deployment, same as the type allowlist."""
    return _pickle_dumps(obj)


def deserialize(data: bytes) -> Any:
    """Wire-tier decode of a pickle frame (0x80 PROTO opcode). A frame of
    the JAX package's native hotwire codec opens with the 0xA7 magic byte;
    the port has no hotwire decoder and refuses it (decode such bytes with
    the JAX package and re-encode them with :func:`serialize`)."""
    if data[:1] == b"\xa7":
        raise ValueError(
            "frame was encoded by the native hotwire codec, which the port "
            "does not decode; re-encode it as a pickle frame")
    return _restricted_pickle_loads(data)


# -- id types are immutable: deep-copy isolation passes them by reference ----
def _register_id_copiers() -> None:
    from .ids import (ActivationAddress, ActivationId, GrainId, GrainType,
                      SiloAddress)
    for _t in (GrainId, GrainType, SiloAddress, ActivationId,
               ActivationAddress):
        _copiers[_t] = lambda x: x


_register_id_copiers()


# ----------------------------------------------------------------------------
# Device tier: array schemas for batched payloads
# ----------------------------------------------------------------------------

@dataclass(frozen=True)
class ArrayField:
    """One field of a device payload/state schema."""

    name: str
    shape: tuple[int, ...]
    dtype: Any  # numpy dtype-like

    def zeros(self, batch: int | None = None) -> np.ndarray:
        shape = self.shape if batch is None else (batch, *self.shape)
        return np.zeros(shape, dtype=self.dtype)


class ArraySchema:
    """Fixed-layout schema: dict of named arrays with static shapes.

    The codegen analog: a grain method that runs on device declares its args
    schema once; the tick engine stacks per-message dicts into one batch
    (``stack``) and splits kernel outputs back per message (``unstack``).
    """

    def __init__(self, *fields: ArrayField):
        self.fields = fields
        self.by_name = {f.name: f for f in fields}

    @classmethod
    def of(cls, **spec) -> "ArraySchema":
        """``ArraySchema.of(x=(np.float32, (3,)), n=(np.int32, ()))``"""
        fs = []
        for name, (dtype, shape) in spec.items():
            fs.append(ArrayField(name, tuple(shape), np.dtype(dtype)))
        return cls(*fs)

    def validate(self, payload: dict) -> None:
        for f in self.fields:
            v = np.asarray(payload[f.name])
            if tuple(v.shape) != f.shape:
                raise ValueError(
                    f"field {f.name!r}: shape {v.shape} != schema {f.shape}")

    def stack(self, payloads: list[dict], pad_to: int) -> dict[str, np.ndarray]:
        """Stack N message payloads into batch arrays padded to ``pad_to``
        rows (padding keeps kernel shapes static — XLA retraces only per
        bucket size, not per batch)."""
        out = {}
        n = len(payloads)
        if n > pad_to:
            raise ValueError(
                f"batch of {n} payloads exceeds pad_to={pad_to} "
                f"(tick-engine bucketing bug)")
        for f in self.fields:
            arr = np.zeros((pad_to, *f.shape), dtype=f.dtype)
            if n:
                try:
                    arr[:n] = np.stack(
                        [np.asarray(p[f.name], dtype=f.dtype) for p in payloads])
                except ValueError as e:
                    raise ValueError(
                        f"payload field {f.name!r} does not match schema shape "
                        f"{f.shape}: {e}") from None
            out[f.name] = arr
        return out

    def unstack(self, batch: dict[str, np.ndarray], n: int) -> list[dict]:
        """Split the first ``n`` rows of a batched kernel output back into
        per-message dicts."""
        keys = list(batch.keys())
        cols = {k: np.asarray(batch[k]) for k in keys}
        return [{k: cols[k][i] for k in keys} for i in range(n)]

    def empty(self) -> dict[str, np.ndarray]:
        return {f.name: f.zeros() for f in self.fields}
