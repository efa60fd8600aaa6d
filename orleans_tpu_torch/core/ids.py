"""Grain identity and its stable hashes, as the device tier uses them.

A copy of the part of ``orleans_tpu.core.ids`` that
``VectorRuntime.actor()`` needs to map a non-int key to its hashed-regime
key hash: ``stable_hash64``/``stable_hash32``, ``type_code_of``,
``GrainType``, and ``GrainId.for_grain`` with its ``uniform_hash``. The
hashes are bit-for-bit the JAX package's (blake2b over the same byte
encodings), so both packages route every key to the same shard and slot.
Pure Python: no torch, no numpy.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Union

__all__ = ["GrainCategory", "GrainId", "GrainType", "stable_hash32",
           "stable_hash64", "type_code_of"]

KeyType = Union[int, str, bytes]


def _int_bytes(k: int) -> bytes:
    return k.to_bytes((k.bit_length() + 8) // 8 + 1, "little", signed=True)


def stable_hash64(data: Union[bytes, str, int]) -> int:
    """Deterministic 64-bit hash, stable across processes and hosts, with
    the top bit cleared (a non-negative int64)."""
    if isinstance(data, int):
        data = _int_bytes(data)
    elif isinstance(data, str):
        data = data.encode("utf-8")
    h = hashlib.blake2b(data, digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def stable_hash32(data: Union[bytes, str, int]) -> int:
    """The low 32 bits of :func:`stable_hash64`."""
    return stable_hash64(data) & 0xFFFFFFFF


def type_code_of(name: str) -> int:
    """Stable 32-bit type code of a grain class name."""
    return stable_hash32("grain-type:" + name)


class GrainCategory(IntEnum):
    GRAIN = 1
    SYSTEM_TARGET = 2
    CLIENT = 3
    SYSTEM_GRAIN = 4


@dataclass(frozen=True)
class GrainType:
    """A grain class identity: name + stable type code."""

    name: str
    type_code: int

    @classmethod
    def of(cls, name: str) -> "GrainType":
        return cls(name=name, type_code=type_code_of(name))


_INTERN_LIMIT = 1 << 17
_interned: dict = {}


@dataclass(frozen=True)
class GrainId:
    """(category, type code, key [, key extension]) with its precomputed
    64-bit uniform hash, the routing key of the hashed regime."""

    category: GrainCategory
    type_code: int
    key: KeyType
    key_ext: str | None = None
    _hash64: int = field(default=-1, compare=False, repr=False)

    def __post_init__(self) -> None:
        if self._hash64 >= 0:
            return
        payload = b"%d|%d|" % (self.category, self.type_code)
        k = self.key
        if isinstance(k, int):
            kb = _int_bytes(k)
            payload += b"i%d:" % len(kb) + kb
        elif isinstance(k, str):
            kb = k.encode("utf-8")
            payload += b"s%d:" % len(kb) + kb
        else:
            payload += b"b%d:" % len(k) + k
        if self.key_ext is not None:
            eb = self.key_ext.encode("utf-8")
            payload += b"e%d:" % len(eb) + eb
        object.__setattr__(self, "_hash64", stable_hash64(payload))

    @classmethod
    def for_grain(cls, grain_type: GrainType, key: KeyType,
                  key_ext: str | None = None) -> "GrainId":
        """The id of an application grain; int and str keys are interned
        (ids are built per ``actor()`` call and hashing is their cost)."""
        if not isinstance(key, (int, str)):
            return cls(GrainCategory.GRAIN, grain_type.type_code, key,
                       key_ext)
        k = (grain_type.type_code, key, key_ext)
        gid = _interned.get(k)
        if gid is None:
            gid = cls(GrainCategory.GRAIN, grain_type.type_code, key,
                      key_ext)
            if len(_interned) >= _INTERN_LIMIT:
                _interned.clear()
            _interned[k] = gid
        return gid

    @property
    def uniform_hash(self) -> int:
        """The 63-bit routing hash."""
        return self._hash64

    def __hash__(self) -> int:
        return self._hash64
