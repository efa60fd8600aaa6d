"""Identity & hashing layer (L0).

TPU-native re-design of the reference's ID system
(Orleans' src/Orleans.Core.Abstractions/IDs/ — ``UniqueKey.cs:9,28-31``,
``GrainId.cs:199``, ``SiloAddress.cs``, ``ActivationAddress.cs``).

Design departures from the reference:

* Keys are plain Python data (int / str / uuid bytes) carried alongside a stable
  64-bit ``uniform_hash`` that is *device-friendly*: every ID can be projected to an
  ``int64`` so the directory, ring placement, and mesh-shard routing can all run as
  integer math inside jitted kernels. The reference's Jenkins hash
  (``UniqueKey.cs:272-286``) plays the same role host-side only.
* No interning table (``Internal/Interner.cs``): frozen dataclasses with cached
  hashes are cheap enough in CPython and hashable by construction.

The port's copy of ``orleans_tpu.core.ids``.
"""

from __future__ import annotations

import hashlib
import os as _os
import random as _random
import uuid
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Union

__all__ = [
    "GrainCategory",
    "GrainType",
    "GrainId",
    "SiloAddress",
    "ActivationId",
    "ActivationAddress",
    "stable_hash64",
    "stable_hash32",
    "type_code_of",
]

def stable_hash64(data: Union[bytes, str, int]) -> int:
    """Deterministic 64-bit hash, stable across processes and hosts.

    Fills the role of ``JenkinsHash``/``GetUniformHashCode`` in the reference
    (``UniqueKey.cs:272-286``): directory sharding, ring placement, and sender-lane
    picking all key off this value. Returns a non-negative int that fits int64
    (top bit cleared so it round-trips through int64 tensors without sign surprises).
    """
    if isinstance(data, int):
        data = data.to_bytes((data.bit_length() + 8) // 8 + 1, "little", signed=True)
    elif isinstance(data, str):
        data = data.encode("utf-8")
    h = hashlib.blake2b(data, digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def stable_hash32(data: Union[bytes, str, int]) -> int:
    """32-bit variant (the reference's uniform hash width)."""
    return stable_hash64(data) & 0xFFFFFFFF


def type_code_of(name: str) -> int:
    """Stable 32-bit type code for a grain class/interface name.

    The reference embeds a type code computed by codegen into the key
    (``UniqueKey.cs:28-31``); here it is derived from the fully-qualified class
    name so that independently-started silos agree without a codegen step.
    """
    return stable_hash32("grain-type:" + name)


class GrainCategory(IntEnum):
    """Mirrors UniqueKey categories (``UniqueKey.cs:17-24``), trimmed to what the
    TPU runtime distinguishes."""

    GRAIN = 1          # ordinary application grain
    SYSTEM_TARGET = 2  # per-silo pseudo-grain at a well-known id
    CLIENT = 3         # client observer endpoint
    SYSTEM_GRAIN = 4   # runtime-owned grain (e.g. membership dev table)


@dataclass(frozen=True)
class GrainType:
    """A grain class identity: name + stable type code."""

    name: str
    type_code: int

    @classmethod
    def of(cls, name: str) -> "GrainType":
        return cls(name=name, type_code=type_code_of(name))

    def __repr__(self) -> str:
        return f"GrainType({self.name})"


KeyType = Union[int, str, bytes]


_grain_id_intern: dict = {}
_INTERN_LIMIT = 1 << 17


def _rebuild_grain_id(category: int, type_code: int, key,
                      key_ext, hash64: int) -> "GrainId":
    """Wire-decode constructor for GrainId.__reduce__ (hash precomputed)."""
    return GrainId(GrainCategory(category), type_code, key, key_ext, hash64)


@dataclass(frozen=True)
class GrainId:
    """Grain identity = (category, type_code, primary key [, key extension]).

    The reference packs this into a 128-bit UniqueKey + 64-bit type-code word
    (``UniqueKey.cs:9,28-31``); we keep the key in native Python form plus a
    precomputed 64-bit uniform hash for device-side routing.
    """

    category: GrainCategory
    type_code: int
    key: KeyType
    key_ext: str | None = None
    _hash64: int = field(default=-1, compare=False, repr=False)

    def __post_init__(self) -> None:
        if self._hash64 < 0:
            payload = b"%d|%d|" % (self.category, self.type_code)
            k = self.key
            if isinstance(k, int):
                kb = k.to_bytes((k.bit_length() + 8) // 8 + 1, "little", signed=True)
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

    # -- factory helpers ---------------------------------------------------
    @classmethod
    def for_grain(cls, grain_type: GrainType, key: KeyType,
                  key_ext: str | None = None) -> "GrainId":
        # interning (the reference's Interner.cs): grain ids are built on
        # every get_grain call and the hash in __post_init__ is the single
        # hottest id-layer cost — reuse frozen instances for hashable keys
        if isinstance(key, (int, str)):
            k = (grain_type.type_code, key, key_ext)
            cached = _grain_id_intern.get(k)
            if cached is None:
                cached = cls(GrainCategory.GRAIN, grain_type.type_code,
                             key, key_ext)
                if len(_grain_id_intern) >= _INTERN_LIMIT:
                    _grain_id_intern.clear()  # bounded; ids are cheap to remake
                _grain_id_intern[k] = cached
            return cached
        return cls(GrainCategory.GRAIN, grain_type.type_code, key, key_ext)

    @classmethod
    def for_guid(cls, grain_type: GrainType, guid: uuid.UUID) -> "GrainId":
        return cls(GrainCategory.GRAIN, grain_type.type_code, guid.bytes)

    @classmethod
    def system_target(cls, type_code: int, silo: "SiloAddress") -> "GrainId":
        """System targets are per-silo well-known ids (``Constants.cs`` +
        ``Silo.RegisterSystemTarget``, ``Silo.cs:816-820``)."""
        return cls(GrainCategory.SYSTEM_TARGET, type_code, silo.uniform_hash)

    @classmethod
    def client(cls, client_id: str) -> "GrainId":
        return cls(GrainCategory.CLIENT, 0, client_id)

    # -- hashing -----------------------------------------------------------
    @property
    def uniform_hash(self) -> int:
        """64-bit uniform hash — the routing key for directory partitioning and
        ring placement (role of ``GetUniformHashCode``)."""
        return self._hash64

    @property
    def consistent_hash(self) -> int:
        """Hash used for ring position (reference keeps a separate consistent
        hash; one good 64-bit hash serves both here)."""
        return self._hash64

    def __hash__(self) -> int:
        # grain ids key every hot dict (catalog, directory, caches); the
        # precomputed 64-bit hash beats re-hashing the field tuple per op
        return self._hash64

    def __reduce__(self):
        # compact wire form: a 5-tuple of primitives (the default frozen-
        # dataclass pickling writes the field-name dict + the enum by
        # reference — ~3x the bytes and time). Carrying _hash64 skips the
        # __post_init__ re-hash on decode.
        return (_rebuild_grain_id, (int(self.category), self.type_code,
                                    self.key, self.key_ext, self._hash64))

    def is_client(self) -> bool:
        return self.category == GrainCategory.CLIENT

    def is_system_target(self) -> bool:
        return self.category == GrainCategory.SYSTEM_TARGET

    def __str__(self) -> str:
        ext = f"+{self.key_ext}" if self.key_ext else ""
        return f"grain/{self.category.name.lower()}/{self.type_code:08x}/{self.key!r}{ext}"


@dataclass(frozen=True)
class SiloAddress:
    """Silo identity: (host endpoint, generation).

    Mirrors ``SiloAddress.cs`` — generation (an epoch stamp) distinguishes a
    restarted silo at the same endpoint. On TPU, a "silo" is one host process
    owning a set of mesh coordinates; ``mesh_index`` is its rank along the
    cluster mesh axis (-1 for clients / not-yet-joined).
    """

    host: str
    port: int
    generation: int
    mesh_index: int = -1
    _uh: int = field(default=-1, compare=False, repr=False)

    def __post_init__(self) -> None:
        if self._uh < 0:
            object.__setattr__(self, "_uh", stable_hash64(
                f"silo|{self.host}|{self.port}|{self.generation}"))

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def uniform_hash(self) -> int:
        return self._uh

    def __hash__(self) -> int:
        return self._uh

    def __reduce__(self):
        return (SiloAddress, (self.host, self.port, self.generation,
                              self.mesh_index, self._uh))

    def same_endpoint(self, other: "SiloAddress") -> bool:
        return self.host == other.host and self.port == other.port

    def is_successor_of(self, other: "SiloAddress") -> bool:
        return self.same_endpoint(other) and self.generation > other.generation

    def __str__(self) -> str:
        return f"S{self.host}:{self.port}@{self.generation}"


_activation_rng = _random.Random(_os.urandom(16))


@dataclass(frozen=True)
class ActivationId:
    """Unique id of one in-memory activation of a grain (``ActivationId.cs``).

    Ids are drawn from a per-process CSPRNG-seeded stream (the reference uses
    GUIDs) so they are unique cluster-wide, including across forked silo
    processes. For device-resident (vectorized) activations the id doubles as
    the stable identity across slot moves; the (table epoch, slot) pair lives
    in the catalog, not here.
    """

    value: int

    @classmethod
    def new(cls) -> "ActivationId":
        return cls(_activation_rng.getrandbits(63))

    def __reduce__(self):
        return (ActivationId, (self.value,))

    def __str__(self) -> str:
        return f"act-{self.value:016x}"


@dataclass(frozen=True)
class ActivationAddress:
    """Full address of an activation: silo + grain + activation
    (``ActivationAddress.cs``)."""

    silo: SiloAddress
    grain: GrainId
    activation: ActivationId

    def __str__(self) -> str:
        return f"[{self.grain} @ {self.silo} / {self.activation}]"
