"""Grain application API (L10).

Re-design of Orleans' src/Orleans.Core.Abstractions/Core/Grain.cs:15
(OnActivateAsync :220, RegisterTimer :113, RegisterOrUpdateReminder :133,
GetStreamProvider :182, DeactivateOnIdle :196; ``Grain<TState>`` :251,284-297)
and the concurrency attributes
(Concurrency/GrainAttributeConcurrency.cs, Placement/PlacementAttribute.cs).

Python grains need no codegen: a grain class *is* its interface; public async
methods become remote-callable; decorators replace C# attributes.

The port's copy of ``orleans_tpu.runtime.grain``.
"""

from __future__ import annotations

import inspect
from typing import TYPE_CHECKING, Any, Callable, TypeVar

from ..core.ids import GrainId, GrainType

if TYPE_CHECKING:
    from .activation import ActivationData
    from .references import GrainRef

T = TypeVar("T")

__all__ = [
    "Grain", "StatefulGrain", "reentrant", "stateless_worker", "read_only",
    "always_interleave", "one_way", "placement", "collection_age",
    "grain_type_of",
]


# ---------------------------------------------------------------------------
# Class / method decorators (C# attribute analogs)
# ---------------------------------------------------------------------------

def reentrant(cls: type) -> type:
    """``[Reentrant]`` — all requests may interleave on this grain's turns."""
    cls.__orleans_reentrant__ = True
    return cls


def stateless_worker(max_local: int = 0) -> Callable[[type], type]:
    """``[StatelessWorker(n)]`` (StatelessWorkerPlacement.cs:6,12-16) —
    auto-scaled local replicas, no directory entry. ``max_local=0`` means
    min(cpu-default) like the reference's processor-count default."""
    def deco(cls: type) -> type:
        cls.__orleans_stateless_worker__ = max(
            max_local, 0) or _DEFAULT_STATELESS_LIMIT
        cls.__orleans_placement__ = "stateless_worker"
        return cls
    return deco


_DEFAULT_STATELESS_LIMIT = 8


def placement(strategy: str) -> Callable[[type], type]:
    """Placement attribute: 'random' | 'prefer_local' | 'hash' |
    'activation_count' (PlacementAttribute.cs)."""
    def deco(cls: type) -> type:
        cls.__orleans_placement__ = strategy
        return cls
    return deco


def collection_age(seconds: float) -> Callable[[type], type]:
    """``[CollectionAgeLimit]`` — per-class idle-deactivation age override
    (GrainCollectionOptions.ClassSpecificCollectionAge; consumed by the
    catalog's idle collector)."""
    def deco(cls: type) -> type:
        cls.__orleans_collection_age__ = float(seconds)
        return cls
    return deco


def read_only(fn: T) -> T:
    """``[ReadOnly]`` — may interleave with other read-only turns."""
    fn.__orleans_read_only__ = True
    return fn


def always_interleave(fn: T) -> T:
    """``[AlwaysInterleave]`` — may interleave with anything."""
    fn.__orleans_always_interleave__ = True
    return fn


def one_way(fn: T) -> T:
    """``[OneWay]`` — fire-and-forget, no response message."""
    fn.__orleans_one_way__ = True
    return fn


def grain_type_of(cls: type) -> GrainType:
    """Stable GrainType for a grain class (the codegen type-code analog)."""
    return GrainType.of(cls.__name__)


# ---------------------------------------------------------------------------
# Grain base class
# ---------------------------------------------------------------------------

class Grain:
    """Base class for host-tier grains (arbitrary Python logic).

    Lifecycle hooks and runtime services mirror ``Grain`` (Grain.cs:15). The
    runtime injects ``_activation`` before ``on_activate`` runs; user code
    accesses services through the properties below, never the runtime
    directly.
    """

    _activation: "ActivationData | None" = None

    # -- identity ----------------------------------------------------------
    @property
    def grain_id(self) -> GrainId:
        return self._activation.grain_id

    @property
    def primary_key(self) -> Any:
        return self._activation.grain_id.key

    @property
    def primary_key_ext(self) -> str | None:
        return self._activation.grain_id.key_ext

    # -- lifecycle hooks (Grain.cs:220,235) --------------------------------
    async def on_activate(self) -> None:  # noqa: B027
        """Called after construction, before the first message turn."""

    async def on_deactivate(self) -> None:  # noqa: B027
        """Called before the activation is destroyed."""

    # -- runtime services --------------------------------------------------
    @property
    def runtime(self):
        """The hosting silo facade (``IGrainRuntime`` — Grain.cs's Runtime):
        grants grains access to silo services, e.g. ``self.runtime.vector``
        for the device tier."""
        return self._activation.runtime

    def get_grain(self, grain_class: type, key: Any,
                  key_ext: str | None = None) -> "GrainRef":
        """``GrainFactory.GetGrain`` from inside a grain (Grain.cs:86-111)."""
        return self._activation.runtime.grain_factory.get_grain(
            grain_class, key, key_ext)

    def register_timer(self, callback, due: float, period: float | None):
        """Volatile per-activation timer; ticks run as turns on this
        activation's context (Grain.cs:113, GrainTimer.cs:11). Returns a
        disposable handle."""
        return self._activation.register_timer(callback, due, period)

    async def register_reminder(self, name: str, due: float, period: float):
        """Durable reminder (Grain.cs:133); requires the grain to implement
        ``receive_reminder``."""
        return await self._activation.runtime.reminders.register_or_update(
            self.grain_id, name, due, period)

    async def unregister_reminder(self, name: str) -> None:
        await self._activation.runtime.reminders.unregister(self.grain_id, name)

    async def get_reminder(self, name: str):
        return await self._activation.runtime.reminders.get(self.grain_id, name)

    def get_stream_provider(self, name: str):
        """``Grain.GetStreamProvider`` (Grain.cs:182)."""
        return self._activation.runtime.get_stream_provider(name)

    def deactivate_on_idle(self) -> None:
        """``DeactivateOnIdle`` (Grain.cs:196): mark for deactivation as soon
        as the current turn (and queued work) completes."""
        self._activation.deactivate_on_idle()

    def delay_deactivation(self, seconds: float) -> None:
        self._activation.delay_deactivation(seconds)

    @property
    def runtime_identity(self) -> str:
        return str(self._activation.runtime.silo_address)


class StatefulGrain(Grain):
    """``Grain<TState>`` (Grain.cs:251): declarative persisted state.

    ``state`` is any picklable object (dict by default); storage round-trips
    through the silo's configured ``IGrainStorage`` provider with etag checks
    (StateStorageBridge.cs:11,49,80,107).
    """

    STORAGE_PROVIDER: str | None = None  # None → silo default provider

    def __init__(self) -> None:
        self.state: Any = {}

    @property
    def _bridge(self):
        return self._activation.storage_bridge

    async def read_state(self) -> None:
        """``ReadStateAsync`` (Grain.cs:284)."""
        data = await self._bridge.read()
        if data is not None:
            self.state = data

    async def write_state(self) -> None:
        """``WriteStateAsync`` (Grain.cs:290)."""
        await self._bridge.write(self.state)

    async def clear_state(self) -> None:
        """``ClearStateAsync`` (Grain.cs:297)."""
        await self._bridge.clear()
        self.state = {}


def remote_methods(cls: type) -> dict[str, Callable]:
    """Public async methods of a grain class = its remote interface
    (the codegen GrainInterfaceMap analog). Device-tier grain classes
    (dispatch.VectorGrain) expose their @actor_method handlers instead —
    the same GrainRef proxies both tiers.

    Cached per class: a GrainRef is built on every get_grain call, and
    inspect.getmembers per ref was ~20% of host-tier call time."""
    cached = cls.__dict__.get("__orleans_remote_methods__")
    if cached is not None:
        return cached
    from ..dispatch.vector_grain import ActorMethod, VectorGrain

    if isinstance(cls, type) and issubclass(cls, VectorGrain):
        out = {name: m.fn for name in dir(cls)
               if isinstance((m := getattr(cls, name)), ActorMethod)}
    else:
        out = {}
        for name, fn in inspect.getmembers(cls, inspect.isfunction):
            if name.startswith("_"):
                continue
            if name in _GRAIN_BASE_METHODS:
                continue
            if inspect.iscoroutinefunction(fn):
                out[name] = fn
    cls.__orleans_remote_methods__ = out
    return out


_GRAIN_BASE_METHODS = frozenset(
    n for n, f in inspect.getmembers(Grain, inspect.isfunction)
) | frozenset(
    n for n, f in inspect.getmembers(StatefulGrain, inspect.isfunction)
)
