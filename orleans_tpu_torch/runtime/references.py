"""Grain references: typed proxies without codegen.

The reference emits ``GrainReference`` subclasses per interface at build time
(Orleans' src/Orleans.CodeGeneration/GrainReferenceGenerator.cs:22;
invocation glue GrainReference.cs:35,340-342, GrainFactory.cs:59-124).
Python needs no codegen: a :class:`GrainRef` resolves methods against the
grain class's public async methods at call time and forwards them as request
messages through the runtime client.

The port's copy of ``orleans_tpu.runtime.references``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from ..core.ids import GrainId
from .grain import grain_type_of, remote_methods

if TYPE_CHECKING:
    from .runtime_client import RuntimeClient

__all__ = ["GrainRef", "GrainFactory"]


class GrainRef:
    """Remote-callable handle to a grain identity (``GrainReference``).

    ``ref.method(*args, **kw)`` → awaitable result. Methods marked
    ``@one_way`` return None immediately (fire-and-forget).
    """

    __slots__ = ("grain_class", "grain_id", "_client", "_methods",
                 "_invokers")

    def __init__(self, grain_class: type, grain_id: GrainId,
                 client: "RuntimeClient"):
        self.grain_class = grain_class
        self.grain_id = grain_id
        self._client = client
        self._methods = remote_methods(grain_class)
        self._invokers: dict[str, Any] = {}

    def __getattr__(self, name: str):
        # bound invoker closures are cached per method with the call
        # flags pre-resolved — the per-call work of the codegen'd proxy
        # method body (GrainReferenceGenerator.cs:22 emits exactly this)
        hit = self._invokers.get(name)
        if hit is not None:
            return hit
        fn = self._methods.get(name)
        if fn is None:
            raise AttributeError(
                f"{self.grain_class.__name__} has no remote method {name!r} "
                f"(remote methods are public async defs)")
        client = self._client
        gid, cls = self.grain_id, self.grain_class
        iface = cls.__name__
        read_only = getattr(fn, "__orleans_read_only__", False)
        interleave = getattr(fn, "__orleans_always_interleave__", False)
        one_way = getattr(fn, "__orleans_one_way__", False)

        def invoke(*args: Any, **kwargs: Any):
            if not one_way:
                if interleave:
                    # always-interleave + local activation: direct
                    # coroutine (InsideRuntimeClient.try_direct_interleave
                    # — the mailbox gate would admit the message
                    # unconditionally, so only the invoke remains)
                    direct = client.try_direct_interleave(
                        gid, name, args, kwargs)
                    if direct is not None:
                        return direct
                else:
                    # hot lane (runtime.hotlane): the default in-silo path
                    # — local Valid activation + admitting gate runs the
                    # turn inline; anything complicated returns None and
                    # falls through to the full messaging path
                    hot = client.try_hot_invoke(gid, cls, iface, name,
                                                args, kwargs, read_only)
                    if hot is not None:
                        return hot
            # skip the filter-dispatch wrapper when no filters are
            # registered (checked per call: filters may be added later)
            send = (client.send_request if client.outgoing_call_filters
                    else client._send_request_unfiltered)
            return send(
                target_grain=gid, grain_class=cls, interface_name=iface,
                method_name=name, args=args, kwargs=kwargs,
                is_read_only=read_only, is_always_interleave=interleave,
                is_one_way=one_way)

        self._invokers[name] = invoke
        return invoke

    def _invoke(self, name: str, fn, *args: Any, **kwargs: Any):
        return self.__getattr__(name)(*args, **kwargs)

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, GrainRef)
                and other.grain_id == self.grain_id)

    def __hash__(self) -> int:
        return hash(self.grain_id)

    def __repr__(self) -> str:
        return f"GrainRef({self.grain_class.__name__}, {self.grain_id.key!r})"


class GrainFactory:
    """``IGrainFactory.GetGrain`` surface (GrainFactory.cs:59-124)."""

    def __init__(self, client: "RuntimeClient"):
        self._client = client

    def get_grain(self, grain_class: type, key: Any,
                  key_ext: str | None = None) -> GrainRef:
        gid = GrainId.for_grain(grain_type_of(grain_class), key, key_ext)
        return GrainRef(grain_class, gid, self._client)

    def call_batch(self, grain_class: type, method_name: str, calls, *,
                   timeout: float | None = None) -> list:
        """Deliberate batched fan-out over one (class, method): N
        ``(key, kwargs)`` calls built and transmitted as one wire batch
        (see ``RuntimeClient.call_batch``). Returns awaitables aligned
        with ``calls`` (None per item for ``@one_way`` methods)."""
        return self._client.call_batch(grain_class, method_name, calls,
                                       timeout=timeout)

    # -- bulk-population collectives (MapReduce over actors) -----------
    def map_actors(self, grain_class: type, method: str,
                   kwargs: dict | None = None, keys=None, *,
                   timeout: float | None = None):
        """Apply ``method`` to every live device-tier activation (or a
        key subset) as single-dispatch bulk ticks — one envelope per
        silo, not one message per actor (``RuntimeClient.map_actors``)."""
        return self._client.map_actors(grain_class, method, kwargs,
                                       keys=keys, timeout=timeout)

    def reduce_actors(self, grain_class: type, method: str,
                      kwargs: dict | None = None, keys=None,
                      combine: str = "sum", *,
                      timeout: float | None = None):
        """Device-side reduction over per-actor results: one row crosses
        each host/silo boundary (``RuntimeClient.reduce_actors``)."""
        return self._client.reduce_actors(grain_class, method, kwargs,
                                          keys=keys, combine=combine,
                                          timeout=timeout)

    def broadcast_actors(self, grain_class: type, method: str, targets,
                         args: dict | None = None, *,
                         timeout: float | None = None):
        """Edge-list fan-out as device collectives
        (``RuntimeClient.broadcast_actors``)."""
        return self._client.broadcast_actors(grain_class, method,
                                             targets, args,
                                             timeout=timeout)

    def join_when(self, grain_class: type, keys, k: int | None = None, *,
                  method: str, kwargs: dict | None = None,
                  timeout: float | None = None, poll: float = 0.02,
                  server: bool = True):
        """Readiness-mask join over a key set: server-armed watch by
        default, ``server=False`` for the per-poll client loop
        (``RuntimeClient.join_when``)."""
        return self._client.join_when(grain_class, keys, k,
                                      method=method, kwargs=kwargs,
                                      timeout=timeout, poll=poll,
                                      server=server)

    def get_system_target(self, grain_class: type, grain_id: GrainId) -> GrainRef:
        ref = GrainRef(grain_class, grain_id, self._client)
        return ref
