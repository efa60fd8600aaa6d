"""Client observers: grain→client push callbacks.

Re-design of the reference's grain-observer pattern
(``IGrainObserver`` one-way callback contracts;
``ClientObserverRegistrar`` records client routes —
Orleans' src/Orleans.Runtime/GrainDirectory/ClientObserverRegistrar.cs;
delivery via ``Gateway.TryDeliverToProxy`` — Runtime/Messaging/Gateway.cs:229):

* a client wraps a local callback object with ``client.create_observer(obj)``
  and passes the returned :class:`ObserverRef` to grains as an ordinary
  argument (it serializes like any value);
* a grain calls methods on the ref — every call is ONE-WAY (fire-and-
  forget, exactly the reference's void-only observer contract) addressed
  straight to the client's pseudo silo address, so the fabric/gateway
  routes it without a directory lookup;
* the client dispatches inbound observer messages to the wrapped object on
  its event loop (the client-side "activations" of
  OutsideRuntimeClient.cs:22).

The port's copy of ``orleans_tpu.runtime.observers``.
"""

from __future__ import annotations

import asyncio
import inspect
import itertools
import logging
from dataclasses import dataclass, field
from typing import Any

from ..core.ids import GrainId, GrainType, SiloAddress
from ..core.message import Message

log = logging.getLogger("orleans.observers")

__all__ = ["ObserverRef", "ObserverHost", "OBSERVER_TYPE"]

OBSERVER_TYPE = GrainType.of("ClientObserver$")


def _public_async_methods(obj: Any) -> tuple[str, ...]:
    # dir(obj) covers class methods AND callables assigned as instance
    # attributes (self.on_event = cb) — both are dispatchable
    return tuple(sorted(
        name for name in dir(obj)
        if not name.startswith("_")
        and callable(getattr(obj, name, None))))


@dataclass(frozen=True)
class ObserverRef:
    """Serializable handle to a client-side callback object. Method calls
    from inside a grain turn send one-way notifications to the client."""

    client_address: SiloAddress
    observer_id: int
    type_name: str
    methods: tuple[str, ...] = field(default_factory=tuple)

    @property
    def grain_id(self) -> GrainId:
        return GrainId.for_grain(OBSERVER_TYPE, self.observer_id)

    def __getattr__(self, name: str):
        # only called for attributes the dataclass doesn't define; dunder
        # probes (pickle's __getstate__ etc.) must fail fast
        if name.startswith("_"):
            raise AttributeError(name)
        if self.methods and name not in self.methods:
            raise AttributeError(
                f"observer {self.type_name} has no method {name!r} "
                f"(exports: {list(self.methods)})")

        def notify(*args: Any, **kwargs: Any) -> None:
            from .context import current_activation

            act = current_activation.get()
            if act is None:
                raise RuntimeError(
                    "observer notifications must be sent from a grain turn "
                    "(the client already holds the object — call it "
                    "directly)")
            act.runtime.runtime_client.send_request(
                target_grain=self.grain_id,
                grain_class=object,
                interface_name=self.type_name,
                method_name=name,
                args=args, kwargs=kwargs,
                is_one_way=True,
                target_silo=self.client_address)

        return notify


class ObserverHost:
    """Client-side observer registry + inbound dispatch (composed into
    ClusterClient / GatewayClient)."""

    def __init__(self, client_address_of) -> None:
        # late-bound: gateway clients learn their pseudo address on connect
        self._address_of = client_address_of
        self._observers: dict[int, Any] = {}
        self._ids = itertools.count(1)
        self._tasks: set[asyncio.Task] = set()

    def create_observer(self, obj: Any) -> ObserverRef:
        """CreateObjectReference: wrap a local object; its public methods
        become the observer surface."""
        addr = self._address_of()
        if addr is None:
            raise RuntimeError("client is not connected")
        methods = _public_async_methods(obj)
        if not methods:
            raise ValueError(
                f"{type(obj).__name__} exposes no public callables — "
                f"nothing for a grain to notify")
        oid = next(self._ids)
        self._observers[oid] = obj
        return ObserverRef(addr, oid, type(obj).__name__, methods)

    def delete_observer(self, ref: ObserverRef) -> bool:
        """DeleteObjectReference."""
        return self._observers.pop(ref.observer_id, None) is not None

    def dispatch(self, msg: Message) -> bool:
        """Route an inbound message to a local observer. Returns False if
        the message is not an observer notification."""
        gid = msg.target_grain
        if gid is None or gid.type_code != OBSERVER_TYPE.type_code:
            return False
        obj = self._observers.get(gid.key)
        if obj is None:
            log.info("dropping notification for deleted observer %s", gid)
            return True
        fn = getattr(obj, msg.method_name, None)
        if fn is None or msg.method_name.startswith("_"):
            log.warning("observer %s has no method %s", type(obj).__name__,
                        msg.method_name)
            return True
        args, kwargs = msg.body if msg.body is not None else ((), {})

        async def run() -> None:
            try:
                out = fn(*args, **kwargs)
                if inspect.isawaitable(out):
                    await out
            except Exception:  # noqa: BLE001 — observer errors never propagate
                log.exception("observer %s.%s raised", type(obj).__name__,
                              msg.method_name)

        # retain the task: the loop holds tasks only weakly, so an
        # unreferenced notification task can be GC'd before it runs
        task = asyncio.ensure_future(run())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return True
