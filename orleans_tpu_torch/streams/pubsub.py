"""Stream pub-sub: rendezvous grain state + implicit subscriptions.

Re-design of Orleans' src/Orleans.Runtime/Streams/PubSub/
PubSubRendezvousGrain.cs:21 (RegisterProducer :62, RegisterConsumer :115 —
durable per-stream subscriber sets held in grain state) and
src/Orleans.Core/Streams/PubSub/ImplicitStreamSubscriberTable.cs:11
(attribute-declared subscriptions resolved from the type map, no rendezvous
round-trip).

The port's copy of ``orleans_tpu.streams.pubsub``.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING

from ..core.errors import StreamError
from ..core.ids import GrainId, GrainType
from ..runtime.grain import StatefulGrain
from .core import StreamId, StreamSignal, SubscriptionHandle

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.streams.pubsub")

__all__ = ["PubSubRendezvousGrain", "implicit_stream_subscription",
           "implicit_consumers", "resolve_consumers", "deliver_to_consumer"]


class PubSubRendezvousGrain(StatefulGrain):
    """One per stream (key = str(StreamId)): the durable subscriber set."""

    async def register_consumer(self, handle: SubscriptionHandle) -> None:
        self.state.setdefault("consumers", {})[handle.handle_id] = handle
        await self.write_state()

    async def unregister_consumer(self, handle_id: str) -> None:
        if self.state.setdefault("consumers", {}).pop(handle_id, None):
            await self.write_state()

    async def get_consumers(self) -> list[SubscriptionHandle]:
        return list(self.state.get("consumers", {}).values())

    async def register_producer(self, producer: str) -> None:
        if producer not in self.state.setdefault("producers", []):
            self.state["producers"].append(producer)
            await self.write_state()

    async def counts(self) -> tuple[int, int]:
        return (len(self.state.get("producers", [])),
                len(self.state.get("consumers", {})))


def implicit_stream_subscription(namespace: str):
    """Class decorator: auto-subscribe every grain of this class to streams
    in ``namespace``, keyed by the stream key ([ImplicitStreamSubscription]).
    The grain must define ``async def on_next(self, item, token)``."""

    def deco(cls: type) -> type:
        existing = list(getattr(cls, "__implicit_stream_ns__", ()))
        cls.__implicit_stream_ns__ = (*existing, namespace)
        return cls

    return deco


def implicit_consumers(silo: "Silo", stream: StreamId) -> list[SubscriptionHandle]:
    """ImplicitStreamSubscriberTable: registered classes whose declared
    namespaces include this stream's — consumer key = stream key. Device
    tier (VectorGrain) classes participate too: their deliveries ride
    batched kernel ticks (deliver_to_vector_consumer)."""
    out = []
    classes = list(silo.registry.all_classes())
    seen = {c.__name__ for c in classes}
    for vcls in getattr(silo, "vector_interfaces", {}).values():
        if vcls.__name__ not in seen:
            classes.append(vcls)
    vector_names = set(getattr(silo, "vector_interfaces", {}))
    for cls in classes:
        if stream.namespace in getattr(cls, "__implicit_stream_ns__", ()):
            gid = GrainId.for_grain(GrainType.of(cls.__name__), stream.key)
            # host-tier classes that define on_error/on_completed hear
            # producer signals automatically; device-tier (kernel) methods
            # cannot take the signal call shape, so signals skip them
            host = cls.__name__ not in vector_names
            out.append(SubscriptionHandle(
                stream=stream, handle_id=f"implicit:{cls.__name__}",
                grain_id=gid, interface_name=cls.__name__,
                method_name="on_next",
                batch=bool(getattr(getattr(cls, "on_next", None),
                                   "__orleans_stream_batch__", False)),
                error_method_name="on_error"
                if host and callable(getattr(cls, "on_error", None))
                else None,
                completed_method_name="on_completed"
                if host and callable(getattr(cls, "on_completed", None))
                else None))
    return out


def _rendezvous(silo: "Silo", stream: StreamId):
    return silo.grain_factory.get_grain(PubSubRendezvousGrain, str(stream))


async def resolve_consumers(silo: "Silo", stream: StreamId
                            ) -> list[SubscriptionHandle]:
    """Explicit (rendezvous state) + implicit (type map) subscribers."""
    explicit = await _rendezvous(silo, stream).get_consumers()
    return list(explicit) + implicit_consumers(silo, stream)


async def deliver_to_consumer(silo: "Silo", handle: SubscriptionHandle,
                              items: list, first_token: int,
                              progress: dict | None = None) -> None:
    """Deliver events as ordinary grain calls (the consumer-extension path):
    ``await consumer.<method>(item, token)`` per event, in order. Consumers
    that are device-tier (VectorGrain) classes take the batched kernel path
    instead — see :func:`deliver_to_vector_consumer`.

    ``progress`` (per delivery attempt-set, owned by one consumer pump):
    records how many items of this batch were fully delivered, so a retry
    after a mid-batch failure resumes at the failed item instead of
    re-applying the whole batch. Delivery remains at-least-once — the
    failed item itself may have partially applied — matching the
    reference's stream redelivery contract (consumers dedup by token)."""
    if progress is None:
        progress = {}
    from ..observability.tracing import arm_root_link
    # stream deliveries root fresh traces (the pump has no ambient trace):
    # carry the subscribing turn's context as a span link on each new
    # root. Set unconditionally — an unlinked handle must clear whatever
    # a previous delivery armed in this pump task's context.
    arm_root_link(getattr(handle, "link", None))
    ft = getattr(handle, "from_token", None)
    if ft is not None:
        # rewound subscription: trim below the resume token (batches
        # fully before it skip entirely)
        if first_token + len(items) <= ft:
            progress["done"] = len(items)
            return
        if first_token < ft:
            items = items[ft - first_token:]
            first_token = ft
    if any(isinstance(i, StreamSignal) for i in items):
        # signals are produced as their own 1-item batches (on_next
        # rejects them as data), so a signal batch is all-signal; a mixed
        # batch can only come from a hand-built adapter — reject it into
        # the retry/failure-handler path rather than guess an order
        if not all(isinstance(i, StreamSignal) for i in items):
            raise StreamError(
                "stream signals must not be batched with data items")
        for i in range(progress.get("done", 0), len(items)):
            await _deliver_signal(silo, handle, items[i], first_token + i)
            progress["done"] = i + 1
        return
    vcls = silo.vector_interfaces.get(handle.interface_name)
    if vcls is not None and getattr(silo, "vector", None) is not None:
        return await deliver_to_vector_consumer(silo, vcls, handle, items,
                                                progress)
    cls = silo.registry.resolve(handle.interface_name)
    if cls is None:
        raise LookupError(
            f"stream consumer class {handle.interface_name} not registered")
    done = progress.get("done", 0)
    if getattr(handle, "batch", False):
        # batch consumer (IAsyncBatchObserver): one call per queue batch;
        # a retry re-sends the unacknowledged remainder
        await silo.runtime_client.send_request(
            target_grain=handle.grain_id, grain_class=cls,
            interface_name=handle.interface_name,
            method_name=handle.method_name,
            args=(list(items[done:]), first_token + done), kwargs={})
        progress["done"] = len(items)
        return
    for i in range(done, len(items)):
        fut = silo.runtime_client.send_request(
            target_grain=handle.grain_id, grain_class=cls,
            interface_name=handle.interface_name,
            method_name=handle.method_name,
            args=(items[i], first_token + i), kwargs={})
        await fut
        progress["done"] = i + 1


async def _deliver_signal(silo: "Silo", handle: SubscriptionHandle,
                          sig: StreamSignal, token: int) -> None:
    """Route one producer signal to the consumer's dedicated method:
    ``on_error(exc, token)`` / ``on_completed(token)``. A consumer that
    registered no method for this signal kind ignores it (counted), as
    the reference does for a null onErrorAsync delegate."""
    attr = ("error_method_name" if sig.kind == "error"
            else "completed_method_name")
    method = getattr(handle, attr, None)
    if method is None:
        silo.stats.increment(f"streams.signals.{sig.kind}_unhandled")
        log.debug("consumer %s has no %s handler for %s",
                  handle.grain_id, sig.kind, handle.stream)
        return
    cls = silo.registry.resolve(handle.interface_name)
    if cls is None:
        raise LookupError(
            f"stream consumer class {handle.interface_name} not registered")
    args = (sig.error, token) if sig.kind == "error" else (token,)
    silo.stats.increment(f"streams.signals.{sig.kind}_delivered")
    await silo.runtime_client.send_request(
        target_grain=handle.grain_id, grain_class=cls,
        interface_name=handle.interface_name, method_name=method,
        args=args, kwargs={})


async def deliver_to_vector_consumer(silo: "Silo", vcls: type,
                                     handle: SubscriptionHandle,
                                     items: list,
                                     progress: dict | None = None) -> None:
    """Device-tier stream delivery: the pulling agent's per-event host
    turns (PersistentStreamPullingAgent.cs:350-368) become batched kernel
    ticks over the consumer VectorGrain class.

    Item shapes (per QueueBatch item, in order):

    * ``{"keys": [M], "args": {field: [M, ...]}}`` — one ``call_batch``
      tick delivering M events (one per key);
    * ``{"keys": [M], "args_rounds": {field: [K, M, ...]}}`` — one
      scanned ``call_batch_rounds`` kernel delivering K sequential rounds
      to the same keys (K·M events, per-key order preserved);
    * ``{"key": k, <field>: value, ...}`` — a single event; joins the
      runtime's coalescing tick (rt.call), so scalar trickles from many
      streams still share kernel launches.

    Events inside one stream stay ordered: each pump delivers its stream's
    batches sequentially, and rounds are sequential inside the scan.
    """
    import numpy as np

    rt = silo.vector
    method = handle.method_name
    if progress is None:
        progress = {}
    delivered = 0
    for i in range(progress.get("done", 0), len(items)):
        item = items[i]
        if isinstance(item, dict) and "keys" in item:
            delivered += await _deliver_bulk_item(silo, rt, vcls, method,
                                                  item)
        elif isinstance(item, dict) and "key" in item:
            delivered += await _deliver_scalar_item(silo, rt, vcls, method,
                                                    item)
        else:
            raise TypeError(
                f"vector stream item must be a dict with 'keys' (bulk) or "
                f"'key' (single); got {type(item).__name__}")
        progress["done"] = i + 1
    silo.stats.increment("streams.vector.delivered", delivered)


async def _deliver_scalar_item(silo: "Silo", rt, vcls: type, method: str,
                               item: dict) -> int:
    """One scalar event, owner-routed like every other vector call: on the
    key's ring owner it joins the runtime's coalescing tick; elsewhere it
    forwards as a 1-key bulk item (Dispatcher._handle_vector_request's
    single-owner rule — executing on a non-owner would mint divergent
    device state)."""
    import numpy as np

    key = item["key"]
    kwargs = {k: v for k, v in item.items() if k != "key"}
    gid = GrainId.for_grain(GrainType.of(vcls.__name__), key)
    me = silo.silo_address
    owner = silo.locator.ring.owner(gid.uniform_hash) or me
    if owner == me:
        kh = rt.key_hash_for(key, gid.uniform_hash)
        rt.table(vcls).note_route(kh, gid.uniform_hash)
        await rt.call(vcls, kh, method, **kwargs)
        return 1
    sub = {"keys": np.asarray([key]),
           "args": {f: np.asarray([v]) for f, v in kwargs.items()}}
    from ..core.ids import type_code_of
    from ..core.message import Category
    target = GrainId.system_target(type_code_of(VECTOR_STREAM_TARGET), owner)
    await silo.runtime_client.send_request(
        target_grain=target, grain_class=VectorStreamDeliverTarget,
        interface_name="VectorStreamDeliverTarget",
        method_name="vector_stream_deliver",
        args=(vcls.__name__, method, sub), kwargs={},
        target_silo=owner, category=Category.SYSTEM)
    return 1


def _bulk_events(item: dict) -> int:
    import numpy as np

    if "args_rounds" in item:
        K = np.asarray(next(iter(item["args_rounds"].values()))).shape[0]
        return K * len(item["keys"])
    return len(item["keys"])


def _run_bulk_local(rt, vcls: type, method: str, item: dict) -> int:
    import numpy as np

    keys = np.asarray(item["keys"])
    if "args_rounds" in item:
        rt.call_batch_rounds(vcls, method, keys, item["args_rounds"],
                             device_results=True)
    else:
        rt.call_batch(vcls, method, keys, item.get("args", {}),
                      device_results=True)
    return _bulk_events(item)


async def _run_bulk_local_via(silo: "Silo", rt, vcls: type, method: str,
                              item: dict) -> int:
    """The device-fan-out lever (``StreamOptions.device_fanout``): when
    armed, ``{"keys", "args"}`` items whose keys are all dense-regime
    ride the engine's ``stream_fanout`` (broadcast edge exchanges +
    apply_received dedup — tolerates duplicate keys, which call_batch
    lanes cannot) instead of a call_batch tick. Default OFF keeps the
    per-consumer path bit for bit; rounds items and hashed-key items
    always take the existing path."""
    import numpy as np

    if getattr(silo.config, "stream_device_fanout", False) and \
            "args_rounds" not in item:
        keys = np.asarray(item["keys"])
        if keys.dtype.kind in "iu" and keys.size:
            tbl = rt.table(vcls)
            if keys.min() >= 0 and keys.max() < tbl.dense_n:
                return await rt.stream_fanout(
                    vcls, method, keys.astype(np.int64),
                    item.get("args", {}))
    return _run_bulk_local(rt, vcls, method, item)


async def _deliver_bulk_item(silo: "Silo", rt, vcls: type, method: str,
                             item: dict) -> int:
    """Run one bulk item, respecting single-owner routing: in a
    multi-silo cluster each key's device-tier state lives on its ring
    owner (Dispatcher._handle_vector_request), so the item is partitioned
    by owner and remote sub-items ride a system-target hop. The
    single-silo (production TPU-host) case skips partitioning entirely —
    that is the >=1M events/sec path."""
    import numpy as np

    ring = silo.locator.ring
    me = silo.silo_address
    alive = getattr(silo.locator, "alive_list", None) or [me]
    if len(alive) <= 1:
        return await _run_bulk_local_via(silo, rt, vcls, method, item)

    keys = np.asarray(item["keys"])
    cls_type = GrainType.of(vcls.__name__)
    owners = [ring.owner(GrainId.for_grain(cls_type, int(k)).uniform_hash)
              or me for k in keys]
    groups: dict = {}
    for idx, owner in enumerate(owners):
        groups.setdefault(owner, []).append(idx)
    total = 0
    for owner, idxs in groups.items():
        sub = _slice_bulk_item(item, keys, idxs)
        if owner == me:
            total += await _run_bulk_local_via(silo, rt, vcls, method, sub)
        else:
            from ..core.ids import type_code_of
            from ..core.message import Category
            target = GrainId.system_target(
                type_code_of(VECTOR_STREAM_TARGET), owner)
            await silo.runtime_client.send_request(
                target_grain=target, grain_class=VectorStreamDeliverTarget,
                interface_name="VectorStreamDeliverTarget",
                method_name="vector_stream_deliver",
                args=(vcls.__name__, method, sub), kwargs={},
                target_silo=owner, category=Category.SYSTEM)
            total += _bulk_events(sub)
    return total


def _slice_bulk_item(item: dict, keys, idxs: list) -> dict:
    import numpy as np

    sel = np.asarray(idxs)
    sub: dict = {"keys": keys[sel]}
    if "args_rounds" in item:
        sub["args_rounds"] = {f: np.asarray(a)[:, sel]
                              for f, a in item["args_rounds"].items()}
    elif "args" in item:
        sub["args"] = {f: np.asarray(a)[sel]
                       for f, a in item["args"].items()}
    return sub


VECTOR_STREAM_TARGET = "vector-stream-deliver"


class VectorStreamDeliverTarget:
    """Per-silo system target executing forwarded bulk stream items on
    the keys' owner silo (the remote half of single-owner delivery)."""

    def __init__(self, silo) -> None:
        self.silo = silo

    async def vector_stream_deliver(self, class_name: str, method: str,
                                    item: dict) -> int:
        vcls = self.silo.vector_interfaces.get(class_name)
        if vcls is None or self.silo.vector is None:
            raise LookupError(
                f"no vector interface {class_name!r} on this silo")
        return await _run_bulk_local_via(self.silo, self.silo.vector,
                                         vcls, method, item)


def install_vector_stream_target(silo) -> None:
    """Idempotently register the bulk-delivery system target (called when
    a persistent-stream provider is installed on a vector-hosting silo)."""
    if getattr(silo, "_vector_stream_target", None) is None and \
            silo.vector is not None:
        silo._vector_stream_target = VectorStreamDeliverTarget(silo)
        silo.register_system_target(silo._vector_stream_target,
                                    VECTOR_STREAM_TARGET)
