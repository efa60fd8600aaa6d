"""Stream model: identities, handles, and the provider contract.

Re-design of Orleans' src/Orleans.Core/Streams/:
``StreamImpl`` (Internal/StreamImpl.cs:13 — Subscribe :60, OnNext :89),
``StreamId``/``IAsyncStream<T>`` (virtual streams addressed by guid+namespace),
``StreamSubscriptionHandle``. Providers implement ``get_stream`` and the
producer/consumer plumbing; consumers are grains — a subscription records
(grain id, method) and delivery is an ordinary grain call, the analog of the
``StreamConsumerExtension`` piggybacking on grain messaging.

The port's copy of ``orleans_tpu.streams.core``.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable

from ..core.errors import StreamError
from ..core.ids import GrainId, stable_hash64

if TYPE_CHECKING:
    from ..runtime.silo import Silo

__all__ = ["StreamId", "StreamRef", "StreamSignal", "SubscriptionHandle",
           "StreamProvider"]


@dataclass(frozen=True)
class StreamId:
    """Stream identity = (provider, namespace, key) — StreamId.cs."""

    provider: str
    namespace: str
    key: str

    @property
    def uniform_hash(self) -> int:
        return stable_hash64(f"stream|{self.provider}|{self.namespace}|{self.key}")

    def __str__(self) -> str:
        return f"{self.provider}/{self.namespace}/{self.key}"


@dataclass(frozen=True)
class StreamSignal:
    """Producer-signaled control event riding the normal item path as a
    single-item batch: ``kind`` is ``"error"`` (OnErrorAsync —
    AsyncObservableExtensions.cs:19-41 routes it to the observer's
    onErrorAsync delegate) or ``"completed"`` (OnCompletedAsync). Signals
    consume one sequence token like any item, so ordering relative to
    data, durable replay, and token dedup all hold unchanged."""

    kind: str
    error: Any = None


@dataclass(frozen=True)
class SubscriptionHandle:
    """Opaque subscription token (StreamSubscriptionHandle<T>)."""

    stream: StreamId
    handle_id: str
    grain_id: GrainId
    interface_name: str
    method_name: str
    # consumer-side OnError/OnCompleted methods (GenericAsyncObserver.cs:37
    # holds the three delegates; here: method names on the SAME grain).
    # None = the consumer declined that part of the contract; the signal
    # is then logged and dropped, as the reference does for null delegates
    error_method_name: str | None = None
    completed_method_name: str | None = None
    # batch consumer (IAsyncBatchObserver<T>): deliveries arrive as ONE
    # call per queue batch — method(items, first_token) — instead of a
    # grain call per event
    batch: bool = False
    # rewound subscription (StreamSequenceToken resume): deliver only
    # events with token >= from_token, replaying older ones from the
    # pulling agent's cache where still present (events already purged
    # are clamped to the oldest cached — the reference's cache-window
    # replay contract). None = from now/oldest-cached as usual.
    from_token: int | None = None
    # span-link arming context: the (trace_id, span_id) of the turn that
    # SUBSCRIBED, when sampled. Stream deliveries from pulling agents
    # root fresh traces; the new roots carry this as a span link so
    # Perfetto/OTLP show which subscription armed the work
    # (observability.tracing.pending_root_link). None for implicit
    # subscribers and untraced subscribes.
    link: tuple | None = None


def consumer_of(handler: Callable) -> tuple[GrainId, str, str]:
    """Extract (grain id, interface, method) from a bound grain method —
    the subscription record. The handler must be ``self.method`` of a live
    grain so delivery can route as a grain call after re-activation."""
    owner = getattr(handler, "__self__", None)
    if owner is None or not hasattr(owner, "grain_id"):
        raise StreamError(
            "stream handlers must be bound methods of a grain "
            "(e.g. stream.subscribe(self.on_event))")
    return owner.grain_id, type(owner).__name__, handler.__name__


def batch_consumer(fn: Callable) -> Callable:
    """Mark a stream handler as a BATCH consumer (the
    ``IAsyncBatchObserver<T>`` role): it receives
    ``(items: list, first_token: int)`` once per delivered batch instead
    of one grain call per event. Subscribing such a method picks batch
    delivery automatically; redelivery after a failure re-sends the
    not-yet-acknowledged remainder of the batch (at-least-once, dedup by
    token as usual)."""
    fn.__orleans_stream_batch__ = True
    return fn


class StreamRef:
    """The user-facing stream handle (IAsyncStream<T>): produce + subscribe.
    Cheap to create; all state lives in pubsub/queues."""

    def __init__(self, provider: "StreamProvider", stream: StreamId):
        self.provider = provider
        self.stream_id = stream

    # -- producer side (StreamImpl.OnNext :89) --------------------------
    async def on_next(self, item: Any) -> None:
        if isinstance(item, StreamSignal):
            raise StreamError("StreamSignal is not a data item; use "
                              "on_error()/on_completed()")
        await self.provider.produce(self.stream_id, [item])

    async def on_next_batch(self, items: list) -> None:
        items = list(items)
        if any(isinstance(i, StreamSignal) for i in items):
            raise StreamError("StreamSignal is not a data item; use "
                              "on_error()/on_completed()")
        await self.provider.produce(self.stream_id, items)

    async def on_error(self, exc: BaseException) -> None:
        """Producer signals failure to every subscriber (OnErrorAsync).
        Rides the normal produce path as its own single-item batch, so
        it is ordered after everything already produced and — on a
        durable provider — survives and replays like data."""
        await self.provider.produce(
            self.stream_id, [StreamSignal(kind="error", error=exc)])

    async def on_completed(self) -> None:
        await self.provider.complete(self.stream_id)

    # -- consumer side (StreamImpl.Subscribe :60) -----------------------
    async def subscribe(self, handler: Callable,
                        batch: bool | None = None,
                        from_token: int | None = None,
                        on_error: Callable | None = None,
                        on_completed: Callable | None = None,
                        ) -> SubscriptionHandle:
        """Subscribe a bound grain method. ``batch`` (or the
        ``@batch_consumer`` marker) selects whole-batch delivery;
        ``from_token`` resumes a rewindable (persistent) stream from a
        sequence token, replaying from the provider's cache window.
        ``on_error`` / ``on_completed`` are further bound methods of the
        SAME grain receiving producer signals: ``on_error(exc, token)``
        and ``on_completed(token)`` — the observer triple of
        GenericAsyncObserver.cs:37."""
        grain_id, iface, method = consumer_of(handler)
        err_method = comp_method = None
        if on_error is not None:
            egid, _, err_method = consumer_of(on_error)
            if egid != grain_id:
                raise StreamError("on_error must be a method of the same "
                                  "grain as the data handler")
        if on_completed is not None:
            cgid, _, comp_method = consumer_of(on_completed)
            if cgid != grain_id:
                raise StreamError("on_completed must be a method of the "
                                  "same grain as the data handler")
        if batch is None:
            batch = bool(getattr(handler, "__orleans_stream_batch__", False))
        from ..observability.tracing import current_trace
        handle = SubscriptionHandle(
            stream=self.stream_id, handle_id=uuid.uuid4().hex,
            grain_id=grain_id, interface_name=iface, method_name=method,
            batch=batch, from_token=from_token,
            error_method_name=err_method, completed_method_name=comp_method,
            link=current_trace.get())
        await self.provider.register_consumer(handle)
        return handle

    async def unsubscribe(self, handle: SubscriptionHandle) -> None:
        await self.provider.unregister_consumer(handle)

    async def subscription_handles(self) -> list[SubscriptionHandle]:
        return await self.provider.consumer_handles(self.stream_id)


class StreamProvider:
    """Provider contract (IStreamProvider). Subclasses: SMS (direct fan-out)
    and persistent (queue-backed)."""

    def __init__(self, silo: "Silo", name: str):
        self.silo = silo
        self.name = name

    def get_stream(self, namespace: str, key) -> StreamRef:
        return StreamRef(self, StreamId(self.name, namespace, str(key)))

    # -- to implement ----------------------------------------------------
    async def produce(self, stream: StreamId, items: list) -> None:
        raise NotImplementedError

    async def complete(self, stream: StreamId) -> None:
        """Completion is a signal through the same ordered path as data
        (subscribers with a ``completed_method_name`` hear it; others
        ignore it)."""
        try:
            await self.produce(stream, [StreamSignal(kind="completed")])
        except StreamError as e:
            # a produce-rejecting adapter (e.g. the generator provider)
            # cannot carry signals either — name the actual operation
            raise StreamError(
                f"on_completed not supported on {stream}: {e}") from e

    async def register_consumer(self, handle: SubscriptionHandle) -> None:
        raise NotImplementedError

    async def unregister_consumer(self, handle: SubscriptionHandle) -> None:
        raise NotImplementedError

    async def consumer_handles(self, stream: StreamId) -> list[SubscriptionHandle]:
        raise NotImplementedError
