"""Simple Message Streams: direct producer→consumer fan-out, no queue.

Re-design of Orleans' src/Orleans.Core/Streams/SimpleMessageStream/
SimpleMessageStreamProducer.cs:12 + SimpleMessageStreamProducerExtension.cs:
each event is fanned out as grain calls to every subscribed consumer at
publish time; optional fire-and-forget delivery.

The port's copy of ``orleans_tpu.streams.sms``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING

from ..core.errors import StreamError
from .core import StreamId, StreamProvider, SubscriptionHandle
from .pubsub import (
    PubSubRendezvousGrain,
    deliver_to_consumer,
    resolve_consumers,
)

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.streams.sms")

__all__ = ["SMSStreamProvider", "add_sms_streams"]


class SMSStreamProvider(StreamProvider):
    """Direct fan-out provider ("SMS")."""

    def __init__(self, silo: "Silo", name: str,
                 fire_and_forget: bool = False):
        super().__init__(silo, name)
        self.fire_and_forget = fire_and_forget
        self._seq = 0

    async def produce(self, stream: StreamId, items: list) -> None:
        consumers = await resolve_consumers(self.silo, stream)
        # item-cumulative: per-item tokens (token + i) stay unique across
        # batches (consumers dedup by token — see deliver_to_consumer)
        token = self._seq
        self._seq += len(items)
        self.silo.stats.increment("streams.sms.produced", len(items))
        deliveries = [
            deliver_to_consumer(self.silo, h, items, token)
            for h in consumers
        ]
        if self.fire_and_forget:
            for d in deliveries:
                asyncio.ensure_future(_swallow(d))
        else:
            results = await asyncio.gather(*deliveries,
                                           return_exceptions=True)
            errors = [r for r in results if isinstance(r, BaseException)]
            if errors:
                raise errors[0]

    async def register_consumer(self, handle: SubscriptionHandle) -> None:
        if getattr(handle, "from_token", None) is not None:
            raise StreamError(
                "SMS streams are not rewindable (no cache to replay "
                "from) — use a persistent (queue-backed) provider for "
                "from_token subscriptions")
        await self._rendezvous(handle.stream).register_consumer(handle)

    async def unregister_consumer(self, handle: SubscriptionHandle) -> None:
        await self._rendezvous(handle.stream).unregister_consumer(
            handle.handle_id)

    async def consumer_handles(self, stream: StreamId):
        return await resolve_consumers(self.silo, stream)

    def _rendezvous(self, stream: StreamId):
        return self.silo.grain_factory.get_grain(
            PubSubRendezvousGrain, str(stream))


async def _swallow(coro) -> None:
    try:
        await coro
    except Exception:  # noqa: BLE001 — fire-and-forget drops errors, logged
        log.debug("fire-and-forget stream delivery failed", exc_info=True)


def add_sms_streams(builder, name: str = "sms",
                    fire_and_forget: bool = False):
    """Register the SMS provider + pubsub grain on a SiloBuilder."""
    builder.add_grains(PubSubRendezvousGrain)

    def install(silo) -> None:
        silo.stream_providers[name] = SMSStreamProvider(
            silo, name, fire_and_forget)

    return builder.configure(install)
