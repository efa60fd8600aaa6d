"""Virtual streams: the stream identities and the pub-sub rendezvous that a
silo hosting vector grains installs (the port of ``orleans_tpu.streams``'
``core`` and ``pubsub``; the providers are not ported)."""

from .core import (StreamId, StreamProvider, StreamRef, StreamSignal,  # noqa: F401
                   SubscriptionHandle, batch_consumer)
from .pubsub import PubSubRendezvousGrain, implicit_stream_subscription  # noqa: F401

__all__ = [
    "StreamId", "StreamRef", "StreamSignal", "SubscriptionHandle",
    "StreamProvider", "batch_consumer",
    "PubSubRendezvousGrain", "implicit_stream_subscription",
]
