"""Virtual streams (reference L11, src/Orleans.Core/Streams/ +
src/Orleans.Runtime/Streams/): SMS direct fan-out + persistent queue-backed
providers over grain-call delivery, and the device-tier provider whose
consumers are vector-grain rows.

The port of ``orleans_tpu.streams``.
"""

from .balancer import (  # noqa: F401
    BestFitBalancer,
    DeploymentBasedBalancer,
    LeaseBasedBalancer,
    MemoryLeaseProvider,
    QueueBalancer,
)
from .cache import PooledQueueCache, QueueCacheCursor  # noqa: F401
from .durable import (  # noqa: F401
    DurableQueueAdapter,
    FileQueueAdapter,
    SqliteQueueAdapter,
)
from .core import (StreamId, StreamProvider, StreamRef, StreamSignal,  # noqa: F401
                   SubscriptionHandle, batch_consumer)
from .device import (  # noqa: F401
    DeviceStreamProvider,
    DeviceSubscription,
    add_device_streams,
)
from .persistent import (  # noqa: F401
    GeneratorQueueAdapter,
    MemoryQueueAdapter,
    PersistentStreamProvider,
    QueueAdapter,
    QueueBatch,
    QueueReceiver,
    add_persistent_streams,
)
from .pubsub import PubSubRendezvousGrain, implicit_stream_subscription  # noqa: F401
from .sms import SMSStreamProvider, add_sms_streams  # noqa: F401

__all__ = [
    "StreamId", "StreamRef", "StreamSignal", "SubscriptionHandle",
    "StreamProvider", "batch_consumer",
    "SMSStreamProvider", "add_sms_streams",
    "QueueAdapter", "QueueReceiver", "QueueBatch", "MemoryQueueAdapter",
    "GeneratorQueueAdapter",
    "DurableQueueAdapter", "FileQueueAdapter", "SqliteQueueAdapter",
    "PersistentStreamProvider", "add_persistent_streams",
    "PubSubRendezvousGrain", "implicit_stream_subscription",
    "QueueBalancer", "DeploymentBasedBalancer", "BestFitBalancer",
    "LeaseBasedBalancer", "MemoryLeaseProvider",
    "PooledQueueCache", "QueueCacheCursor",
    "DeviceStreamProvider", "DeviceSubscription", "add_device_streams",
]
