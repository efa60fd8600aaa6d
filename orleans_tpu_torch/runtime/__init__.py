"""Host-tier runtime: silo, catalog, dispatcher, grain API (the port of
``orleans_tpu.runtime`` for in-proc silos: the socket fabric, the gateway
client, multi-process and multi-loop silos are not ported)."""

from .activation import ActivationData, ActivationState  # noqa: F401
from .cancellation import (  # noqa: F401
    GrainCancellationToken,
    GrainCancellationTokenSource,
)
from .cluster import ClusterClient, InProcFabric  # noqa: F401
from .context import RequestContext  # noqa: F401
from .grain import (  # noqa: F401
    Grain,
    StatefulGrain,
    always_interleave,
    collection_age,
    one_way,
    placement,
    read_only,
    reentrant,
    stateless_worker,
)
from .filters import (  # noqa: F401
    GrainCallContext,
    IncomingCallContext,
    OutgoingCallContext,
)
from .observers import ObserverHost, ObserverRef  # noqa: F401
from .references import GrainFactory, GrainRef  # noqa: F401
from .silo import (  # noqa: F401
    ServiceLifecycleStage,
    Silo,
    SiloBuilder,
    SiloConfig,
)
