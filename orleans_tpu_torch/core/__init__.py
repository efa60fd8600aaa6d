"""Core identity, message, and serialization layers (the port of
``orleans_tpu.core``; the serializer is pickle-only, see
``serialization``)."""

from .asyncs import (  # noqa: F401
    AsyncPipeline,
    AsyncSerialExecutor,
    BatchWorker,
    ExponentialBackoff,
    retry,
)
from .errors import *  # noqa: F401,F403
from .ids import (  # noqa: F401
    ActivationAddress,
    ActivationId,
    GrainCategory,
    GrainId,
    GrainType,
    SiloAddress,
    stable_hash32,
    stable_hash64,
    type_code_of,
)
from .message import (  # noqa: F401
    Category,
    Direction,
    Message,
    RejectionType,
    ResponseKind,
    make_request,
    make_response,
    make_error_response,
    make_rejection,
)
from .serialization import (  # noqa: F401
    ArrayField,
    ArraySchema,
    Immutable,
    allow_wire_modules,
    deep_copy,
    deserialize,
    register_copier,
    serialize,
)
