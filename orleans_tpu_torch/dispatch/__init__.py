"""Device-tier batched dispatch: VectorGrain, sharded actor tables, tick
engine (the port of ``orleans_tpu.dispatch``, synchronous part)."""

from .engine import VectorRuntime  # noqa: F401
from .table import ShardedActorTable  # noqa: F401
from .vector_grain import ActorMethod, VectorGrain, actor_method  # noqa: F401
from .vector_grain import vector_methods  # noqa: F401
