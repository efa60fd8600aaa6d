"""Device-tier batched dispatch: VectorGrain, sharded actor tables, the
tick engine with its per-key, bulk and collective paths, dense
resharding and replicated stateless workers (the port of
``orleans_tpu.dispatch``, all but hosting)."""

from .engine import VectorActorRef, VectorRuntime, join_poll  # noqa: F401
from .replicated import ReplicatedWorkerHost  # noqa: F401
from .replicated import replicated_worker  # noqa: F401
from .reshard import reshard_dense  # noqa: F401
from .table import ShardedActorTable  # noqa: F401
from .vector_grain import ActorMethod, VectorGrain, actor_method  # noqa: F401
from .vector_grain import vector_methods  # noqa: F401
