"""OTPU007 bad, a loop handed to the constructor: an egress shard is
given the shard loop it runs on (``self.loop = loop``) instead of making
one, and the client flush it schedules onto that loop writes the
loop-confined registry directly instead of stamping it for a loop-side
replay. The port's analyzer infers the handed loop as a worker loop and
flags the write; the JAX package's analyzer infers worker loops only
from ``asyncio.new_event_loop()`` and misses it."""
from orleans_tpu_torch.observability.stats import StatsRegistry


class EgressShard:
    def __init__(self, registry, main_loop, loop):
        self.loop = loop
        self.main_loop = main_loop
        self.registry: StatsRegistry = registry

    def client_direct(self, addr, msg):
        self.loop.call_soon_threadsafe(self._write_client, addr, [msg])

    def _write_client(self, addr, msgs):
        self.registry.increment("egress.frames")
        return [(addr, m) for m in msgs]
