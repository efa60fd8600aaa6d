"""OTPU007 clean, a loop handed to the constructor: the same egress
shard stamps its count on the shard loop and hands the stamps to the
main loop, which writes the registry (the stamp-and-replay pattern)."""
from orleans_tpu_torch.observability.stats import StatsRegistry


class EgressShard:
    def __init__(self, registry, main_loop, loop):
        self.loop = loop
        self.main_loop = main_loop
        self.registry: StatsRegistry = registry

    def client_direct(self, addr, msg):
        self.loop.call_soon_threadsafe(self._write_client, addr, [msg])

    def _write_client(self, addr, msgs):
        stamps = [("egress.frames", len(msgs))]
        self.main_loop.call_soon_threadsafe(self._replay, stamps)
        return [(addr, m) for m in msgs]

    def _replay(self, stamps):
        for name, n in stamps:
            self.registry.increment(name, n)
