"""The port's host tier (orleans_tpu_torch.runtime, core, observability)
against the JAX package's, on the CPU.

Host grains run through a silo of each package with the same calls and
must return the same values and store the same state; a replicated
journaled grain (its module not ported yet) is refused when the silo is
built, and every option once refused builds a silo that answers; a
profiled hosted silo books the off-loop worker's completions to
``tick_schedule``; a traced hosted silo records the JAX package's span
kinds; the serializer copies tensors, reads and writes the JAX package's
hotwire frames byte for byte and refuses a tensor on the wire.
Every async body runs under ``asyncio.wait_for(..., 30)``.
"""

import asyncio

import numpy as np
import pytest
import torch

import orleans_tpu.core.serialization as jser
import orleans_tpu.runtime as jr
import orleans_tpu.storage as js
import orleans_tpu_torch.core.serialization as tser
import orleans_tpu_torch.dispatch as td
import orleans_tpu_torch.observability.profiling as tprof
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.storage as ts
from orleans_tpu_torch.parallel import make_mesh

TIMEOUT = 30


class JHello(jr.Grain):
    async def say_hello(self, greeting: str) -> str:
        return f"You said: '{greeting}', I say: Hello!"

    async def fail(self, why: str) -> None:
        raise ValueError(why)


class THello(tr.Grain):
    async def say_hello(self, greeting: str) -> str:
        return f"You said: '{greeting}', I say: Hello!"

    async def fail(self, why: str) -> None:
        raise ValueError(why)


class JPersistent(jr.StatefulGrain):
    async def add(self, x: int) -> int:
        self.state["n"] = self.state.get("n", 0) + x
        self.state.setdefault("log", []).append(x)
        await self.write_state()
        return self.state["n"]

    async def read(self) -> dict:
        await self.read_state()
        return dict(self.state)


class TPersistent(tr.StatefulGrain):
    async def add(self, x: int) -> int:
        self.state["n"] = self.state.get("n", 0) + x
        self.state.setdefault("log", []).append(x)
        await self.write_state()
        return self.state["n"]

    async def read(self) -> dict:
        await self.read_state()
        return dict(self.state)


for _name, _pair in {"HelloGrain": (JHello, THello),
                     "PersistentGrain": (JPersistent, TPersistent)}.items():
    for _cls in _pair:
        _cls.__name__ = _cls.__qualname__ = _name


async def _silo_calls(rt, grains, body, storage=None):
    b = rt.SiloBuilder().with_name("host").add_grains(*grains)
    if storage is not None:
        b.with_storage("Default", storage)
    silo = b.build()
    await silo.start()
    client = await rt.ClusterClient(silo.fabric).connect()
    try:
        return await body(client)
    finally:
        await client.close_async()
        await silo.stop()


async def test_hello_grain_parity():
    async def body(cls):
        async def run(client):
            out = [await client.get_grain(cls, k).say_hello(f"hi {k}")
                   for k in range(3)]
            with pytest.raises(ValueError, match="no reason") as e:
                await client.get_grain(cls, 0).fail("no reason")
            return out, type(e.value).__name__
        return run

    got = []
    for rt, cls in ((jr, JHello), (tr, THello)):
        got.append(await asyncio.wait_for(
            _silo_calls(rt, [cls], await body(cls)), TIMEOUT))
    assert got[0] == got[1]
    assert got[1][0][2] == "You said: 'hi 2', I say: Hello!"


async def test_stateful_grain_over_memory_storage_parity():
    async def run_pkg(rt, storage_mod, cls):
        storage = storage_mod.MemoryStorage()

        async def first(client):
            return [await client.get_grain(cls, k % 2).add(k)
                    for k in range(1, 6)]

        async def second(client):  # a new silo reads what the first wrote
            return [await client.get_grain(cls, k).read() for k in (0, 1)]

        out = await _silo_calls(rt, [cls], first, storage)
        state = await _silo_calls(rt, [cls], second, storage)
        return out, state

    j = await asyncio.wait_for(run_pkg(jr, js, JPersistent), TIMEOUT)
    t = await asyncio.wait_for(run_pkg(tr, ts, TPersistent), TIMEOUT)
    assert j == t
    assert t[0] == [1, 2, 4, 6, 9]
    assert t[1] == [{"n": 6, "log": [2, 4]}, {"n": 9, "log": [1, 3, 5]}]


class _Replicated(tr.Grain):
    __journal_replicated__ = True


@pytest.mark.parametrize("option, value, module", [
    ("worker_procs", 2, "runtime/multiproc.py"),
    ("ingress_loops", 2, "runtime/multiloop.py"),
    ("egress_shards", 1, "runtime/multiloop.py"),
    ("metrics_enabled", True, "observability/metrics.py"),
    ("metrics_port", 0, "observability/metrics.py"),
    ("slo_enabled", True, "observability/slo.py"),
    ("ledger_enabled", True, "observability/ledger.py"),
    ("trace_otlp_endpoint", "http://localhost:4318",
     "observability/export.py"),
    ("journal_replicated", True, "eventsourcing/journaled.py"),
    ("with_options", True, "config.py"),
])
def test_unported_option_raises_at_build(option, value, module):
    """Only a replicated journaled grain is still refused at ``build()``
    (ROADMAP Queue 1 item 18). Every option of items 16-17 builds a silo
    that starts and answers, with ``with_config`` and through an options
    group — but ``worker_procs``, which on the in-process fabric meets the
    JAX package's own ``ConfigurationError`` (SO_REUSEPORT needs a
    ``SocketFabric``; tests/test_torch_socket.py starts it on one)."""
    b = tr.SiloBuilder().add_grains(THello)
    if option == "journal_replicated":
        with pytest.raises(NotImplementedError, match="ROADMAP") as e:
            b.add_grains(_Replicated).build()
        assert module in str(e.value)
        return
    if option == "with_options":
        from orleans_tpu_torch.config import MetricsOptions
        b.with_options(MetricsOptions(enabled=value))
    else:
        b.with_config(**{option: value})
    if option == "worker_procs":
        from orleans_tpu_torch.core.errors import ConfigurationError
        with pytest.raises(ConfigurationError, match="SocketFabric"):
            b.build()
        return
    silo = b.build()

    async def run():
        await silo.start()
        client = await tr.ClusterClient(silo.fabric).connect()
        try:
            return await client.get_grain(THello, 1).say_hello("hi")
        finally:
            await client.close_async()
            await silo.stop()

    assert asyncio.run(asyncio.wait_for(run(), TIMEOUT)) == \
        "You said: 'hi', I say: Hello!"
    assert silo.status == "Stopped"


async def test_profiled_silo_books_worker_completions_to_tick_schedule():
    class Beat(td.VectorGrain):
        STATE = {"n": (torch.int32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"n": torch.zeros_like(key_hash)}

        @td.actor_method
        def beat(state, args):
            return {"n": state["n"] + 1}, state["n"] + 1

    b = tr.SiloBuilder().with_config(profiling_enabled=True,
                                     profiling_window=0.05)
    td.add_vector_grains(b, Beat, mesh=make_mesh(4, device="cpu"),
                         capacity_per_shard=64)
    silo = b.build()
    seen = []

    async def body():
        await silo.start()
        client = await tr.ClusterClient(silo.fabric).connect()
        try:
            rt = silo.vector
            assert rt.offloop_tick and rt.loop_prof is silo.loop_prof
            complete = rt._complete_job

            def spy(*a, **kw):  # the worker's completion, on the loop
                seen.append((tprof.LOOP_CATEGORY.get(),
                             silo.loop_prof._cur))
                return complete(*a, **kw)
            rt._complete_job = spy
            for _ in range(3):
                out = await asyncio.gather(*(
                    client.get_grain(Beat, k).beat() for k in range(32)))
            assert [int(v) for v in out] == [3] * 32
            await asyncio.sleep(0.12)  # close a profiling window
            return silo.loop_prof.occupancy()
        finally:
            await client.close_async()
            await silo.stop()

    occupancy = await asyncio.wait_for(body(), TIMEOUT)
    assert seen and all(c == ("tick_schedule", "tick_schedule")
                        for c in seen), seen
    assert occupancy.get("tick_schedule", 0.0) > 0.0


async def test_hosted_silo_hooks_trace_and_shed_like_the_jax_package():
    """A hosted silo hands its tracer and queue-wait trend to the engine;
    device ticks record the same span kinds in both packages."""
    import jax.numpy as jnp

    import orleans_tpu.dispatch as jd
    import orleans_tpu.parallel as jp

    class JBeat(jd.VectorGrain):
        STATE = {"n": (jnp.int32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"n": jnp.int32(0)}

        @jd.actor_method
        def beat(state, args):
            return {"n": state["n"] + 1}, state["n"] + 1

    class TBeat(td.VectorGrain):
        STATE = {"n": (torch.int32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"n": torch.zeros_like(key_hash)}

        @td.actor_method
        def beat(state, args):
            return {"n": state["n"] + 1}, state["n"] + 1

    JBeat.__name__ = TBeat.__name__ = "Beat"

    async def run(rt, add, cls, mesh):
        b = rt.SiloBuilder().with_config(trace_enabled=True,
                                         load_shedding_enabled=True,
                                         load_shedding_queue_wait=0.5)
        add(b, cls, mesh=mesh, capacity_per_shard=64)
        silo = b.build()
        await silo.start()
        client = await rt.ClusterClient(silo.fabric).connect()
        try:
            assert silo.vector.tracer is silo.tracer
            assert silo.vector.shed_trend is silo.shed_trend is not None
            out = await asyncio.gather(*(
                client.get_grain(cls, k).beat() for k in range(16)))
            await asyncio.sleep(0.05)
            kinds = sorted({sp["kind"] for sp in silo.tracer.snapshot()})
            return [int(v) for v in out], kinds
        finally:
            await client.close_async()
            await silo.stop()

    j = await asyncio.wait_for(
        run(jr, jd.add_vector_grains, JBeat, jp.make_mesh(4)), TIMEOUT)
    t = await asyncio.wait_for(
        run(tr, td.add_vector_grains, TBeat, make_mesh(4, device="cpu")),
        TIMEOUT)
    assert j == t and "device_tick" in t[1]


def test_torch_profiler_capture(tmp_path):
    prof = tprof.Profiler()
    with prof.capture(str(tmp_path)):
        with tprof.annotate("orleans-span"):
            torch.ones(8).sum()

        @tprof.traced("orleans-fn")
        def f():
            return torch.ones(4) * 2
        f()
    assert prof.stop() is None  # idempotent
    text = (tmp_path / "trace.json").read_text()
    assert "orleans-span" in text and "orleans-fn" in text
    assert "orleans-span" in {e.key for e in prof.last.key_averages()}


@pytest.mark.skipif(tser._hotwire is None or jser._hotwire is None,
                    reason="native toolchain unavailable")
def test_serializer_copies_tensors_and_reads_and_writes_hotwire_frames():
    t = torch.arange(4)
    copied = tser.deep_copy({"t": t, "a": np.arange(3)})
    copied["t"][0] = 9
    assert int(t[0]) == 0  # the caller's tensor is not aliased
    a = np.arange(3)
    assert tser.deep_copy(a) is a  # numpy payloads pass by value contract
    from orleans_tpu.core.ids import GrainId as JGrainId
    from orleans_tpu.core.ids import GrainType as JGrainType
    from orleans_tpu_torch.core.ids import GrainId, GrainType
    jg = JGrainId.for_grain(JGrainType.of("HelloGrain"), 7)
    tg = GrainId.for_grain(GrainType.of("HelloGrain"), 7)
    value = {"k": [1, 2.5, "x", None, (True, b"b")],
             "a": np.arange(4, dtype=np.int32), "s": np.float32(1.5)}
    # the port reads the JAX package's 0xA7 frames of builtins, numpy
    # values and ids ...
    frame = jser.serialize({**value, "g": jg})
    assert frame[:1] == b"\xa7"
    back = tser.deserialize(frame)
    assert back["k"] == value["k"] and back["s"] == value["s"]
    assert np.array_equal(back["a"], value["a"])
    assert type(back["g"]) is GrainId and back["g"] == tg
    assert back["g"].uniform_hash == jg.uniform_hash
    # ... and writes the same bytes, which the JAX package reads
    mine = tser.serialize({**value, "g": tg})
    assert mine == frame
    assert type(jser.deserialize(mine)["g"]) is JGrainId
    # durable blobs stay pickle, readable by either package
    blob = tser.serialize_portable(value)
    assert blob[:1] == b"\x80"
    assert jser.deserialize(blob)["k"] == value["k"]
    # the wire allowlist names the port, not the JAX package
    assert "orleans_tpu_torch" in tser._wire_allowlist
    assert not {"orleans_tpu", "jax", "jaxlib"} & tser._wire_allowlist
    # a torch tensor is refused at encode, naming its type
    for enc in (tser.serialize, tser.serialize_portable):
        with pytest.raises(tser.WireTypeError, match="torch.Tensor"):
            enc({"x": [torch.ones(2)]})


def test_adaptive_cache_drops_one_access_mark_at_its_bound():
    """A new gid at the bound of the accessed-mark set evicts one mark,
    not every mark (the reference clears the set, so one extra gid made
    the maintainer's next sweep miss the whole hot working set)."""
    from orleans_tpu_torch.directory.adaptive_cache import \
        AdaptiveDirectoryCache
    now = [0.0]
    cache = AdaptiveDirectoryCache(4, initial_ttl=1.0, clock=lambda: now[0])
    for g in range(4):
        cache.put(g, "silo-a")
        assert cache.get(g) == "silo-a"
    cache.put(4, "silo-b")  # the LRU entry 0 leaves the cache
    assert cache.get(4) == "silo-b"
    assert len(cache._accessed) == 4 and 4 in cache._accessed
    now[0] = 0.5  # every entry expires within the sweep horizon
    assert len(cache.sweep_candidates(horizon=1.0)) >= 3
