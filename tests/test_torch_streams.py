"""Parity of the port's stream providers (orleans_tpu_torch.streams) with
orleans_tpu.streams, on the CPU.

Every scenario of tests/test_vector_streams.py, tests/test_device_streams.py
and tests/test_stream_balancers.py, and the SMS and persistent cases of
tests/test_streams.py that need no membership table, runs through a silo
(or the bare object) of each package with the same seeded inputs. What a
consumer heard (items, tokens, order), the vector tables (the sink row
left out), the balancers' queue sets and the delivery counters must be
equal. Tolerance: exact. Integer and bool fields are compared bit for bit;
float fields too, because every float row is a sum of a few small
integers in float32, exact in any order of accumulation.

The silos of the two packages run one after the other, never on one loop
(each package's silo installs its own eager task factory). Grains of a
pair share their ``__name__``: it is part of every hashed key's GrainId
and of the ring-owner hash of a dense key. Every async body runs under
``asyncio.wait_for(..., 30)`` and stops its silos in a ``finally``.
"""

import asyncio
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orleans_tpu.core.errors as jerr
import orleans_tpu.core.ids as jids
import orleans_tpu.core.message as jmsg
import orleans_tpu.dispatch as jd
import orleans_tpu.parallel as jp
import orleans_tpu.runtime as jr
import orleans_tpu.storage as jstore
import orleans_tpu.streams as jst
import orleans_tpu.streams.cache as jcache
import orleans_tpu.streams.persistent as jpers
import orleans_tpu_torch.core.errors as terr
import orleans_tpu_torch.core.ids as tids
import orleans_tpu_torch.core.message as tmsg
import orleans_tpu_torch.dispatch as td
import orleans_tpu_torch.parallel as tp
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.storage as tstore
import orleans_tpu_torch.streams as tst
import orleans_tpu_torch.streams.cache as tcache
import orleans_tpu_torch.streams.persistent as tpers

TIMEOUT = 30
RECEIVED: dict = {}   # (consumer key, kind) -> items, one package at a time
FAILURES: list = []


# ---------------------------------------------------------------------------
# vector-grain consumers, once in jnp and once in torch
# ---------------------------------------------------------------------------

@jst.implicit_stream_subscription("telemetry")
class JSensorVec(jd.VectorGrain):
    STATE = {"events": (jnp.int32, ()), "total": (jnp.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"events": jnp.int32(0), "total": jnp.float32(0)}

    @jd.actor_method(args={"v": (jnp.float32, ())})
    def on_next(state, args):
        new = {"events": state["events"] + 1,
               "total": state["total"] + args["v"]}
        return new, new["events"]


@tst.implicit_stream_subscription("telemetry")
class TSensorVec(td.VectorGrain):
    STATE = {"events": (torch.int32, ()), "total": (torch.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"events": torch.zeros_like(key_hash),
                "total": key_hash.new_zeros((), dtype=torch.float32)}

    @td.actor_method(args={"v": (torch.float32, ())})
    def on_next(state, args):
        new = {"events": state["events"] + 1,
               "total": state["total"] + args["v"]}
        return new, new["events"]


class JFeedVec(jd.VectorGrain):
    """Counts events, sums payloads, and flips ``ok`` to 0 the moment a
    delivered ``v`` does not exceed the last (publishers send strictly
    increasing values)."""

    STATE = {"events": (jnp.int32, ()), "total": (jnp.float32, ()),
             "last": (jnp.float32, ()), "ok": (jnp.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"events": jnp.int32(0), "total": jnp.float32(0),
                "last": jnp.float32(-1), "ok": jnp.int32(1)}

    @jd.actor_method(args={"v": (jnp.float32, ())})
    def on_next(state, args):
        good = (args["v"] > state["last"]).astype(jnp.int32)
        new = {"events": state["events"] + 1,
               "total": state["total"] + args["v"],
               "last": args["v"], "ok": state["ok"] * good}
        return new, new["events"]

    @jd.actor_method(read_only=True)
    def ready(state, args):
        return state, (state["events"] >= 3).astype(jnp.int32)


class TFeedVec(td.VectorGrain):
    STATE = {"events": (torch.int32, ()), "total": (torch.float32, ()),
             "last": (torch.float32, ()), "ok": (torch.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"events": torch.zeros_like(key_hash),
                "total": key_hash.new_zeros((), dtype=torch.float32),
                "last": key_hash.new_full((), -1.0, dtype=torch.float32),
                "ok": torch.ones_like(key_hash)}

    @td.actor_method(args={"v": (torch.float32, ())})
    def on_next(state, args):
        good = (args["v"] > state["last"]).to(torch.int32)
        new = {"events": state["events"] + 1,
               "total": state["total"] + args["v"],
               "last": args["v"], "ok": state["ok"] * good}
        return new, new["events"]

    @td.actor_method(read_only=True)
    def ready(state, args):
        return state, (state["events"] >= 3).to(torch.int32)


@jst.implicit_stream_subscription("lever")
class JLeverVec(jd.VectorGrain):
    STATE = {"events": (jnp.int32, ()), "total": (jnp.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"events": jnp.int32(0), "total": jnp.float32(0)}

    @jd.actor_method(args={"v": (jnp.float32, ())})
    def on_next(state, args):
        return {"events": state["events"] + 1,
                "total": state["total"] + args["v"]}, state["events"]


@tst.implicit_stream_subscription("lever")
class TLeverVec(td.VectorGrain):
    STATE = {"events": (torch.int32, ()), "total": (torch.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"events": torch.zeros_like(key_hash),
                "total": key_hash.new_zeros((), dtype=torch.float32)}

    @td.actor_method(args={"v": (torch.float32, ())})
    def on_next(state, args):
        return {"events": state["events"] + 1,
                "total": state["total"] + args["v"]}, state["events"]


for _name, _pair in {"SensorVec": (JSensorVec, TSensorVec),
                     "FeedVec": (JFeedVec, TFeedVec),
                     "LeverVec": (JLeverVec, TLeverVec)}.items():
    for _cls in _pair:
        _cls.__name__ = _cls.__qualname__ = _name


# ---------------------------------------------------------------------------
# host-tier grains of tests/test_streams.py, built once per package
# ---------------------------------------------------------------------------

def host_grains(rt, st, err):
    class ProducerGrain(rt.Grain):
        async def publish(self, provider, ns, stream_key, item):
            s = self.get_stream_provider(provider).get_stream(ns, stream_key)
            await s.on_next(item)

        async def publish_batch(self, provider, ns, stream_key, items):
            s = self.get_stream_provider(provider).get_stream(ns, stream_key)
            await s.on_next_batch(items)

        async def publish_error(self, provider, ns, stream_key, text):
            s = self.get_stream_provider(provider).get_stream(ns, stream_key)
            await s.on_error(RuntimeError(text))

        async def publish_completed(self, provider, ns, stream_key):
            s = self.get_stream_provider(provider).get_stream(ns, stream_key)
            await s.on_completed()

    class ConsumerGrain(rt.Grain):
        async def join(self, provider, ns, stream_key):
            s = self.get_stream_provider(provider).get_stream(ns, stream_key)
            self._handle = await s.subscribe(self.on_event)
            return self._handle.handle_id

        async def leave(self, provider, ns, stream_key):
            s = self.get_stream_provider(provider).get_stream(ns, stream_key)
            await s.unsubscribe(self._handle)

        async def join_from(self, provider, ns, stream_key, token):
            s = self.get_stream_provider(provider).get_stream(ns, stream_key)
            await s.subscribe(self.on_token, from_token=token)

        async def try_rewind(self, provider, ns, stream_key):
            s = self.get_stream_provider(provider).get_stream(ns, stream_key)
            try:
                await s.subscribe(self.on_event, from_token=5)
            except err.StreamError:
                return "rejected"
            return "accepted"

        async def on_event(self, item, token):
            RECEIVED.setdefault((self.primary_key, "explicit"),
                                []).append(item)

        async def on_token(self, item, token):
            RECEIVED.setdefault((self.primary_key, "token"),
                                []).append((item, token))

    @st.implicit_stream_subscription("telemetry")
    class ImplicitConsumerGrain(rt.Grain):
        async def on_next(self, item, token):
            RECEIVED.setdefault((self.primary_key, "implicit"),
                                []).append(item)

    class FlakyConsumerGrain(rt.Grain):
        async def join(self, provider, ns, stream_key):
            s = self.get_stream_provider(provider).get_stream(ns, stream_key)
            await s.subscribe(self.on_event)

        async def on_event(self, item, token):
            raise RuntimeError("consumer permanently broken")

    class SignalConsumerGrain(rt.Grain):
        async def join(self, provider, ns, stream_key):
            s = self.get_stream_provider(provider).get_stream(ns, stream_key)
            await s.subscribe(self.on_event, on_error=self.on_stream_error,
                              on_completed=self.on_stream_done)

        async def on_event(self, item, token):
            RECEIVED.setdefault((self.primary_key, "signal"),
                                []).append(item)

        async def on_stream_error(self, exc, token):
            RECEIVED.setdefault((self.primary_key, "signal"), []).append(
                ("error", str(exc), token))

        async def on_stream_done(self, token):
            RECEIVED.setdefault((self.primary_key, "signal"), []).append(
                ("completed", token))

    class BatchSink(rt.Grain):
        async def join(self, provider, ns, stream_key):
            s = self.get_stream_provider(provider).get_stream(ns, stream_key)
            await s.subscribe(self.on_batch)

        @st.batch_consumer
        async def on_batch(self, items, first_token):
            RECEIVED.setdefault((self.primary_key, "batch"), []).append(
                (list(items), first_token))

    class SlowConsumer(rt.Grain):
        async def join(self, provider, ns, stream_key):
            s = self.get_stream_provider(provider).get_stream(ns, stream_key)
            await s.subscribe(self.on_event)

        async def on_event(self, item, token):
            await asyncio.sleep(0.05)
            RECEIVED.setdefault(("slow", "explicit"), []).append(item)

    return SimpleNamespace(
        Producer=ProducerGrain, Consumer=ConsumerGrain,
        Implicit=ImplicitConsumerGrain, Flaky=FlakyConsumerGrain,
        Signal=SignalConsumerGrain, Batch=BatchSink, Slow=SlowConsumer,
        all=[ProducerGrain, ConsumerGrain, ImplicitConsumerGrain,
             FlakyConsumerGrain, SignalConsumerGrain, BatchSink,
             SlowConsumer])


J = SimpleNamespace(
    name="jax", rt=jr, add=jd.add_vector_grains, st=jst, cache=jcache,
    pers=jpers, ids=jids, msg=jmsg, err=jerr, storage=jstore,
    mesh=lambda n: jp.make_mesh(n), Sensor=JSensorVec, Feed=JFeedVec,
    Lever=JLeverVec, host=host_grains(jr, jst, jerr))
T = SimpleNamespace(
    name="torch", rt=tr, add=td.add_vector_grains, st=tst, cache=tcache,
    pers=tpers, ids=tids, msg=tmsg, err=terr, storage=tstore,
    mesh=lambda n: tp.make_mesh(n, device="cpu"), Sensor=TSensorVec,
    Feed=TFeedVec, Lever=TLeverVec, host=host_grains(tr, tst, terr))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _same(a, b, label="") -> None:
    """Equal nested values (dicts, sequences, arrays, scalars), with
    equal dtypes where both sides are numpy values."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), label
        for k in a:
            _same(a[k], b[k], f"{label}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (label, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{label}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, \
            (label, x.dtype, y.dtype, x.shape, y.shape)
        assert np.array_equal(x, y), (label, x, y)


async def _parity(scenario, *args):
    """``scenario(pkg, *args)`` through the JAX package, then the port,
    each bounded by TIMEOUT; both results, after checking them equal."""
    got = []
    for pkg in (J, T):
        RECEIVED.clear()
        FAILURES.clear()
        got.append(await asyncio.wait_for(scenario(pkg, *args), TIMEOUT))
    _same(got[0], got[1], scenario.__name__)
    return got


async def _run(silos, client_fabric, pkg, body):
    """Start ``silos`` and a client, run ``body(silos, client)``, stop
    everything."""
    started = []
    client = None
    try:
        for s in silos:
            await s.start()
            started.append(s)
        client = await pkg.rt.ClusterClient(client_fabric).connect()
        return await body(silos, client)
    finally:
        if client is not None:
            await client.close_async()
        for s in started:
            if s.status not in ("Stopped", "Dead"):
                await s.stop()


async def _poll(check, timeout=6.0, step=0.02):
    for _ in range(int(timeout / step)):
        if check():
            return True
        await asyncio.sleep(step)
    return check()


def _rows(tbl) -> dict:
    """A table snapshot without its sink row."""
    return {k: v[:, :-1] for k, v in tbl.snapshot().items()}


def _events(silos, cls, k):
    total = 0
    for s in silos:
        tbl = s.vector.table(cls)
        if tbl.dense_active[k]:
            total += int(tbl.read_row(k)["events"])
    return total


def _misplaced(pkg, silos, cls, keys) -> int:
    """Rows with events on a silo that is not the key's ring owner."""
    ct = pkg.ids.GrainType.of(cls.__name__)
    n = 0
    for k in keys:
        owner = silos[0].locator.ring.owner(
            pkg.ids.GrainId.for_grain(ct, int(k)).uniform_hash)
        for s in silos:
            tbl = s.vector.table(cls)
            if tbl.dense_active[k] and int(tbl.read_row(k)["events"]) \
                    and s.silo_address != owner:
                n += 1
    return n


# ---------------------------------------------------------------------------
# tests/test_vector_streams.py: persistent batches to vector consumers
# ---------------------------------------------------------------------------

def _vector_silos(pkg, n, adapter, n_dense=64, n_shards=1):
    fabric = pkg.rt.InProcFabric()
    silos = []
    for i in range(n):
        b = (pkg.rt.SiloBuilder().with_name(f"vs{i}").with_fabric(fabric)
             .with_config(response_timeout=5.0))
        pkg.add(b, pkg.Sensor, mesh=pkg.mesh(n_shards),
                capacity_per_shard=max(64, n_dense),
                dense={pkg.Sensor: n_dense})
        pkg.st.add_persistent_streams(b, "queue", adapter, pull_period=0.02)
        silos.append(b.build())
    return fabric, silos


async def _bulk_item(pkg):
    fabric, silos = _vector_silos(pkg, 1, pkg.st.MemoryQueueAdapter(2))

    async def body(silos, client):
        silo = silos[0]
        provider = silo.stream_providers["queue"]
        await provider.produce(pkg.st.StreamId("queue", "telemetry", "s1"), [
            {"keys": np.arange(32),
             "args": {"v": np.arange(32, dtype=np.float32)}}])
        tbl = silo.vector.table(pkg.Sensor)
        assert await _poll(lambda: int(tbl.read_row(31)["events"]) == 1)
        return _rows(tbl), silo.stats.get("streams.vector.delivered")
    return await _run(silos, fabric, pkg, body)


async def test_bulk_item_delivers_through_call_batch():
    (rows, delivered), _ = await _parity(_bulk_item)
    assert delivered == 32
    assert (rows["events"][0, :32] == 1).all()
    assert (rows["total"][0, :32] == np.arange(32)).all()


async def _rounds_item(pkg, K=4):
    fabric, silos = _vector_silos(pkg, 1, pkg.st.MemoryQueueAdapter(2))

    async def body(silos, client):
        silo = silos[0]
        await silo.stream_providers["queue"].produce(
            pkg.st.StreamId("queue", "telemetry", "s2"), [
                {"keys": np.arange(16),
                 "args_rounds": {"v": np.ones((K, 16), np.float32)}}])
        tbl = silo.vector.table(pkg.Sensor)
        assert await _poll(lambda: int(tbl.read_row(0)["events"]) == K)
        return _rows(tbl)
    return await _run(silos, fabric, pkg, body)


async def test_rounds_item_preserves_per_key_order():
    rows, _ = await _parity(_rounds_item)
    assert (rows["events"][0, :16] == 4).all()
    assert (rows["total"][0, :16] == 4.0).all()


async def _scalar_items(pkg):
    fabric, silos = _vector_silos(pkg, 1, pkg.st.MemoryQueueAdapter(2))

    async def body(silos, client):
        silo = silos[0]
        await silo.stream_providers["queue"].produce(
            pkg.st.StreamId("queue", "telemetry", "s3"), [
                {"key": 2, "v": np.float32(5.0)},
                {"key": 2, "v": np.float32(7.0)}])
        tbl = silo.vector.table(pkg.Sensor)
        assert await _poll(lambda: tbl.dense_active[2]
                           and int(tbl.read_row(2)["events"]) == 2)
        return tbl.read_row(2)
    return await _run(silos, fabric, pkg, body)


async def test_scalar_items_coalesce_via_rt_call():
    row, _ = await _parity(_scalar_items)
    assert int(row["events"]) == 2 and float(row["total"]) == 12.0


async def _provider_path(pkg, N=2048, K=8, n_items=6):
    """The provider path of the 1M events/s case, its checks at a small
    size: produce → queue → pulling agent → pub-sub resolve → batched
    rounds on the device tier (the rate is measured on the card)."""
    fabric, silos = _vector_silos(pkg, 1, pkg.st.MemoryQueueAdapter(1),
                                  n_dense=N, n_shards=8)

    async def body(silos, client):
        silo = silos[0]
        provider = silo.stream_providers["queue"]
        stream = pkg.st.StreamId("queue", "telemetry", "big")
        rounds = np.ones((K, N), dtype=np.float32)
        tbl = silo.vector.table(pkg.Sensor)
        await provider.produce(stream, [
            {"keys": np.arange(N), "args_rounds": {"v": rounds}}])
        assert await _poll(lambda: int(tbl.read_row(0)["events"]) == K)
        await provider.produce(stream, [
            {"keys": np.arange(N), "args_rounds": {"v": rounds}}
            for _ in range(n_items)])
        target = K * (1 + n_items)
        assert await _poll(
            lambda: int(tbl.read_row(N - 1)["events"]) == target, 20.0)
        return _rows(tbl), silo.stats.get("streams.vector.delivered")
    return await _run(silos, fabric, pkg, body)


async def test_provider_path_sustains_1m_events_per_sec():
    (rows, delivered), _ = await _parity(_provider_path)
    assert delivered == 7 * 8 * 2048
    assert rows["events"].sum() == 7 * 8 * 2048
    assert rows["total"].sum() == 7 * 8 * 2048


async def _multi_silo_bulk(pkg):
    fabric, silos = _vector_silos(pkg, 2, pkg.st.MemoryQueueAdapter(2))

    async def body(silos, client):
        await silos[0].stream_providers["queue"].produce(
            pkg.st.StreamId("queue", "telemetry", "ms"), [
                {"keys": np.arange(64),
                 "args": {"v": np.ones(64, dtype=np.float32)}}])
        assert await _poll(lambda: all(
            _events(silos, pkg.Sensor, k) == 1 for k in range(64)))
        return ([_events(silos, pkg.Sensor, k) for k in range(64)],
                _misplaced(pkg, silos, pkg.Sensor, range(64)),
                [_rows(s.vector.table(pkg.Sensor)) for s in silos])
    return await _run(silos, fabric, pkg, body)


async def test_multi_silo_bulk_delivery_respects_ring_ownership():
    (events, misplaced, _), _ = await _parity(_multi_silo_bulk)
    assert events == [1] * 64 and misplaced == 0


# ---------------------------------------------------------------------------
# tests/test_device_streams.py: the device-tier provider
# ---------------------------------------------------------------------------

def _device_silos(pkg, n, n_dense=64, n_shards=1, **cfg):
    fabric = pkg.rt.InProcFabric()
    silos = []
    for i in range(n):
        b = (pkg.rt.SiloBuilder().with_name(f"ds{i}").with_fabric(fabric)
             .with_config(response_timeout=5.0, **cfg))
        pkg.add(b, pkg.Feed, mesh=pkg.mesh(n_shards),
                capacity_per_shard=max(64, n_dense),
                dense={pkg.Feed: n_dense})
        pkg.st.add_device_streams(b, "device")
        silos.append(b.build())
    return fabric, silos


async def _publish(pkg, n_shards):
    fabric, silos = _device_silos(pkg, 1, n_dense=32, n_shards=n_shards)

    async def body(silos, client):
        silo = silos[0]
        provider = silo.stream_providers["device"]
        sub = await provider.subscribe_keys("ticks", pkg.Feed, np.arange(32))
        stream = pkg.st.StreamId("device", "ticks", "c1")
        toks = [sub.live,
                await provider.produce(stream, [{"v": np.float32(0.0)},
                                                {"v": np.float32(1.0)}]),
                await provider.produce(stream, [{"v": np.float32(2.0)}])]
        tbl = silo.vector.table(pkg.Feed)
        assert await _poll(lambda: tbl.dense_active[31]
                           and int(tbl.read_row(31)["events"]) == 3)
        return (toks, _rows(tbl), silo.stats.get("streams.device.delivered"),
                provider.stream_delivery_group(), provider.stream_backlog())
    return await _run(silos, fabric, pkg, body)


@pytest.mark.parametrize("n_shards", [1, 8])
async def test_publish_fans_out_through_bulk_path(n_shards):
    """At 8 shards every delivery chunk goes through ``route`` (K2's
    plain version here)."""
    (toks, rows, delivered, group, backlog), _ = await _parity(
        _publish, n_shards)
    assert toks == [True, 0, 2]  # live at once; item-cumulative tokens
    assert delivered == 3 * 32 and group >= 32 and backlog >= 0
    per = 32 // n_shards
    events = rows["events"][:, :per].reshape(-1)
    assert (events == 3).all() and (rows["ok"][:, :per] == 1).all()
    assert (rows["total"][:, :per] == 3.0).all()


async def _rewind(pkg):
    fabric, silos = _device_silos(pkg, 1, n_dense=32)

    async def body(silos, client):
        silo = silos[0]
        provider = silo.stream_providers["device"]
        await provider.subscribe_keys("feed", pkg.Feed, np.arange(0, 8))
        # armed before the backlog exists: token 6 lands mid-batch 2
        rew = await provider.subscribe_keys("feed", pkg.Feed,
                                            np.arange(8, 16), from_token=6)
        out = [rew.live]
        stream = pkg.st.StreamId("device", "feed", "s")
        for base in (0, 4, 8):
            await provider.produce(stream, [
                {"v": np.float32(base + i)} for i in range(4)])
        tbl = silo.vector.table(pkg.Feed)
        assert await _poll(lambda: tbl.dense_active[8]
                           and int(tbl.read_row(8)["events"]) == 6)
        out.append(_rows(tbl))
        assert await _poll(lambda: rew.live)
        await provider.produce(stream, [{"v": np.float32(50.0)}])
        assert await _poll(lambda: int(tbl.read_row(15)["events"]) == 7)
        out.append(_rows(tbl))
        return out
    return await _run(silos, fabric, pkg, body)


async def test_rewind_replays_exactly_from_token():
    (was_live, mid, end), _ = await _parity(_rewind)
    assert not was_live
    assert (mid["events"][0, :8] == 12).all()
    assert (mid["total"][0, :8] == sum(range(12))).all()
    assert (mid["events"][0, 8:16] == 6).all()  # tokens 6..11 exactly
    assert (mid["total"][0, 8:16] == sum(range(6, 12))).all()
    assert (mid["ok"][0, :16] == 1).all()
    assert (end["events"][0, :8] == 13).all()
    assert (end["events"][0, 8:16] == 7).all()


async def _grow_and_migrate(pkg, n_shards):
    fabric, silos = _device_silos(pkg, 1, n_dense=32, n_shards=n_shards)

    async def body(silos, client):
        silo = silos[0]
        rt = silo.vector
        tbl = rt.table(pkg.Feed)
        hashed = [10**12 + i * 104729 for i in range(6)]
        for k in hashed:
            rt.call(pkg.Feed, k, "on_next", v=np.float32(0.0))
        await rt.flush()
        provider = silo.stream_providers["device"]
        await provider.subscribe_keys("race", pkg.Feed, np.arange(32))
        stream = pkg.st.StreamId("device", "race", "r")
        moved = None
        for t in range(24):
            await provider.produce(stream, [{"v": np.float32(t + 1)}])
            if t == 6:
                tbl.grow(tbl.capacity * 2)  # fenced growth mid-storm
            if t == 12:
                dests = [(tbl.key_to_slot[k][0] + 1) % tbl.n_shards
                         for k in hashed]
                moved = tbl.move_rows(hashed, dests)  # fenced migration
            await asyncio.sleep(0)
        assert await _poll(
            lambda: int(tbl.read_row(31)["events"]) == 24, 10.0)
        return (moved, _rows(tbl), dict(tbl.key_to_slot),
                [tbl.read_row(k) for k in hashed])
    return await _run(silos, fabric, pkg, body)


@pytest.mark.parametrize("n_shards", [1, 4])
async def test_order_preserved_across_grow_and_migration_racing_delivery(
        n_shards):
    """Growth and a live row migration land between delivery rounds;
    every consumer still hears its events in token order. At 4 shards
    the migration really moves the six hashed rows (at 1 shard every
    destination is the source, so ``move_rows`` skips them all)."""
    (moved, rows, slots, hashed_rows), _ = await _parity(
        _grow_and_migrate, n_shards)
    assert moved == (0 if n_shards == 1 else 6)
    per = 32 // n_shards
    assert (rows["events"][:, :per] == 24).all()
    assert (rows["ok"][:, :per] == 1).all()
    assert (rows["last"][:, :per] == 24.0).all()
    assert all(int(r["events"]) == 1 for r in hashed_rows)


async def _lever(pkg, device_fanout):
    fabric = pkg.rt.InProcFabric()
    b = (pkg.rt.SiloBuilder().with_name("lv").with_fabric(fabric)
         .with_config(response_timeout=5.0,
                      stream_device_fanout=device_fanout))
    pkg.add(b, pkg.Lever, mesh=pkg.mesh(1), capacity_per_shard=64,
            dense={pkg.Lever: 32})
    pkg.st.add_persistent_streams(b, "queue", pkg.st.MemoryQueueAdapter(1),
                                  pull_period=0.02)

    async def body(silos, client):
        silo = silos[0]
        await silo.stream_providers["queue"].produce(
            pkg.st.StreamId("queue", "lever", "s"), [
                {"keys": np.arange(32),
                 "args": {"v": np.arange(32, dtype=np.float32)}},
                {"keys": np.arange(32), "args": {"v": np.ones(32, np.float32)}}])
        tbl = silo.vector.table(pkg.Lever)
        assert await _poll(lambda: tbl.dense_active[31]
                           and int(tbl.read_row(31)["events"]) == 2)
        return _rows(tbl), getattr(silo.vector, "last_stream_group", 0) > 0
    return await _run([b.build()], fabric, pkg, body)


async def test_device_fanout_lever_off_is_bit_for_bit():
    (on_rows, on_device), _ = await _parity(_lever, True)
    (off_rows, off_device), _ = await _parity(_lever, False)
    assert on_device and not off_device  # the lever switched
    _same(on_rows, off_rows, "lever")    # byte-identical either way


async def _debug_pool(pkg):
    fabric, silos = _device_silos(pkg, 2, n_dense=64)
    pkg.msg.set_debug_pool(True)

    async def body(silos, client):
        provider = silos[0].stream_providers["device"]
        await provider.subscribe_keys("pool", pkg.Feed, np.arange(64))
        stream = pkg.st.StreamId("device", "pool", "p")
        for t in range(3):
            await provider.produce(stream, [{"v": np.float32(t)}])
        assert await _poll(lambda: all(
            _events(silos, pkg.Feed, k) == 3 for k in range(64)), 10.0)
        return ([_events(silos, pkg.Feed, k) for k in range(64)],
                _misplaced(pkg, silos, pkg.Feed, range(64)))
    try:
        return await _run(silos, fabric, pkg, body)
    finally:
        pkg.msg.set_debug_pool(False)


async def test_debug_pool_full_publish_broadcast_consume_path():
    """The debug pool through publish → peer ``__stream_deliver__`` →
    broadcast → consumer; each row lives on its ring owner."""
    (events, misplaced), _ = await _parity(_debug_pool)
    assert events == [3] * 64 and misplaced == 0


async def _qos(pkg):
    fabric, silos = _device_silos(pkg, 2, n_dense=64)
    seen = []
    real_deliver, real_group = fabric.deliver, fabric.deliver_group

    def spy_deliver(msg):
        seen.append((msg.category, msg.method_name))
        return real_deliver(msg)

    def spy_group(target, msgs):
        for m in msgs:
            seen.append((m.category, m.method_name))
        return real_group(target, msgs)

    fabric.deliver, fabric.deliver_group = spy_deliver, spy_group

    async def body(silos, client):
        provider = silos[0].stream_providers["device"]
        await provider.subscribe_keys("qos", pkg.Feed, np.arange(64))
        await provider.produce(pkg.st.StreamId("device", "qos", "q"),
                               [{"v": np.float32(1.0)}])
        assert await _poll(lambda: all(
            _events(silos, pkg.Feed, k) == 1 for k in range(64)), 10.0)
        app = pkg.msg.Category.APPLICATION
        deliveries = [cat == app for cat, m in seen
                      if m == "__stream_deliver__"]
        protected = [m for cat, m in seen
                     if cat in (pkg.msg.Category.PING,
                                pkg.msg.Category.SYSTEM)
                     and "stream" in str(m)]
        return len(deliveries), all(deliveries), protected
    return await _run(silos, fabric, pkg, body)


async def test_stream_delivery_rides_application_category_only():
    (n, all_app, protected), _ = await _parity(_qos)
    assert n >= 1 and all_app and protected == []


async def _join_server(pkg):
    fabric, silos = _device_silos(pkg, 1, n_dense=16)

    async def body(silos, client):
        silo = silos[0]
        provider = silo.stream_providers["device"]
        await provider.subscribe_keys("join", pkg.Feed, np.arange(16))
        stream = pkg.st.StreamId("device", "join", "j")
        with pytest.raises(asyncio.TimeoutError):
            await client.join_when(pkg.Feed, list(range(16)),
                                   method="ready", timeout=0.4)
        watches = silo.stats.get("vector.join.watches") >= 1
        base = silo.stats.get("messaging.received.application")
        task = asyncio.ensure_future(client.join_when(
            pkg.Feed, list(range(16)), method="ready", timeout=10.0))
        await asyncio.sleep(0.1)
        for t in range(3):
            await provider.produce(stream, [{"v": np.float32(t)}])
        got = await asyncio.wait_for(task, 10.0)
        envelopes = silo.stats.get("messaging.received.application") - base
        return watches, got, envelopes <= 3
    return await _run(silos, fabric, pkg, body)


async def test_join_when_server_armed_watch():
    (watches, got, few), _ = await _parity(_join_server)
    assert watches and got == 16 and few


async def _join_client(pkg):
    fabric, silos = _device_silos(pkg, 1, n_dense=8)

    async def body(silos, client):
        provider = silos[0].stream_providers["device"]
        await provider.subscribe_keys("joinc", pkg.Feed, np.arange(8))
        stream = pkg.st.StreamId("device", "joinc", "j")
        for t in range(3):
            await provider.produce(stream, [{"v": np.float32(t)}])
        return await client.join_when(pkg.Feed, list(range(8)),
                                      method="ready", timeout=5.0,
                                      server=False)
    return await _run(silos, fabric, pkg, body)


async def test_join_when_client_loop_still_available():
    got, _ = await _parity(_join_client)
    assert got == 8


# ---------------------------------------------------------------------------
# tests/test_stream_balancers.py: balancers and the pooled cache
# ---------------------------------------------------------------------------

def _silo_addrs(pkg, n):
    return [pkg.ids.SiloAddress("10.0.0.%d" % i, 5000, i + 1)
            for i in range(n)]


async def _deployment_cover(pkg):
    silos = _silo_addrs(pkg, 3)
    b = pkg.st.DeploymentBasedBalancer()
    return [sorted(await b.owned_queues(16, "q", s, silos)) for s in silos]


async def test_deployment_balancer_covers_all_queues_exactly_once():
    owned, _ = await _parity(_deployment_cover)
    assert sorted(q for o in owned for q in o) == list(range(16))


async def _deployment_churn(pkg):
    silos = _silo_addrs(pkg, 4)
    b = pkg.st.DeploymentBasedBalancer()
    before = [await b.owned_queues(32, "q", s, silos) for s in silos]
    after = [await b.owned_queues(32, "q", s, silos[:3]) for s in silos[:3]]
    return [sorted(o) for o in before], [sorted(o) for o in after]


async def test_deployment_balancer_minimal_churn_on_leave():
    (before, after), _ = await _parity(_deployment_churn)
    for b, a in zip(before, after):
        assert set(b) <= set(a)  # survivors keep what they had
    assert sorted(q for o in after for q in o) == list(range(32))


async def _best_fit(pkg):
    silos = _silo_addrs(pkg, 3)
    b = pkg.st.BestFitBalancer()
    return [sorted(await b.owned_queues(8, "q", s, silos)) for s in silos]


async def test_best_fit_balancer_even_counts():
    owned, _ = await _parity(_best_fit)
    assert sorted(len(o) for o in owned) == [2, 3, 3]


async def _lease_failover(pkg):
    provider = pkg.st.MemoryLeaseProvider()
    silos = _silo_addrs(pkg, 2)
    b1 = pkg.st.LeaseBasedBalancer(provider, ttl=0.2)
    b2 = pkg.st.LeaseBasedBalancer(provider, ttl=0.2)
    o1 = await b1.owned_queues(8, "q", silos[0], silos)
    o2 = await b2.owned_queues(8, "q", silos[1], silos)
    await asyncio.sleep(0.25)  # silo 1 stops renewing: its leases expire
    o2b = await b2.owned_queues(8, "q", silos[1], [silos[1]])
    return sorted(o1), sorted(o2), sorted(o2b)


async def test_lease_balancer_acquires_fair_share_and_fails_over():
    (o1, o2, o2b), _ = await _parity(_lease_failover)
    assert len(o1) == 4 and len(o2) == 4 and not set(o1) & set(o2)
    assert o2b == list(range(8))


async def _lease_shed(pkg):
    provider = pkg.st.MemoryLeaseProvider()
    silos = _silo_addrs(pkg, 2)
    b1 = pkg.st.LeaseBasedBalancer(provider, ttl=5.0)
    alone = await b1.owned_queues(8, "q", silos[0], [silos[0]])
    mine = await b1.owned_queues(8, "q", silos[0], silos)
    b2 = pkg.st.LeaseBasedBalancer(provider, ttl=5.0)
    theirs = await b2.owned_queues(8, "q", silos[1], silos)
    return sorted(alone), sorted(mine), sorted(theirs)


async def test_lease_balancer_sheds_excess_when_silo_joins():
    (alone, mine, theirs), _ = await _parity(_lease_shed)
    assert alone == list(range(8)) and len(mine) == 4
    assert len(theirs) == 4 and not set(mine) & set(theirs)


async def _receiver_shutdown(pkg):
    adapter = pkg.st.MemoryQueueAdapter(n_queues=1)
    sid = pkg.st.StreamId("mem", "ns", "s")
    for i in range(5):
        await adapter.queue_message_batch(0, sid, [i])
    r1 = adapter.create_receiver(0)
    got = await r1.get_messages(5)
    await r1.ack(got[0])
    await r1.ack(got[1])
    r1.shutdown()  # the owner dies with 3 batches unacked
    again = await adapter.create_receiver(0).get_messages(10)
    return [b.items[0] for b in got], [(b.items[0], b.seq) for b in again]


async def test_receiver_shutdown_requeues_unacked_batches():
    (got, again), _ = await _parity(_receiver_shutdown)
    assert got == [0, 1, 2, 3, 4] and [i for i, _ in again] == [2, 3, 4]


def _batch(pkg, stream_name, seq):
    return pkg.st.QueueBatch(pkg.st.StreamId("mem", "ns", stream_name),
                             [seq], seq)


def _cursors(pkg):
    c = pkg.st.PooledQueueCache(capacity=16)
    c.resolved_streams.add(pkg.st.StreamId("mem", "ns", "a"))
    for i in range(4):
        c.add(_batch(pkg, "a", i))
    fast, slow = c.new_cursor("fast"), c.new_cursor("slow")
    out = [[c.next(fast).batch.seq for _ in range(4)], c.next(fast),
           [b.seq for b in c.purge()]]
    out.append([c.next(slow).batch.seq for _ in range(4)])
    out.append([b.seq for b in c.purge()])
    out.append(c.count)
    return out


def test_cache_cursors_are_independent():
    j, t = _cursors(J), _cursors(T)
    _same(j, t)
    assert t == [[0, 1, 2, 3], None, [], [0, 1, 2, 3], [0, 1, 2, 3], 0]


def _pressure(pkg):
    c = pkg.st.PooledQueueCache(capacity=4, pressure_threshold=0.75)
    out = [c.under_pressure]
    for i in range(3):
        c.add(_batch(pkg, "a", i))
    out += [c.under_pressure, len(c.purge())]  # unresolved: pinned
    c.resolved_streams.add(pkg.st.StreamId("mem", "ns", "a"))
    out += [len(c.purge()), c.under_pressure]
    return out


def test_cache_pressure_and_purge_without_cursors():
    j, t = _pressure(J), _pressure(T)
    assert j == t == [False, True, 0, 3, False]


async def _slow_fast(pkg):
    fabric = pkg.rt.InProcFabric()
    h = pkg.host
    b = (pkg.rt.SiloBuilder().with_name("sb").with_fabric(fabric)
         .add_grains(*h.all).with_storage("Default",
                                          pkg.storage.MemoryStorage()))
    pkg.st.add_persistent_streams(b, "q", pkg.st.MemoryQueueAdapter(2),
                                  pull_period=0.02)

    async def body(silos, client):
        await client.get_grain(h.Slow, 1).join("q", "ns", "s")
        await client.get_grain(h.Consumer, 2).join("q", "ns", "s")
        await client.get_grain(h.Producer, 3).publish_batch(
            "q", "ns", "s", list(range(10)))
        assert await _poll(lambda: len(RECEIVED.get((2, "explicit"), []))
                           >= 10, 5.0)
        slow_at_fast_done = len(RECEIVED.get(("slow", "explicit"), []))
        assert await _poll(lambda: len(RECEIVED.get(("slow", "explicit"),
                                                    [])) >= 10, 5.0)
        return (slow_at_fast_done < 10, RECEIVED[(2, "explicit")],
                RECEIVED[("slow", "explicit")])
    return await _run([b.build()], fabric, pkg, body)


async def test_slow_consumer_does_not_block_fast_consumer():
    """Independent cursor pumps: the fast consumer finishes while the
    slow one (50 ms an event) is still behind; both keep order."""
    (not_gated, fast, slow), _ = await _parity(_slow_fast)
    assert not_gated and fast == slow == list(range(10))


def _late_cursor(pkg):
    c = pkg.st.PooledQueueCache(capacity=16)
    for i in range(3):
        c.add(_batch(pkg, "a", i))
    old = c.new_cursor("old", from_oldest=True)
    new = c.new_cursor("new", from_oldest=False)
    out = [c.next(old).batch.seq, c.next(new)]
    c.add(_batch(pkg, "a", 3))
    out.append(c.next(new).batch.seq)
    return out


def test_cache_late_cursor_starts_at_oldest_or_latest():
    assert _late_cursor(J) == _late_cursor(T) == [0, None, 3]


# ---------------------------------------------------------------------------
# tests/test_streams.py: SMS and persistent providers, host consumers
# ---------------------------------------------------------------------------

def _host_silos(pkg, n):
    fabric = pkg.rt.InProcFabric()
    storage = pkg.storage.MemoryStorage()
    adapter = pkg.st.MemoryQueueAdapter(n_queues=4)
    silos = []
    for i in range(n):
        b = (pkg.rt.SiloBuilder().with_name(f"st{i}").with_fabric(fabric)
             .add_grains(*pkg.host.all).with_storage("Default", storage)
             .with_config(response_timeout=2.0))
        pkg.st.add_sms_streams(b, "sms")
        pkg.st.add_persistent_streams(b, "queue", adapter, pull_period=0.05)
        b.configure(lambda s: setattr(
            s.stream_providers["queue"], "failure_handler",
            lambda h, st, batch, exc: FAILURES.append(str(exc))))
        silos.append(b.build())
    return fabric, silos


async def _wait_received(key, count, timeout=8.0):
    assert await _poll(lambda: len(RECEIVED.get(key, [])) >= count,
                       timeout), (key, RECEIVED.get(key))
    return list(RECEIVED[key])


async def _host(pkg, n, body):
    fabric, silos = _host_silos(pkg, n)
    return await _run(silos, fabric, pkg, body)


async def _sms_roundtrip(pkg):
    async def body(silos, client):
        h = pkg.host
        consumer = client.get_grain(h.Consumer, 1)
        await consumer.join("sms", "chat", "room1")
        producer = client.get_grain(h.Producer, 1)
        await producer.publish("sms", "chat", "room1", "hello")
        await producer.publish_batch("sms", "chat", "room1", ["a", "b"])
        got = await _wait_received((1, "explicit"), 3)
        await consumer.leave("sms", "chat", "room1")
        await producer.publish("sms", "chat", "room1", "after")
        await asyncio.sleep(0.2)
        return got, list(RECEIVED[(1, "explicit")])
    return await _host(pkg, 1, body)


async def test_sms_explicit_pubsub_roundtrip():
    (got, after), _ = await _parity(_sms_roundtrip)
    assert got == after == ["hello", "a", "b"]


async def _sms_fan_out(pkg):
    async def body(silos, client):
        h = pkg.host
        for k in (10, 11, 12):
            await client.get_grain(h.Consumer, k).join("sms", "chat", "r")
        await client.get_grain(h.Producer, 2).publish("sms", "chat", "r", "x")
        return [await _wait_received((k, "explicit"), 1)
                for k in (10, 11, 12)]
    return await _host(pkg, 2, body)


async def test_sms_multiple_consumers_fan_out():
    got, _ = await _parity(_sms_fan_out)
    assert got == [["x"]] * 3


async def _implicit(pkg):
    async def body(silos, client):
        await client.get_grain(pkg.host.Producer, 3).publish(
            "sms", "telemetry", "device-7", {"t": 1})
        return await _wait_received(("device-7", "implicit"), 1)
    return await _host(pkg, 1, body)


async def test_implicit_subscription_receives_by_stream_key():
    got, _ = await _parity(_implicit)
    assert got == [{"t": 1}]


async def _persistent_delivers(pkg):
    async def body(silos, client):
        h = pkg.host
        await client.get_grain(h.Consumer, 20).join("queue", "gps", "car1")
        producer = client.get_grain(h.Producer, 4)
        for i in range(5):
            await producer.publish("queue", "gps", "car1", i)
        return await _wait_received((20, "explicit"), 5)
    return await _host(pkg, 2, body)


async def test_persistent_stream_delivers_through_queue():
    got, _ = await _parity(_persistent_delivers)
    assert got == [0, 1, 2, 3, 4]  # per-stream order kept


async def _delivery_failure(pkg):
    async def body(silos, client):
        h = pkg.host
        await client.get_grain(h.Flaky, 40).join("queue", "gps", "f")
        await client.get_grain(h.Producer, 6).publish("queue", "gps", "f", 1)
        assert await _poll(lambda: FAILURES, 8.0), "handler never invoked"
        return (FAILURES[0],
                silos[0].stats.get("streams.persistent.delivery_failures"))
    return await _host(pkg, 1, body)


async def test_persistent_delivery_failure_invokes_handler():
    (exc, failures), _ = await _parity(_delivery_failure)
    assert "permanently broken" in exc and failures == 1


async def _batch_consumer(pkg):
    async def body(silos, client):
        h = pkg.host
        await client.get_grain(h.Batch, "k").join("queue", "ns", "k")
        p = client.get_grain(h.Producer, "p")
        await p.publish_batch("queue", "ns", "k", ["a", "b", "c"])
        await p.publish_batch("queue", "ns", "k", ["d", "e"])
        return await _wait_received(("k", "batch"), 2)
    return await _host(pkg, 1, body)


async def test_batch_consumer_receives_whole_batches():
    got, _ = await _parity(_batch_consumer)
    assert [x for items, _ in got for x in items] == ["a", "b", "c", "d", "e"]
    tokens = [t for _, t in got]
    assert tokens == sorted(set(tokens))  # one call a batch, increasing


def _unresolved_purge(pkg):
    class B:
        def __init__(self, stream):
            self.stream = stream
            self.items = [1]

    cache = pkg.cache.PooledQueueCache(capacity=8)
    cache.add(B("s1"))
    cache.add(B("s2"))
    out = [cache.purge(), cache.count]
    cache.resolved_streams.add("s1")
    out += [[b.stream for b in cache.purge()], cache.count]
    cache.resolved_streams.add("s2")
    cur = cache.new_cursor("c1", from_oldest=True)
    out += [cache.purge(), cache.next(cur) is not None,
            [b.stream for b in cache.purge()], cache.count]
    return out


def test_cache_purge_retains_unresolved_streams():
    assert _unresolved_purge(J) == _unresolved_purge(T) == \
        [[], 2, ["s1"], 1, [], True, ["s2"], 0]


async def _rewind_token(pkg):
    async def body(silos, client):
        h = pkg.host
        p = client.get_grain(h.Producer, "p")
        # two batches of 3: item tokens 0-2 and 3-5 (item-cumulative)
        await p.publish_batch("queue", "ns", "k", ["a", "b", "c"])
        await p.publish_batch("queue", "ns", "k", ["d", "e", "f"])
        await asyncio.sleep(0.15)  # cached, pinned (no consumer yet)
        await client.get_grain(h.Consumer, "late").join_from(
            "queue", "ns", "k", 2)
        return await _wait_received(("late", "token"), 4)
    return await _host(pkg, 1, body)


async def test_rewindable_subscription_from_token():
    got, _ = await _parity(_rewind_token)
    assert got == [("c", 2), ("d", 3), ("e", 4), ("f", 5)]


async def _sms_rewind(pkg):
    async def body(silos, client):
        return await client.get_grain(pkg.host.Consumer, "c").try_rewind(
            "sms", "ns", "s")
    return await _host(pkg, 1, body)


async def test_sms_rejects_rewind():
    got, _ = await _parity(_sms_rewind)
    assert got == "rejected"


async def _generator(pkg):
    def generate(queue_id, poll):
        if poll >= 3:
            return None  # 3 batches a queue, then dry
        sid = pkg.st.StreamId("gen", "load", f"q{queue_id}")
        return sid, [f"q{queue_id}-b{poll}-i{j}" for j in range(4)]

    fabric = pkg.rt.InProcFabric()
    b = (pkg.rt.SiloBuilder().with_name("gen").with_fabric(fabric)
         .add_grains(*pkg.host.all))
    pkg.st.add_persistent_streams(
        b, "gen", pkg.st.GeneratorQueueAdapter(generate, n_queues=2),
        pull_period=0.01)

    async def body(silos, client):
        for q in ("q0", "q1"):
            await client.get_grain(pkg.host.Consumer, q).join(
                "gen", "load", q)
        out = [await _wait_received(("q0", "explicit"), 12),
               await _wait_received(("q1", "explicit"), 12)]
        stream = silos[0].stream_providers["gen"].get_stream("load", "q0")
        with pytest.raises(pkg.err.StreamError):
            await stream.on_next("x")
        return out
    return await _run([b.build()], fabric, pkg, body)


async def test_generator_adapter_synthesizes_streams():
    (q0, q1), _ = await _parity(_generator)
    assert q0 == [f"q0-b{p}-i{j}" for p in range(3) for j in range(4)]
    assert q1 == [f"q1-b{p}-i{j}" for p in range(3) for j in range(4)]


async def _signals(pkg, provider, key):
    async def body(silos, client):
        h = pkg.host
        await client.get_grain(h.Signal, key).join(provider, "sig", "s")
        p = client.get_grain(h.Producer, 1)
        if provider == "sms":
            await p.publish(provider, "sig", "s", "a")
            await p.publish_error(provider, "sig", "s", "boom")
            await p.publish(provider, "sig", "s", "b")
        else:
            await p.publish_batch(provider, "sig", "s", ["x", "y"])
            await p.publish_error(provider, "sig", "s", "kaput")
        await p.publish_completed(provider, "sig", "s")
        return await _wait_received((key, "signal"), 4)
    return await _host(pkg, 1, body)


async def test_sms_on_error_and_completed_signals():
    got, _ = await _parity(_signals, "sms", 7)
    # signals take sequence tokens like items: a=0, error=1, b=2, done=3
    assert got == ["a", ("error", "boom", 1), "b", ("completed", 3)]


async def test_persistent_on_error_and_completed_signals():
    got, _ = await _parity(_signals, "queue", 9)
    assert got[:2] == ["x", "y"] and got[2][:2] == ("error", "kaput")
    assert got[3] == ("completed", 3)


async def _signals_skip(pkg):
    async def body(silos, client):
        await client.get_grain(pkg.host.Consumer, 3).join("sms", "sig", "s3")
        p = client.get_grain(pkg.host.Producer, 1)
        await p.publish("sms", "sig", "s3", "before")
        await p.publish_error("sms", "sig", "s3", "ignored")
        await p.publish("sms", "sig", "s3", "after")
        got = await _wait_received((3, "explicit"), 2)
        return got, silos[0].stats.get("streams.signals.error_unhandled")
    return await _host(pkg, 1, body)


async def test_signals_skip_consumers_without_handlers():
    (got, unhandled), _ = await _parity(_signals_skip)
    assert got == ["before", "after"] and unhandled >= 1


async def _signal_as_data(pkg):
    async def body(silos, client):
        stream = silos[0].stream_providers["sms"].get_stream("sig", "s4")
        out = []
        for bad in (stream.on_next(pkg.st.StreamSignal(kind="error")),
                    stream.on_next_batch(
                        ["ok", pkg.st.StreamSignal(kind="completed")])):
            with pytest.raises(pkg.err.StreamError) as e:
                await bad
            out.append(str(e.value))
        return out
    return await _host(pkg, 1, body)


async def test_stream_signal_rejected_as_data():
    got, _ = await _parity(_signal_as_data)
    assert len(got) == 2


async def _replay_progress(pkg):
    async def body(silos, client):
        consumer = client.get_grain(pkg.host.Consumer, 41)
        await consumer.join("queue", "leak", "s")
        await client.get_grain(pkg.host.Producer, 1).publish(
            "queue", "leak", "s", "x")
        await _wait_received((41, "explicit"), 1)
        provider = silos[0].stream_providers["queue"]
        had = any(k[0].key == "s" for k in provider.replay_progress)
        await consumer.leave("queue", "leak", "s")
        dropped = await _poll(lambda: not any(
            k[0].key == "s" for k in provider.replay_progress), 8.0)
        return had, dropped
    return await _host(pkg, 1, body)


async def test_replay_progress_dropped_on_unsubscribe():
    (had, dropped), _ = await _parity(_replay_progress)
    assert had and dropped


def test_persistent_module_exports_match():
    """The port's stream package exports the reference's names, less the
    durable adapters (file and SQLite queues)."""
    durable = {"DurableQueueAdapter", "FileQueueAdapter",
               "SqliteQueueAdapter"}
    assert set(tst.__all__) == set(jst.__all__) - durable
    assert set(tpers.__all__) == set(jpers.__all__)
    assert set(tcache.__all__) == set(jcache.__all__)
