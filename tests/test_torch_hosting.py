"""Parity of the port's silo hosting (orleans_tpu_torch.dispatch
.add_vector_grains over the port's in-proc host tier) with the JAX
package's, on the CPU.

Each scenario of tests/test_vector_hosting.py that runs in one process
(client call, coalescing, host grain → vector grain, error propagation,
write-behind plus resume, scheduled checkpoints plus whole-silo resume,
non-vector grains unaffected), the client's collectives, and the
Presence drive of samples/presence_torch.py run through a silo of each
package with the same seeded calls; every returned value and the final
table (the sink row left out: padding lanes write there in an undefined
order) must be equal. Tolerance: exact — state and results are integers
or float32 values copied from the inputs.

The two silos of a pair run one after the other, never interleaved on
one loop (each package's silo installs its own eager task factory). Every
async body runs under ``asyncio.wait_for(..., 30)``.
"""

import asyncio
import os
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orleans_tpu.dispatch as jd
import orleans_tpu.parallel as jp
import orleans_tpu.runtime as jr
import orleans_tpu.storage as js
import orleans_tpu_torch.dispatch as td
import orleans_tpu_torch.parallel as tp
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.storage as ts

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "samples"))

import presence_torch  # noqa: E402

TIMEOUT = 30


class JCounterVec(jd.VectorGrain):
    STATE = {"count": (jnp.int32, ()), "last": (jnp.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"count": jnp.int32(0), "last": jnp.float32(0)}

    @jd.actor_method(args={"x": (jnp.float32, ())})
    def add(state, args):
        new = {"count": state["count"] + 1, "last": args["x"]}
        return new, new["count"]

    @jd.actor_method(read_only=True)
    def count(state, args):
        return state, state["count"]

    @jd.actor_method(read_only=True)
    def ready(state, args):
        return state, (state["count"] > 0).astype(jnp.int32)


class TCounterVec(td.VectorGrain):
    STATE = {"count": (torch.int32, ()), "last": (torch.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"count": torch.zeros_like(key_hash),
                "last": key_hash.new_zeros((), dtype=torch.float32)}

    @td.actor_method(args={"x": (torch.float32, ())})
    def add(state, args):
        new = {"count": state["count"] + 1, "last": args["x"]}
        return new, new["count"]

    @td.actor_method(read_only=True)
    def count(state, args):
        return state, state["count"]

    @td.actor_method(read_only=True)
    def ready(state, args):
        return state, (state["count"] > 0).to(torch.int32)


class JHostGrain(jr.Grain):
    """Host-tier grain calling into the device tier (tiers compose)."""

    async def poke_vector(self, key: int, x: float) -> int:
        return int(await self.get_grain(JCounterVec, key).add(x=x))


class THostGrain(tr.Grain):
    async def poke_vector(self, key: int, x: float) -> int:
        return int(await self.get_grain(TCounterVec, key).add(x=x))


class JPlayer(jd.VectorGrain):
    """samples/presence_tpu.py's PlayerVectorGrain with the read-only
    score and readiness methods of samples/presence_torch.py."""

    STATE = {"pos": (jnp.float32, (2,)), "score": (jnp.int32, ()),
             "game": (jnp.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"pos": jnp.zeros(2, jnp.float32), "score": jnp.int32(0),
                "game": key_hash % presence_torch.N_GAMES}

    @jd.actor_method(args={"pos": (jnp.float16, (2,)),
                           "delta": (jnp.int32, ())})
    def heartbeat(state, args):
        new = {"pos": args["pos"].astype(jnp.float32),
               "score": state["score"] + args["delta"],
               "game": state["game"]}
        return new, new["score"]

    @jd.actor_method(args={}, read_only=True)
    def whereis(state, args):
        return state, state["pos"]

    @jd.actor_method(args={}, read_only=True)
    def get_score(state, args):
        return state, state["score"]

    @jd.actor_method(args={}, read_only=True)
    def ready(state, args):
        return state, (state["score"] > 0).astype(jnp.int32)


class JGame(jr.Grain):
    """The JAX twin of presence_torch.GameGrain: the same masked fan-in
    through orleans_tpu.ops.segment_sum."""

    async def summary(self) -> dict:
        from orleans_tpu.ops import segment_sum
        rt = self.runtime.vector
        tbl = rt.table(JPlayer)
        game = int(self.primary_key)
        with rt.tick_fence():
            per, n = tbl.dense_per_shard, tbl.dense_n
            g = tbl.state["game"][:, :per].reshape(-1)[:n]
            score = tbl.state["score"][:, :per].reshape(-1)[:n]
            ids = jnp.where(jnp.asarray(tbl.dense_active), g, -1)
            values = jnp.stack([score, jnp.ones_like(score)], axis=1)
            totals = np.asarray(segment_sum(values, ids,
                                            presence_torch.N_GAMES))[game]
        return {"game": game, "total_score": int(totals[0]),
                "players": int(totals[1])}


# one grain name per pair: the name is part of every hashed key's GrainId
for _name, _pair in {"CounterVec": (JCounterVec, TCounterVec),
                     "HostGrain": (JHostGrain, THostGrain),
                     "PlayerVectorGrain": (JPlayer,
                                           presence_torch.PlayerVectorGrain),
                     "GameGrain": (JGame, presence_torch.GameGrain)}.items():
    for _cls in _pair:
        _cls.__name__ = _cls.__qualname__ = _name

J = SimpleNamespace(
    name="jax", rt=jr, add=jd.add_vector_grains, storage=js,
    mesh=lambda n: jp.make_mesh(n), Counter=JCounterVec, Host=JHostGrain,
    Player=JPlayer, Game=JGame)
T = SimpleNamespace(
    name="torch", rt=tr, add=td.add_vector_grains, storage=ts,
    mesh=lambda n: tp.make_mesh(n, device="cpu"), Counter=TCounterVec,
    Host=THostGrain, Player=presence_torch.PlayerVectorGrain,
    Game=presence_torch.GameGrain)


def _build(pkg, name="two-tier", n_shards=8, **kw):
    b = pkg.rt.SiloBuilder().with_name(name).add_grains(pkg.Host)
    pkg.add(b, pkg.Counter, mesh=pkg.mesh(n_shards), capacity_per_shard=32,
            **kw)
    return b.build()


def _rows(snap: dict) -> dict:
    """A table snapshot without its sink row."""
    return {k: v[:, :-1] for k, v in snap.items()}


def _same(a, b, label="") -> None:
    """Equal nested values: dicts, sequences, arrays and scalars, with
    equal dtypes where both sides are numpy values."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), label
        for k in a:
            _same(a[k], b[k], f"{label}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), label
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{label}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, \
            (label, x.dtype, y.dtype, x.shape, y.shape)
        assert np.array_equal(x, y), (label, x, y)


async def _hosted(pkg, body, build=None):
    """Start a silo (``build(pkg)``, default :func:`_build`) and a client,
    run ``body(silo, client)``, stop both."""
    silo = (build or _build)(pkg)
    await silo.start()
    client = await pkg.rt.ClusterClient(silo.fabric).connect()
    try:
        return await body(pkg, silo, client)
    finally:
        await client.close_async()
        await silo.stop()


async def _parity(scenario, *args):
    """``scenario(pkg, *args)`` through the JAX package, then the port;
    returns both results after checking them equal."""
    got = []
    for pkg in (J, T):
        got.append(await asyncio.wait_for(scenario(pkg, *args), TIMEOUT))
    _same(got[0], got[1], scenario.__name__)
    return got


# ---------------------------------------------------------------------------
# the in-proc scenarios of tests/test_vector_hosting.py
# ---------------------------------------------------------------------------

async def _client_call(pkg):
    async def body(pkg, silo, client):
        g = client.get_grain(pkg.Counter, 5)
        out = [await g.add(x=1.5), await g.add(x=2.5)]
        row = silo.vector.table(pkg.Counter).read_row(5)
        return out, row, _rows(silo.vector.table(pkg.Counter).snapshot())
    return await _hosted(pkg, body)


async def test_client_calls_vector_grain_through_silo():
    (out, row, _), _ = await _parity(_client_call)
    assert [int(v) for v in out] == [1, 2] and float(row["last"]) == 2.5


async def _coalesce(pkg, n=64):
    async def body(pkg, silo, client):
        t0 = silo.vector.ticks
        out = await asyncio.gather(*(
            client.get_grain(pkg.Counter, k).add(x=float(k))
            for k in range(n)))
        assert silo.vector.ticks - t0 < n / 4
        assert silo.vector.messages_processed >= n
        return out, _rows(silo.vector.table(pkg.Counter).snapshot())
    return await _hosted(pkg, body)


async def test_concurrent_calls_coalesce_into_ticks():
    (out, _), _ = await _parity(_coalesce)
    assert [int(v) for v in out] == [1] * 64


async def _host_to_vector(pkg):
    async def body(pkg, silo, client):
        h = client.get_grain(pkg.Host, 0)
        out = [await h.poke_vector(9, 3.0), await h.poke_vector(9, 4.0)]
        return out, _rows(silo.vector.table(pkg.Counter).snapshot())
    return await _hosted(pkg, body)


async def test_host_grain_calls_vector_grain():
    (out, _), _ = await _parity(_host_to_vector)
    assert out == [1, 2]


async def _errors(pkg):
    async def body(pkg, silo, client):
        g = client.get_grain(pkg.Counter, 1)
        out = []
        with pytest.raises(Exception, match="keyword") as e:
            await g.add(1.0)  # positional
        out.append(type(e.value).__name__)
        with pytest.raises(Exception, match="args mismatch|unexpected") as e:
            await g.add(bogus=1.0)
        out.append(type(e.value).__name__)
        out.append(await g.add(x=1.0))  # the key still serves
        return out
    return await _hosted(pkg, body)


async def test_vector_errors_propagate_to_caller():
    out, _ = await _parity(_errors)
    assert int(out[-1]) == 1


async def _write_behind(pkg):
    storage = pkg.storage.MemoryStorage()

    def build(pkg):
        return _build(pkg, "wb", storage=storage, flush_period=0.05)

    async def first(pkg, silo, client):
        out = [await client.get_grain(pkg.Counter, k).add(x=float(k))
               for k in (3, 4)]
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 5.0
        while silo.stats.get("vector.storage.flushed") < 2 and \
                loop.time() < deadline:
            await asyncio.sleep(0.05)
        assert silo.stats.get("vector.storage.flushed") >= 2
        return out

    async def second(pkg, silo, client):
        loaded = await silo.vector_bridges[pkg.Counter].load([3, 4, 99])
        out = await client.get_grain(pkg.Counter, 3).add(x=9.0)
        return (sorted(loaded), out,
                _rows(silo.vector.table(pkg.Counter).snapshot()))

    out1 = await _hosted(pkg, first, build)
    out2 = await _hosted(pkg, second, build)
    # what the first silo's final drain stored, as values
    stored = {}
    for k in (3, 4):
        stored[k], _ = await storage.read(
            "CounterVec", _grain_id(pkg, "CounterVec", k))
    return out1, out2, stored


def _grain_id(pkg, name, key):
    ids = (sys.modules["orleans_tpu.core.ids"] if pkg is J
           else sys.modules["orleans_tpu_torch.core.ids"])
    return ids.GrainId.for_grain(ids.GrainType.of(name), key)


async def test_write_behind_persistence_and_resume():
    (out1, (loaded, out, _), stored), _ = await _parity(_write_behind)
    assert loaded == [3, 4] and int(out) == 2
    assert int(stored[4]["count"]) == 1 and float(stored[4]["last"]) == 4.0


async def _checkpoints(pkg, root):
    directory = os.path.join(root, pkg.name)

    def build(pkg):
        return _build(pkg, "ckpt", checkpoint_dir=directory,
                      checkpoint_period=0.1)

    async def first(pkg, silo, client):
        out = [await client.get_grain(pkg.Counter, 8).add(x=1.0)
               for _ in range(3)]
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 5.0
        while silo.stats.get("vector.checkpoints") < 1:
            assert loop.time() < deadline, "no scheduled checkpoint"
            await asyncio.sleep(0.05)
        return out, _rows(silo.vector.table(pkg.Counter).snapshot())

    async def second(pkg, silo, client):
        restored = _rows(silo.vector.table(pkg.Counter).snapshot())
        out = await client.get_grain(pkg.Counter, 8).add(x=2.0)
        return restored, out

    out, before = await _hosted(pkg, first, build)
    restored, after = await _hosted(pkg, second, build)
    _same(before, restored, f"{pkg.name} restore")
    return out, before, after


async def test_scheduled_checkpoints_and_whole_silo_resume(tmp_path):
    (out, _, after), _ = await _parity(_checkpoints, str(tmp_path))
    assert [int(v) for v in out] == [1, 2, 3] and int(after) == 4


async def _non_vector(pkg):
    async def body(pkg, silo, client):
        before = silo.catalog.activation_count()
        await client.get_grain(pkg.Counter, 2).add(x=0.0)
        after = silo.catalog.activation_count()
        await client.get_grain(pkg.Host, 1).poke_vector(2, 1.0)
        return before, after, silo.catalog.activation_count()
    return await _hosted(pkg, body)


async def test_non_vector_grains_unaffected():
    (before, after, with_host), _ = await _parity(_non_vector)
    # vector calls create no host activations; a host grain makes one
    assert after == before and with_host == before + 1


# ---------------------------------------------------------------------------
# the client's collectives
# ---------------------------------------------------------------------------

async def _collectives(pkg, n=256, seed=7):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n, 192)
    xs = rng.random(192, dtype=np.float32)

    def build(pkg):
        return _build(pkg, "bulk", dense={pkg.Counter: n})

    async def body(pkg, silo, client):
        out = {}
        out["call_batch"] = await asyncio.gather(*client.call_batch(
            pkg.Counter, "add",
            [(int(k), {"x": x}) for k, x in zip(keys, xs)]))
        out["broadcast"] = await client.broadcast_actors(
            pkg.Counter, "add", np.arange(0, n, 2),
            {"x": np.float32(0.5)})
        out["reduce"] = {c: await client.reduce_actors(
            pkg.Counter, "count", combine=c)
            for c in ("sum", "max", "min", "mean")}
        out["reduce_keys"] = await client.reduce_actors(
            pkg.Counter, "count", keys=list(range(10)))
        out["map"] = await client.map_actors(pkg.Counter, "add",
                                             {"x": np.float32(2.0)})
        live = sorted(set(keys.tolist()) | set(range(0, n, 2)))
        out["join"] = await client.join_when(
            pkg.Counter, live, method="ready", timeout=10)
        out["join_some"] = await client.join_when(
            pkg.Counter, range(n), k=n // 2, method="ready", timeout=10,
            server=False)
        out["table"] = _rows(silo.vector.table(pkg.Counter).snapshot())
        return out

    return await _hosted(pkg, body, build)


async def test_client_collectives_through_both_silos():
    out, _ = await _parity(_collectives)
    counts = np.bincount(np.random.default_rng(7).integers(0, 256, 192),
                         minlength=256)
    counts[::2] += 1
    assert out["broadcast"] == 128
    assert int(out["reduce"]["sum"]) == counts.sum()
    assert out["map"] == int((counts > 0).sum())
    assert out["join"] == out["map"] and out["join_some"] >= 128


# ---------------------------------------------------------------------------
# samples/presence_torch.py's drive at 2,048 players
# ---------------------------------------------------------------------------

async def _presence(pkg, root, n=2048):
    sched = presence_torch.presence_schedule(
        n, 0, waves=2, batches=4, batch=256, singles=256, reads=64,
        sample=256)

    def build(storage, checkpoint_dir):
        b = pkg.rt.SiloBuilder().with_name("presence").add_grains(pkg.Game)
        pkg.add(b, pkg.Player, dense={pkg.Player: n}, mesh=pkg.mesh(8),
                capacity_per_shard=n // 8, storage=storage,
                flush_period=0.5, checkpoint_dir=checkpoint_dir)
        return b.build()

    res, _ = await presence_torch.drive_presence(
        build, pkg.rt.ClusterClient, pkg.storage.MemoryStorage(),
        pkg.Player, pkg.Game, sched, os.path.join(root, pkg.name))
    return res


async def test_presence_drive_through_both_silos(tmp_path):
    res, _ = await _parity(_presence, str(tmp_path))
    assert res["delivered"] == 2048 and res["joined"] == 2048
    assert res["summaries"][:, 1].sum() == 2048
