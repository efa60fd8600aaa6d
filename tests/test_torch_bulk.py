"""Parity of the port's bulk collectives (map_actors, reduce_actors,
broadcast_actors, stream_fanout, join_when), dense resharding and
replicated stateless workers with the JAX package's, on the CPU.

Both engines take the same seeded numpy inputs; every reduced value,
delivered count and state row (sink row left out) must be equal.
Tolerance: exact. Values are integers, or floats that are small multiples
of 1/4, whose sums are exact in float32 in any order. Every async body
runs under ``asyncio.wait_for(..., timeout=30)`` and shuts its worker
down in a ``finally``.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orleans_tpu.dispatch import VectorGrain as JGrain
from orleans_tpu.dispatch import VectorRuntime as JRuntime
from orleans_tpu.dispatch import actor_method as j_method
from orleans_tpu.dispatch import reshard_dense as j_reshard
from orleans_tpu.dispatch.replicated import replicated_worker as j_repl
from orleans_tpu.parallel import make_mesh as j_mesh
from orleans_tpu_torch.dispatch import VectorGrain as TGrain
from orleans_tpu_torch.dispatch import VectorRuntime as TRuntime
from orleans_tpu_torch.dispatch import actor_method as t_method
from orleans_tpu_torch.dispatch import reshard_dense as t_reshard
from orleans_tpu_torch.dispatch import replicated_worker as t_repl
from orleans_tpu_torch.ops import RANK_BY_DEST
from orleans_tpu_torch.parallel import make_mesh as t_mesh

TIMEOUT = 30


class JCell(JGrain):
    STATE = {"total": (jnp.int32, ()), "hits": (jnp.int32, ()),
             "x": (jnp.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"total": jnp.int32(0), "hits": jnp.int32(0),
                "x": jnp.float32(0)}

    @j_method(args={"c": (jnp.int32, ())})
    def add(state, args):
        new = {"total": state["total"] + args["c"],
               "hits": state["hits"] + 1,
               "x": state["x"] + args["c"].astype(jnp.float32) * 0.25}
        return new, new["total"]

    @j_method(read_only=True)
    def read(state, args):
        return state, state["total"]

    @j_method(read_only=True)
    def both(state, args):
        return state, {"total": state["total"], "x": state["x"]}

    @j_method(read_only=True)
    def ready(state, args):
        return state, (state["hits"] >= 2).astype(jnp.int32)


class TCell(TGrain):
    STATE = {"total": (torch.int32, ()), "hits": (torch.int32, ()),
             "x": (torch.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"total": torch.zeros_like(key_hash),
                "hits": torch.zeros_like(key_hash),
                "x": key_hash.new_zeros((), dtype=torch.float32)}

    @t_method(args={"c": (torch.int32, ())})
    def add(state, args):
        new = {"total": state["total"] + args["c"],
               "hits": state["hits"] + 1,
               "x": state["x"] + args["c"].to(torch.float32) * 0.25}
        return new, new["total"]

    @t_method(read_only=True)
    def read(state, args):
        return state, state["total"]

    @t_method(read_only=True)
    def both(state, args):
        return state, {"total": state["total"], "x": state["x"]}

    @t_method(read_only=True)
    def ready(state, args):
        return state, (state["hits"] >= 2).to(torch.int32)


def _pair(n_shards, capacity=64, dense=None, offloop=False):
    jrt = JRuntime(mesh=j_mesh(n_shards), capacity_per_shard=capacity)
    trt = TRuntime(mesh=t_mesh(n_shards, device="cpu"),
                   capacity_per_shard=capacity)
    jrt.offloop_tick = trt.offloop_tick = offloop
    jrt.register(JCell)
    trt.register(TCell)
    if dense:
        jrt.table(JCell).ensure_dense(dense)
        trt.table(TCell).ensure_dense(dense)
    return jrt, trt


def _both(drive, jrt, trt):
    """``drive(rt, cls)`` on each engine under the deadlock timeout;
    returns (jax result, port result)."""
    async def main(rt, cls):
        try:
            return await asyncio.wait_for(drive(rt, cls), timeout=TIMEOUT)
        finally:
            rt.shutdown_worker()
    return (asyncio.run(main(jrt, JCell)), asyncio.run(main(trt, TCell)))


def _same_state(jtbl, ttbl):
    assert jtbl.capacity == ttbl.capacity
    c = jtbl.capacity
    js, ts = jtbl.snapshot(), ttbl.snapshot()
    for k in js:
        np.testing.assert_array_equal(ts[k][:, :c], js[k][:, :c], err_msg=k)
    np.testing.assert_array_equal(ttbl.dense_active, jtbl.dense_active)


def _same(t, j):
    if isinstance(j, dict):
        assert t.keys() == j.keys()
        for k in j:
            _same(t[k], j[k])
    elif isinstance(j, (tuple, list)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b)
    elif j is None or isinstance(j, (int, float, str)):
        assert t == j
    else:
        assert np.asarray(t).dtype == np.asarray(j).dtype, (t, j)
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _check(drive, jrt, trt):
    jo, to = _both(drive, jrt, trt)
    _same(to, jo)
    _same_state(jrt.table(JCell), trt.table(TCell))
    for attr in ("ticks", "messages_processed", "exchange_lanes"):
        assert getattr(trt, attr) == getattr(jrt, attr), attr
    return to


HASHED = [10**13 + i * 7919 for i in range(3)]


@pytest.mark.parametrize("offloop", [False, True], ids=["inline", "offloop"])
def test_map_actors_live_subset_and_deferred(offloop):
    """map_actors over every live actor (dense and hashed), over a subset
    (dense keys activate, duplicates collapse, non-resident hashed keys
    are skipped), and with per-key turns pending (deferred a round)."""
    jrt, trt = _pair(4, dense=32, offloop=offloop)

    async def drive(rt, cls):
        for k in list(range(6)) + HASHED:
            rt.call(cls, k, "add", c=np.int32(1))
        await rt.flush()
        out = [await rt.map_actors(cls, "add", {"c": np.int32(5)})]
        out.append(await rt.map_actors(cls, "add", {"c": np.int32(7)},
                                       keys=np.arange(10, 20)))
        out.append(await rt.map_actors(cls, "add", {"c": np.int32(1)},
                                       keys=np.array([10, 10, 11, 11])))
        out.append(await rt.map_actors(
            cls, "add", {"c": np.int32(1)},
            keys=np.array([HASHED[0], HASHED[0] + 1])))
        futs = [rt.call(cls, k, "add", c=np.int32(2)) for k in range(8)]
        out.append(await rt.map_actors(cls, "add", {"c": np.int32(10)}))
        await rt.flush()
        out.append(await asyncio.gather(*futs))
        out.append(rt.table(cls).active_count())
        return out

    to = _check(drive, jrt, trt)
    assert to[:4] == [9, 10, 2, 1] and to[4] == to[-1] == 21


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_reduce_int_float_mean_and_empty(n_shards):
    """Sum/max/min/mean of int and float results (a dict of both) equal
    the reference's exactly; an empty population reduces to None; an
    unknown combine raises."""
    rng = np.random.default_rng(n_shards)
    keys = rng.permutation(48)
    vals = rng.integers(-1000, 1000, 48).astype(np.int32)
    jrt, trt = _pair(n_shards, dense=48)

    async def drive(rt, cls):
        out = [await rt.reduce_actors(cls, "read"),
               await rt.reduce_actors(cls, "read", combine="mean")]
        with pytest.raises(ValueError):
            await rt.reduce_actors(cls, "read", combine="median")
        rt.call_batch(cls, "add", keys, {"c": vals})
        for combine in ("sum", "max", "min", "mean"):
            out.append(await rt.reduce_actors(cls, "both", combine=combine))
        out.append(await rt.reduce_actors_partial(
            cls, "read", keys=keys[:20], combine="mean"))
        return out

    to = _check(drive, jrt, trt)
    assert to[0] is None and to[1] is None
    assert int(to[2]["total"]) == int(vals.sum())
    assert float(to[2]["x"]) == float(vals.sum()) * 0.25


def test_reduce_after_reshard_round_trip():
    """reshard_dense 4 → 8 → 3: the same rows, the same bitmap and the
    same reduced value as the reference at every step."""
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 10000, 64).astype(np.int32)
    jrt, trt = _pair(4, capacity=16, dense=64)
    jrt.call_batch(JCell, "add", np.arange(40), {"c": vals[:40]})
    trt.call_batch(TCell, "add", np.arange(40), {"c": vals[:40]})
    expect = int(vals[:40].sum())
    for n_to in (8, 3):
        j2 = JRuntime(mesh=j_mesh(n_to), capacity_per_shard=32)
        t2 = TRuntime(mesh=t_mesh(n_to, device="cpu"), capacity_per_shard=32)
        j2.tables[JCell] = j_reshard(jrt.table(JCell), j2)
        t2.tables[TCell] = t_reshard(trt.table(TCell), t2)
        _same_state(j2.table(JCell), t2.table(TCell))
        jrt, trt = j2, t2

        async def drive(rt, cls):
            return await rt.reduce_actors(cls, "read")

        assert int(_check(drive, jrt, trt)) == expect
    with pytest.raises(ValueError):
        t_reshard(TRuntime(mesh=t_mesh(2, device="cpu")).table(TCell), trt)


@pytest.mark.parametrize("n_from,n_to", [(4, 8), (8, 4), (3, 8), (8, 5)])
def test_reshard_dense_matches_jax(n_from, n_to):
    """The reference's reshard cases: a partly written dense table
    re-ranged onto another shard count gives the same rows and bitmap,
    and both tables then take the same writes."""
    rng = np.random.default_rng(n_from * 10 + n_to)
    keys = rng.choice(50, 30, replace=False)
    vals = rng.integers(-99, 99, 30).astype(np.int32)
    jrt, trt = _pair(n_from, capacity=8, dense=50)
    jrt.call_batch(JCell, "add", keys, {"c": vals})
    trt.call_batch(TCell, "add", keys, {"c": vals})
    j2 = JRuntime(mesh=j_mesh(n_to), capacity_per_shard=8)
    t2 = TRuntime(mesh=t_mesh(n_to, device="cpu"), capacity_per_shard=8)
    jt, tt = j_reshard(jrt.table(JCell), j2), t_reshard(trt.table(TCell), t2)
    _same_state(jt, tt)
    _same(t2.call_batch(TCell, "add", np.arange(50),
                        {"c": np.ones(50, np.int32)}),
          j2.call_batch(JCell, "add", np.arange(50),
                        {"c": np.ones(50, np.int32)}))
    _same_state(jt, tt)


@pytest.mark.parametrize("n_shards", [1, 8])
def test_broadcast_delivers_every_edge(n_shards):
    """Edge-list fan-out with duplicate targets, per-edge payloads, small
    chunks (so several chunks, each with dedup rounds), dirty marks and
    pending per-key turns deferred: same state as the reference; on 8
    shards every chunk is routed through K2."""
    rng = np.random.default_rng(5)
    targets = rng.integers(0, 64, 300)
    payload = rng.integers(1, 9, 300).astype(np.int32)
    jrt, trt = _pair(n_shards, dense=64)
    launches = RANK_BY_DEST.launches

    async def drive(rt, cls):
        rt.enable_dirty_tracking()
        futs = [rt.call(cls, k, "add", c=np.int32(100)) for k in (3, 4)]
        d = await rt.broadcast_actors(cls, "add", targets, {"c": payload},
                                      chunk=128)
        await rt.flush()
        out = [d, await asyncio.gather(*futs),
               sorted(rt.drain_dirty(cls).tolist())]
        out.append(await rt.broadcast_actors(
            cls, "add", np.array([1, 1, 1, 2]), {"c": np.int32(3)}))
        with pytest.raises(ValueError):
            await rt.broadcast_actors(cls, "add", np.array([999]),
                                      {"c": np.int32(1)})
        out.append(await rt.stream_fanout(cls, "add", np.arange(8),
                                          {"c": np.int32(1)}))
        out.append(rt.last_stream_group)
        out.append(await rt.reduce_actors(cls, "read"))
        out.append(rt.drain_dirty(cls).size)
        return out

    to = _check(drive, jrt, trt)
    assert to[0] == 300 and to[3] == 4 and to[4] == 8
    # the CPU wrapper runs K2's plain version and counts no launch
    assert RANK_BY_DEST.launches == launches


def test_join_when_at_k_and_timeout():
    jrt, trt = _pair(2, dense=16)

    async def drive(rt, cls):
        keys = np.arange(6)

        async def feed():
            for _ in range(2):
                await asyncio.sleep(0.01)
                await rt.map_actors(cls, "add", {"c": np.int32(1)},
                                    keys=keys[:4])

        t = asyncio.ensure_future(feed())
        got = await rt.join_when(cls, keys, k=4, method="ready",
                                 timeout=5.0)
        await t
        with pytest.raises(asyncio.TimeoutError):
            await rt.join_when(cls, keys, method="ready", timeout=0.05,
                               poll=0.01)
        return got, await rt.join_when(cls, keys[:4], method="ready")

    to = _both(drive, jrt, trt)[1]
    assert to == (4, 4)
    _same_state(jrt.table(JCell), trt.table(TCell))


@j_repl
class JHits(JGrain):
    STATE = {"hits": (jnp.int32, ()), "peak": (jnp.int32, ()),
             "low": (jnp.int32, ())}
    MERGE = {"hits": "sum", "peak": "max", "low": "min"}

    @staticmethod
    def initial_state(key_hash):
        return {"hits": jnp.int32(0), "peak": jnp.int32(-1),
                "low": key_hash + 100}

    @j_method(args={"v": (jnp.int32, ())})
    def see(state, args):
        new = {"hits": state["hits"] + 1,
               "peak": jnp.maximum(state["peak"], args["v"]),
               "low": jnp.minimum(state["low"], args["v"])}
        return new, new["hits"]


@t_repl
class THits(TGrain):
    STATE = {"hits": (torch.int32, ()), "peak": (torch.int32, ()),
             "low": (torch.int32, ())}
    MERGE = {"hits": "sum", "peak": "max", "low": "min"}

    @staticmethod
    def initial_state(key_hash):
        return {"hits": torch.zeros_like(key_hash),
                "peak": torch.full_like(key_hash, -1),
                "low": key_hash + 100}

    @t_method(args={"v": (torch.int32, ())})
    def see(state, args):
        new = {"hits": state["hits"] + 1,
               "peak": torch.maximum(state["peak"], args["v"]),
               "low": torch.minimum(state["low"], args["v"])}
        return new, new["hits"]


@pytest.mark.parametrize("n_shards", [1, 4])
def test_replicated_worker_merge(n_shards):
    """Round-robin replicas with duplicate keys (serialized per shard),
    then merged reads (sum/max/min over the shard dimension): the same
    per-call results, replica rows and merged values as the reference."""
    rng = np.random.default_rng(n_shards)
    keys = rng.integers(0, 10, 40)
    vals = rng.integers(-50, 50, 40).astype(np.int32)
    jrt, trt = _pair(n_shards)
    jh = jrt.replicated_host(JHits, 10)
    th = trt.replicated_host(THits, 10)
    assert trt.replicated_host(THits) is th
    with pytest.raises(ValueError):
        trt.replicated_host(THits, 11)
    for lo, hi in ((0, 25), (25, 40)):
        _same(th.call_batch("see", keys[lo:hi], {"v": vals[lo:hi]}),
              jh.call_batch("see", keys[lo:hi], {"v": vals[lo:hi]}))
    for f in JHits.STATE:
        np.testing.assert_array_equal(th.state[f][:, :10].numpy(),
                                      np.asarray(jh.state[f])[:, :10])
    np.testing.assert_array_equal(th.active, jh.active)
    _same(th.read_merged(np.arange(10)), jh.read_merged(np.arange(10)))
    assert int(th.read_merged(np.arange(10))["hits"].sum()) == 40
    with pytest.raises(ValueError):
        th.call_batch("see", np.array([10]), {"v": np.int32([1])})
    with pytest.raises(TypeError):
        t_repl(TCell)
