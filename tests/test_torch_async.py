"""Parity of the port's per-key asynchronous tick (orleans_tpu_torch
.dispatch.VectorRuntime.call/call_group/call_packed/actor, inline and on
the off-loop worker) with the JAX package's, on the CPU.

Each test drives both engines with the same seeded numpy inputs and
compares every future's result, every state row (the sink row left out:
padding lanes write there in an undefined order) and the engine counters.
Tolerance: exact. State and results are integers, bools, or float32
positions cast from float16 payloads, which both packages cast the same
way.

Every async body runs under ``asyncio.wait_for(..., timeout=30)`` and
shuts its worker down in a ``finally``: a deadlock fails one test.
"""

import asyncio
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orleans_tpu.config import DispatchOptions as JOptions
from orleans_tpu.core import ids as jids
from orleans_tpu.dispatch import VectorGrain as JGrain
from orleans_tpu.dispatch import VectorRuntime as JRuntime
from orleans_tpu.dispatch import actor_method as j_method
from orleans_tpu.parallel import make_mesh as j_mesh
from orleans_tpu_torch.config import DispatchOptions as TOptions
from orleans_tpu_torch.core import ids as tids
from orleans_tpu_torch.dispatch import VectorGrain as TGrain
from orleans_tpu_torch.dispatch import VectorRuntime as TRuntime
from orleans_tpu_torch.dispatch import actor_method as t_method
from orleans_tpu_torch.interop import carry_table, numpy_dtype
from orleans_tpu_torch.observability import INGEST_STATS as T_INGEST
from orleans_tpu_torch.parallel import make_mesh as t_mesh

TIMEOUT = 30


class JCounter(JGrain):
    STATE = {"total": (jnp.int32, ()), "hits": (jnp.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"total": key_hash % 7, "hits": jnp.int32(0)}

    @j_method(args={"c": (jnp.int32, ())})
    def add(state, args):
        new = {"total": state["total"] + args["c"],
               "hits": state["hits"] + 1}
        return new, {"total": new["total"], "hits": new["hits"]}

    @j_method(read_only=True)
    def read(state, args):
        return state, state["total"]

    @j_method
    def touch(state, args):
        return {"total": state["total"], "hits": state["hits"] + 1}, ()

    @j_method
    def bump(state, args):  # schema inferred from the first call
        return {"total": state["total"] + args["x"],
                "hits": state["hits"]}, state["total"] + args["x"]


class TCounter(TGrain):
    STATE = {"total": (torch.int32, ()), "hits": (torch.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"total": key_hash % 7, "hits": torch.zeros_like(key_hash)}

    @t_method(args={"c": (torch.int32, ())})
    def add(state, args):
        new = {"total": state["total"] + args["c"],
               "hits": state["hits"] + 1}
        return new, {"total": new["total"], "hits": new["hits"]}

    @t_method(read_only=True)
    def read(state, args):
        return state, state["total"]

    @t_method
    def touch(state, args):
        return {"total": state["total"], "hits": state["hits"] + 1}, ()

    @t_method
    def bump(state, args):
        return {"total": state["total"] + args["x"],
                "hits": state["hits"]}, state["total"] + args["x"]


class JPlayer(JGrain):
    STATE = {"pos": (jnp.float32, (2,)), "beats": (jnp.int32, ()),
             "game": (jnp.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"pos": jnp.zeros(2, jnp.float32), "beats": jnp.int32(0),
                "game": key_hash % 1024}

    @j_method(args={"pos": (jnp.float16, (2,))})
    def heartbeat(state, args):
        new = {"pos": args["pos"].astype(jnp.float32),
               "beats": state["beats"] + 1, "game": state["game"]}
        return new, {"beats": new["beats"], "game": new["game"],
                     "pos": new["pos"]}


class TPlayer(TGrain):
    STATE = {"pos": (torch.float32, (2,)), "beats": (torch.int32, ()),
             "game": (torch.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"pos": key_hash.new_zeros(2, dtype=torch.float32),
                "beats": torch.zeros_like(key_hash),
                "game": key_hash % 1024}

    @t_method(args={"pos": (torch.float16, (2,))})
    def heartbeat(state, args):
        new = {"pos": args["pos"].to(torch.float32),
               "beats": state["beats"] + 1, "game": state["game"]}
        return new, {"beats": new["beats"], "game": new["game"],
                     "pos": new["pos"]}


PAIRS = {"Counter": (JCounter, TCounter), "Player": (JPlayer, TPlayer)}
# one grain name per pair: the name is part of every hashed key's GrainId
for _name, _pair_classes in PAIRS.items():
    for _cls in _pair_classes:
        _cls.__name__ = _cls.__qualname__ = _name


def _pair(n_shards, capacity, offloop=False, dense=None):
    jrt = JRuntime(mesh=j_mesh(n_shards), capacity_per_shard=capacity)
    trt = TRuntime(mesh=t_mesh(n_shards, device="cpu"),
                   capacity_per_shard=capacity)
    jrt.offloop_tick = trt.offloop_tick = offloop
    for j, t in PAIRS.values():
        jrt.register(j)
        trt.register(t)
        if dense:
            jrt.table(j).ensure_dense(dense)
            trt.table(t).ensure_dense(dense)
    return jrt, trt


def _run(coro_fn, *rts):
    """Run ``coro_fn()`` under the deadlock timeout; stop every worker."""
    async def main():
        try:
            return await asyncio.wait_for(coro_fn(), timeout=TIMEOUT)
        finally:
            for rt in rts:
                rt.shutdown_worker()
    return asyncio.run(main())


def _same_state(jtbl, ttbl):
    assert jtbl.capacity == ttbl.capacity
    c = jtbl.capacity
    js, ts = jtbl.snapshot(), ttbl.snapshot()
    assert js.keys() == ts.keys()
    for k in js:
        np.testing.assert_array_equal(ts[k][:, :c], js[k][:, :c], err_msg=k)


def _same_value(t, j):
    if isinstance(j, dict):
        assert isinstance(t, dict) and t.keys() == j.keys()
        for k in j:
            _same_value(t[k], j[k])
        return
    if isinstance(j, tuple):
        assert t == j
        return
    assert np.asarray(t).dtype == np.asarray(j).dtype
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _same_counters(jrt, trt):
    for attr in ("ticks", "messages_processed", "conflicts_deferred",
                 "exchange_lanes"):
        assert getattr(trt, attr) == getattr(jrt, attr), attr
    assert not trt.pending and trt._inflight == 0


def _traffic(seed, n_calls, dense, hashed):
    """(key, c) calls: dense keys drawn with replacement (so some keys get
    several calls: the conflict-defer path) mixed with hashed keys."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, dense, n_calls).tolist()
    keys += [hashed[i % len(hashed)] for i in range(n_calls // 4)]
    order = rng.permutation(len(keys))
    keys = [int(keys[i]) for i in order]
    cs = rng.integers(-50, 50, len(keys)).astype(np.int32)
    return keys, cs


HASHED = [10**13 + 7919 * i for i in range(5)]


@pytest.mark.parametrize("offloop", [False, True], ids=["inline", "offloop"])
def test_call_group_packed_and_call_match_jax(offloop):
    """Per-key calls through call, call_group (futures and one-way items)
    and call_packed, with same-key conflicts that defer over several
    ticks: same results, same state, same counters."""
    jrt, trt = _pair(4, 16, offloop=offloop, dense=40)
    keys, cs = _traffic(1, 96, 40, HASHED)
    rng = np.random.default_rng(2)
    pkeys = rng.integers(0, 40, 48).tolist()
    pos = (rng.random((48, 2), dtype=np.float32)).astype(np.float16)

    async def drive(rt, counter, player):
        futs = [rt.call(counter, k, "add", c=cs[i])
                for i, k in enumerate(keys[:30])]
        futs += rt.call_group(counter, "add", [
            (k, {"c": cs[30 + i]}, i % 3 != 0)
            for i, k in enumerate(keys[30:90])])
        futs += rt.call_packed(counter, "add", keys[90:],
                               {"c": list(cs[90:])},
                               [True] * len(keys[90:]))
        pf = rt.call_group(player, "heartbeat", [
            (k, {"pos": pos[i]}, True) for i, k in enumerate(pkeys)])
        out = await asyncio.gather(*(f for f in futs if f is not None))
        pout = await asyncio.gather(*pf)
        await rt.flush()
        return out, pout

    jout, jp = _run(lambda: drive(jrt, JCounter, JPlayer), jrt)
    tout, tp = _run(lambda: drive(trt, TCounter, TPlayer), trt)
    assert len(tout) == len(jout)
    for t, j in zip(tout + tp, jout + jp):
        _same_value(t, j)
    for j, t in PAIRS.values():
        _same_state(jrt.table(j), trt.table(t))
    _same_counters(jrt, trt)
    assert trt.conflicts_deferred > 0  # the defer path ran
    if offloop:
        assert trt._worker is None  # shut down by _run


def test_actor_refs_and_ids_hash_like_jax():
    """GrainId hashes of int, str and negative keys, and actor() key
    hashes with their noted routing hashes, equal the reference's."""
    for name in ("Counter", "Presence.PlayerGrain", ""):
        assert tids.type_code_of(name) == jids.type_code_of(name)
        gt, jt = tids.GrainType.of(name), jids.GrainType.of(name)
        assert gt.type_code == jt.type_code
        for key in (0, 5, -1, -(2**40), 2**62, 2**70, "player-7", "",
                    "ключ", b"raw"):
            assert tids.GrainId.for_grain(gt, key).uniform_hash == \
                jids.GrainId.for_grain(jt, key).uniform_hash, (name, key)
    for data in (0, -3, 12345678901234567, "abc", b"\x00\x01"):
        assert tids.stable_hash64(data) == jids.stable_hash64(data)
        assert tids.stable_hash32(data) == jids.stable_hash32(data)
    jrt, trt = _pair(8, 16)
    for key in (3, "player-3", -4, 2**63):
        jref = jrt.actor(JCounter, key)
        tref = trt.actor(TCounter, key)
        assert tref.key_hash == jref.key_hash
    assert trt.table(TCounter).route_hash == jrt.table(JCounter).route_hash

    async def drive(rt, cls):
        return await asyncio.gather(
            *(rt.actor(cls, f"player-{i}").add(c=np.int32(i))
              for i in range(12)),
            rt.actor(cls, 3).add(c=np.int32(4)))

    jo = _run(lambda: drive(jrt, JCounter), jrt)
    to = _run(lambda: drive(trt, TCounter), trt)
    for t, j in zip(to, jo):
        _same_value(t, j)
    _same_state(jrt.table(JCounter), trt.table(TCounter))
    with pytest.raises(AttributeError):
        trt.actor(TCounter, 1).nope


def test_grow_racing_worker_upload():
    """Waves of new hashed keys grow the table (state swap, staging sink
    moved) while worker batches are in flight: no write is lost, and the
    result equals the reference's."""
    jrt, trt = _pair(2, 8, offloop=True)

    async def drive(rt, cls):
        tbl = rt.table(cls)
        cap0 = tbl.capacity
        keys = []
        for wave in range(4):
            wave_keys = [(1 << 40) + wave * 64 + i for i in range(40)]
            keys.extend(wave_keys)
            await asyncio.gather(*(rt.call(cls, k, "add", c=np.int32(1))
                                   for k in wave_keys))
        assert tbl.capacity > cap0, "growth never triggered"
        return await asyncio.gather(*(rt.call(cls, k, "read")
                                      for k in keys))

    jo = _run(lambda: drive(jrt, JCounter), jrt)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # interleave the loop and the worker often
    try:
        to = _run(lambda: drive(trt, TCounter), trt)
    finally:
        sys.setswitchinterval(switch)
    for t, j in zip(to, jo):
        _same_value(t, j)
    _same_state(jrt.table(JCounter), trt.table(TCounter))
    _same_counters(jrt, trt)


@pytest.mark.parametrize("offloop", [False, True], ids=["inline", "offloop"])
def test_flush_drains_one_way_and_result_less(offloop):
    """flush() returns only after pending and in-flight work retired (one
    way calls leave no futures); a result-less method resolves to ()."""
    jrt, trt = _pair(2, 16, offloop=offloop, dense=16)

    async def drive(rt, cls):
        rt.call_group(cls, "add", [(k, {"c": np.int32(k)}, False)
                                   for k in range(12)])
        fut = rt.call(cls, 3, "touch")
        await rt.flush()
        assert not rt.pending and rt._inflight == 0
        return await fut

    jo = _run(lambda: drive(jrt, JCounter), jrt)
    to = _run(lambda: drive(trt, TCounter), trt)
    assert to == jo == ()
    _same_state(jrt.table(JCounter), trt.table(TCounter))
    _same_counters(jrt, trt)


@pytest.mark.parametrize("offloop", [False, True], ids=["inline", "offloop"])
def test_per_item_error_isolation(offloop):
    """A schema-violating item resolves its own future with the error;
    the rest of the group proceeds."""
    jrt, trt = _pair(1, 16, offloop=offloop, dense=8)

    async def drive(rt, cls):
        futs = rt.call_group(cls, "add", [
            (0, {"c": np.int32(1)}, True), (1, {"bogus": 1}, True),
            (1, {"bogus": 1}, False), (2, {"c": np.int32(2)}, True)])
        return await asyncio.gather(*(f for f in futs if f is not None),
                                    return_exceptions=True)

    jo = _run(lambda: drive(jrt, JCounter), jrt)
    to = _run(lambda: drive(trt, TCounter), trt)
    assert isinstance(to[1], TypeError) and isinstance(jo[1], TypeError)
    for i in (0, 2):
        _same_value(to[i], jo[i])
    _same_state(jrt.table(JCounter), trt.table(TCounter))


def test_bad_first_call_does_not_poison_inferred_schema():
    """A first call whose argument has no device dtype fails once and
    leaves the inferred schema unset; the next call infers and runs."""
    jrt, trt = _pair(1, 16)

    async def drive(rt, cls):
        with pytest.raises(TypeError):
            await rt.call(cls, 1, "bump", x="abc")
        m = rt.table(cls).methods["bump"]
        assert m.args_schema is None, m.args_schema
        out = await rt.call(cls, 1, "bump", x=np.int32(5))
        return out, m.args_schema["x"]

    (jo, jspec) = _run(lambda: drive(jrt, JCounter), jrt)
    (to, tspec) = _run(lambda: drive(trt, TCounter), trt)
    _same_value(to, jo)
    assert numpy_dtype(tspec[0]) == np.dtype(jspec[0]) == np.int32
    assert tuple(tspec[1]) == tuple(jspec[1])


def test_pipeline_depth_guard_and_options():
    """validate_pipeline_depth keeps the reference's contract on the
    port's mesh; DispatchOptions carries capacity and the off-loop
    lever; a bare runtime stays inline."""
    multi = TRuntime(mesh=t_mesh(8, device="cpu"))
    assert multi.validate_pipeline_depth(1) == 1
    for allow in (False, True):
        with pytest.raises(ValueError, match="rendezvous"):
            multi.validate_pipeline_depth(2, allow_unproven=allow)
    with pytest.raises(ValueError):
        multi.validate_pipeline_depth(0)
    assert TRuntime(mesh=t_mesh(1, device="cpu")) \
        .validate_pipeline_depth(4) == 4
    assert TRuntime(mesh=t_mesh(1, device="cpu")).offloop_tick is False
    with pytest.raises(ValueError):
        TOptions(capacity_per_shard=0).validate()
    assert TOptions() == TOptions(**{
        k: getattr(JOptions(), k) for k in
        ("capacity_per_shard", "offloop_tick")})
    rt = TRuntime(mesh=t_mesh(1, device="cpu"),
                  options=TOptions(capacity_per_shard=16, offloop_tick=True))
    assert rt.offloop_tick and rt.capacity_per_shard == 16

    async def drive():
        out = await rt.call(TCounter, 5, "add", c=np.int32(3))
        assert rt._worker is not None
        return out

    assert int(_run(drive, rt)["total"]) == 5 % 7 + 3


class _Recorder:
    """Duck-typed stats/ledger/tracer/shed-trend hook that records what
    the engine reports."""

    def __init__(self):
        self.observed: dict = {}
        self.counted: dict = {}
        self.charges: list = []
        self.spans: list = []
        self.notes = 0
        self.device_trace_id = "dev"

    def observe(self, key, value):
        assert value >= 0
        self.observed[key] = self.observed.get(key, 0) + 1

    def increment(self, key, n=1):
        self.counted[key] = self.counted.get(key, 0) + n

    def charge_tick(self, payload):
        name, method, rows, wall, labels = payload[:5]
        assert wall >= 0
        self.charges.append((name, method, rows, labels))

    def sample(self):
        return True

    def record(self, trace_id, parent, name, kind, start, dur, **attrs):
        self.spans.append((trace_id, parent, name, kind,
                           attrs.get("batch")))

    def note(self, mean):
        self.notes += 1


@pytest.mark.parametrize("offloop", [False, True], ids=["inline", "offloop"])
def test_hooks_see_the_same_reports(offloop):
    """stats/ledger/tracer/shed_trend stubs see the same keys and counts
    from both engines; hit and cost counters fold the same lanes."""
    jrt, trt = _pair(2, 16, offloop=offloop, dense=16)
    recs = {}
    for name, rt in (("j", jrt), ("t", trt)):
        rec = _Recorder()
        rt.stats = rt.ledger = rt.tracer = rt.shed_trend = rec
        rt.enable_load_tracking()
        rt.enable_cost_tracking()
        recs[name] = rec

    async def drive(rt, cls):
        keys = [1, 2, 2, 3, 1, 9]
        futs = rt.call_group(cls, "add", [
            (k, {"c": np.int32(i)}, True) for i, k in enumerate(keys)],
            traces=[("tr", f"s{i % 2}") for i in range(len(keys))],
            origin="w1")
        await asyncio.gather(*futs)
        await rt.call(cls, 10**12, "add", c=np.int32(1))
        rt.call_batch(cls, "add", np.arange(4),
                      {"c": np.arange(4, dtype=np.int32)})

    _run(lambda: drive(jrt, JCounter), jrt)
    _run(lambda: drive(trt, TCounter), trt)
    j, t = recs["j"], recs["t"]
    assert set(t.observed) <= set(T_INGEST.values())
    assert t.observed == j.observed and t.counted == j.counted
    assert t.charges == j.charges and t.notes == j.notes
    assert sorted(t.spans) == sorted(j.spans)
    jt, tt = jrt.table(JCounter), trt.table(TCounter)
    np.testing.assert_array_equal(tt.slot_hits()[:, :tt.capacity],
                                  jt.slot_hits()[:, :jt.capacity])
    np.testing.assert_array_equal(trt.shard_loads()[TCounter],
                                  jrt.shard_loads()[JCounter])
    np.testing.assert_array_equal(tt.slot_cost() > 0, jt.slot_cost() > 0)
    assert tt.cost_seconds() >= 0
    _same_state(jt, tt)


def test_migration_fence_sees_inflight_keys():
    """While a worker batch waits on the fence (held here), its keys stay
    in pending_key_hashes; completion releases them."""
    _, trt = _pair(1, 16, offloop=True, dense=8)

    async def drive():
        await trt.call(TCounter, 0, "add", c=np.int32(1))
        fence = trt.tick_fence()
        fence.acquire()
        try:
            futs = [trt.call(TCounter, k, "add", c=np.int32(2))
                    for k in (3, 4)]
            for _ in range(50):
                await asyncio.sleep(0)
                if trt._inflight:
                    break
            assert trt._inflight >= 1
            assert {3, 4} <= trt.pending_key_hashes(TCounter)
            assert trt.queue_depth() == 2
        finally:
            fence.release()
        await asyncio.gather(*futs)
        assert not trt.pending_key_hashes(TCounter) & {3, 4}
        assert trt.staging_lanes() > 0

    _run(drive, trt)


def test_carried_state_continues_like_jax():
    """A JAX table's state, dense bitmap, hashed directory, routing
    hashes and hit/cost counters carry into the port (interop
    .carry_table); both engines then take the same calls and stay
    equal."""
    jrt, trt = _pair(4, 8, dense=20)
    jrt.enable_load_tracking()
    jrt.enable_cost_tracking()
    hashed = [(1 << 41) + 13 * i for i in range(40)]  # grows the table

    async def warm():
        await asyncio.gather(
            *(jrt.call(JCounter, k, "add", c=np.int32(k % 5))
              for k in list(range(0, 20, 3)) + hashed),
            jrt.actor(JCounter, "carried").add(c=np.int32(2)),
            jrt.actor(JCounter, 7).add(c=np.int32(3)))
        jrt.table(JCounter).release(hashed[0])

    _run(warm, jrt)
    jt, tt = jrt.table(JCounter), trt.table(TCounter)
    carry_table(jt, tt)
    trt.enable_load_tracking()
    trt.enable_cost_tracking()
    assert tt.capacity == jt.capacity > 8
    _same_state(jt, tt)
    np.testing.assert_array_equal(tt.slot_hits(), jt.slot_hits())
    np.testing.assert_array_equal(tt.slot_cost(), jt.slot_cost())
    assert tt.key_to_slot == jt.key_to_slot
    assert tt.route_hash == jt.route_hash and tt.route_hash
    assert tt.active_count() == jt.active_count()
    for k in hashed[1:]:
        assert tt.device_dir.lookup(k) == jt.device_dir.lookup(k)

    async def more(rt, cls):
        return await asyncio.gather(
            *(rt.call(cls, k, "add", c=np.int32(1))
              for k in list(range(20)) + hashed + [hashed[0], 1 << 50]),
            rt.actor(cls, "carried").add(c=np.int32(1)))

    jo = _run(lambda: more(jrt, JCounter), jrt)
    to = _run(lambda: more(trt, TCounter), trt)
    for t, j in zip(to, jo):
        _same_value(t, j)
    _same_state(jt, tt)
    np.testing.assert_array_equal(tt.slot_hits(), jt.slot_hits())
    with pytest.raises(ValueError):
        carry_table(jt, TRuntime(mesh=t_mesh(2, device="cpu"))
                    .table(TCounter))


def test_fence_blocks_grow_during_a_worker_batch():
    """grow() waits on the tick fence while a worker batch holds it, and
    runs once the batch is done."""
    _, trt = _pair(1, 8)
    tbl = trt.table(TCounter)
    fence = trt.tick_fence()
    assert tbl.fence is fence
    held, release = threading.Event(), threading.Event()

    def batch():
        with fence:
            held.set()
            release.wait(TIMEOUT)

    worker = threading.Thread(target=batch)
    worker.start()
    held.wait(TIMEOUT)
    grower = threading.Thread(target=tbl.grow, args=(16,))
    grower.start()
    time.sleep(0.2)
    assert grower.is_alive() and tbl.capacity == 8
    release.set()
    grower.join(TIMEOUT)
    worker.join(TIMEOUT)
    assert not grower.is_alive() and tbl.capacity == 16
