"""Parity of the port's cross-shard leg (route → exchange → fan-in →
apply) with the JAX package's, on the CPU.

``dryrun_multichip(8)`` phases 1-4 (``__graft_entry__.py``) run at their
tiny shapes in both packages, phase by phase: the scanned heartbeat
rounds, the exchange, the fan-in segment sum onto the game table, and the
sparse route through the on-device directory with its apply-side defer.
Tolerance: exact — every value here is an integer or a bool.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from orleans_tpu.dispatch import VectorGrain as JGrain
from orleans_tpu.dispatch import VectorRuntime as JRuntime
from orleans_tpu.dispatch import actor_method as j_method
from orleans_tpu.ops import segment_sum_onehot as j_segment_sum_onehot
from orleans_tpu.ops.hash_probe import split64
from orleans_tpu.parallel import make_mesh as j_mesh
from orleans_tpu.parallel.transport import build_exchange as j_exchange
from orleans_tpu_torch.dispatch import VectorGrain as TGrain
from orleans_tpu_torch.dispatch import VectorRuntime as TRuntime
from orleans_tpu_torch.dispatch import actor_method as t_method
from orleans_tpu_torch.ops import segment_sum as t_segment_sum
from orleans_tpu_torch.parallel import build_exchange as t_exchange
from orleans_tpu_torch.parallel import make_mesh as t_mesh

N = 8  # shards, as in dryrun_multichip(8)


class TPlayer(TGrain):
    """The port of ``__graft_entry__._player_class()``."""

    STATE = {"pos": (torch.float32, (2,)), "beats": (torch.int32, ()),
             "game": (torch.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"pos": key_hash.new_zeros(2, dtype=torch.float32),
                "beats": torch.zeros_like(key_hash), "game": key_hash % 64}

    @t_method(args={"pos": (torch.float16, (2,))})
    def heartbeat(state, args):
        new = {"pos": args["pos"].to(torch.float32),
               "beats": state["beats"] + 1, "game": state["game"]}
        return new, {"game": new["game"], "beats": new["beats"]}


class JCounter(JGrain):
    STATE = {"total": (jnp.int32, ()), "hits": (jnp.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"total": jnp.int32(0), "hits": jnp.int32(0)}

    @j_method(args={"amount": (jnp.int32, ())})
    def add(state, args):
        new = {"total": state["total"] + args["amount"],
               "hits": state["hits"] + 1}
        return new, new["total"]


class TCounter(TGrain):
    STATE = {"total": (torch.int32, ()), "hits": (torch.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"total": torch.zeros_like(key_hash),
                "hits": torch.zeros_like(key_hash)}

    @t_method(args={"amount": (torch.int32, ())})
    def add(state, args):
        new = {"total": state["total"] + args["amount"],
               "hits": state["hits"] + 1}
        return new, new["total"]


def _eq(t, j, msg=""):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, (msg, t.dtype, j.dtype)
    np.testing.assert_array_equal(t, j, err_msg=msg)


def _same_state(jtbl, ttbl):
    C = jtbl.capacity
    assert ttbl.capacity == C
    js, ts = jtbl.snapshot(), ttbl.snapshot()
    for k in js:
        _eq(ts[k][:, :C], js[k][:, :C], k)


def _activate_hashed(rt, cls, method, hashes, args):
    """Activate hashed keys in one fresh tick through call_batch_device
    (the port has no per-key async path yet): allocate each key's slot,
    then fresh-init and apply ``method`` on every lane."""
    tbl = rt.table(cls)
    locs = [tbl.lookup_or_allocate(h)[:2] for h in hashes]
    n = tbl.n_shards
    B = max(1, max(sum(1 for s, _ in locs if s == sh) for sh in range(n)))
    slots = np.full((n, B), tbl.sink_slot, np.int32)
    khash = np.zeros((n, B), np.int32)
    valid = np.zeros((n, B), bool)
    fill = [0] * n
    lane_of = []
    for h, (s, slot) in zip(hashes, locs):
        i = fill[s]
        fill[s] += 1
        slots[s, i], khash[s, i], valid[s, i] = slot, h & 0x7FFFFFFF, True
        lane_of.append((s, i))
    packed = {}
    for k, v in args.items():
        buf = np.zeros((n, B), v.dtype)
        for (s, i), x in zip(lane_of, v):
            buf[s, i] = x
        packed[k] = torch.from_numpy(buf).to(rt.device)

    def dev(x):
        return torch.from_numpy(x).to(rt.device)
    return rt.call_batch_device(cls, method, dev(slots), dev(khash),
                                dev(valid), dev(valid), packed)


def test_dryrun_multichip_phases_1_to_3():
    JPlayer = __graft_entry__._player_class()
    n_players, n_games = 16 * N, 4 * N
    jrt = JRuntime(mesh=j_mesh(N), capacity_per_shard=64)
    trt = TRuntime(mesh=t_mesh(N, device="cpu"), capacity_per_shard=64)
    jtbl, ttbl = jrt.table(JPlayer), trt.table(TPlayer)
    jtbl.ensure_dense(n_players)
    ttbl.ensure_dense(n_players)
    keys = np.arange(n_players)
    jplan = jrt.make_dense_plan(JPlayer, keys)
    tplan = trt.make_dense_plan(TPlayer, keys)

    # phase 1: scanned heartbeat rounds (K=2) on the sharded player table
    K = 2
    pos = np.zeros((K, n_players, 2), np.float16)
    jout = jrt.call_batch_rounds(JPlayer, "heartbeat", keys, {"pos": pos},
                                 plan=jplan, device_results=True)
    tout = trt.call_batch_rounds(TPlayer, "heartbeat", keys, {"pos": pos},
                                 plan=tplan, device_results=True)
    for k in ("game", "beats"):
        _eq(tout[k], jout[k], k)
    _same_state(jtbl, ttbl)

    # phase 2: route player→game messages over the exchange
    gps = -(-n_games // N)
    jgame, jbeats = jout["game"][-1], jout["beats"][-1]
    tgame, tbeats = tout["game"][-1], tout["beats"][-1]
    jrecv, jrv, jdrops = j_exchange(j_mesh(N), capacity=64)(
        ((jgame % n_games) // gps).astype(jnp.int32),
        jnp.asarray(jplan.valid_b), {"game": jgame, "beats": jbeats})
    trecv, trv, tdrops = t_exchange(trt.mesh, capacity=64)(
        ((tgame % n_games) // gps).to(torch.int32),
        torch.from_numpy(tplan.valid_b), {"game": tgame, "beats": tbeats})
    _eq(trv, jrv, "recv_valid")
    _eq(tdrops, jdrops, "drops")
    for k in ("game", "beats"):
        _eq(trecv[k], jrecv[k], k)

    # phase 3: fan-in onto the sharded game table
    def j_reduce(g, v):
        return jax.vmap(lambda gs, vs: j_segment_sum_onehot(
            jnp.where(vs, 1, 0), (gs % n_games) % gps, gps))(g, v)
    jtable = np.asarray(j_reduce(jrecv["game"], jrv)).astype(np.int32)
    ttable = t_segment_sum(
        torch.where(trv, 1, 0).to(torch.int32),
        (trecv["game"] % n_games) % gps, gps)
    assert ttable.shape == (N, gps)
    _eq(ttable, jtable, "game table")
    total, dropped = int(ttable.sum()), int(tdrops.sum())
    assert total + dropped == n_players


@pytest.mark.parametrize("capacity", [1, 3])
def test_exchange_overflow_conserves(capacity):
    """Capacity pressure: drops are counted per source shard, identically
    in both packages, and every valid message is delivered or dropped."""
    rng = np.random.default_rng(capacity)
    B = 12
    dest = rng.integers(0, N, (N, B)).astype(np.int32)
    valid = rng.random((N, B)) < 0.8
    x = rng.integers(0, 1000, (N, B)).astype(np.int32)
    jrecv, jrv, jd = j_exchange(j_mesh(N), capacity=capacity)(
        jnp.asarray(dest), jnp.asarray(valid), {"x": jnp.asarray(x)})
    trecv, trv, td = t_exchange(t_mesh(N, device="cpu"), capacity)(
        torch.from_numpy(dest), torch.from_numpy(valid),
        {"x": torch.from_numpy(x)})
    _eq(trv, jrv)
    _eq(td, jd)
    _eq(trecv["x"], jrecv["x"])
    assert int(trv.sum()) + int(td.sum()) == int(valid.sum())


def test_dryrun_multichip_phase_4_sparse_route_defers():
    jrt = JRuntime(mesh=j_mesh(N), capacity_per_shard=64)
    trt = TRuntime(mesh=t_mesh(N, device="cpu"), capacity_per_shard=64)
    jtbl, ttbl = jrt.table(JCounter), trt.table(TCounter)
    hashes = [((k * 2654435761) ^ (k << 33)) & ((1 << 62) - 1) | (1 << 40)
              for k in range(1, 2 * N + 1)]

    async def activate():
        await asyncio.gather(*(
            jrt.call(JCounter, h, "add", amount=np.int32(0))
            for h in hashes))
    asyncio.run(activate())
    _activate_hashed(trt, TCounter, "add", hashes,
                     {"amount": np.zeros(len(hashes), np.int32)})
    assert ttbl.device_dir.count == jtbl.device_dir.count == len(hashes)
    assert ttbl.key_to_slot == jtbl.key_to_slot
    _same_state(jtbl, ttbl)

    B2 = 2
    dest = np.zeros((N, B2), np.int64)
    amount = np.zeros((N, B2), np.int32)
    expect: dict = {}
    for s in range(N):
        for i in range(B2):
            # shard 0 double-targets one actor to force the defer path
            h = hashes[0] if (s, i) == (0, 1) else \
                hashes[(s * B2 + i) % len(hashes)]
            dest[s, i] = h
            amount[s, i] = 100 + s * B2 + i
            expect[h] = expect.get(h, 0) + amount[s, i]
    lo, hi = split64(dest)
    ones = np.ones((N, B2), bool)
    jk, jp, jv, jd = jrt.route(
        JCounter, (jnp.asarray(lo), jnp.asarray(hi)),
        {"amount": jnp.asarray(amount)}, jnp.asarray(ones), capacity=16,
        sparse=True)
    tk, tp, tv, td = trt.route(
        TCounter, (torch.from_numpy(lo), torch.from_numpy(hi)),
        {"amount": torch.from_numpy(amount)}, torch.from_numpy(ones),
        capacity=16, sparse=True)
    _eq(td, jd, "drops")
    _eq(tv, jv, "recv_valid")
    _eq(tk[0], jk[0], "lo")
    _eq(tk[1], jk[1], "hi")
    _eq(tp["amount"], jp["amount"], "amount")
    delivered = int(tv.sum())
    assert delivered == N * B2 and int(td.sum()) == 0

    rounds = applied_total = 0
    while applied_total < delivered and rounds <= delivered:
        jres, ja = jrt.apply_received(JCounter, "add", jk, jv, jp,
                                      sparse=True)
        tres, ta = trt.apply_received(TCounter, "add", tk, tv, tp,
                                      sparse=True)
        _eq(ta, ja, f"applied, round {rounds}")
        a = ta.numpy()
        np.testing.assert_array_equal(tres.numpy()[a], np.asarray(jres)[a])
        applied_total += int(a.sum())
        jv = jnp.asarray(np.asarray(jv) & ~a)
        tv = tv & ~ta
        rounds += 1
    assert applied_total == delivered
    assert rounds >= 2  # the duplicate really deferred a tick
    for h, want in expect.items():
        assert int(ttbl.read_row(h)["total"]) == want
    _same_state(jtbl, ttbl)


def test_sparse_route_counts_unregistered_as_drops():
    jrt = JRuntime(mesh=j_mesh(N), capacity_per_shard=8)
    trt = TRuntime(mesh=t_mesh(N, device="cpu"), capacity_per_shard=8)
    known = [(1 << 40) | k for k in range(1, 5)]
    for h in known:
        jrt.table(JCounter).lookup_or_allocate(h)
    _activate_hashed(trt, TCounter, "add", known,
                     {"amount": np.zeros(4, np.int32)})
    dest = np.array([[known[0], 12345 << 33]] * N, np.int64)
    lo, hi = split64(dest)
    valid = np.ones((N, 2), bool)
    amount = np.ones((N, 2), np.int32)
    *_, jd = jrt.route(JCounter, (jnp.asarray(lo), jnp.asarray(hi)),
                       {"amount": jnp.asarray(amount)}, jnp.asarray(valid),
                       capacity=4, sparse=True)
    *_, td = trt.route(TCounter, (torch.from_numpy(lo), torch.from_numpy(hi)),
                       {"amount": torch.from_numpy(amount)},
                       torch.from_numpy(valid), capacity=4, sparse=True)
    _eq(td, jd)
    assert td.tolist() == [1] * N


def test_dense_route_apply_duplicates_defer():
    """Extreme dense fan-in (every message to one account): the applied
    masks of each defer round match, and so does the final state."""
    JBank, TBank = JCounter, TCounter
    jrt = JRuntime(mesh=j_mesh(N), capacity_per_shard=8)
    trt = TRuntime(mesh=t_mesh(N, device="cpu"), capacity_per_shard=8)
    for rt, cls in ((jrt, JBank), (trt, TBank)):
        rt.table(cls).ensure_dense(32)
        rt.call_batch(cls, "add", np.arange(32),
                      {"amount": np.zeros(32, np.int32)})
    B = 4
    dest = np.full((N, B), 5, np.int32)
    dest[:, 0] = np.arange(N) * 3     # some distinct accounts too
    amount = np.arange(N * B, dtype=np.int32).reshape(N, B)
    valid = np.ones((N, B), bool)
    jk, jp, jv, jd = jrt.route(JBank, jnp.asarray(dest),
                               {"amount": jnp.asarray(amount)},
                               jnp.asarray(valid), capacity=32)
    tk, tp, tv, td = trt.route(TBank, torch.from_numpy(dest),
                               {"amount": torch.from_numpy(amount)},
                               torch.from_numpy(valid), capacity=32)
    _eq(tk, jk)
    _eq(td, jd)
    for _ in range(N * B):
        if not bool(tv.any()):
            break
        _, ja = jrt.apply_received(JBank, "add", jk, jv, jp)
        _, ta = trt.apply_received(TBank, "add", tk, tv, tp)
        _eq(ta, ja)
        jv = jnp.asarray(np.asarray(jv) & ~np.asarray(ja))
        tv = tv & ~ta
    assert not bool(tv.any())
    _same_state(jrt.table(JBank), trt.table(TBank))
    assert int(trt.table(TBank).read_row(5)["total"]) == \
        int(amount[dest == 5].sum())
