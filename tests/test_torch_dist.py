"""The silo axis across ranks: the port's process-group mesh, exchange,
Phase B's super, merged reads, the sparse route, the per-key tick, the
bulk collectives and ``reshard_dense``, on gloo ranks on the CPU.

``samples/ranks_torch.py`` runs each scenario (the exchange with
overflow, ``bench.py --devices 8``'s super at ``dryrun_multichip(8)``'s
shapes, a replicated worker's calls and merged reads, ``dryrun_multichip``
phase 4's sparse route with its hashed activation and dedup, Phase G's
fan-out with per-key calls, reductions, map, ``join_when`` and a reshard
8 -> 4 -> 8, and a ``join_when`` that times out) on every rank of a gloo
group: 2 ranks of 4 shards and 8 ranks of 1 (where 4 shards do not
divide, so the reshard is refused naming the world). The ranks are
spawned once for the module, as fresh interpreters joined through a file
in a temporary directory (no port), each group within 60 s or killed; a
rank that entered a collective the others did not would hang its group
until then. Their outputs, stacked along the shard axis, are held
against the same inputs through the JAX package on its 8-virtual-device
mesh (``all_to_all``, ``psum``/``pmax``/``pmin``; its 4-device mesh for
the reshard) and through the one-device port.
Tolerance: exact for every integer and bool, and for the float32 and
float16 values, which are copied, never summed, so they are equal bit
for bit; the float reduce ``mean`` within 1e-6 relative.
"""

import asyncio
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__
from orleans_tpu.dispatch import VectorGrain as JGrain
from orleans_tpu.dispatch import VectorRuntime as JRuntime
from orleans_tpu.dispatch import actor_method as j_method
from orleans_tpu.dispatch import reshard_dense as j_reshard
from orleans_tpu.dispatch.replicated import replicated_worker as j_repl
from orleans_tpu.ops import segment_sum as j_segment_sum
from orleans_tpu.parallel import make_mesh as j_mesh
from orleans_tpu.parallel.transport import build_exchange as j_exchange
from orleans_tpu_torch.config import DispatchOptions
from orleans_tpu_torch.dispatch import VectorRuntime as TRuntime
from orleans_tpu_torch.dispatch import add_vector_grains, reshard_dense
from orleans_tpu_torch.ops import split64
from orleans_tpu_torch.parallel import (GroupMeshError, agree, all_reduce,
                                        gather, make_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "samples"))
import ranks_torch as rk  # noqa: E402

WORLDS = [2, 8]
N = rk.N_SHARDS


class GameGrain(JGrain):
    STATE = {"count": (jnp.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"count": jnp.int32(0)}

    @j_method(args={"n": (jnp.int32, ())})
    def accumulate(state, args):
        new = {"count": state["count"] + args["n"]}
        return new, new["count"]


@j_repl
class HitsGrain(JGrain):
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


class CounterVec(JGrain):
    STATE = {"total": (jnp.int32, ()), "hits": (jnp.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"total": jnp.int32(0), "hits": jnp.int32(0)}

    @j_method(args={"amount": (jnp.int32, ())})
    def add(state, args):
        new = {"total": state["total"] + args["amount"],
               "hits": state["hits"] + 1}
        return new, new["total"]

    @j_method(read_only=True)
    def get(state, args):
        return state, state["total"]


class FanVec(JGrain):
    STATE = {"events": (jnp.int32, ()), "last": (jnp.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"events": jnp.int32(0), "last": jnp.float32(0)}

    @j_method(args={"v": (jnp.float32, ())})
    def on_next(state, args):
        return {"events": state["events"] + 1,
                "last": args["v"]}, state["events"]

    @j_method(read_only=True)
    def events(state, args):
        return state, state["events"]

    @j_method(read_only=True)
    def ready(state, args):
        return state, (state["events"] > 0).astype(jnp.int32)


def _jax_reference() -> dict:
    """Every scenario of ``ranks_torch.run_all`` through the JAX package
    on its 8-device mesh, under the same names."""
    out = {}
    dest, valid, payload = rk.exchange_inputs()
    recv, rv, drops = j_exchange(j_mesh(N), capacity=rk.EX_CAPACITY)(
        jnp.asarray(dest), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in payload.items()})
    out.update({f"ex_recv_{k}": v for k, v in recv.items()})
    out.update(ex_valid=rv, ex_drops=drops)

    JPlayer = __graft_entry__._player_class()
    rt = JRuntime(mesh=j_mesh(N), capacity_per_shard=64)
    tbl = rt.table(JPlayer)
    tbl.ensure_dense(rk.N_PLAYERS)
    keys = np.arange(rk.N_PLAYERS)
    plan = rt.make_dense_plan(JPlayer, keys)
    gt = rt.table(GameGrain)
    gt.ensure_dense(rk.N_GAMES)
    gps = gt.dense_per_shard
    rt.call_batch(GameGrain, "accumulate", np.arange(rk.N_GAMES),
                  {"n": np.zeros(rk.N_GAMES, np.int32)})
    d_game = jnp.asarray(plan.pack(keys % rk.N_GAMES, np.int32, ()))
    d_valid = jnp.asarray(plan.valid_b)
    g_slots = jnp.asarray(np.broadcast_to(
        np.arange(gps, dtype=np.int32), (N, gps)).copy())
    g_valid = jnp.ones((N, gps), bool)
    g_fresh = jnp.zeros((N, gps), bool)
    delivered = dropped = 0
    for pos in rk.super_inputs():
        res = rt.call_batch_rounds(JPlayer, "heartbeat", keys, {"pos": pos},
                                   plan=plan, device_results=True)
        rkeys, recv, rv, drops = rt.route(
            GameGrain, d_game, {"beats": res["beats"][-1]}, d_valid,
            capacity=rk.CAPACITY)
        rk_np, rv_np = np.asarray(rkeys), np.asarray(rv)
        counts = np.stack([np.asarray(j_segment_sum(
            jnp.asarray(rv_np[s].astype(np.int32)),
            jnp.asarray(rk_np[s] % gps), gps)) for s in range(N)])
        rt.call_batch_device(GameGrain, "accumulate", g_slots, g_slots,
                             g_fresh, g_valid, {"n": jnp.asarray(counts)})
        delivered += int(rv_np.sum())
        dropped += int(np.asarray(drops).sum())
        out.update(sp_game=res["game"], sp_beats=res["beats"],
                   sp_recv_keys=rkeys, sp_recv_beats=recv["beats"],
                   sp_recv_valid=rv, sp_drops=drops, sp_counts=counts)
    for k, v in tbl.snapshot().items():
        out[f"sp_player_{k}"] = v[:, :tbl.capacity]
    out["sp_game_count"] = gt.snapshot()["count"][:, :gt.capacity]
    out["sp_delivered"] = np.int64(delivered)
    out["sp_dropped"] = np.int64(dropped)

    host = rt.replicated_host(HitsGrain, rk.HITS_KEYS)
    hkeys, vals = rk.hits_inputs()
    for i, (lo, hi) in enumerate(rk.HITS_BATCHES):
        out[f"hits_calls_{i}"] = host.call_batch(
            "see", hkeys[lo:hi], {"v": vals[lo:hi]})
    for k, v in host.state.items():
        out[f"hits_rows_{k}"] = v[:, :rk.HITS_KEYS]
    for k, v in host.read_merged(np.arange(rk.HITS_KEYS)).items():
        out[f"hits_merged_{k}"] = v

    # the sparse route and Phase G's fan-out: the sample's own drives,
    # run through the JAX package's runtime and grains
    out.update(asyncio.run(rk.sparse_drive(
        JRuntime(mesh=j_mesh(N), capacity_per_shard=64), CounterVec,
        slice(None), jnp.asarray, np.asarray)))

    def remesh(m):
        return JRuntime(mesh=j_mesh(m), capacity_per_shard=-(-rk.FAN_SUBS
                                                             // m))
    out.update(asyncio.run(rk.fanout_drive(remesh(N), FanVec, remesh,
                                           j_reshard)))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Each world's ranks, started once for the module (the worlds side
    by side, each joined within 60 s): the futures of their outputs."""
    dirs = {w: str(tmp_path_factory.mktemp(f"world{w}")) for w in WORLDS}
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        yield {w: pool.submit(rk.spawn, w, dirs[w], "cpu", 60.0)
               for w in WORLDS}


@pytest.fixture(scope="module")
def jax_ref(spawned):
    return _jax_reference()  # in this process while the ranks run


@pytest.fixture(scope="module")
def ranks(spawned, jax_ref):
    """Each world's rank outputs."""
    return {w: run.result() for w, run in spawned.items()}


@pytest.fixture(scope="module")
def one_device():
    return rk.run_all(make_mesh(N, "cpu"))


def _whole(ranks_out: list, key: str) -> np.ndarray:
    """The ranks' outputs of ``key`` stacked along the shard axis (dim 1
    of the [K, n, B] round results)."""
    axis = 1 if key in ("sp_game", "sp_beats") else 0
    return np.concatenate([r[key] for r in ranks_out], axis=axis)


def _eq(got, want, key):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (key, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=key)


SHARDED = {
    "exchange": ["ex_recv_x", "ex_recv_h", "ex_valid", "ex_drops"],
    "super": ["sp_game", "sp_beats", "sp_recv_keys", "sp_recv_beats",
              "sp_recv_valid", "sp_drops", "sp_counts", "sp_player_pos",
              "sp_player_beats", "sp_player_game", "sp_game_count"],
    "replica_rows": ["hits_rows_hits", "hits_rows_peak", "hits_rows_low"],
    "sparse_route": ["sv_recv_lo", "sv_recv_hi", "sv_recv_amount",
                     "sv_recv_valid", "sv_drops", "sv_rounds",
                     "sv_rows_total", "sv_rows_hits"],
    "fanout_rows": ["fo_rows_events", "fo_rows_last"],
    "reshard_rows": [f"rs_rows_{m}_{f}" for m in (rk.FAN_SHRINK, N)
                     for f in ("events", "last")],
}
WHOLE = {  # every rank holds the whole value
    "super_totals": ["sp_delivered", "sp_dropped"],
    "merged_reads": ["hits_merged_hits", "hits_merged_peak",
                     "hits_merged_low"],
    "replica_calls": ["hits_calls_0", "hits_calls_1", "hits_calls_2"],
    "sparse_calls": ["sv_activate", "sv_skewed", "sv_locs", "sv_dir_count",
                     "sv_totals", "sv_mapped", "sv_red_sum", "sv_red_max",
                     "sv_red_min"],
    "fanout_totals": ["fo_delivered", "fo_calls", "fo_red_sum",
                      "fo_red_max", "fo_red_min", "fo_red_mean",
                      "fo_mapped", "fo_ready", "fo_red_after_map"],
    "reshard_totals": [f"rs_red_{m}" for m in (rk.FAN_SHRINK, N)],
}
CASES = sorted(SHARDED) + sorted(WHOLE)
RTOL = {"fo_red_mean": 1e-6}  # a float sum over ranks, then a division


def _check(ranks_out: list, ref: dict, case: str) -> None:
    world = len(ranks_out)
    if case.startswith("reshard") and rk.FAN_SHRINK % world:
        # 4 shards do not divide over this world: every rank refused
        for r in ranks_out:
            assert f"do not divide over {world} ranks" in \
                str(r["fo_reshard_refused"])
            assert not any(k.startswith("rs_") for k in r)
        return
    for key in SHARDED.get(case, []):
        _eq(_whole(ranks_out, key), ref[key], key)
    for key in WHOLE.get(case, []):
        for r in ranks_out:
            if key in RTOL:
                got, want = np.asarray(r[key]), np.asarray(ref[key])
                assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
                np.testing.assert_allclose(got, want, rtol=RTOL[key],
                                           err_msg=key)
            else:
                _eq(r[key], ref[key], key)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_equal_the_jax_mesh(ranks, jax_ref, world, case):
    _check(ranks[world], jax_ref, case)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_equal_the_one_device_port(ranks, one_device, world, case):
    _check(ranks[world], one_device, case)


@pytest.mark.parametrize("world", WORLDS)
def test_scenarios_exercise_overflow_and_deliver_every_message(ranks,
                                                               world):
    out = ranks[world]
    # the exchange case overflows its 3 lanes a pair: drops are counted
    ex_valid = rk.exchange_inputs()[1]
    drops = int(_whole(out, "ex_drops").sum())
    assert drops > 0
    assert int(_whole(out, "ex_valid").sum()) + drops == int(ex_valid.sum())
    # the super routes every player's message to its game every super
    assert int(out[0]["sp_delivered"]) == rk.SUPERS * rk.N_PLAYERS
    assert int(out[0]["sp_dropped"]) == 0
    gps = rk.N_GAMES // N  # games a shard
    counts = _whole(out, "sp_game_count")[:, :gps].reshape(-1)
    want = np.bincount(np.arange(rk.N_PLAYERS) % rk.N_GAMES,
                       minlength=rk.N_GAMES) * rk.SUPERS
    np.testing.assert_array_equal(counts, want)
    # the sparse route's duplicate target deferred one lane a tick, and
    # every routed lane applied
    rounds = _whole(out, "sv_rounds")
    assert rounds.max() == 1
    assert ((rounds >= 0) == _whole(out, "sv_recv_valid")).all()
    # every broadcast edge landed; the busy keys' calls ran first
    assert int(out[0]["fo_delivered"]) == rk.FAN_EVENTS * rk.FAN_SUBS
    assert int(out[0]["fo_red_sum"]) == int(out[0]["fo_delivered"]) \
        + rk.FAN_BUSY


@pytest.mark.parametrize("world", WORLDS)
def test_join_when_times_out_on_every_rank_at_the_same_poll(ranks, world):
    """Rank r entered ``join_when`` JOIN_DRIFT * r s late, so its own
    deadline fell polls after rank 0's; the ranks agreed on it at every
    poll, so each raised ``TimeoutError`` on the same poll (the group
    joined within its 60 s, so no rank was left waiting in a reduction)."""
    out = ranks[world]
    assert all(bool(r["jt_raised"]) for r in out)
    polls = {int(r["jt_polls"]) for r in out}
    assert len(polls) == 1 and polls.pop() >= 1


# ---------------------------------------------------------------------------
# A group of one rank inside this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    """A gloo group of world 1 in the test process (a FileStore in a
    temporary directory), destroyed at the end of the module."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("g1") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_group_of_one_equals_the_one_device_port(group1, one_device):
    got = rk.run_all(make_mesh(N, "cpu", group=group1))
    assert sorted(got) == sorted(one_device)
    for k, v in one_device.items():
        _eq(got[k], v, k)


def test_group_mesh_shape_and_backend_checks(group1):
    mesh = make_mesh(N, "cpu", group=group1)
    assert (mesh.n_shards, mesh.n_local, mesh.shard0, mesh.rank,
            mesh.world) == (N, N, 0, 0, 1)
    one = make_mesh(N, "cpu")
    assert (one.n_local, one.shard0, one.group) == (N, 0, None)
    t = torch.tensor([3, -1], dtype=torch.int32)
    for op in ("sum", "max", "min"):
        _eq(all_reduce(mesh, t, op), t, op)
        assert all_reduce(one, t, op) is t
    with pytest.raises(ValueError, match="unknown reduce op"):
        all_reduce(mesh, t, "mean")


def _refusals(mesh):
    """Every entry point that does not run across ranks, as a callable
    over a fresh runtime on ``mesh``: hosting, the off-loop worker and
    ``move_rows`` between ranks."""
    def moved():
        r = TRuntime(mesh, capacity_per_shard=64)
        tbl = r.table(rk.CounterVec)
        tbl.lookup_or_allocate(1 << 40)
        return tbl.move_rows([1 << 40], [1])

    return {
        "hosting": lambda: add_vector_grains(object(), rk.PlayerGrain,
                                             mesh=mesh),
        "offloop_tick": lambda: TRuntime(mesh, options=DispatchOptions(
            capacity_per_shard=64, offloop_tick=True)),
        "move_rows": moved,
    }


REFUSED = sorted(_refusals(make_mesh(1, "cpu")))


@pytest.mark.parametrize("entry", REFUSED)
def test_entry_points_off_the_path_raise_naming_the_roadmap(group1, entry):
    with pytest.raises(GroupMeshError, match="ROADMAP Queue 4 item 1"):
        _refusals(make_mesh(N, "cpu", group=group1))[entry]()


def test_offloop_lever_set_on_a_built_engine_raises_on_a_group(group1):
    """The lever set on a built engine (as a silo sets it) refuses at
    once on a group mesh, and stays off."""
    rt = TRuntime(make_mesh(N, "cpu", group=group1), capacity_per_shard=64)
    with pytest.raises(GroupMeshError, match="off-loop tick"):
        rt.offloop_tick = True
    assert rt.offloop_tick is False
    rt.offloop_tick = False


_HASHES = rk.sparse_hashes()


def _hashed_dest(mesh):
    """Phase 4's route inputs (this process's rows) as tensors."""
    dest, amount = rk.sparse_inputs()
    lo, hi = split64(dest)
    dev = torch.from_numpy
    return ((dev(lo), dev(hi)), {"amount": dev(amount)},
            torch.ones(dest.shape, dtype=torch.bool))


async def _activate(r):
    return await asyncio.gather(*(r.call(rk.CounterVec, h, "add",
                                         amount=np.int32(1))
                                  for h in _HASHES))


def _entries(mesh):
    """Every entry point that now runs across ranks, as ``async fn(rt)``
    over a fresh runtime on ``mesh`` (FanVec dense over FAN_SUBS keys),
    returning what it answered."""
    v = np.float32(0.5)
    targets = np.array([1, 1, 5, 300, 7, 7, 7, 299])

    async def actor(r):
        ref = r.actor(rk.CounterVec, "player-7")
        return [ref.key_hash, await ref.add(amount=np.int32(5)),
                await ref.add(amount=np.int32(2))]

    async def call(r):
        return await asyncio.gather(*(
            r.call(rk.FanVec, k, "on_next", v=np.float32(k))
            for k in (3, 3, 17, 300, 3)))

    async def call_group(r):
        return await asyncio.gather(*r.call_group(rk.FanVec, "on_next", [
            (k, {"v": np.float32(k)}, True) for k in (9, 40, 9, 41)]))

    async def call_packed(r):
        futs = r.call_packed(rk.FanVec, "on_next", [2, 200, 2],
                             {"v": np.float32([1, 2, 3])},
                             [True, True, True])
        return await asyncio.gather(*futs)

    async def map_actors(r):
        await call_group(r)
        return await r.map_actors(rk.FanVec, "on_next", {"v": v})

    async def reduce_actors(r):
        await r.broadcast_actors(rk.FanVec, "on_next", targets, {"v": v})
        return [await r.reduce_actors(rk.FanVec, "events", combine=c)
                for c in ("sum", "max", "min", "mean")]

    async def reduce_actors_partial(r):
        await r.broadcast_actors(rk.FanVec, "on_next", targets, {"v": v})
        return await r.reduce_actors_partial(rk.FanVec, "events",
                                             combine="mean")

    async def broadcast_actors(r):
        busy = r.call(rk.FanVec, 7, "on_next", v=np.float32(-1))
        got = await r.broadcast_actors(
            rk.FanVec, "on_next", targets,
            {"v": np.arange(targets.size, dtype=np.float32)}, chunk=4)
        return [got, await busy]

    async def stream_fanout(r):
        return await r.stream_fanout(rk.FanVec, "on_next", targets,
                                     {"v": v}, chunk=3)

    async def join_when(r):
        await r.broadcast_actors(rk.FanVec, "on_next", targets, {"v": v})
        return await r.join_when(rk.FanVec, np.unique(targets),
                                 method="ready", timeout=5)

    async def route_sparse(r):
        await _activate(r)
        rkeys, rpay, rvalid, drops = r.route(rk.CounterVec,
                                             *_hashed_dest(mesh),
                                             sparse=True)
        return [rkeys, rpay, rvalid, drops]

    async def apply_received_sparse(r):
        await _activate(r)
        rkeys, rpay, rvalid, _ = r.route(rk.CounterVec, *_hashed_dest(mesh),
                                         sparse=True)
        applied_masks = []
        while bool(rvalid.any()):
            _, applied = r.apply_received(rk.CounterVec, "add", rkeys,
                                          rvalid, rpay, sparse=True)
            applied_masks.append(applied)
            rvalid = rvalid & ~applied
        return applied_masks

    async def hashed_key(r):
        tbl = r.table(rk.CounterVec)
        # 70 keys on shard 0 outgrow its 64 slots: grow on every rank
        locs = [tbl.lookup_or_allocate(N * i + (1 << 40))
                for i in range(70)]
        tbl.release(1 << 40)
        locs.append(tbl.lookup_or_allocate(1 << 41))
        return [locs, tbl.capacity, tbl.device_dir.count,
                tbl.read_row(N + (1 << 40))]

    async def reshard(r):
        await r.broadcast_actors(rk.FanVec, "on_next", targets, {"v": v})
        out = []
        tbl = r.table(rk.FanVec)
        for m in (rk.FAN_SHRINK, N):
            r2 = TRuntime(make_mesh(m, "cpu", group=mesh.group),
                          capacity_per_shard=-(-rk.FAN_SUBS // m))
            tbl = reshard_dense(tbl, r2)
            out.append([tbl.snapshot()["events"][:, :tbl.capacity],
                        await r2.reduce_actors(rk.FanVec, "events")])
        return out

    return {f.__name__: f for f in (
        actor, call, call_group, call_packed, map_actors, reduce_actors,
        reduce_actors_partial, broadcast_actors, stream_fanout, join_when,
        route_sparse, apply_received_sparse, hashed_key, reshard)}


ENTRIES = sorted(_entries(make_mesh(1, "cpu")))


def _run_entry(mesh, name):
    """(answer, FanVec and CounterVec rows) of one entry point, as
    numpy, over a fresh runtime on ``mesh``."""
    r = TRuntime(mesh, capacity_per_shard=64)
    r.table(rk.FanVec).ensure_dense(rk.FAN_SUBS)
    got = asyncio.run(asyncio.wait_for(_entries(mesh)[name](r), 30))

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.cpu().numpy()
        if isinstance(x, dict):
            return {k: host(v) for k, v in sorted(x.items())}
        if isinstance(x, (list, tuple)):
            return [host(v) for v in x]
        return np.asarray(x)
    rows = {f"{c.__name__}_{k}": v[:, :r.table(c).capacity]
            for c in (rk.FanVec, rk.CounterVec)
            for k, v in r.table(c).snapshot().items()}
    return [host(got), rows]


def _same(got, want, where):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    else:
        _eq(got, want, where)


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_run_on_a_group_of_one_as_on_one_device(group1, entry):
    """Each entry point that used to raise ``GroupMeshError`` runs on a
    gloo group of one rank and answers, and leaves its tables, exactly
    as on the one-device port."""
    got = _run_entry(make_mesh(N, "cpu", group=group1), entry)
    want = _run_entry(make_mesh(N, "cpu"), entry)
    _same(got, want, entry)


def test_gather_and_agree_on_a_group_of_one(group1):
    mesh = make_mesh(N, "cpu", group=group1)
    for t in (torch.arange(N * 6, dtype=torch.int32).reshape(N, 3, 2),
              torch.tensor([[True, False]] * N),
              torch.randn(N, 3).to(torch.float16)):
        _eq(gather(mesh, t), t, str(t.dtype))
    assert agree(mesh, True) and not agree(mesh, False)
    one = make_mesh(N, "cpu")
    t = torch.ones(N, 2)
    assert gather(one, t) is t and agree(one, 1) is True


def test_reshard_between_meshes_over_different_groups_raises(group1):
    """Across ranks both meshes of a reshard span the same group; a
    group mesh and a one-device mesh do not, and the refusal names each
    mesh's world."""
    rt = TRuntime(make_mesh(N, "cpu", group=group1), capacity_per_shard=64)
    rt.table(rk.FanVec).ensure_dense(rk.FAN_SUBS)
    with pytest.raises(ValueError, match="over 1 rank"):
        reshard_dense(rt.table(rk.FanVec),
                      TRuntime(make_mesh(rk.FAN_SHRINK, "cpu")))


def test_dense_read_row_of_a_key_on_another_rank_raises():
    """A table of rank 1's shards (built over a group mesh's fields
    without a group, so no collective runs) refuses a dense key that
    lives on rank 0."""
    from orleans_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(N, torch.device("cpu"), group=None, rank=1, world=2)
    tbl = TRuntime(mesh, capacity_per_shard=64).table(rk.PlayerGrain)
    tbl.ensure_dense(rk.N_PLAYERS)
    assert (tbl.n_shards, tbl.n_global, tbl.shard0) == (4, 8, 4)
    assert tbl.read_row(rk.N_PLAYERS - 1) is not None
    with pytest.raises(ValueError, match="not on rank 1"):
        tbl.read_row(0)


def test_spawned_ranks_past_their_limit_are_killed(tmp_path):
    with pytest.raises(TimeoutError, match="killed"):
        rk.spawn(2, str(tmp_path), "cpu", timeout=0.2)


# ---------------------------------------------------------------------------
# One shard, every lane valid: a pass-through field under the scan
# ---------------------------------------------------------------------------

def test_scan_on_one_full_shard_with_a_pass_through_field():
    """K scanned rounds on a one-shard table whose batch is all valid
    lanes read the pool as a view; a field the handler passes through
    unchanged is that view. The port used to write it over itself, which
    torch refuses; it now equals the JAX package's run."""
    JPlayer = __graft_entry__._player_class()
    n = 16
    keys = np.arange(n)
    pos = np.random.default_rng(3).standard_normal(
        (2, n, 2)).astype(np.float16)
    jrt = JRuntime(mesh=j_mesh(1), capacity_per_shard=n)
    trt = TRuntime(make_mesh(1, "cpu"), capacity_per_shard=n)
    jrt.table(JPlayer).ensure_dense(n)
    trt.table(rk.PlayerGrain).ensure_dense(n)
    jout = jrt.call_batch_rounds(JPlayer, "heartbeat", keys, {"pos": pos})
    tout = trt.call_batch_rounds(rk.PlayerGrain, "heartbeat", keys,
                                 {"pos": pos})
    for k in ("game", "beats"):
        _eq(tout[k], np.asarray(jout[k]), k)
    js = jrt.table(JPlayer).snapshot()
    ts = trt.table(rk.PlayerGrain).snapshot()
    for k in js:
        _eq(ts[k][:, :n], np.asarray(js[k])[:, :n], k)
