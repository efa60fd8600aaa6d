"""The silo axis across ranks: the port's process-group mesh, exchange,
Phase B's super and merged reads, on gloo ranks on the CPU.

``samples/ranks_torch.py`` runs each scenario (the exchange with
overflow, ``bench.py --devices 8``'s super at ``dryrun_multichip(8)``'s
shapes, a replicated worker's calls and merged reads) on every rank of a
gloo group: 2 ranks of 4 shards and 8 ranks of 1. The ranks are spawned
once for the module, as fresh interpreters joined through a file in a
temporary directory (no port), each group within 60 s or killed. Their
outputs, stacked along the shard axis, are held against the same inputs
through the JAX package on its 8-virtual-device mesh (``all_to_all``,
``psum``/``pmax``/``pmin``) and through the one-device port.
Tolerance: exact. Every value compared is an integer or a bool, except
the float32 player positions and the float16 payload of the exchange,
which are copied, never summed, so they are equal bit for bit too.
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
from orleans_tpu.dispatch.replicated import replicated_worker as j_repl
from orleans_tpu.ops import segment_sum as j_segment_sum
from orleans_tpu.parallel import make_mesh as j_mesh
from orleans_tpu.parallel.transport import build_exchange as j_exchange
from orleans_tpu_torch.dispatch import VectorRuntime as TRuntime
from orleans_tpu_torch.dispatch import add_vector_grains, reshard_dense
from orleans_tpu_torch.parallel import GroupMeshError, all_reduce, make_mesh

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
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world's rank outputs, spawned once for the module (the
    worlds side by side, each joined within 60 s)."""
    dirs = {w: str(tmp_path_factory.mktemp(f"world{w}")) for w in WORLDS}
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {w: pool.submit(rk.spawn, w, dirs[w], "cpu", 60.0)
                for w in WORLDS}
        return {w: run.result() for w, run in runs.items()}


@pytest.fixture(scope="module")
def jax_ref():
    return _jax_reference()


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
}
WHOLE = {  # every rank holds the whole value
    "super_totals": ["sp_delivered", "sp_dropped"],
    "merged_reads": ["hits_merged_hits", "hits_merged_peak",
                     "hits_merged_low"],
    "replica_calls": ["hits_calls_0", "hits_calls_1", "hits_calls_2"],
}
CASES = sorted(SHARDED) + sorted(WHOLE)


def _check(ranks_out: list, ref: dict, case: str) -> None:
    for key in SHARDED.get(case, []):
        _eq(_whole(ranks_out, key), ref[key], key)
    for key in WHOLE.get(case, []):
        for r in ranks_out:
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
    over a fresh runtime on ``mesh``."""
    def rt():
        r = TRuntime(mesh, capacity_per_shard=64)
        r.table(rk.PlayerGrain).ensure_dense(rk.N_PLAYERS)
        return r

    def aw(coro_fn):
        async def run():
            return await coro_fn()
        return lambda: asyncio.run(run())

    keys = np.arange(4)
    lo = hi = torch.zeros((mesh.n_local, 2), dtype=torch.int32)
    valid = torch.ones((mesh.n_local, 2), dtype=torch.bool)

    async def call():
        return await rt().call(rk.PlayerGrain, 3, "heartbeat",
                               pos=np.zeros(2, np.float16))

    async def call_group():
        return rt().call_group(rk.PlayerGrain, "heartbeat", [
            (3, {"pos": np.zeros(2, np.float16)}, True)])

    return {
        "actor": lambda: rt().actor(rk.PlayerGrain, 3),
        "call": aw(call),
        "call_group": aw(call_group),
        "map_actors": aw(lambda: rt().map_actors(
            rk.PlayerGrain, "heartbeat", keys)),
        "reduce_actors": aw(lambda: rt().reduce_actors(
            rk.PlayerGrain, "heartbeat", keys)),
        "reduce_actors_partial": aw(lambda: rt().reduce_actors_partial(
            rk.PlayerGrain, "heartbeat", keys)),
        "broadcast_actors": aw(lambda: rt().broadcast_actors(
            rk.PlayerGrain, "heartbeat", {"pos": np.zeros(2, np.float16)},
            keys)),
        "stream_fanout": aw(lambda: rt().stream_fanout(
            rk.PlayerGrain, "heartbeat", keys, {})),
        "join_when": aw(lambda: rt().join_when(rk.PlayerGrain, keys,
                                               method="heartbeat")),
        "route_sparse": lambda: rt().route(
            rk.PlayerGrain, (lo, hi), {}, valid, sparse=True),
        "apply_received_sparse": lambda: rt().apply_received(
            rk.PlayerGrain, "heartbeat", (lo, hi), valid, {}, sparse=True),
        "hashed_key": lambda: rt().table(rk.GameGrain).lookup_or_allocate(
            1 << 40),
        "hosting": lambda: add_vector_grains(object(), rk.PlayerGrain,
                                             mesh=mesh),
        "reshard_dense": lambda: reshard_dense(
            rt().table(rk.PlayerGrain), TRuntime(make_mesh(4, "cpu"))),
    }


REFUSED = sorted(_refusals(make_mesh(1, "cpu")))


@pytest.mark.parametrize("entry", REFUSED)
def test_entry_points_off_the_path_raise_naming_the_roadmap(group1, entry):
    with pytest.raises(GroupMeshError, match="ROADMAP Queue 4 item 1"):
        _refusals(make_mesh(N, "cpu", group=group1))[entry]()


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
