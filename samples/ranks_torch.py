"""``bench.py --devices N``'s super-round across the ranks of a process
group, on the port (orleans_tpu_torch).

The JAX package runs its multi-shard super as one program over a device
mesh: the K scanned heartbeat rounds on the sharded player table, the
route of every player's message to its GameGrain over the ``all_to_all``
exchange, the fan-in segment sum (K1) and the GameGrain tick, with merged
reads of replicated workers as ``psum``/``pmax``/``pmin``. Here each rank
is a process with one device and ``n_local`` of the mesh's shards
(``make_mesh(n, device, group=...)``), and every rank runs the same
program on its own shards: the exchange is one ``all_to_all_single`` a
tensor, the merged reads an ``all_reduce``.

Every scenario's inputs are made from a seed with numpy, so each rank
(and a reference run in another process) makes the same ones.

Run: ``python samples/ranks_torch.py --cpu --world 2`` spawns two gloo
ranks on the CPU with four shards each, runs the scenarios and holds the
ranks' outputs against the one-device port. A CUDA run needs a card a
rank (``--world`` at most the cards; NCCL refuses two ranks on one card).
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orleans_tpu_torch.dispatch import (VectorGrain, VectorRuntime,  # noqa
                                        actor_method, replicated_worker)
from orleans_tpu_torch.ops import segment_sum  # noqa: E402
from orleans_tpu_torch.parallel import all_reduce, make_mesh  # noqa: E402
from orleans_tpu_torch.parallel import build_exchange  # noqa: E402

N_SHARDS = 8
# dryrun_multichip(8)'s shapes (``__graft_entry__.py``)
N_PLAYERS = 16 * N_SHARDS
N_GAMES = 4 * N_SHARDS
K = 2
CAPACITY = 64  # per-(source, destination) exchange lanes
SUPERS = 2
EX_B, EX_CAPACITY = 16, 3  # the exchange case: overflow is dropped
HITS_KEYS, HITS_CALLS = 10, 40  # the merged-read case
# its call batches; the last holds one call, so most ranks run none
HITS_BATCHES = ((0, 25), (25, 39), (39, 40))


class PlayerGrain(VectorGrain):
    """``__graft_entry__._player_class()``: a heartbeat updates position
    and liveness and reports the player's game."""

    STATE = {"pos": (torch.float32, (2,)), "beats": (torch.int32, ()),
             "game": (torch.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"pos": key_hash.new_zeros(2, dtype=torch.float32),
                "beats": torch.zeros_like(key_hash), "game": key_hash % 64}

    @actor_method(args={"pos": (torch.float16, (2,))})
    def heartbeat(state, args):
        new = {"pos": args["pos"].to(torch.float32),
               "beats": state["beats"] + 1, "game": state["game"]}
        return new, {"game": new["game"], "beats": new["beats"]}


class GameGrain(VectorGrain):
    """bench.py's GameGrain: the fan-in target of the route."""

    STATE = {"count": (torch.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"count": torch.zeros_like(key_hash)}

    @actor_method(args={"n": (torch.int32, ())})
    def accumulate(state, args):
        new = {"count": state["count"] + args["n"]}
        return new, new["count"]


@replicated_worker
class HitsGrain(VectorGrain):
    """A replicated stateless worker whose reads merge its replicas by
    sum, max and min."""

    STATE = {"hits": (torch.int32, ()), "peak": (torch.int32, ()),
             "low": (torch.int32, ())}
    MERGE = {"hits": "sum", "peak": "max", "low": "min"}

    @staticmethod
    def initial_state(key_hash):
        return {"hits": torch.zeros_like(key_hash),
                "peak": torch.full_like(key_hash, -1),
                "low": key_hash + 100}

    @actor_method(args={"v": (torch.int32, ())})
    def see(state, args):
        new = {"hits": state["hits"] + 1,
               "peak": torch.maximum(state["peak"], args["v"]),
               "low": torch.minimum(state["low"], args["v"])}
        return new, new["hits"]


def exchange_inputs(seed: int = 5):
    """[N_SHARDS, EX_B] destinations, valid mask and payload (int32 and
    float16 pairs) of the exchange case."""
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, N_SHARDS, (N_SHARDS, EX_B)).astype(np.int32)
    valid = rng.random((N_SHARDS, EX_B)) < 0.8
    payload = {"x": rng.integers(-1000, 1000, (N_SHARDS, EX_B))
               .astype(np.int32),
               "h": rng.standard_normal((N_SHARDS, EX_B, 2))
               .astype(np.float16)}
    return dest, valid, payload


def super_inputs(seed: int = 7) -> list:
    """Each super's [K, N_PLAYERS, 2] float16 positions."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((K, N_PLAYERS, 2)).astype(np.float16)
            for _ in range(SUPERS)]


def hits_inputs(seed: int = 9):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, HITS_KEYS, HITS_CALLS),
            rng.integers(-50, 50, HITS_CALLS).astype(np.int32))


def run_exchange(mesh) -> dict:
    """The exchange case over ``mesh``'s shards (this rank's rows)."""
    dest, valid, payload = exchange_inputs()
    rows = slice(mesh.shard0, mesh.shard0 + mesh.n_local)

    def dev(a):
        return torch.from_numpy(a[rows]).to(mesh.device)
    recv, rv, drops = build_exchange(mesh, EX_CAPACITY)(
        dev(dest), dev(valid), {k: dev(v) for k, v in payload.items()})
    out = {f"ex_recv_{k}": v for k, v in recv.items()}
    out.update(ex_valid=rv, ex_drops=drops)
    return {k: v.cpu().numpy() for k, v in out.items()}


def run_super(mesh) -> dict:
    """bench.py's cross-shard super at dryrun_multichip's shapes, SUPERS
    times: the K scanned rounds, the route, the K1 fan-in and the game
    tick. Returns this rank's outputs of the last super and its tables."""
    rt = VectorRuntime(mesh, capacity_per_shard=64)
    tbl = rt.table(PlayerGrain)
    tbl.ensure_dense(N_PLAYERS)
    keys = np.arange(N_PLAYERS)
    plan = rt.make_dense_plan(PlayerGrain, keys)
    gt = rt.table(GameGrain)
    gt.ensure_dense(N_GAMES)
    gps = gt.dense_per_shard
    rt.call_batch(GameGrain, "accumulate", np.arange(N_GAMES),
                  {"n": np.zeros(N_GAMES, np.int32)})
    dev = mesh.device
    n = tbl.n_shards  # this rank's shards
    d_game = torch.from_numpy(plan.pack(keys % N_GAMES, torch.int32,
                                        ())).to(dev)
    d_valid = torch.from_numpy(plan.valid_b).to(dev)
    g_slots = torch.arange(gps, dtype=torch.int32, device=dev) \
        .expand(n, gps).contiguous()
    g_valid = torch.ones((n, gps), dtype=torch.bool, device=dev)
    g_fresh = torch.zeros((n, gps), dtype=torch.bool, device=dev)
    out: dict = {}
    delivered = dropped = 0
    for pos in super_inputs():
        res = rt.call_batch_rounds(PlayerGrain, "heartbeat", keys,
                                   {"pos": pos}, plan=plan,
                                   device_results=True)
        rk, recv, rv, drops = rt.route(
            GameGrain, d_game, {"beats": res["beats"][-1]}, d_valid,
            capacity=CAPACITY)
        counts = segment_sum(rv.to(torch.int32), rk % gps, gps)
        rt.call_batch_device(GameGrain, "accumulate", g_slots, g_slots,
                             g_fresh, g_valid, {"n": counts})
        delivered += int(all_reduce(mesh, rv.sum().to(torch.int64)))
        dropped += int(all_reduce(mesh, drops.sum().to(torch.int64)))
        out = {"sp_game": res["game"], "sp_beats": res["beats"],
               "sp_recv_keys": rk, "sp_recv_beats": recv["beats"],
               "sp_recv_valid": rv, "sp_drops": drops, "sp_counts": counts}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    for k, v in tbl.snapshot().items():
        out[f"sp_player_{k}"] = v[:, :tbl.capacity]  # the sink is junk
    out["sp_game_count"] = gt.snapshot()["count"][:, :gt.capacity]
    out["sp_delivered"] = np.int64(delivered)
    out["sp_dropped"] = np.int64(dropped)
    return out


def run_hits(mesh) -> dict:
    """The merged-read case: calls in HITS_BATCHES, then a merged read
    of every key."""
    rt = VectorRuntime(mesh, capacity_per_shard=64)
    host = rt.replicated_host(HitsGrain, HITS_KEYS)
    keys, vals = hits_inputs()
    out = {f"hits_calls_{i}": host.call_batch(
        "see", keys[lo:hi], {"v": vals[lo:hi]})
        for i, (lo, hi) in enumerate(HITS_BATCHES)}
    for k, v in host.state.items():
        out[f"hits_rows_{k}"] = v[:, :HITS_KEYS].cpu().numpy()
    for k, v in host.read_merged(np.arange(HITS_KEYS)).items():
        out[f"hits_merged_{k}"] = v
    return out


def run_all(mesh) -> dict:
    return {**run_exchange(mesh), **run_super(mesh), **run_hits(mesh)}


def rank_main(rank: int, world: int, init: str, out: str,
              device: str) -> None:
    """One rank: join the group through the file at ``init``, run every
    scenario over ``N_SHARDS`` shards and save this rank's outputs to
    ``out``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    backend = "nccl" if device == "cuda" else "gloo"
    dev = torch.device("cuda", rank) if device == "cuda" else device
    if device == "cuda":
        torch.cuda.set_device(dev)  # one card a rank
    dist.init_process_group(backend, init_method=f"file://{init}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(N_SHARDS, dev, group=dist.group.WORLD)
        np.savez(out, **run_all(mesh))
    finally:
        dist.destroy_process_group()


def launch(argvs: list[list[str]], timeout: float) -> list[str]:
    """Run one fresh process a rank (``argvs[r]``) and return each one's
    output. Every rank is joined within ``timeout`` seconds in all; past
    it every rank still running is killed and this raises, so a
    mismatched collective fails instead of hanging."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for argv in argvs]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            left = max(0.0, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"{len(procs)} ranks did not finish within "
                           f"{timeout} s; killed") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, logs[r][-2000:])
           for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks failed: {bad}")
    return logs


def spawn(world: int, workdir: str, device: str = "cpu",
          timeout: float = 60.0) -> list[dict]:
    """Run ``world`` ranks of :func:`rank_main` as fresh processes
    (:func:`launch`) and return each rank's outputs."""
    init = os.path.join(workdir, "init")
    outs = [os.path.join(workdir, f"rank{r}.npz") for r in range(world)]
    launch([[sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(world), "--init", init, "--out", outs[r]]
            + (["--cpu"] if device == "cpu" else [])
            for r in range(world)], timeout)
    result = []
    for path in outs:
        with np.load(path) as z:
            result.append({k: z[k] for k in z.files})
    return result


def check_against_one_device(ranks: list[dict], device: str) -> None:
    """The ranks' outputs, stacked along the shard axis, equal the same
    scenarios on a one-device mesh of N_SHARDS shards, exactly."""
    one = run_all(make_mesh(N_SHARDS, device))
    for k, want in one.items():
        if k.startswith(("sp_delivered", "sp_dropped", "hits_calls",
                         "hits_merged")):
            got = [r[k] for r in ranks]  # every rank holds the whole
        else:
            axis = 1 if k in ("sp_game", "sp_beats") else 0
            got = [np.concatenate([r[k] for r in ranks], axis=axis)]
        for g in got:
            np.testing.assert_array_equal(g, want, err_msg=k)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (else NCCL, a card each)")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="seconds for every rank to finish")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init")
    ap.add_argument("--out")
    a = ap.parse_args()
    device = "cpu" if a.cpu else "cuda"
    if a.rank is not None:
        rank_main(a.rank, a.world, a.init, a.out, device)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn(a.world, tmp, device, a.timeout)
        wall = time.perf_counter() - t0
    check_against_one_device(ranks, device)
    print(f"{a.world} {device} ranks x {N_SHARDS // a.world} shards: "
          f"exchange, {SUPERS} supers ({int(ranks[0]['sp_delivered'])} "
          f"messages delivered, {int(ranks[0]['sp_dropped'])} dropped) and "
          f"merged reads equal to one {N_SHARDS}-shard device, exactly "
          f"({wall:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
