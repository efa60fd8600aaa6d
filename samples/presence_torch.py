"""Presence on the port's device tier (orleans_tpu_torch), end to end.

The port's twin of ``presence_tpu.py``: Orleans' Presence sample
(PlayerGrain heartbeats fan into GameGrain summaries), two-tier, hosted
in an in-proc silo on PyTorch:

* PlayerVectorGrain is a **VectorGrain**: players live as rows of a
  sharded table on the card; heartbeat waves arrive as bulk batches and
  run as one tick each.
* GameGrain stays a **host grain**: it summarizes its players from the
  device table with one fan-in segment sum (``ops.segment_sum``, the
  hand-written K1 kernel on a CUDA table) instead of a message per
  player. It reads the table under the engine's tick fence, because the
  off-loop tick worker writes the slot pools in place.
* Single players are called through the ordinary client surface —
  ``client.get_grain(PlayerVectorGrain, k).whereis()`` — and coalesce
  into ticks with everyone else's.
* Write-behind persistence keeps per-player state durable
  (``MemoryStorage`` here; any GrainStorage provider works).
* GameJournalGrain keeps a game's summaries as an event journal: a
  durable reminder fires it, it reads the game's ``summary`` and records
  it as a confirmed event (reminders and event sourcing on the host tier
  over the same device table).

Run: ``python samples/presence_torch.py`` on a CUDA card, or
``python samples/presence_torch.py --cpu`` to run the plain versions on
the CPU. ``--tcp`` hosts the silo on a ``SocketFabric`` and calls it from
a ``GatewayClient`` over a real TCP gateway (the path of a client in its
own process), e.g. ``python samples/presence_torch.py --cpu --tcp
--players 20000``.
"""

import argparse
import asyncio
import os
import sys
import tempfile
import time
from contextlib import nullcontext
from types import SimpleNamespace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from orleans_tpu_torch.eventsourcing import JournaledGrain  # noqa: E402
from orleans_tpu_torch.dispatch import (  # noqa: E402
    VectorGrain,
    actor_method,
    add_vector_grains,
)
from orleans_tpu_torch.ops import segment_sum  # noqa: E402
from orleans_tpu_torch.parallel import make_mesh  # noqa: E402
from orleans_tpu_torch.membership import (  # noqa: E402
    FileMembershipTable,
    join_cluster,
)
from orleans_tpu_torch.runtime import (  # noqa: E402
    ClusterClient,
    GatewayClient,
    Grain,
    SiloBuilder,
    SocketFabric,
)
from orleans_tpu_torch.storage import MemoryStorage  # noqa: E402

N_GAMES = 64
STALL_S = 0.02  # a gap between two event-loop wake-ups counted as a stall


class PlayerVectorGrain(VectorGrain):
    """PlayerGrain (Samples/Presence/Grains/PlayerGrain.cs:14), vectorized:
    heartbeat updates position/score; game id fixed at activation."""

    STATE = {
        "pos": (torch.float32, (2,)),
        "score": (torch.int32, ()),
        "game": (torch.int32, ()),
    }

    @staticmethod
    def initial_state(key_hash):
        return {"pos": key_hash.new_zeros(2, dtype=torch.float32),
                "score": torch.zeros_like(key_hash),
                "game": key_hash % N_GAMES}

    @actor_method(args={"pos": (torch.float16, (2,)),
                        "delta": (torch.int32, ())})
    def heartbeat(state, args):
        new = {"pos": args["pos"].to(torch.float32),
               "score": state["score"] + args["delta"],
               "game": state["game"]}
        return new, new["score"]

    @actor_method(args={}, read_only=True)
    def whereis(state, args):
        return state, state["pos"]

    @actor_method(args={}, read_only=True)
    def get_score(state, args):
        return state, state["score"]

    @actor_method(args={}, read_only=True)
    def ready(state, args):
        return state, (state["score"] > 0).to(torch.int32)


def game_operands(tbl) -> tuple[torch.Tensor, torch.Tensor]:
    """The fan-in's operands over the table's dense players: values
    [n, 2] int32 (score, 1) and ids [n], each player's game, or -1 for a
    player not yet activated (free slots and the sink are left out). The
    caller holds the tick fence."""
    per, n = tbl.dense_per_shard, tbl.dense_n
    game = tbl.state["game"][:, :per].reshape(-1)[:n]
    score = tbl.state["score"][:, :per].reshape(-1)[:n]
    active = torch.from_numpy(tbl.dense_active).to(game.device)
    ids = torch.where(active, game, torch.full_like(game, -1))
    return torch.stack([score, torch.ones_like(score)], dim=1), ids


def game_totals(tbl) -> torch.Tensor:
    """[N_GAMES, 2] int32: each game's total score and player count, in
    one segment sum. The caller holds the tick fence."""
    return segment_sum(*game_operands(tbl), N_GAMES)


class GameGrain(Grain):
    """GameGrain (host tier): summarizes its players from the device
    table — one segment sum instead of a message per player."""

    async def summary(self) -> dict:
        rt = self.runtime.vector
        game = int(self.primary_key)
        with rt.tick_fence():
            totals = game_totals(rt.table(PlayerVectorGrain))[game].cpu()
        return {"game": game, "total_score": int(totals[0]),
                "players": int(totals[1])}


class GameJournalGrain(JournaledGrain):
    """A game's summaries as a journal (log storage on the ``Default``
    provider): each tick of its ``summary`` reminder reads the game's
    :meth:`GameGrain.summary` (one fan-in on the device table) and
    records ``(total_score, players)`` as one confirmed event."""

    def initial_state(self):
        return []

    def apply_event(self, state, event):
        return state + [event]

    async def start_summaries(self, period: float) -> None:
        await self.register_reminder("summary", period, period)

    async def receive_reminder(self, name, status) -> None:
        s = await self.get_grain(GameGrain, self.primary_key).summary()
        self.raise_event((s["total_score"], s["players"]))
        await self.confirm_events()

    async def journal(self) -> tuple[int, list]:
        return self.version, list(self.state)


def build_silo(n_players: int, mesh, storage=None, flush_period=0.5,
               checkpoint_dir=None, membership=None, setup=None, **config):
    """A silo hosting ``n_players`` dense PlayerVectorGrains on ``mesh``
    beside the GameGrain host grain. With a ``membership`` table the silo
    is built on a new ``SocketFabric`` (its own TCP listener and gateway)
    and joined to the table. ``setup(builder)``, when given, adds to the
    builder before the silo is built (more grains, storage, services)."""
    b = SiloBuilder().with_name("presence-torch").add_grains(GameGrain)
    if membership is not None:
        b.with_fabric(SocketFabric())
    if config:
        b.with_config(**config)
    if setup is not None:
        setup(b)
    add_vector_grains(b, PlayerVectorGrain,
                      dense={PlayerVectorGrain: n_players}, mesh=mesh,
                      capacity_per_shard=-(-n_players // mesh.n_shards),
                      storage=storage, flush_period=flush_period,
                      checkpoint_dir=checkpoint_dir)
    silo = b.build()
    if membership is not None:
        join_cluster(silo, membership)
    return silo


def gateway_client(gateway_cls=GatewayClient, response_timeout=30.0):
    """A ``client_cls`` for :func:`drive_presence` that dials
    ``gateway_cls`` (the ``GatewayClient`` of either package) to the
    gateway of the silo on the ``SocketFabric`` it is given, so the same
    drive runs over TCP; each silo the drive builds is dialled anew."""
    def dial(fabric):
        return gateway_cls([fabric.local_address().endpoint],
                           response_timeout=response_timeout)
    return dial


# ---------------------------------------------------------------------------
# The hosted Presence drive: one schedule, a numpy model of it, and a drive
# that holds every answer against the model. It touches only the silo,
# client and engine surface both packages share, so the same drive runs
# over orleans_tpu's silos and over the port's.
# ---------------------------------------------------------------------------

def presence_schedule(n: int, seed: int = 0, *, waves: int = 5,
                      batches: int = 16, batch: int = 4096,
                      singles: int = 4096, reads: int = 1024,
                      sample: int = 4096) -> SimpleNamespace:
    """The traffic of :func:`drive_presence` for ``n`` players, from
    ``seed``: bulk waves over every player, ``batches`` client batches of
    ``batch`` heartbeats to keys drawn with replacement (same-key calls
    defer), ``singles`` single heartbeats and ``reads`` ``whereis`` calls
    to distinct keys, one broadcast event, and the ``sample`` of keys a
    storage-only silo reloads and calls again."""
    rng = np.random.default_rng(seed)

    def pos(m):
        return rng.random((m, 2), dtype=np.float32).astype(np.float16)

    def delta(m):
        return rng.integers(1, 5, m, dtype=np.int32)

    def distinct(m):
        return rng.choice(n, min(m, n), replace=False)

    calls = batches * batch
    s_keys, r_keys, l_keys = distinct(singles), distinct(reads), \
        distinct(sample)
    return SimpleNamespace(
        n=n, batch=batch,
        waves=[(pos(n), delta(n)) for _ in range(waves)],
        calls=(rng.integers(0, n, calls), pos(calls), delta(calls)),
        singles=(s_keys, pos(s_keys.size), delta(s_keys.size)),
        reads=r_keys,
        event=(np.array([0.5, 0.25], np.float16), np.int32(1)),
        sample=(l_keys, pos(l_keys.size), delta(l_keys.size)))


class PresenceModel:
    """Every player's score and position after the calls applied so far,
    in per-key arrival order (the engine's turn order)."""

    def __init__(self, n: int):
        self.score = np.zeros(n, np.int64)
        self.pos = np.zeros((n, 2), np.float32)

    def apply(self, keys, pos, delta) -> np.ndarray:
        """Heartbeats in arrival order; returns each call's new score."""
        keys = np.asarray(keys, np.int64)
        d = np.asarray(delta, np.int64)
        order = np.argsort(keys, kind="stable")
        sk, sd = keys[order], d[order]
        run = np.cumsum(sd)
        starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
        base = np.repeat(run[starts] - sd[starts],
                         np.diff(np.r_[starts, sk.size]))
        out = np.empty(keys.size, np.int64)
        out[order] = self.score[sk] + run - base
        np.add.at(self.score, keys, d)
        # the last call of each key sets its position
        u, first = np.unique(keys[::-1], return_index=True)
        self.pos[u] = np.asarray(pos)[keys.size - 1 - first] \
            .astype(np.float32)
        return out

    def games(self) -> tuple[np.ndarray, np.ndarray]:
        g = np.arange(self.score.size) % N_GAMES
        return (np.bincount(g, self.score, N_GAMES).astype(np.int64),
                np.bincount(g, minlength=N_GAMES))


def _check(label: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape \
            else "shape"
        raise AssertionError(f"{label}: {bad} values off the model")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


async def drive_presence(build, client_cls, storage, player, game, sched,
                         checkpoint_dir: str, profile=None) -> tuple:
    """Drive Presence through hosted silos and hold every answer against
    :class:`PresenceModel`; returns (results, stats).

    ``build(storage, checkpoint_dir)`` makes an unstarted silo hosting
    ``player`` (dense over ``sched.n`` keys) and the host grain ``game``;
    ``client_cls(silo.fabric)`` is a client of it (``ClusterClient`` in
    process, :func:`gateway_client` over TCP). In order: (1) bulk waves
    through ``silo.vector.call_batch`` with a dense plan; (2)
    ``client.call_batch`` heartbeats, one batch awaited at a time; (3)
    concurrent single heartbeats then ``whereis`` reads; (4)
    ``client.broadcast_actors`` of one event to every player, the
    ``reduce_actors`` score sum and ``join_when`` at k = all; (5) every
    game's ``summary``; (6) ``silo.stop()`` (final write-behind flush and
    final checkpoint), a silo that restores the checkpoint (its table
    must equal the pre-stop table bit for bit), and a storage-only silo
    that reloads ``sched.sample`` through its bridge and calls each key
    again. With ``storage`` None (and ``checkpoint_dir`` None) the silo
    has no write-behind and no checkpoints, and (6) is left out.
    ``profile(step)``, when given, returns a context manager
    wrapped around the last batch of (2) (``step`` "batch") and the last
    summary of (5) ("summary"). The stats give each step's wall time, the
    part of it that write-behind flushes overlapped (``<step>_flush_s``),
    the event loop's stalls longer than ``STALL_S`` within it (their sum
    ``<step>_stalled_s`` and the longest, ``<step>_stall_s``; a flush
    yields to the loop between slices, so it stalls the loop a slice at
    a time), and the seconds of each ``call_batch`` batch and each
    summary that no flush overlapped (``batch_clear_s``,
    ``summary_clear_s``)."""
    n = sched.n
    model = PresenceModel(n)
    res: dict = {}
    st: dict = {}
    clock = time.perf_counter
    durable = storage is not None
    silo = build(storage, checkpoint_dir)
    flushes: list = []  # (rows, start, end, started by silo.stop())
    steps: dict = {}  # step -> (start, end)
    batches: list = []  # (start, end) of each client.call_batch batch
    summaries: list = []  # (start, end) of each summary call
    stopping = [False]
    stalls: list = []  # (start, end) of each event-loop stall
    saves: list = []
    if durable:
        bridge = silo.vector_bridges[player]
        flush = bridge.flush

        async def timed_flush(keys, strict=False):
            t0, final = clock(), stopping[0]
            done = await flush(keys, strict=strict)
            flushes.append((done, t0, clock(), final))
            return done
        bridge.flush = timed_flush
        ckpt = silo.vector_checkpointer
        save = ckpt.save

        def timed_save(step):
            t0 = clock()
            save(step)
            saves.append(clock() - t0)
        ckpt.save = timed_save

    async def watch_loop():
        last = clock()
        while True:
            await asyncio.sleep(STALL_S / 4)
            now = clock()
            if now - last > STALL_S:
                stalls.append((last, now))
            last = now

    await silo.start()
    client = await client_cls(silo.fabric).connect()
    watcher = asyncio.get_running_loop().create_task(watch_loop())
    try:
        rt = silo.vector
        # (1) bulk waves
        keys = np.arange(n)
        plan = rt.make_dense_plan(player, keys)
        want = [model.apply(keys, pos, delta) for pos, delta in sched.waves]
        t0 = clock()
        got = [rt.call_batch(player, "heartbeat", keys,
                             {"pos": pos, "delta": delta}, plan=plan)
               for pos, delta in sched.waves]
        steps["waves"] = (t0, clock())
        for out, w in zip(got, want):
            _check("wave", np.asarray(out, np.int64), w)
        # (2) client.call_batch, one batch at a time
        ks, ps, ds = sched.calls
        want = model.apply(ks, ps, ds)
        got: list = []
        ticks, conflicts = rt.ticks, rt.conflicts_deferred
        t0 = clock()
        for lo in range(0, ks.size, sched.batch):
            hi = lo + sched.batch
            calls = [(int(k), {"pos": p, "delta": d})
                     for k, p, d in zip(ks[lo:hi], ps[lo:hi], ds[lo:hi])]
            ctx = profile("batch") if profile is not None \
                and hi >= ks.size else nullcontext()
            with ctx:
                tb = clock()
                got += await asyncio.gather(
                    *client.call_batch(player, "heartbeat", calls))
                batches.append((tb, clock()))
        steps["batch"] = (t0, clock())
        st["batch_ticks"] = rt.ticks - ticks
        st["batch_conflicts"] = rt.conflicts_deferred - conflicts
        res["call_batch"] = np.asarray(got, np.int64)
        _check("client.call_batch", res["call_batch"], want)
        # (3) concurrent single calls, then reads
        ks, ps, ds = sched.singles
        want = model.apply(ks, ps, ds)
        ticks, conflicts = rt.ticks, rt.conflicts_deferred
        t0 = clock()
        got = await asyncio.gather(*(
            client.get_grain(player, int(k)).heartbeat(pos=p, delta=d)
            for k, p, d in zip(ks, ps, ds)))
        reads = await asyncio.gather(*(
            client.get_grain(player, int(k)).whereis()
            for k in sched.reads))
        steps["single"] = (t0, clock())
        st["single_ticks"] = rt.ticks - ticks
        st["single_conflicts"] = rt.conflicts_deferred - conflicts
        res["singles"] = np.asarray(got, np.int64)
        res["whereis"] = np.stack([np.asarray(r, np.float32)
                                   for r in reads])
        _check("single heartbeats", res["singles"], want)
        _check("whereis", res["whereis"], model.pos[sched.reads])
        # (4) broadcast, reduce, join
        pos, delta = sched.event
        t0 = clock()
        res["delivered"] = int(await client.broadcast_actors(
            player, "heartbeat", keys, {"pos": pos, "delta": delta}))
        steps["broadcast"] = (t0, clock())
        model.apply(keys, np.broadcast_to(pos, (n, 2)),
                    np.full(n, delta))
        _check("broadcast deliveries", res["delivered"], n)
        res["score_sum"] = int(np.asarray(
            await client.reduce_actors(player, "get_score")))
        _check("reduce_actors score sum", res["score_sum"],
               model.score.sum())
        res["joined"] = int(await client.join_when(
            player, range(n), method="ready", timeout=600))
        _check("join_when", res["joined"], n)
        # (5) game summaries
        totals, players = model.games()
        got = []
        t0 = clock()
        for g in range(N_GAMES):
            ctx = profile("summary") if profile is not None \
                and g == N_GAMES - 1 else nullcontext()
            with ctx:
                tb = clock()
                s = await client.get_grain(game, g).summary()
                summaries.append((tb, clock()))
            got.append((s["total_score"], s["players"]))
        steps["summary"] = (t0, clock())
        res["summaries"] = np.asarray(got, np.int64)
        _check("summaries", res["summaries"],
               np.stack([totals, players], axis=1))
        res["table"] = rt.table(player).snapshot()
    finally:
        await client.close_async()
        stopping[0] = True
        t0 = clock()
        await silo.stop()
        steps["stop"] = (t0, clock())
        watcher.cancel()
    for name, (a, b) in steps.items():
        st[f"{name}_s"] = b - a
        st[f"{name}_flush_s"] = sum(max(0.0, min(b, e) - max(a, s))
                                    for _, s, e, _ in flushes)
        held = [max(0.0, min(b, e) - max(a, s)) for s, e in stalls]
        st[f"{name}_stalled_s"] = sum(held)
        st[f"{name}_stall_s"] = max(held, default=0.0)
    def clear(calls):  # seconds of the calls no flush overlapped
        return [b - a for a, b in calls
                if all(e <= a or s >= b for _, s, e, _ in flushes)]
    st["batch_clear_s"] = clear(batches)
    st["summary_clear_s"] = clear(summaries)
    for kind, last in (("final", True), ("periodic", False)):
        st[f"{kind}_flush_rows"] = sum(r for r, _, _, f in flushes
                                       if f is last)
        st[f"{kind}_flush_s"] = sum(e - s for _, s, e, f in flushes
                                    if f is last)
    if not durable:
        return res, st
    st["save_s"] = saves[-1]
    step = ckpt.latest_step()
    st["checkpoint_bytes"] = _dir_bytes(
        os.path.join(checkpoint_dir, str(step)))
    # (6a) whole-silo resume from the checkpoint
    silo = build(None, checkpoint_dir)
    restore = silo.vector_checkpointer.restore
    restored: list = []

    def timed_restore(step=None):
        t0 = clock()
        out = restore(step)
        restored.append(clock() - t0)
        return out
    silo.vector_checkpointer.restore = timed_restore
    await silo.start()
    try:
        again = silo.vector.table(player).snapshot()
    finally:
        await silo.stop()
    st["restore_s"] = restored[0]
    for f, a in res["table"].items():
        if again[f].dtype != a.dtype or not np.array_equal(again[f], a):
            raise AssertionError(f"restored table field {f} differs")
    # (6b) per-actor resume from write-behind storage
    silo = build(storage, None)
    await silo.start()
    client = await client_cls(silo.fabric).connect()
    try:
        ks, ps, ds = sched.sample
        res["loaded"] = np.sort(np.asarray(
            await silo.vector_bridges[player].load(ks), np.int64))
        _check("loaded keys", res["loaded"], np.sort(ks))
        calls = [(int(k), {"pos": p, "delta": d})
                 for k, p, d in zip(ks, ps, ds)]
        res["resumed"] = np.asarray(await asyncio.gather(
            *client.call_batch(player, "heartbeat", calls)), np.int64)
        _check("heartbeats after reload", res["resumed"],
               model.apply(ks, ps, ds))
    finally:
        await client.close_async()
        await silo.stop()
    return res, st


async def main(n_players: int, device, tcp: bool = False) -> None:
    if not tcp:
        return await _main(n_players, device, None)
    with tempfile.TemporaryDirectory(prefix="presence-") as tmp:
        await _main(n_players, device, FileMembershipTable(
            os.path.join(tmp, "membership.json")))


async def _main(n_players: int, device, membership) -> None:
    silo = build_silo(n_players, make_mesh(8, device),
                      storage=MemoryStorage(), membership=membership)
    await silo.start()
    client_cls = ClusterClient if membership is None else gateway_client()
    client = await client_cls(silo.fabric).connect()
    try:
        # --- bulk heartbeat waves: the device-tier hot path -------------
        rt = silo.vector
        keys = np.arange(n_players)
        rng = np.random.default_rng(0)
        plan = rt.make_dense_plan(PlayerVectorGrain, keys)
        waves = 5
        t0 = time.perf_counter()
        for _ in range(waves):
            rt.call_batch(
                PlayerVectorGrain, "heartbeat", keys,
                {"pos": rng.random((n_players, 2), np.float32)
                 .astype(np.float16),
                 "delta": np.ones(n_players, np.int32)}, plan=plan)
        dt = time.perf_counter() - t0
        print(f"{waves} heartbeat waves x {n_players:,} players = "
              f"{waves * n_players / dt:,.0f} msgs/sec")

        # --- one player through the ordinary client surface -------------
        pos = await client.get_grain(PlayerVectorGrain, 42).whereis()
        print(f"player 42 is at {np.round(np.asarray(pos), 3)}")

        # --- host-tier fan-in summary -----------------------------------
        s = await client.get_grain(GameGrain, 7).summary()
        print(f"game 7: {s['players']:,} players, total score "
              f"{s['total_score']:,} (expect score == players x {waves})")
        assert s["total_score"] == s["players"] * waves
    finally:
        await client.close_async()
        await silo.stop()  # the final write-behind flush happens here


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--players", type=int, default=100_000)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--tcp", action="store_true",
                    help="call the silo through a GatewayClient over TCP")
    a = ap.parse_args()
    asyncio.run(main(a.players, "cpu" if a.cpu else None, a.tcp))
