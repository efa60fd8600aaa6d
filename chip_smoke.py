#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (orleans_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``nvidia-smi``; it imports neither
JAX nor the JAX package. What it does, in order (any failure raises, and
the script exits non-zero without its result line):

1. prints the card's name and power limit, and builds the two CUDA
   kernels (K1 fan-in segment sum, K2 within-destination rank) from
   ``orleans_tpu_torch/ops/csrc``;
2. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at edge shapes (exact for integers and
   ranks; float sums within 1e-6 of the per-segment sum of |values| plus
   one unit in the last place of the output dtype), checks that two calls
   on one input give the same bits (K2, and K1 on integers), and times
   the kernel, its plain version and (K1) the library call
   ``index_add_``, with the device kernels each call runs;
3. Phase A: the Presence headline on one shard — 1M PlayerGrains, one
   fresh tick, then K=8 scanned heartbeat rounds per super;
4. Phase B: the ``bench.py --devices 8`` super-round with 8 logical
   shards on the one card — the K=8 scan, the route of every player's
   message to its GameGrain (K2), the fan-in segment sum (K1) and the
   GameGrain tick; 1M messages per super must all arrive;
5. Phase C: the sparse route of ``__graft_entry__.dryrun_multichip``
   phase 4 — hashed keys activated through ``call``, resolved through
   the on-device directory, one actor targeted twice so that the apply
   defers a tick;
6. Phase D: a small Phase B on the card and on the CPU, compared exactly;
7. Phase E: the per-key async tick at Presence width — 1,048,576
   PlayerGrains over 8 shards, 262,144 heartbeats as 64 ``call_group``
   groups of 4,096 (keys drawn with replacement, so same-key calls defer
   over several ticks) and 4,096 hashed-key calls through ``actor()``,
   run inline and on the off-loop worker; every future must equal its
   key's count of earlier calls plus one, and both runs must leave the
   same state;
8. Phase F: E and G at 20,000 actors on the card and on the CPU,
   compared exactly;
9. Phase G: the celebrity fan-out — 1,048,576 subscribers over 8 shards,
   3 events through ``broadcast_actors`` (every chunk routed through K2)
   while 1,024 per-key calls are pending, then ``reduce_actors`` (the
   sum must equal the deliveries), ``map_actors``, ``join_when`` and a
   reshard 8 → 7 → 8 that keeps the sum;
10. Phase H: Presence through a hosted silo — ``samples/presence_torch.py``
   at 262,144 PlayerVectorGrains over 8 shards (write-behind
   ``MemoryStorage`` flushed every 0.5 s, scheduled
   checkpoints, the off-loop tick): bulk waves, 65,536 heartbeats through
   ``client.call_batch``, 4,096 single calls and 1,024 ``whereis``, a
   ``client.broadcast_actors`` to every player (K2 on every chunk) with
   ``reduce_actors`` and ``join_when``, 64 ``GameGrain.summary`` fan-ins
   (K1), then ``silo.stop()`` (final flush and checkpoint), a silo that
   restores the checkpoint bit for bit and a storage-only silo that
   reloads 4,096 players and calls them again; every answer is held
   against a numpy model of the schedule (``drive_presence``);
11. Phase I: Phase H's drive at 20,000 players on the card and on the
   CPU, compared exactly;
12. Phase J: the celebrity fan-out through the device-stream provider on
   two silos at 1,048,576 subscribers, and the persistent provider's
   vector path; then the same at 20,000 on the card and on the CPU;
13. Phase K: live rebalancing on the port's ``TestCluster`` — two silos
   with membership and management, 262,144 string-keyed counters over 8
   shards each, 3 rounds of 65,536 skewed calls each followed by a
   planning round on each silo (the drain packed through K2, the rows
   moved by ``move_rows``), a kill of one silo and reads of its keys
   from write-behind storage through the survivor; then the same at
   20,000 keys on the card and on the CPU, compared exactly;
14. Phase L: Presence over real TCP gateways. The port's native hotwire
   codec and loop runner must be the ones loaded. L1 runs Phase H's
   drive at 1,048,576 players with a ``GatewayClient`` dialled to each
   silo's ``SocketFabric`` gateway (every answer over the wire against
   the model; K1 in each of the 64 summaries, K2 in each of the 64
   broadcast chunks); L2 runs two silos on their own fabrics with the
   client on silo 0's gateway: 65,536 heartbeats (silo 1's forwarded over
   the peer socket, counted exactly), a broadcast whose partition crosses
   to silo 1, a reduce; then L1's drive at 20,000 players over TCP on the
   card and on the CPU, equal to each other and to Phase I.
15. Phase M: multi-process and multi-loop silos with the observability
   stack (metrics with ``GET /metrics`` and the OTLP push, the cost
   ledger, the SLO monitor, tracing with an OTLP sink, all sending to an
   HTTP receiver on 127.0.0.1 inside the script). M1: a
   ``worker_procs=2`` silo with 1,048,576 players on the card, whose
   owner forks its workers after its tables are on the card; two
   ``GatewayClient``s, one on each worker, send 65,536 heartbeats that
   cross the workers' shared-memory rings into the owner's engine; every
   answer against the model, the rings drained, the ring-staged messages
   equal to the calls, every worker's CUDA uninitialized, the ledger's
   per-worker rows, one ``/metrics`` scrape and the receiver's batches
   checked. M2: L1's drive without write-behind through a silo of two
   ingress loops and two egress shards (K1 in each of the 64 summaries,
   K2 in each broadcast chunk), every ingress shard pumping and every
   egress shard encoding; then M1's heartbeats and M2's drive at 20,000
   players on the card and on the CPU, equal to each other, and M2 equal
   to Phase I on its steps.
16. Phase N: durable streams, reminders, event sourcing and transactions.
   N1: the persistent provider's vector path (1,048,576 sensors x 8
   shards, ``device_fanout`` on, so K2 ranks every delivered chunk) over
   a ``SqliteQueueAdapter`` file: items 1 and 2 delivered with durable
   acks, the silo stopped, items 3 and 4 produced into the file with no
   silo, and a new silo resuming from the durable cursor, whose rows must
   hold exactly items 3 and 4. N2: a Presence silo at 1,048,576 players
   with reminders on a ``SqliteReminderTable`` file, transactions over a
   ``SqliteTransactionLog`` file and ``GameJournalGrain`` journals: 64
   reminders of 0.5 s, each fire one ``GameGrain.summary`` (K1) confirmed
   as a journal event, 1,000 transfers among 64 accounts meanwhile; the
   journals' versions equal the counted fires and K1's launches, every
   summary the numpy model, the balances conserved; then a new silo on
   the same files whose reminders fire again with no new registration.
   Then N1 (SQLite and file queues) and N2 at 20,000 on the card and on
   the CPU, compared exactly.
17. Phase O: the silo axis across ranks. An NCCL process group of one
   rank on this card (a ``FileStore`` in a temporary directory) and a
   mesh over it (``make_mesh(8, card, group=...)``); Phase B's super at
   its full width through that mesh: every route goes through the
   process-group exchange (K2 packs the outbox, one
   ``all_to_all_single`` a tensor), the delivered and dropped counts
   through ``all_reduce``; every message must arrive, and the games and
   the player state must equal Phase B's exactly. Then the merged reads
   of a replicated worker (``all_reduce`` SUM/MAX/MIN after the dim-0
   fold) and an overflowing exchange of ``samples/ranks_torch.py``,
   equal to the one-device port. One card holds one rank (NCCL refuses
   two ranks on a card), so an exchange between cards is not verified.

Phase H runs at 262,144 players (L1 runs its drive at full width). The
launch counts are set to 0 just before Phase A and read just after Phase
C, and again around Phases E, G, H, J, K, L, M, N and O: a kernel of a
path that was not launched fails the run (A-C launch both kernels, G, J
and K launch K2, H, L, M, N and O both; E's tick uses neither). The last
two lines are the ``kernels`` JSON (launches summed over those runs,
errors and times in ms) and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (NVIDIA data sheet)
FLOAT_RTOL = 1e-6
N_PLAYERS = 1_000_000
N_GAMES = 1024
K = 8
SHARDS_B = 8
N_E = 1 << 20  # Phase E: bench.py's population, rounded to 2^20
N_G = 1 << 20  # Phase G: subscribers of the celebrity fan-out
# Phase H: hosted Presence players, cut from Phase E's population to a
# quarter so that A-L fit the run's time limit (Phase L1 runs the same
# drive at full width, over TCP)
N_H = 1 << 18
N_I = 20_000   # Phase I: the card against the CPU
N_J = 1 << 20  # Phase J: subscribers of the device-stream fan-out
N_J_CPU = 20_000  # Phase J against the CPU
J_REWIND = 4096  # Phase J: keys of the rewound subscription
N_K = 1 << 18  # Phase K: string keys of the live cluster
N_K_CPU = 20_000  # Phase K against the CPU
K_ROUNDS, K_CALLS, K_BATCH = 3, 65536, 4096  # Phase K's traffic
K_FAILOVER = 4096  # Phase K: the dead silo's keys read back
N_L = 1 << 20  # Phase L1: Presence over a TCP gateway, Phase E's population
N_L2 = 1 << 20  # Phase L2: players of the two silos over TCP
L2_CALLS = 65536  # Phase L2: heartbeats through silo 0's gateway
N_M = 1 << 20  # Phase M: players of the multi-process and multi-loop silos
M_CALLS = 65536  # Phase M1: heartbeats through the workers' rings
M_CALLS_CPU = 16384  # Phase M1 at N_I players, card against the CPU
N_N = 1 << 20  # Phase N: sensors of N1 and players of N2
N_N_CPU = 20_000  # Phase N against the CPU
N_CHUNK = 16384  # the engine's stream_fanout chunk: one K2 launch each
N_PERIOD = 0.5  # Phase N2: the summary reminders' period, seconds
N_FIRES = 4  # Phase N2: fires of every reminder before the restart
N_TRANSFERS = 1000  # Phase N2: transactional transfers
N_ACCOUNTS = 64  # Phase N2: host-tier accounts
N_BALANCE = 1000  # Phase N2: each account's opening balance
ROOT = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 20) -> dict[str, tuple[float, float]]:
    """(device ms, launches) per call of each CUDA kernel that ``fn``
    launches, by kernel name, from torch.profiler's trace of ``iters``
    calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {k: (ms / iters, n / iters)
            for k, (ms, n) in profiled_kernels(prof).items()}


def profiled_kernels(prof) -> dict[str, tuple[float, float]]:
    """(device ms, launches) of each CUDA kernel in a finished
    torch.profiler run, by kernel name."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms, n = out.get(e.key, (0.0, 0))
        out[e.key] = (ms + us / 1e3, n + e.count)
    return out


def kernel_names(kernels) -> list[str]:
    """Kernel names without return type, anonymous namespaces and
    template or call arguments."""
    out = []
    for k in sorted(kernels):
        k = k.removeprefix("void ").replace("(anonymous namespace)::", "")
        out.append(re.split(r"[<(]", k)[0].strip())
    return out


def device_breakdown(fn, iters: int = 20) -> dict[str, float]:
    """Device ms per call of each CUDA kernel that ``fn`` launches."""
    return {k: ms for k, (ms, _) in device_profile(fn, iters).items()}


def sass_summary(kernel) -> None:
    """Per device function of a kernel's library, the count of each SASS
    opcode (with its modifiers) that says how its loops load, match, add
    and synchronise (from ``cuobjdump -sass``; skipped where the tool is
    missing)."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        print(f"  {kernel.name}: SASS not read (no cuobjdump)")
        return
    out = subprocess.run([tool, "-sass", str(kernel.library)],
                         capture_output=True, text=True, timeout=120)
    kinds = {"ATOMS", "ATOMG", "REDG", "MATCH", "VOTE", "REDUX", "SHFL",
             "LDG", "STG", "LDS", "STS", "UCGABAR_ARV", "UCGABAR_WAIT",
             "BAR", "NANOSLEEP"}
    op = re.compile(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
    fn, counts = None, {}
    for line in out.stdout.splitlines() + ["Function : <end>"]:
        if "Function :" in line:
            if fn is not None:
                print(f"  {kernel.name} SASS {fn}: " + ", ".join(
                    f"{o} {c}" for o, c in sorted(counts.items())))
            fn, counts = line.split("Function :")[1].strip(), {}
            continue
        m = op.search(line)
        if m and m.group(1).split(".")[0] in kinds:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1


def report_breakdown(label: str, kernels: dict, wall_ms: float) -> None:
    """Device busy time per step against its wall time, and the top
    kernels by device time."""
    busy = sum(kernels.values())
    print(f"  {label}: device busy {busy:.4f} ms of {wall_ms:.4f} ms wall "
          f"per step (idle share {max(0.0, 1 - busy / wall_ms):.3f}); "
          f"top kernels:")
    for k, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {t:.4f} ms  {k[:90]}")


def player_classes():
    from orleans_tpu_torch.dispatch import VectorGrain, actor_method

    class PlayerGrain(VectorGrain):
        """bench.py's PlayerGrain: heartbeat updates position + liveness."""

        STATE = {"pos": (torch.float32, (2,)), "beats": (torch.int32, ()),
                 "game": (torch.int32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"pos": key_hash.new_zeros(2, dtype=torch.float32),
                    "beats": torch.zeros_like(key_hash),
                    "game": key_hash % 1024}

        @actor_method(args={"pos": (torch.float16, (2,))})
        def heartbeat(state, args):
            new = {"pos": args["pos"].to(torch.float32),
                   "beats": state["beats"] + 1, "game": state["game"]}
            return new, new["beats"]

    class GameGrain(VectorGrain):
        """bench.py's GameGrain fan-in target."""

        STATE = {"count": (torch.int32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"count": torch.zeros_like(key_hash)}

        @actor_method(args={"n": (torch.int32, ())})
        def accumulate(state, args):
            new = {"count": state["count"] + args["n"]}
            return new, new["count"]

    class CounterVec(VectorGrain):
        """dryrun_multichip phase 4's sparse-keyed counter."""

        STATE = {"total": (torch.int32, ()), "hits": (torch.int32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"total": torch.zeros_like(key_hash),
                    "hits": torch.zeros_like(key_hash)}

        @actor_method(args={"amount": (torch.int32, ())})
        def add(state, args):
            new = {"total": state["total"] + args["amount"],
                   "hits": state["hits"] + 1}
            return new, new["total"]

    return PlayerGrain, GameGrain, CounterVec


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def check_segment_sum(values, ids, S, label) -> float:
    from orleans_tpu_torch.ops import segment_sum, segment_sum_ref
    got = segment_sum(values, ids, S)
    want = segment_sum_ref(values, ids, S)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, label
    err = max_err(got, want)
    if values.dtype.is_floating_point:
        flat_ids = ids.reshape(-1).long()
        n = 1 if ids.ndim == 1 else ids.shape[0]
        if ids.ndim == 2:
            ok = (ids >= 0) & (ids < S)
            flat_ids = torch.where(
                ok, ids + torch.arange(n, device=ids.device)[:, None] * S,
                torch.full_like(ids, -1)).reshape(-1).long()
        v = values.reshape(flat_ids.shape[0], -1).double().abs()
        keep = (flat_ids >= 0) & (flat_ids < n * S)
        scale = torch.zeros((n * S, v.shape[1]), dtype=torch.float64,
                            device=v.device)
        scale.index_add_(0, flat_ids[keep], v[keep])
        ulp = torch.from_numpy(np.spacing(np.abs(
            want.float().cpu().numpy().astype(
                np.float16 if values.dtype == torch.float16
                else np.float32)))).double().to(v.device)
        tol = FLOAT_RTOL * scale.reshape(want.shape) + ulp.reshape(want.shape)
        bad = (got.double() - want.double()).abs() > tol
        assert not bool(bad.any()), f"{label}: float sums off by {err}"
    else:
        assert err == 0, f"{label}: integer sums differ by {err}"
    print(f"  K1 {label}: shape {tuple(values.shape)} S={S} "
          f"{values.dtype} max_abs_err={err}")
    return err


def check_rank(dest, n_dest, label) -> float:
    from orleans_tpu_torch.ops import rank_by_dest, rank_by_dest_ref
    got = rank_by_dest(dest, n_dest)
    want = rank_by_dest_ref(dest, n_dest)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == dest.shape, label
    err = max_err(got, want)
    assert err == 0, f"{label}: ranks differ by {err}"
    print(f"  K2 {label}: shape {tuple(dest.shape)} n_dest={n_dest} "
          f"max_abs_err={err}")
    return err


def main_path_inputs(dev, gen):
    """K1's and K2's operands as Phase B gives them: K2 ranks each shard's
    131,072 lanes (125,000 players, the rest padding on the sink) over 8
    shards + 1 sink; K1 folds each shard's 8 x 19,532 received lanes into
    its 128 games."""
    per = -(-N_PLAYERS // SHARDS_B)
    B = 1 << (per - 1).bit_length()
    lanes = torch.arange(B, device=dev)
    keys = torch.arange(SHARDS_B, device=dev)[:, None] * per + lanes
    real = (lanes < per) & (keys < N_PLAYERS)
    dest = torch.where(real, (keys % N_GAMES) // 128,
                       torch.full_like(keys, SHARDS_B)).to(torch.int32)
    cap = -(-5 * N_PLAYERS // (4 * SHARDS_B * SHARDS_B))
    L = SHARDS_B * cap
    ids = torch.randint(0, 128, (SHARDS_B, L), generator=gen, device=dev,
                        dtype=torch.int32)
    # about 1M of the 1.25M received lanes are valid; invalid lanes carry
    # value 0, as the fan-in's where(valid, 1, 0) gives them
    valid = torch.rand((SHARDS_B, L), generator=gen, device=dev) \
        < N_PLAYERS / (SHARDS_B * L)
    values = valid.to(torch.int32)
    return dest, values, ids


def check_repeat(fn, label) -> None:
    """Two calls of a kernel on the same input give the same bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(a, b), f"{label}: two calls differ"
    print(f"  {label}: two calls equal to the bit")


def kernel_checks(dev):
    from orleans_tpu_torch.ops import rank_by_dest, segment_sum
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {"segment_sum": 0.0, "rank_by_dest": 0.0}
    dest, values, ids = main_path_inputs(dev, gen)

    def seg(*a):
        errs["segment_sum"] = max(errs["segment_sum"],
                                  check_segment_sum(*a))

    def rank(*a):
        errs["rank_by_dest"] = max(errs["rank_by_dest"], check_rank(*a))

    print("kernel checks (kernel against its plain version, on the card):")
    seg(values, ids, 128, "main path (Phase B fan-in)")
    rank(dest, SHARDS_B + 1, "main path (Phase B route)")
    # two calls on the same input: K2 equal to the bit, K1 exact (integers)
    check_repeat(lambda: segment_sum(values, ids, 128), "K1 main path")
    check_repeat(lambda: rank_by_dest(dest, SHARDS_B + 1), "K2 main path")
    # odd B: every row after the first starts off 16-byte alignment
    seg(torch.randint(0, 6, (3, 10001), generator=gen, device=dev,
                      dtype=torch.int32),
        torch.randint(-1, 51, (3, 10001), generator=gen, device=dev,
                      dtype=torch.int32), 50, "odd B int32, 3 rows")
    seg(torch.randn(5, 777, 3, generator=gen, device=dev),
        torch.randint(-2, 20, (5, 777), generator=gen, device=dev,
                      dtype=torch.int32), 20, "odd B float32 D=3, 5 rows")
    seg(torch.randn(3, 4099, generator=gen, device=dev).half(),
        torch.randint(0, 30, (3, 4099), generator=gen, device=dev,
                      dtype=torch.int32), 30, "odd B float16, 3 rows")
    rank(torch.randint(0, 7, (5, 1001), generator=gen, device=dev,
                       dtype=torch.int32), 7, "odd B, 5 rows")
    many = torch.randint(0, 5, (3, 300_001), generator=gen, device=dev,
                         dtype=torch.int32)
    rank(many, 5, "odd B, 3 rows of several clusters each")
    check_repeat(lambda: rank_by_dest(many, 5), "K2 several clusters a row")
    ones = torch.randint(0, 2, (3, 300_001), generator=gen, device=dev,
                         dtype=torch.int32)
    check_repeat(lambda: segment_sum(ones, many, 5), "K1 odd B int32")
    # edge shapes: ragged B, out-of-range ids, 1-D and 2-D, float types,
    # every lane one segment or dest, every lane distinct, large S*D
    fv = torch.randn(1000, generator=gen, device=dev)
    fid = torch.randint(-3, 40, (1000,), generator=gen, device=dev,
                        dtype=torch.int32)
    seg(fv, fid, 37, "ragged 1-D float32, out-of-range ids")
    seg(torch.randn(5001, 3, generator=gen, device=dev), torch.randint(
        -1, 301, (5001,), generator=gen, device=dev, dtype=torch.int32),
        300, "2-D float32")
    seg(torch.randn(777, 2, generator=gen, device=dev).half(),
        torch.randint(0, 9, (777,), generator=gen, device=dev,
                      dtype=torch.int32), 9, "2-D float16")
    seg(torch.ones(300_000, dtype=torch.int32, device=dev),
        torch.zeros(300_000, dtype=torch.int32, device=dev), 4,
        "every lane one segment")
    seg(torch.randint(-50, 50, (20_000, 8), generator=gen, device=dev,
                      dtype=torch.int32),
        torch.randint(0, 4096, (20_000,), generator=gen, device=dev,
                      dtype=torch.int32), 4096, "S*D=32768 (128 KB shared)")
    rank(torch.randint(0, 7, (1000,), generator=gen, device=dev,
                       dtype=torch.int32), 7, "ragged 1-D")
    rank(torch.zeros(100_000, dtype=torch.int32, device=dev), 3,
         "every lane one dest")
    rank(torch.arange(1000, dtype=torch.int32, device=dev), 1000,
         "every lane distinct, S = 1000")
    # the main path's shapes once more, after calls of other shapes have
    # used each kernel's scratch
    seg(values, ids, 128, "main path again, after the other shapes")
    big = torch.randint(0, 2, (1_048_576,), generator=gen, device=dev,
                        dtype=torch.int32)
    rank(big, 2, "one shard, 1M lanes")
    check_repeat(lambda: rank_by_dest(big, 2), "K2 one shard, 1M lanes")
    rank(dest, SHARDS_B + 1, "main path again, after the other shapes")
    # Phase G's routes, built as its first event builds them: full chunks
    # of 16,384 subscribers at [8, 2048] (one that straddles two owning
    # shards), the last chunk with its padding on the sink id 8, and the
    # 1,024 deferred per-key targets at [8, 128]
    per = -(-N_G // SHARDS_B)
    for label, targets in g_first_event_chunks(N_G, 16384):
        g = g_chunk_dest(dev, targets, per)
        rank(g, SHARDS_B + 1, f"{label} route")
        check_repeat(lambda: rank_by_dest(g, SHARDS_B + 1), f"K2 {label}")
    # Phases H and L1: a broadcast chunk of 16,384 consecutive players
    # (no busy keys: every chunk is one or two owning shards) and the
    # summary's fan-in of [n, 2] (score, 1) rows into 64 games, inactive
    # rows on -1, at each phase's population
    for phase, n in (("Phase L1", N_L), ("Phase H", N_H)):
        per = -(-n // SHARDS_B)
        g = g_chunk_dest(dev, np.arange(3 * 16384, 4 * 16384), per)
        rank(g, SHARDS_B + 1, f"{phase} broadcast chunk route")
        hv, hid = h_summary_inputs(dev, gen, n)
        seg(hv, hid, 64, f"{phase} summary fan-in")
        check_repeat(lambda: segment_sum(hv, hid, 64),
                     f"K1 {phase} summary")
    for label, g in j_chunk_dests(dev):
        rank(g, SHARDS_B + 1, f"{label} route")
        check_repeat(lambda: rank_by_dest(g, SHARDS_B + 1), f"K2 {label}")
    # Phase K: the rebalance planner's 1-D pack of up to rebalance_budget
    # drain candidates, each bound for a cool shard (1-7), over 8 shards
    # and the sink; a full round and a short one
    for n in (16384, 1759):
        g = torch.randint(1, SHARDS_B, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        rank(g, SHARDS_B + 1, f"Phase K planner drain [{n}]")
        check_repeat(lambda: rank_by_dest(g, SHARDS_B + 1),
                     f"K2 Phase K planner drain [{n}]")
    return errs, (dest, values, ids)


def j_chunk_dests(dev):
    """(label, K2 operand) of two Phase J delivery chunks: 16,384 of one
    silo's subscribers in key order, the ring having split the keys
    between two silos (here a seeded half), so every chunk spans all 8
    owning shards; and the short last chunk of that silo's part."""
    per = -(-N_J // SHARDS_B)
    part = np.flatnonzero(np.random.default_rng(6).random(N_J) < 0.5)
    tail = part.size - part.size % 16384
    return [("Phase J delivery chunk",
             g_chunk_dest(dev, part[:16384], per)),
            (f"Phase J last chunk ({part.size - tail} targets)",
             g_chunk_dest(dev, part[tail:], per))]


def h_summary_inputs(dev, gen, n):
    """K1's operands as ``presence_torch.game_totals`` builds them for
    Phases H and L1: per player (score, 1) as int32 [n, 2], ids the
    player's game (key % 64), with a few inactive players on -1."""
    keys = torch.arange(n, device=dev, dtype=torch.int32)
    ids = torch.where(torch.rand(n, generator=gen, device=dev) < 0.001,
                      torch.full_like(keys, -1), keys % 64)
    score = torch.randint(5, 40, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    return torch.stack([score, torch.ones_like(score)], dim=1), ids


def g_first_event_chunks(n_subs: int, chunk: int):
    """(label, targets) of three of the chunks that Phase G's first
    broadcast routes: the subscribers that no per-key call holds go in
    chunks of ``chunk`` in key order, then the ones it deferred (the
    busy keys of ``drive_fanout``, same seed) in one last chunk."""
    busy = np.random.default_rng(4).choice(n_subs, 1024, replace=False)
    held = np.zeros(n_subs, bool)
    held[busy] = True
    ready = np.flatnonzero(~held)
    per = -(-n_subs // SHARDS_B)
    starts = range(0, ready.size, chunk)
    cross = next(o for o in starts
                 if ready[o] // per != ready[min(o + chunk, ready.size) - 1]
                 // per)
    last = starts[-1]
    return [(f"Phase G chunk at {cross} (two owning shards)",
             ready[cross:cross + chunk]),
            (f"Phase G last chunk ({ready.size - last} targets)",
             ready[last:]),
            ("Phase G deferred targets", np.flatnonzero(held))]


def g_chunk_dest(dev, targets, per):
    """K2's operand for one broadcast chunk as ``_broadcast_chunk``,
    ``route`` and ``pack_by_dest`` build it: the E targets split over the
    source shards in power-of-two rows of L lanes, each lane's owning
    shard (key // per), and the padding lanes on the sink id."""
    n = SHARDS_B
    E = targets.size
    L = 1 << (-(-E // n) - 1).bit_length()
    keys = np.zeros(n * L, np.int64)
    keys[:E] = targets
    valid = np.arange(n * L) < E
    dest = np.where(valid, keys // per, n).reshape(n, L)
    return torch.from_numpy(dest.astype(np.int32)).to(dev)


def kernel_times(dest, values, ids):
    """Per kernel at the main path's shapes: (wrapper ms by CUDA events,
    the kernel's own device ms by profiler, plain ms, library ms, bound
    ms). The wrapper time includes its small PyTorch ops (id offsets,
    output zeroing, the cast back) and the host launch cost."""
    from orleans_tpu_torch.ops import (rank_by_dest, rank_by_dest_ref,
                                       segment_sum, segment_sum_ref)
    S = 128
    n = ids.shape[0]

    def seg():
        return segment_sum(values, ids, S)

    def rank():
        return rank_by_dest(dest, SHARDS_B + 1)

    # the library call: index_add_ into n*S segments, ids offset per shard
    # ahead of time (the kernel does that offset inside its wrapper)
    flat = (ids + torch.arange(n, device=ids.device, dtype=torch.int32)
            [:, None] * S).reshape(-1)
    vals = values.reshape(-1)

    def lib():
        return torch.zeros(n * S, dtype=values.dtype,
                           device=values.device).index_add_(0, flat, vals)

    from orleans_tpu_torch.ops import rank_plan, segment_sum_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k1_plan = segment_sum_plan(n, ids.shape[1], 1, S, sms)
    k2_plan = rank_plan(*dest.shape, SHARDS_B + 1)
    print(f"  plans on {sms} SMs: K1 {k1_plan}; K2 {k2_plan} (cluster size "
          f"8 where the card holds no cluster of 16)")
    out = {}
    for name, fn, own, plain, library, nbytes in (
            ("segment_sum", seg, "segment_sum_kernel",
             lambda: segment_sum_ref(values, ids, S), lib,
             values.nbytes + ids.nbytes + n * S * values.element_size()),
            ("rank_by_dest", rank, "rank_by_dest_kernel",
             lambda: rank_by_dest_ref(dest, SHARDS_B + 1), None,
             dest.nbytes * 2)):  # each input read once, output written once
        ms = time_ms(fn)
        kernels = device_profile(fn)
        device_ms = sum(t for k, (t, _) in kernels.items() if own in k)
        per_call = sum(c for _, c in kernels.values())
        print(f"  {name}: wrapper {ms:.4f} ms/call; {per_call:g} device "
              f"kernels per call:")
        for k, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
            print(f"    {t:.4f} ms  x{c:g}  {k[:90]}")
        assert device_ms > 0, f"{name}: no device time for {own}"
        out[name] = (ms, device_ms, time_ms(plain, iters=5),
                     time_ms(library) if library else None,
                     nbytes / HBM_BYTES_PER_S * 1e3, per_call)
    return out


# ---------------------------------------------------------------------------
# 3-6. the main path
# ---------------------------------------------------------------------------

def phase_a(dev, card):
    from orleans_tpu_torch.dispatch import VectorRuntime
    from orleans_tpu_torch.parallel import make_mesh
    Player, _, _ = player_classes()
    rt = VectorRuntime(make_mesh(1, dev), capacity_per_shard=N_PLAYERS)
    tbl = rt.table(Player)
    tbl.ensure_dense(N_PLAYERS)
    keys = np.arange(N_PLAYERS)
    rng = np.random.default_rng(0)
    pos = rng.random((N_PLAYERS, 2), dtype=np.float32).astype(np.float16)
    plan = rt.make_dense_plan(Player, keys)
    out = rt.call_batch(Player, "heartbeat", keys, {"pos": pos},
                        fresh=np.ones(N_PLAYERS, bool), plan=plan)
    assert (out == 1).all()
    staged = [torch.from_numpy(np.stack([
        pos + np.float16(0.001 * (i * K + k)) for k in range(K)])).to(dev)
        for i in range(2)]
    rounds = 1
    warm, supers = 2, 10
    for i in range(warm):
        rt.call_batch_rounds(Player, "heartbeat", keys,
                             {"pos": staged[i % 2]}, plan=plan,
                             device_results=True)
        rounds += K
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(supers):
        res = rt.call_batch_rounds(Player, "heartbeat", keys,
                                   {"pos": staged[i % 2]}, plan=plan,
                                   device_results=True)
        rounds += K
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    beats = tbl.state["beats"][0, :N_PLAYERS]
    assert bool((beats == rounds).all()), "beats != rounds"
    assert res.shape == (K, 1, plan.B)
    assert bool((res[-1, 0, :N_PLAYERS] == rounds).all())
    pos_state = tbl.state["pos"][0, :N_PLAYERS]
    assert bool(torch.isfinite(pos_state).all())
    report_breakdown("Phase A super (K=8)", device_breakdown(
        lambda: rt.call_batch_rounds(Player, "heartbeat", keys,
                                     {"pos": staged[0]}, plan=plan,
                                     device_results=True), iters=3),
        wall / supers * 1e3)
    rate = supers * K * N_PLAYERS / wall
    print(f"Phase A: {N_PLAYERS} players, 1 shard, {supers} supers x K={K}: "
          f"{rate:.0f} msgs/sec ({wall / supers * 1e3:.3f} ms/super) "
          f"on {card}")
    return rate


def phase_b(dev, card, n_players=N_PLAYERS, supers=3, warm=1, quiet=False,
            group=None, label="Phase B"):
    """bench.py --devices 8's super-round on ``dev``; returns the game
    counts and the player state of this process's shards for a
    comparison. ``group``: run it on a mesh over that process group
    (Phase O), whose ranks each hold their share of the 8 shards."""
    from orleans_tpu_torch.dispatch import VectorRuntime
    from orleans_tpu_torch.ops import segment_sum
    from orleans_tpu_torch.parallel import all_reduce, make_mesh
    Player, Game, _ = player_classes()
    mesh = make_mesh(SHARDS_B, dev, group=group)
    n = mesh.n_local
    rt = VectorRuntime(mesh, capacity_per_shard=-(-n_players // SHARDS_B))
    tbl = rt.table(Player)
    tbl.ensure_dense(n_players)
    keys = np.arange(n_players)
    rng = np.random.default_rng(1)
    pos = rng.random((n_players, 2), dtype=np.float32).astype(np.float16)
    plan = rt.make_dense_plan(Player, keys)
    rt.call_batch(Player, "heartbeat", keys, {"pos": pos},
                  fresh=np.ones(n_players, bool), plan=plan)
    staged = [torch.from_numpy(np.stack([
        pos + np.float16(0.001 * (i * K + k)) for k in range(K)])).to(dev)
        for i in range(2)]
    route_capacity = -(-5 * n_players // (4 * SHARDS_B * SHARDS_B))
    gt = rt.table(Game)
    gt.ensure_dense(N_GAMES)
    gps = gt.dense_per_shard
    rt.call_batch(Game, "accumulate", np.arange(N_GAMES),
                  {"n": np.zeros(N_GAMES, np.int32)})
    d_game = torch.from_numpy(plan.pack(keys % N_GAMES, torch.int32,
                                        ())).to(dev)
    d_valid = torch.from_numpy(plan.valid_b).to(dev)
    g_slots = torch.arange(gps, dtype=torch.int32, device=dev) \
        .expand(n, gps).contiguous()
    g_valid = torch.ones((n, gps), dtype=torch.bool, device=dev)
    g_fresh = torch.zeros((n, gps), dtype=torch.bool, device=dev)
    delivered = torch.zeros(n, dtype=torch.int64, device=dev)
    dropped = torch.zeros(n, dtype=torch.int64, device=dev)

    def super_round(i):
        res = rt.call_batch_rounds(Player, "heartbeat", keys,
                                   {"pos": staged[i % 2]}, plan=plan,
                                   device_results=True)
        rk, _, rv, drops = rt.route(Game, d_game, {"beats": res[-1]},
                                    d_valid, capacity=route_capacity)
        counts = segment_sum(rv.to(torch.int32), rk % gps, gps)
        rt.call_batch_device(Game, "accumulate", g_slots, g_slots,
                             g_fresh, g_valid, {"n": counts})
        delivered.add_(rv.sum(dim=1))
        dropped.add_(drops)

    for i in range(warm):
        super_round(i)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(supers):
        super_round(warm + i)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = warm + supers
    d = int(all_reduce(mesh, delivered.sum()))
    x = int(all_reduce(mesh, dropped.sum()))
    assert x == 0, f"exchange dropped {x} messages"
    assert d == total * n_players, (d, total * n_players)
    # this process's games and players: global shards shard0 .. + n
    games = gt.state["count"][:, :gps].reshape(-1).cpu().numpy()
    g0 = mesh.shard0 * gps
    want = np.bincount(keys % N_GAMES, minlength=N_GAMES) * total
    n_g = max(0, min(games.size, N_GAMES - g0))
    np.testing.assert_array_equal(games[:n_g], want[g0:g0 + n_g])
    beats = tbl.state["beats"][:, :tbl.dense_per_shard].reshape(-1)
    p0 = mesh.shard0 * tbl.dense_per_shard
    n_p = max(0, min(beats.numel(), n_players - p0))
    assert bool((beats[:n_p] == 1 + total * K).all())
    if not quiet:
        report_breakdown(f"{label} super", device_breakdown(
            lambda: super_round(0), iters=3), wall / supers * 1e3)
        rate = supers * K * n_players / wall
        where = "on one card" if group is None else \
            f"on rank {mesh.rank} of {mesh.world} ({n} shards a rank)"
        print(f"{label}: {n_players} players over {SHARDS_B} shards {where},"
              f" {supers} supers (K={K} scan + route + fan-in + game tick): "
              f"{rate:.0f} heartbeat msgs/sec, {supers * n_players / wall:.0f}"
              f" routed msgs/sec ({wall / supers * 1e3:.3f} ms/super), "
              f"delivered {d}, dropped {x} on {card}")
    return games[:n_g], {k: v.cpu() for k, v in tbl.state.items()}


def phase_c(dev):
    from orleans_tpu_torch.dispatch import VectorRuntime
    from orleans_tpu_torch.ops import split64
    from orleans_tpu_torch.parallel import make_mesh
    _, _, Counter = player_classes()
    n = SHARDS_B
    rt = VectorRuntime(make_mesh(n, dev), capacity_per_shard=64)
    ctbl = rt.table(Counter)
    hashes = [((k * 2654435761) ^ (k << 33)) & ((1 << 62) - 1) | (1 << 40)
              for k in range(1, 2 * n + 1)]

    async def activate():
        await asyncio.gather(*(
            rt.call(Counter, h, "add", amount=np.int32(0)) for h in hashes))
    asyncio.run(activate())
    assert ctbl.device_dir.count == len(hashes)
    B2 = 2
    dest = np.zeros((n, B2), np.int64)
    amount = np.zeros((n, B2), np.int32)
    expect: dict = {}
    for s in range(n):
        for i in range(B2):
            h = hashes[0] if (s, i) == (0, 1) else \
                hashes[(s * B2 + i) % len(hashes)]
            dest[s, i] = h
            amount[s, i] = 100 + s * B2 + i
            expect[h] = expect.get(h, 0) + int(amount[s, i])
    lo, hi = split64(dest)
    rkeys, rpay, rvalid, drops = rt.route(
        Counter, (torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)),
        {"amount": torch.from_numpy(amount).to(dev)},
        torch.ones((n, B2), dtype=torch.bool, device=dev), capacity=16,
        sparse=True)
    assert int(drops.sum()) == 0
    delivered = int(rvalid.sum())
    assert delivered == n * B2
    applied_total = rounds = 0
    while applied_total < delivered and rounds <= delivered:
        _, applied = rt.apply_received(Counter, "add", rkeys, rvalid, rpay,
                                       sparse=True)
        applied_total += int(applied.sum())
        rvalid = rvalid & ~applied
        rounds += 1
    assert applied_total == delivered and rounds >= 2
    for h, want in expect.items():
        assert int(ctbl.read_row(h)["total"]) == want
    print(f"Phase C: sparse route over {n} shards, {delivered} delivered, "
          f"applied over {rounds} ticks (one deferred), totals verified")


def phase_d(dev):
    """A small Phase B on the card and on the CPU: same state, same game
    counts (the CPU runs the kernels' plain versions)."""
    g_cuda, s_cuda = phase_b(dev, "", n_players=20_000, supers=2, warm=0,
                             quiet=True)
    g_cpu, s_cpu = phase_b(torch.device("cpu"), "", n_players=20_000,
                           supers=2, warm=0, quiet=True)
    np.testing.assert_array_equal(g_cuda, g_cpu)
    for k in s_cuda:
        c = s_cuda[k].shape[1] - 1  # the sink row is undefined
        assert torch.equal(s_cuda[k][:, :c], s_cpu[k][:, :c]), k
    print("Phase D: 20,000 players x 8 shards, card == CPU reference, "
          "exactly")


def fan_class():
    from orleans_tpu_torch.dispatch import VectorGrain, actor_method

    class FanVec(VectorGrain):
        """The celebrity fan-out subscriber of benchmarks/gauntlet.py, with
        read-only ``events`` and ``ready`` methods for the reductions."""

        STATE = {"events": (torch.int32, ()), "last": (torch.float32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"events": torch.zeros_like(key_hash),
                    "last": key_hash.new_zeros((), dtype=torch.float32)}

        @actor_method(args={"v": (torch.float32, ())})
        def on_next(state, args):
            return {"events": state["events"] + 1,
                    "last": args["v"]}, state["events"]

        @actor_method(read_only=True)
        def events(state, args):
            return state, state["events"]

        @actor_method(read_only=True)
        def ready(state, args):
            return state, (state["events"] > 0).to(torch.int32)

    return FanVec


def host_state(tbl) -> dict:
    """A copy of a table's rows on the host, sink row left out
    (undefined)."""
    return {k: v[:, :tbl.capacity].cpu().clone()
            for k, v in tbl.state.items()}


def same_state(a: dict, b: dict, label: str) -> None:
    assert a.keys() == b.keys(), label
    for k in a:
        assert torch.equal(a[k], b[k]), f"{label}: field {k} differs"


class StageClock:
    """A ``VectorRuntime.stats`` hook that sums the engine's stage seconds
    (staging fill, upload, tick = kernel + device + host copy; queue wait
    per item) and its message count."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def observe(self, key: str, value: float) -> None:
        self.seconds[key] = self.seconds.get(key, 0.0) + value
        self.counts[key] = self.counts.get(key, 0) + 1

    def increment(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def line(self, wall: float) -> str:
        from orleans_tpu_torch.observability import INGEST_STATS as st
        parts = {name: self.seconds.get(st[name], 0.0)
                 for name in ("staging", "transfer", "tick")}
        rest = wall - sum(parts.values())
        waits = self.counts.get(st["queue_wait"], 0)
        mean_wait = self.seconds.get(st["queue_wait"], 0.0) / max(1, waits)
        return (", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
                + f", the rest (enqueue, claim, resolve, gather) {rest:.3f}"
                f" s of {wall:.3f} s; mean queue wait {mean_wait * 1e3:.1f}"
                f" ms over {waits} calls")


def heartbeat_schedule(n_players: int, seed: int = 3):
    """Phase E's traffic: 64 groups of heartbeats to keys drawn with
    replacement, the float16 positions, and each call's expected
    ``beats`` (that key's count of earlier calls plus one)."""
    group = n_players // 4 // 64
    n_calls = 64 * group
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_players, n_calls)
    pos = rng.random((n_calls, 2), dtype=np.float32).astype(np.float16)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    run_start = np.repeat(starts, np.diff(np.r_[starts, n_calls]))
    expect = np.empty(n_calls, np.int64)
    expect[order] = np.arange(n_calls) - run_start + 1
    return group, keys, pos, expect


async def drive_heartbeats(rt, Player, Counter, group, keys, pos,
                           n_hashed=4096):
    """Enqueue the schedule as call_group groups of ``group`` (every item
    with a future) plus ``n_hashed`` hashed-key Counter calls, and await
    all."""
    futs = []
    for lo in range(0, keys.size, group):
        futs += rt.call_group(Player, "heartbeat", [
            (int(keys[i]), {"pos": pos[i]}, True)
            for i in range(lo, lo + group)])
    cfuts = [rt.actor(Counter, f"player-{i}").add(amount=np.int32(i % 97 + 1))
             for i in range(n_hashed)]
    out = await asyncio.gather(*futs)
    cout = await asyncio.gather(*cfuts)
    await rt.flush()
    return out, cout


def phase_e(dev, card, n_players=N_E, offloop=False, quiet=False):
    """The per-key async tick at Presence width: 1M dense PlayerGrains
    over 8 logical shards, 262,144 heartbeats as 64 call_group groups of
    4,096 (about 30,000 keys called twice or more: conflict-defer over
    several ticks) and 4,096 hashed-key Counter calls through actor().
    Returns the Player and Counter state for the comparisons."""
    from orleans_tpu_torch.config import DispatchOptions
    from orleans_tpu_torch.dispatch import VectorRuntime
    from orleans_tpu_torch.parallel import make_mesh
    Player, _, Counter = player_classes()
    n = SHARDS_B
    cap = -(-n_players // n)
    rt = VectorRuntime(make_mesh(n, dev), options=DispatchOptions(
        capacity_per_shard=cap, offloop_tick=offloop))
    rt.table(Player).ensure_dense(n_players)
    rt.register(Counter, capacity_per_shard=1024)
    clock = rt.stats = StageClock()
    group, keys, pos, expect = heartbeat_schedule(n_players)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, cout = asyncio.run(drive_heartbeats(rt, Player, Counter, group,
                                             keys, pos))
    wall = time.perf_counter() - t0
    ticks = rt.ticks
    rt.shutdown_worker()
    beats = np.array([int(b) for b in out])
    assert np.array_equal(beats, expect), "beats off the turn order"
    tbl = rt.table(Player)
    touched = np.unique(keys)
    shard, slot = tbl.dense_shard_slot(touched)
    game = tbl.state["game"][torch.from_numpy(shard), torch.from_numpy(slot)]
    assert np.array_equal(game.cpu().numpy(), touched % N_GAMES)
    last = np.zeros(n_players, np.int64)  # each key's last call
    np.maximum.at(last, keys, np.arange(keys.size))
    pos_rows = tbl.state["pos"][torch.from_numpy(shard),
                                torch.from_numpy(slot)].cpu().numpy()
    assert np.array_equal(pos_rows, pos[last[touched]].astype(np.float32))
    ctbl = rt.table(Counter)
    for i in range(0, 4096, 97):
        kh = rt.actor(Counter, f"player-{i}").key_hash
        assert int(ctbl.read_row(kh)["total"]) == i % 97 + 1
        assert int(cout[i]) == i % 97 + 1
    assert ctbl.active_count() == 4096
    assert rt.conflicts_deferred > 0 and ticks >= 3
    calls = keys.size + 4096
    state = {"player": host_state(tbl), "counter": host_state(ctbl)}
    if not quiet:
        mode = "off-loop worker" if offloop else "inline"
        dup = int((np.bincount(keys) > 1).sum())
        print(f"Phase E ({mode}): {calls} calls ({keys.size} heartbeats in "
              f"64 groups of {group}, {dup} keys called twice or more, "
              f"4096 hashed Counter calls) in {ticks} ticks: "
              f"{calls / wall:.0f} calls/sec, {wall / ticks * 1e3:.3f} "
              f"ms/tick, {wall:.3f} s on {card}")
        print(f"  Phase E ({mode}) stages: {clock.line(wall)}")
        rt.stats = None
        if not offloop:
            # device busy per tick from a profiled rerun of the same
            # schedule, all 64 groups and the hashed calls (its wall is the
            # profiler's; the wall per tick is the timed run's, above)
            t_before = rt.ticks
            kernels = device_breakdown(lambda: asyncio.run(
                drive_heartbeats(rt, Player, Counter, group, keys, pos)),
                iters=1)
            pt = (rt.ticks - t_before) // 2  # one warm-up run, one traced
            report_breakdown(f"Phase E tick (inline; profiled rerun, {pt} "
                             f"ticks)",
                             {k: v / pt for k, v in kernels.items()},
                             wall / ticks * 1e3)
    return state, ticks


async def drive_fanout(rt, Fan, n_subs, events, chunk, rng):
    """Phase G's traffic and checks; returns (reduced values, deliveries,
    per-key calls, broadcast wall seconds, chunks)."""
    from orleans_tpu_torch.dispatch import VectorRuntime, reshard_dense
    from orleans_tpu_torch.parallel import make_mesh
    busy = rng.choice(n_subs, 1024, replace=False)
    futs = [rt.call(Fan, int(k), "on_next", v=np.float32(-1.0))
            for k in busy]
    subs = np.arange(n_subs)
    t0 = time.perf_counter()
    delivered = 0
    for e in range(events):
        delivered += await rt.broadcast_actors(
            Fan, "on_next", subs, {"v": np.float32(e)}, chunk=chunk)
    if rt.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    await asyncio.gather(*futs)
    assert delivered == events * n_subs, delivered
    total = delivered + busy.size  # broadcast edges and per-key calls
    red = {c: await rt.reduce_actors(Fan, "events", combine=c)
           for c in ("sum", "max", "min", "mean")}
    assert int(red["sum"]) == total, (int(red["sum"]), total)
    assert int(red["max"]) == events + 1 and int(red["min"]) == events
    assert float(red["mean"]) == total / n_subs
    assert await rt.map_actors(Fan, "on_next", {"v": np.float32(9.0)}) \
        == n_subs
    total += n_subs
    ready = await rt.join_when(Fan, subs, k=n_subs, method="ready",
                               timeout=600)
    assert ready == n_subs
    red["after_map"] = await rt.reduce_actors(Fan, "events")
    assert int(red["after_map"]) == total
    tbl = rt.table(Fan)
    for shards in (7, SHARDS_B):
        rt2 = VectorRuntime(make_mesh(shards, rt.device),
                            capacity_per_shard=-(-n_subs // shards))
        rt2.tables[Fan] = reshard_dense(tbl, rt2)
        tbl = rt2.table(Fan)
        got = await rt2.reduce_actors(Fan, "events")
        assert int(got) == total, (shards, int(got), total)
        red[f"resharded_{shards}"] = got
    return red, tbl, delivered, busy.size, wall


def chunk_legs(rt, Fan, chunk: int, iters: int = 20):
    """Wall ms of one broadcast chunk's two device legs at Phase G's
    shapes, synchronised: ``route`` ([8, chunk/8] lanes through K2 and
    the exchange) and one ``apply_received`` dedup round with the two
    host syncs ``_broadcast_chunk`` makes per round."""
    n = SHARDS_B
    L = chunk // n
    dev = rt.device
    keys = torch.arange(n * L, device=dev).reshape(n, L)
    payload = {"v": torch.zeros((n, L), device=dev)}
    valid = torch.ones((n, L), dtype=torch.bool, device=dev)
    recv = rt.route(Fan, keys, payload, valid, capacity=L)

    def route():
        rt.route(Fan, keys, payload, valid, capacity=L)

    def apply():
        _, applied = rt.apply_received(Fan, "on_next", recv[0], recv[2],
                                       recv[1])
        left = recv[2] & ~applied
        int(applied.sum())
        int(left.sum())

    out = []
    for fn in (route, apply):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / iters * 1e3)
    return out


def phase_g(dev, card, n_subs=N_G, events=3, chunk=16384, quiet=False):
    """Bulk collectives at the celebrity fan-out width: 1M subscribers
    over 8 logical shards, 3 events broadcast to all with 1,024 per-key
    calls pending (deferred by _busy_split), then reduce (sum, max, min,
    mean), map over every subscriber, join_when at k = all, and the
    reshard 8 → 7 → 8 with the sum unchanged. Every chunk is routed
    through K2."""
    from orleans_tpu_torch.dispatch import VectorRuntime
    from orleans_tpu_torch.ops import KERNELS
    from orleans_tpu_torch.parallel import make_mesh
    Fan = fan_class()
    rt = VectorRuntime(make_mesh(SHARDS_B, dev),
                       capacity_per_shard=-(-n_subs // SHARDS_B))
    rt.table(Fan).ensure_dense(n_subs)
    red, tbl, delivered, n_busy, wall = asyncio.run(drive_fanout(
        rt, Fan, n_subs, events, chunk, np.random.default_rng(4)))
    launched = {k.name: k.launches for k in KERNELS}
    n_chunks = events * -(-n_subs // chunk)
    if not quiet:
        print(f"Phase G: {n_subs} subscribers x {SHARDS_B} shards, {events} "
              f"events in {n_chunks} chunks of {chunk} ({n_busy} per-key "
              f"calls deferred): {delivered / wall:.0f} deliveries/sec, "
              f"{wall / n_chunks * 1e3:.3f} ms/chunk, {wall:.3f} s; "
              f"sum {int(red['sum'])}, after map {int(red['after_map'])}, "
              f"unchanged through reshard 8->7->8 on {card}")
        subs = np.arange(n_subs)
        kernels = device_breakdown(lambda: asyncio.run(
            rt.broadcast_actors(Fan, "on_next", subs,
                                {"v": np.float32(0.5)}, chunk=chunk)),
            iters=1)
        per = -(-n_subs // chunk)
        report_breakdown("Phase G chunk",
                         {k: v / per for k, v in kernels.items()},
                         wall / n_chunks * 1e3)
        route_ms, apply_ms = chunk_legs(rt, Fan, chunk)
        print(f"  Phase G chunk legs: route {route_ms:.3f} ms, apply "
              f"(one dedup round with its two syncs) {apply_ms:.3f} ms, "
              f"the rest (busy split, activation, host pads and uploads) "
              f"{wall / n_chunks * 1e3 - route_ms - apply_ms:.3f} ms of "
              f"{wall / n_chunks * 1e3:.3f} ms")
    return red, host_state(tbl), launched


def phase_f(dev):
    """Phases E and G at 20,000 actors on the card and on the CPU: every
    state row and every reduced value equal."""
    cpu = torch.device("cpu")
    e_cuda, t_cuda = phase_e(dev, "", n_players=20_000, quiet=True)
    e_cpu, t_cpu = phase_e(cpu, "", n_players=20_000, quiet=True)
    assert t_cuda == t_cpu, (t_cuda, t_cpu)
    for k in e_cuda:
        same_state(e_cuda[k], e_cpu[k], f"Phase F E {k}")
    r_cuda, g_cuda, _ = phase_g(dev, "", n_subs=20_000, quiet=True)
    r_cpu, g_cpu, _ = phase_g(cpu, "", n_subs=20_000, quiet=True)
    assert r_cuda.keys() == r_cpu.keys()
    for k in r_cuda:
        a, b = np.asarray(r_cuda[k]), np.asarray(r_cpu[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), (k, a, b)
    same_state(g_cuda, g_cpu, "Phase F G")
    print(f"Phase F: E ({t_cuda} ticks) and G at 20,000 actors x "
          f"{SHARDS_B} shards, card == CPU, exactly")


class DeviceWindow:
    """A context manager that profiles the CUDA kernels run inside it (the
    off-loop worker's too) and its wall time: ``kernels`` (device ms and
    launches by name), ``busy_ms`` and ``wall_ms`` after exit."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall_ms = (time.perf_counter() - self._t0) * 1e3
        self._prof.__exit__(*exc)
        self.kernels = profiled_kernels(self._prof)
        self.busy_ms = sum(ms for ms, _ in self.kernels.values())
        return False


class TraceWindow:
    """A capture of the port's own ``observability.profiling.Profiler``
    around a window: after exit, ``kernels`` (device ms and launches by
    kernel name, from the finished profile), ``trace_kernels`` (the kernel
    events of its ``trace.json``, by name), ``launched`` (K1's and K2's
    launch counts inside the window) and ``wall_ms``."""

    def __init__(self, log_dir: str):
        from orleans_tpu_torch.observability.profiling import Profiler
        self.log_dir = log_dir
        self._prof = Profiler()

    def __enter__(self):
        from orleans_tpu_torch.ops import KERNELS
        self._launches = {k.name: k.launches for k in KERNELS}
        self._prof.start(self.log_dir)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from orleans_tpu_torch.ops import KERNELS
        self._prof.stop()
        self.wall_ms = (time.perf_counter() - self._t0) * 1e3
        self.launched = {k.name: k.launches - self._launches[k.name]
                         for k in KERNELS}
        self.kernels = profiled_kernels(self._prof.last)
        with open(os.path.join(self.log_dir, "trace.json")) as f:
            events = json.load(f).get("traceEvents", [])
        self.trace_kernels = {}
        for e in events:
            if e.get("cat") == "kernel":
                n = e.get("name", "")
                self.trace_kernels[n] = self.trace_kernels.get(n, 0) + 1
        return False


def build_tmpdir(prefix: str) -> str:
    """A new temporary directory under ``orleans_tpu_torch/_build``
    (gitignored); the caller removes it."""
    scratch = os.path.join(ROOT, "orleans_tpu_torch", "_build")
    os.makedirs(scratch, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=scratch)


def presence_sample():
    sys.path.insert(0, os.path.join(ROOT, "samples"))
    import presence_torch
    return presence_torch


def drive_hosted(dev, n_players, profile=None):
    """``presence_torch.drive_presence`` over silos on ``dev`` (8 shards)
    with its default schedule and the default 30 s response timeout;
    returns (results, stats)."""
    pt = presence_sample()
    from orleans_tpu_torch.parallel import make_mesh
    from orleans_tpu_torch.runtime import ClusterClient
    from orleans_tpu_torch.storage import MemoryStorage
    mesh = make_mesh(SHARDS_B, dev)
    sched = pt.presence_schedule(n_players, seed=5)

    def build(storage, checkpoint_dir):
        return pt.build_silo(n_players, mesh, storage=storage,
                             checkpoint_dir=checkpoint_dir)

    ckdir = build_tmpdir("phase_h_ckpt_")
    try:
        return asyncio.run(pt.drive_presence(
            build, ClusterClient, MemoryStorage(), pt.PlayerVectorGrain,
            pt.GameGrain, sched, ckdir, profile=profile))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def phase_h(dev, card):
    """Presence through a hosted silo at N_H players; prints the hosted
    path's rates (each step's wall, and the part of it that write-behind
    flushes held the loop) and the device idle share of one profiled
    ``client.call_batch`` batch. Returns the kernels' launch counts of the
    drive and its stats (Phase L prints its steps beside them), then times
    the summary's device work at its shapes outside the silo (those
    launches are not the drive's)."""
    from orleans_tpu_torch.dispatch import VectorRuntime
    from orleans_tpu_torch.ops import KERNELS, segment_sum
    from orleans_tpu_torch.parallel import make_mesh
    windows = {}
    trace_dir = build_tmpdir("phase_h_trace_")

    def profile(step):
        windows[step] = (TraceWindow(trace_dir) if step == "summary"
                         else DeviceWindow())
        return windows[step]

    pt = presence_sample()
    n_players = N_H
    t0 = time.perf_counter()
    try:
        with GcPauses() as gc_h:
            res, st = drive_hosted(dev, n_players, profile)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    launched = {k.name: k.launches for k in KERNELS}

    def step(name, count, what):
        secs, held = st[f"{name}_s"], st[f"{name}_flush_s"]
        clear = (f"{count / (secs - held):.0f} {what}/sec outside them"
                 if secs - held > 0.01 * secs else "all of it")
        return (f"{count / secs:.0f} {what}/sec, {secs:.3f} s, of which "
                f"{held:.3f} s overlapped by write-behind flushes "
                f"({clear}); event-loop stalls over "
                f"{pt.STALL_S * 1e3:.0f} ms {st[f'{name}_stalled_s']:.3f} s"
                f", the longest {st[f'{name}_stall_s'] * 1e3:.1f} ms")

    calls = 16 * 4096
    print(f"Phase H: Presence hosted in a silo, {n_players} players x "
          f"{SHARDS_B} shards, off-loop tick, write-behind every 0.5 s, "
          f"on {card}; {wall:.3f} s in all")
    print(f"  waves: 5 x {n_players} heartbeats through silo.vector"
          f".call_batch: {step('waves', 5 * n_players, 'msgs')} on {card}")
    print(f"  client.call_batch: {calls} heartbeats in 16 batches of 4096 "
          f"over {st['batch_ticks']} ticks "
          f"({st['batch_s'] / st['batch_ticks'] * 1e3:.3f} ms/tick), "
          f"{st['batch_conflicts']} conflicts deferred: "
          f"{step('batch', calls, 'calls')} on {card}")
    clear = st["batch_clear_s"]
    if clear:
        print(f"  client.call_batch, the {len(clear)} batches no flush "
              f"overlapped: median {np.median(clear) * 1e3:.3f} ms a batch "
              f"({4096 / np.median(clear):.0f} calls/sec), min "
              f"{min(clear) * 1e3:.3f}, max {max(clear) * 1e3:.3f} ms on "
              f"{card}")
    w = windows["batch"]
    print(f"  client.call_batch, last batch profiled: device busy "
          f"{w.busy_ms:.4f} ms of {w.wall_ms:.3f} ms wall (idle share "
          f"{max(0.0, 1 - w.busy_ms / w.wall_ms):.4f}) on {card}")
    print(f"  single calls: 4096 heartbeats + 1024 whereis through "
          f"get_grain over {st['single_ticks']} ticks "
          f"({st['single_s'] / max(1, st['single_ticks']) * 1e3:.3f} "
          f"ms/tick), {st['single_conflicts']} conflicts deferred: "
          f"{step('single', 4096 + 1024, 'calls')} on {card}")
    chunks = -(-n_players // 16384)
    print(f"  client.broadcast_actors: {res['delivered']} deliveries in "
          f"{chunks} chunks ({st['broadcast_s'] / chunks * 1e3:.3f} "
          f"ms/chunk): {step('broadcast', res['delivered'], 'deliveries')}"
          f"; reduce_actors sum {res['score_sum']}, join_when "
          f"{res['joined']} on {card}")
    print(f"  GameGrain.summary: 64 in {st['summary_s']:.3f} s "
          f"({st['summary_s'] / 64 * 1e3:.3f} ms/summary), of which "
          f"{st['summary_flush_s']:.3f} s overlapped by write-behind "
          f"flushes on {card}")
    w = windows["summary"]
    k1 = [k for k in w.kernels if "segment_sum_kernel" in k]
    print(f"  GameGrain.summary, the last one in a capture of "
          f"observability.profiling.Profiler: {w.wall_ms:.3f} ms wall; K1 "
          f"launched {w.launched['segment_sum']} times in it; the "
          f"profile's {len(w.kernels)} kernels {kernel_names(w.kernels)} "
          f"(K1 among "
          f"them: {bool(k1)}, device "
          f"{sum(w.kernels[k][0] for k in k1):.4f} ms, all "
          f"{sum(t for t, _ in w.kernels.values()):.4f} ms); trace.json: "
          f"{sum(w.trace_kernels.values())} kernel events on {card}")
    assert w.launched["segment_sum"] == 1, "the summary did not run K1"
    assert k1 and any("segment_sum" in k for k in w.trace_kernels), \
        "the port's Profiler missed the summary's K1 inside the silo"
    clear = st["summary_clear_s"]
    if clear:
        print(f"  GameGrain.summary, the {len(clear)} calls no flush "
              f"overlapped: median {np.median(clear) * 1e3:.3f} ms, min "
              f"{min(clear) * 1e3:.3f}, max {max(clear) * 1e3:.3f} ms on "
              f"{card}")
    for kind, what in (("periodic", "periodic flushes"),
                       ("final", "the final drain in silo.stop")):
        rows, secs = st[f"{kind}_flush_rows"], st[f"{kind}_flush_s"]
        print(f"  write-behind, {what}: {rows} rows in {secs:.3f} s"
              f" ({rows / secs if secs else 0:.0f} rows/sec) on {card}")
    print(f"  silo.stop {st['stop_s']:.3f} s; checkpoint: "
          f"{st['checkpoint_bytes']} bytes, save {st['save_s']:.3f} s, "
          f"restore {st['restore_s']:.3f} s (equal to the pre-stop table "
          f"bit for bit); a storage-only silo reloaded "
          f"{res['loaded'].size} players and continued their scores, on "
          f"{card}")
    print(f"  {gc_h.line()} (in H's drive)")
    # the summary's device work at its shapes: a table of n_players
    # activated by one wave, its operands as GameGrain builds them
    rt = VectorRuntime(make_mesh(SHARDS_B, dev),
                       capacity_per_shard=-(-n_players // SHARDS_B))
    rt.table(pt.PlayerVectorGrain).ensure_dense(n_players)
    keys = np.arange(n_players)
    rt.call_batch(pt.PlayerVectorGrain, "heartbeat", keys, {
        "pos": np.zeros((n_players, 2), np.float16),
        "delta": np.ones(n_players, np.int32)})
    tbl = rt.table(pt.PlayerVectorGrain)
    values, ids = pt.game_operands(tbl)
    k1_ms = time_ms(lambda: segment_sum(values, ids, pt.N_GAMES))
    totals_ms = time_ms(lambda: pt.game_totals(tbl))
    kernels = device_profile(lambda: pt.game_totals(tbl), iters=5)
    k1_dev = sum(t for k, (t, _) in kernels.items()
                 if "segment_sum_kernel" in k)
    busy = sum(t for t, _ in kernels.values())
    print(f"  summary's device work at its shapes ([{n_players}, 2] int32 "
          f"into {pt.N_GAMES} games): game_totals {totals_ms:.4f} ms, K1 "
          f"{k1_ms:.4f} ms (CUDA events); profiler: K1 device "
          f"{k1_dev:.4f} ms, all kernels {busy:.4f} ms a summary on {card}")
    return launched, st


def same_results(a, b, label: str) -> None:
    """Equal nested results (dicts, arrays, ints), dtypes included."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), label
        for k in a:
            same_results(a[k], b[k], f"{label}.{k}")
        return
    x, y = np.asarray(a), np.asarray(b)
    assert x.dtype == y.dtype and x.shape == y.shape, (label, x.dtype,
                                                       y.dtype)
    assert np.array_equal(x, y), f"{label} differs"


def phase_i(dev):
    """Phase H's drive at 20,000 players on the card and on the CPU: every
    returned value and the final tables equal. Returns the card's results
    and stats (Phase L's drive over TCP must give the same results)."""
    got_cuda, st_cuda = drive_hosted(dev, N_I)
    got_cpu, _ = drive_hosted(torch.device("cpu"), N_I)
    same_results(got_cuda, got_cpu, "Phase I")
    print(f"Phase I: Phase H's drive at {N_I} players x {SHARDS_B} shards, "
          f"card == CPU, exactly (every answer and the final table)")
    return got_cuda, st_cuda


def rewind_class():
    from orleans_tpu_torch.dispatch import VectorGrain, actor_method

    class RewindVec(VectorGrain):
        """Phase J's rewound subscriber: counts and sums events and keeps
        ``ok`` at 1 while every event exceeds the one before (the
        publisher's values rise, so a replay out of order or twice
        clears it)."""

        STATE = {"events": (torch.int32, ()), "total": (torch.float32, ()),
                 "last": (torch.float32, ()), "ok": (torch.int32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"events": torch.zeros_like(key_hash),
                    "total": key_hash.new_zeros((), dtype=torch.float32),
                    "last": key_hash.new_full((), -1.0, dtype=torch.float32),
                    "ok": torch.ones_like(key_hash)}

        @actor_method(args={"v": (torch.float32, ())})
        def on_next(state, args):
            good = (args["v"] > state["last"]).to(torch.int32)
            return {"events": state["events"] + 1,
                    "total": state["total"] + args["v"], "last": args["v"],
                    "ok": state["ok"] * good}, state["events"]

    return RewindVec


def sensor_class():
    from orleans_tpu_torch.dispatch import VectorGrain, actor_method
    from orleans_tpu_torch.streams import implicit_stream_subscription

    @implicit_stream_subscription("telemetry")
    class SensorVec(VectorGrain):
        """The persistent provider's vector consumer of
        tests/test_vector_streams.py: one row per sensor key."""

        STATE = {"events": (torch.int32, ()), "total": (torch.float32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"events": torch.zeros_like(key_hash),
                    "total": key_hash.new_zeros((), dtype=torch.float32)}

        @actor_method(args={"v": (torch.float32, ())})
        def on_next(state, args):
            new = {"events": state["events"] + 1,
                   "total": state["total"] + args["v"]}
            return new, new["events"]

    return SensorVec


def dense_rows(silos, cls, n) -> dict:
    """Each field of ``cls`` as a host array over keys 0..n-1, summed over
    the silos (a dense row nobody owns stays zero), and which silo holds
    each key's activated row (-1 for none, -2 for more than one)."""
    out, where = {}, np.full(n, -1, np.int64)
    for i, s in enumerate(silos):
        tbl = s.vector.table(cls)
        per = tbl.dense_per_shard
        for f, v in tbl.state.items():
            rows = v[:, :per].reshape(-1)[:n].cpu().numpy()
            out[f] = out[f] + rows if f in out else rows.copy()
        active = tbl.dense_active[:n]
        where = np.where(active, np.where(where == -1, i, -2), where)
    out["silo"] = where
    return out


async def await_count(read, target, label, timeout=300.0, step=0.002):
    """Poll ``read()`` until it reaches ``target``; fail after ``timeout``
    seconds."""
    deadline = time.perf_counter() + timeout
    while read() < target:
        assert time.perf_counter() < deadline, \
            f"{label}: {read()} of {target} after {timeout} s"
        await asyncio.sleep(step)


def drive_streams(dev, n_subs, profile=None):
    """Phase J's device-stream traffic on two port silos of one
    InProcFabric (8 shards each, on ``dev``), through
    ``DeviceStreamProvider``: ``subscribe_keys`` of all ``n_subs``
    FanVec rows, a rewound subscription of ``J_REWIND`` RewindVec rows
    from token 1 (armed before any publish, so its catch-up cursor must
    skip the warm batch and replay 1-3 exactly), one warm publish, then
    3 publishes of ``{"v": e + 1}`` (the last inside ``profile()`` when
    given). Checks every count exactly and returns (rows, stats)."""
    from orleans_tpu_torch.core.ids import GrainCategory, GrainId, GrainType
    from orleans_tpu_torch.dispatch import add_vector_grains
    from orleans_tpu_torch.parallel import make_mesh
    from orleans_tpu_torch.runtime import InProcFabric, SiloBuilder
    from orleans_tpu_torch.streams import StreamId, add_device_streams
    Fan, Rewind = fan_class(), rewind_class()
    rkeys = np.arange(J_REWIND, dtype=np.int64) * (n_subs // J_REWIND)
    st: dict = {}

    async def run():
        fabric = InProcFabric()
        silos = []
        for i in range(2):
            b = SiloBuilder().with_name(f"phase-j-{i}").with_fabric(fabric)
            add_vector_grains(b, Fan, Rewind, mesh=make_mesh(SHARDS_B, dev),
                              capacity_per_shard=-(-n_subs // SHARDS_B),
                              dense={Fan: n_subs, Rewind: n_subs})
            add_device_streams(b, "device")
            silos.append(b.build())
        started = []
        try:
            for s in silos:
                await s.start()
                started.append(s)
            provider = silos[0].stream_providers["device"]
            stats = silos[0].stats
            delivered = lambda: stats.get("streams.device.delivered")  # noqa: E731
            stream = StreamId("device", "celebrity", "post")
            t0 = time.perf_counter()
            await provider.subscribe_keys("celebrity", Fan, np.arange(n_subs))
            rew = await provider.subscribe_keys("celebrity", Rewind, rkeys,
                                                from_token=1)
            assert not rew.live
            assert await provider.produce(stream, [{"v": np.float32(0.5)}]) == 0
            await await_count(delivered, n_subs, "Phase J warm publish")
            st["subscribe_s"] = time.perf_counter() - t0
            grp = provider._namespaces["celebrity"].groups[("FanVec",
                                                            "on_next")]
            st["parts"] = {str(a): int(e.size) for a, e in grp.parts.items()}
            st["chunks"] = sum(-(-int(e.size) // provider.chunk)
                               for e in grp.parts.values())
            t0 = time.perf_counter()
            for e in range(2):
                await provider.produce(stream, [{"v": np.float32(e + 1)}])
            target = 3 * n_subs + 2 * J_REWIND
            await await_count(delivered, target, "Phase J publishes 1-2")
            st["timed_s"] = time.perf_counter() - t0
            st["timed_deliveries"] = target - n_subs
            ctx = profile() if profile is not None else None
            if ctx is not None:
                ctx.__enter__()
            t0 = time.perf_counter()
            await provider.produce(stream, [{"v": np.float32(3.0)}])
            await await_count(delivered, 4 * n_subs + 3 * J_REWIND,
                              "Phase J publish 3")
            st["last_s"] = time.perf_counter() - t0
            if ctx is not None:
                ctx.__exit__(None, None, None)
            deadline = time.perf_counter() + 30
            while not rew.live:  # caught up: merged into the fused list
                assert time.perf_counter() < deadline, "rewind never merged"
                await asyncio.sleep(0.01)
            st["delivered"] = delivered()
            st["produced"] = stats.get("streams.device.produced")
            st["dropped"] = sum(s.stats.get(k) for s in silos for k in (
                "streams.device.delivery_errors",
                "streams.device.signals_dropped"))
            fan = dense_rows(silos, Fan, n_subs)
            rew_rows = dense_rows(silos, Rewind, n_subs)
            # every row on its ring owner: the GrainId hash of the key,
            # built as GrainId.for_grain builds it, without interning
            ring = silos[0].locator.ring
            idx = {s.silo_address: i for i, s in enumerate(silos)}

            def owners(cls, keys):
                tc = GrainType.of(cls.__name__).type_code
                return np.fromiter(
                    (idx[ring.owner(GrainId(GrainCategory.GRAIN, tc, int(k))
                                    .uniform_hash)] for k in keys),
                    np.int64, len(keys))
            t0 = time.perf_counter()
            owner = owners(Fan, range(n_subs))
            st["owner_check_s"] = time.perf_counter() - t0
            return fan, rew_rows, owner, owners(Rewind, rkeys)
        finally:
            for s in started:
                await s.stop()

    fan, rew, owner, rew_owner = asyncio.run(run())
    assert (fan["events"] == 4).all(), "Phase J: a subscriber missed events"
    assert (fan["last"] == 3.0).all(), "Phase J: a subscriber's last event"
    assert (fan["silo"] == owner).all(), "Phase J: a row off its ring owner"
    mask = np.zeros(n_subs, bool)
    mask[rkeys] = True
    assert (rew["events"][mask] == 3).all() and (rew["ok"][mask] == 1).all()
    assert (rew["total"][mask] == 6.0).all() and (rew["last"][mask] == 3.0
                                                   ).all()
    assert (rew["events"][~mask] == 0).all() and (rew["silo"][~mask] == -1
                                                   ).all()
    assert (rew["silo"][rkeys] == rew_owner).all()
    assert st["produced"] == 4 and st["dropped"] == 0
    assert st["delivered"] == 4 * n_subs + 3 * J_REWIND == \
        int(fan["events"].sum() + rew["events"].sum())
    return {"fan": fan, "rewind": rew}, st


def drive_persistent(dev, n, fanout: bool, items: int = 4):
    """The persistent provider's vector path: one silo (8 shards on
    ``dev``) with ``add_persistent_streams`` over a ``MemoryQueueAdapter``
    and the implicitly subscribed SensorVec; one warm bulk item of ``n``
    events, then ``items`` more in one produce, each ``{"keys":
    arange(n), "args": {"v": key % 7}}``. ``fanout`` arms
    ``StreamOptions(device_fanout=True)``, so the items ride
    ``stream_fanout`` (K2 on every chunk) instead of ``call_batch``.
    Checks every row exactly; returns (rows, events/sec)."""
    from orleans_tpu_torch.config import StreamOptions
    from orleans_tpu_torch.dispatch import add_vector_grains
    from orleans_tpu_torch.parallel import make_mesh
    from orleans_tpu_torch.runtime import InProcFabric, SiloBuilder
    from orleans_tpu_torch.streams import (MemoryQueueAdapter, StreamId,
                                           add_persistent_streams)
    Sensor = sensor_class()
    v = (np.arange(n) % 7).astype(np.float32)
    item = {"keys": np.arange(n), "args": {"v": v}}

    async def run():
        b = (SiloBuilder().with_name("phase-j-queue")
             .with_fabric(InProcFabric())
             .with_options(StreamOptions(device_fanout=fanout)))
        add_vector_grains(b, Sensor, mesh=make_mesh(SHARDS_B, dev),
                          capacity_per_shard=-(-n // SHARDS_B),
                          dense={Sensor: n})
        add_persistent_streams(b, "queue", MemoryQueueAdapter(n_queues=1),
                               pull_period=0.005)
        silo = b.build()
        await silo.start()
        try:
            provider = silo.stream_providers["queue"]
            stream = StreamId("queue", "telemetry", "bulk")
            got = lambda: silo.stats.get("streams.vector.delivered")  # noqa: E731
            await provider.produce(stream, [item])
            await await_count(got, n, "Phase J persistent warm item")
            t0 = time.perf_counter()
            await provider.produce(stream, [item] * items)
            await await_count(got, (1 + items) * n, "Phase J persistent")
            rate = items * n / (time.perf_counter() - t0)
            return dense_rows([silo], Sensor, n), rate
        finally:
            await silo.stop()

    rows, rate = asyncio.run(run())
    assert (rows["events"] == 1 + items).all(), "Phase J persistent events"
    assert (rows["total"] == (1 + items) * v).all(), "Phase J persistent total"
    return rows, rate


def phase_j(dev, card):
    """Phase J: the celebrity fan-out of benchmarks/gauntlet.py through the
    port's DeviceStreamProvider at 1,048,576 subscribers over 8 shards on
    two silos, and the persistent provider's vector path with bulk items
    of 1,048,576 events; returns the kernels' launch counts of both."""
    from orleans_tpu_torch.ops import KERNELS, RANK_BY_DEST
    windows = []

    def profile():
        windows.append(DeviceWindow())
        return windows[-1]

    t0 = time.perf_counter()
    _, st = drive_streams(dev, N_J, profile)
    k2_streams = RANK_BY_DEST.launches
    off_rows, off_rate = drive_persistent(dev, N_J, fanout=False)
    on_rows, on_rate = drive_persistent(dev, N_J, fanout=True)
    for f in off_rows:
        assert np.array_equal(off_rows[f], on_rows[f]), \
            f"Phase J persistent: the fan-out lever changed field {f}"
    launched = {k.name: k.launches for k in KERNELS}
    wall = time.perf_counter() - t0
    w = windows[0]
    print(f"Phase J: device streams, {N_J} subscribers x {SHARDS_B} shards "
          f"on 2 silos (parts {sorted(st['parts'].values())}, "
          f"{st['chunks']} delivery chunks a publish), on {card}; "
          f"{wall:.3f} s in all")
    print(f"  subscribe_keys + the first delivery (ownership partition "
          f"included): {st['subscribe_s']:.3f} s on {card}")
    print(f"  publishes 1-2: {st['timed_deliveries']} deliveries in "
          f"{st['timed_s']:.3f} s, "
          f"{st['timed_deliveries'] / st['timed_s']:.0f} deliveries/sec "
          f"on {card}")
    print(f"  publish 3 profiled: {w.wall_ms:.3f} ms wall for "
          f"{st['chunks']} chunks ({w.wall_ms / st['chunks']:.3f} ms/chunk), "
          f"device busy {w.busy_ms:.4f} ms "
          f"({w.busy_ms / st['chunks']:.4f} ms/chunk, idle share "
          f"{max(0.0, 1 - w.busy_ms / w.wall_ms):.4f}) on {card}")
    print(f"  rewound subscription: {J_REWIND} keys from token 1 heard "
          f"tokens 1-3 exactly once, in order; every row on its ring "
          f"owner (checked in {st['owner_check_s']:.3f} s); delivered "
          f"{st['delivered']} = 4 x {N_J} + 3 x {J_REWIND}, dropped "
          f"{st['dropped']}")
    print(f"  persistent provider, bulk items of {N_J} events: "
          f"{off_rate:.0f} events/sec through call_batch, {on_rate:.0f} "
          f"events/sec through stream_fanout (device_fanout on), the same "
          f"rows either way, on {card}")
    print(f"  K2 launches: {k2_streams} in the device streams, "
          f"{launched[RANK_BY_DEST.name]} with the persistent path")
    k2 = [(t, c) for k, (t, c) in w.kernels.items()
          if "rank_by_dest_kernel" in k]
    print(f"  K2 in the profiled publish: {sum(c for _, c in k2):g} "
          f"launches, {sum(t for t, _ in k2) / max(1, sum(c for _, c in k2)):.6f}"
          f" ms device each on {card}")
    # K2 alone at a delivery chunk's shape (these launches come after the
    # phase's count was read)
    from orleans_tpu_torch.ops import rank_by_dest, rank_by_dest_ref
    label, g = j_chunk_dests(dev)[0]

    def k2_call():
        return rank_by_dest(g, SHARDS_B + 1)

    k2 = [(t, c) for k, (t, c) in device_profile(k2_call).items()
          if "rank_by_dest_kernel" in k]
    seen = sum(c for _, c in k2)
    print(f"  K2 at the {label} shape {tuple(g.shape)}: wrapper "
          f"{time_ms(k2_call):.4f} ms (CUDA events), device "
          f"{sum(t for t, _ in k2) / max(seen, 1e-9):.6f} ms a launch "
          f"(the profile kept {seen:g} launches a call), plain "
          f"{time_ms(lambda: rank_by_dest_ref(g, SHARDS_B + 1), iters=5):.4f}"
          f" ms, bound {g.nbytes * 2 / HBM_BYTES_PER_S * 1e3:.6f} ms "
          f"(bytes) on {card}")
    return launched


def phase_j_cpu(dev):
    """Phase J's scenario at N_J_CPU subscribers on the card and on the
    CPU: every row (summed over the two silos) and every persistent row
    equal."""
    cpu = torch.device("cpu")
    got = [drive_streams(d, N_J_CPU)[0] for d in (dev, cpu)]
    for cls in ("fan", "rewind"):
        for f, a in got[0][cls].items():
            if f == "silo":  # each run has its own ring of silo addresses
                continue
            b = got[1][cls][f]
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                f"Phase J {cls}.{f}: card != CPU"
    for fanout in (False, True):
        a, _ = drive_persistent(dev, N_J_CPU, fanout)
        b, _ = drive_persistent(cpu, N_J_CPU, fanout)
        for f in a:
            assert np.array_equal(a[f], b[f]), f"Phase J persistent {f}"
    print(f"Phase J: the same scenario at {N_J_CPU} subscribers, card == "
          f"CPU, exactly (every row of both providers' paths)")


def rebalance_class():
    from orleans_tpu_torch.dispatch import VectorGrain, actor_method

    class RebalanceVec(VectorGrain):
        """tests/test_rebalance.py's CounterVec: a hashed-regime counter."""

        STATE = {"count": (torch.int32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"count": torch.zeros_like(key_hash)}

        @actor_method(args={"x": (torch.int32, ())})
        def bump(state, args):
            new = {"count": state["count"] + args["x"]}
            return new, new["count"]

    return RebalanceVec


class Timed:
    """Wrap ``obj.name`` (an instance or module attribute) to add the wall
    seconds of each call, after a device sync on ``dev``, to ``spent``;
    ``record(args)`` sees each call's arguments. ``restore()`` undoes it."""

    def __init__(self, obj, name, dev, spent: list, record=None):
        self.obj, self.name = obj, name
        self.had = name in vars(obj)
        inner = getattr(obj, name)

        def call(*a, **kw):
            if record is not None:
                record(a)
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            spent.append(time.perf_counter() - t0)
            return out
        self.inner = inner
        setattr(obj, name, call)

    def restore(self):
        if self.had:
            setattr(self.obj, self.name, self.inner)
        else:
            delattr(self.obj, self.name)


def drive_cluster(dev, n_keys, profile=None):
    """Phase K's live cluster on ``dev``: the port's ``TestCluster`` of two
    silos (membership, management, ``with_rebalancer(period=0)``) on one
    InProcFabric, each with RebalanceVec over 8 shards of 65,536 slots,
    write-behind to the cluster's MemoryStorage, ``rebalance_budget``
    16,384 and ``rebalance_imbalance_ratio`` 1.2. ``n_keys`` string keys
    ``u{i}`` (63-bit hashes) are activated through ``client.call_batch``;
    3 rounds of 65,536 ``bump(x=1)`` calls (seed 7; half to keys that sat
    on shard 0 of their silo at activation, half uniform over the rest,
    batches of 4,096) each followed by ``run_round()`` on each silo's
    rebalancer (the first of the silo with more keys inside
    ``profile()`` when given);
    then the write-behind drain, a kill of silo 1, its death, and 4,096
    of its keys called through the survivor; ``stop_all()`` within 60 s.
    Checks every count and move exactly; returns (results, stats)."""
    import orleans_tpu_torch.ops.route as route
    from orleans_tpu_torch.core.ids import GrainId, GrainType
    from orleans_tpu_torch.management import ManagementGrain
    from orleans_tpu_torch.ops import RANK_BY_DEST
    from orleans_tpu_torch.parallel import make_mesh
    from orleans_tpu_torch.storage import MemoryStorage
    from orleans_tpu_torch.testing import TestClusterBuilder
    Vec = rebalance_class()
    keys = [f"u{i}" for i in range(n_keys)]
    gt = GrainType.of(Vec.__name__)
    hashes = [GrainId.for_grain(gt, k).uniform_hash for k in keys]
    model = np.zeros(n_keys, np.int64)
    res: dict = {"moves": [], "rows_moved": [], "shares": []}
    st: dict = {"round_s": [], "plan_s": [], "pack_s": [], "move_s": [],
                "k2_shapes": [], "k2_rounds": 0, "k2_operands": []}

    async def call(idx, x):
        """One client.call_batch of ``keys[idx]``; the answers."""
        futs = cluster.client.call_batch(
            Vec, "bump", [(keys[i], {"x": x}) for i in idx])
        return np.array([int(v) for v in await asyncio.gather(*futs)],
                        np.int64)

    def locations(tbl):
        """key index -> (shard, slot) of the keys ``tbl`` holds."""
        k2s = tbl.key_to_slot
        return {i: k2s[h] for i, h in enumerate(hashes) if h in k2s}

    def counts(silo_tables):
        out = np.full(n_keys, -1, np.int64)
        for tbl in silo_tables:
            loc = locations(tbl)
            idx = np.fromiter(loc, np.int64, len(loc))
            sh = torch.tensor([loc[i][0] for i in idx], dtype=torch.int64,
                              device=tbl.device)
            sl = torch.tensor([loc[i][1] for i in idx], dtype=torch.int64,
                              device=tbl.device)
            with tbl.fence:
                out[idx] = tbl.state["count"][sh, sl].cpu().numpy()
        return out

    def record_pack(args):
        st["k2_shapes"].append(tuple(args[0].shape))
        st["k2_operands"].append(args[0].detach().clone())

    cluster = None

    async def run():
        nonlocal cluster
        storage = MemoryStorage()
        cluster = (TestClusterBuilder(2).with_storage(storage)
                   .with_config(membership_probe_period=1.0,
                                membership_probe_timeout=5.0,
                                membership_missed_probes_limit=2,
                                response_timeout=30.0,
                                rebalance_budget=16384,
                                rebalance_imbalance_ratio=1.2)
                   .with_vector_grains(Vec, mesh=make_mesh(SHARDS_B, dev),
                                       capacity_per_shard=65536,
                                       storage=storage, flush_period=0.5)
                   .with_rebalancer(period=0).build())
        await cluster.deploy()
        try:
            await drive(storage)
        finally:
            t0 = time.perf_counter()
            await asyncio.wait_for(cluster.stop_all(), 60)
            st["stop_s"] = time.perf_counter() - t0

    async def drive(storage):
        silos = cluster.silos
        tbls = [s.vector.table(Vec) for s in silos]
        t0 = time.perf_counter()
        for lo in range(0, n_keys, K_BATCH):
            got = await call(range(lo, min(lo + K_BATCH, n_keys)), 0)
            assert not got.any(), "Phase K: a fresh key's count is not 0"
        st["activate_s"] = time.perf_counter() - t0
        locs = [locations(t) for t in tbls]
        owner = np.full(n_keys, -1, np.int64)
        shard0 = np.zeros(n_keys, bool)
        for si, loc in enumerate(locs):
            idx = np.fromiter(loc, np.int64, len(loc))
            assert (owner[idx] == -1).all(), "Phase K: a key on two silos"
            owner[idx] = si
            shard0[idx] = [loc[i][0] == 0 for i in idx]
        assert (owner >= 0).all(), "Phase K: a key has no silo"
        res["owner"] = owner
        active = [t.active_count() for t in tbls]
        assert sum(active) == n_keys, f"Phase K: {active} rows for {n_keys}"
        big = int(np.argmax(active))  # the ring splits keys unevenly
        st["profiled_silo"] = big
        for s in silos:  # manual rounds: the caller turns the counters on
            s.vector.enable_load_tracking()
        timers = []
        for s, tbl in zip(silos, tbls):
            timers.append(Timed(s.rebalancer.planner, "plan", dev,
                                st["plan_s"]))
            timers.append(Timed(tbl, "move_rows", dev, st["move_s"]))
        timers.append(Timed(route, "pack_by_dest", dev, st["pack_s"],
                            record_pack))
        rng = np.random.default_rng(7)
        hot, rest = np.flatnonzero(shard0), np.flatnonzero(~shard0)
        half = K_BATCH // 2
        try:
            for r in range(K_ROUNDS):
                t0 = time.perf_counter()
                for _ in range(K_CALLS // K_BATCH):
                    idx = np.concatenate([rng.choice(hot, half, replace=False),
                                          rng.choice(rest, half,
                                                     replace=False)])
                    rng.shuffle(idx)
                    model[idx] += 1
                    got = await call(idx, 1)
                    assert np.array_equal(got, model[idx]), \
                        f"Phase K round {r + 1}: an answer is off the model"
                st["round_s"].append(time.perf_counter() - t0)
                for si, (s, tbl) in enumerate(zip(silos, tbls)):
                    hits = tbl.shard_hits()
                    res["shares"].append(float(hits[0]) / float(hits.sum()))
                    before = locations(tbl)
                    k2 = RANK_BY_DEST.launches
                    window = profile() if (profile is not None and r == 0
                                           and si == big) else None
                    if window is not None:
                        with window:
                            outcome = await s.rebalancer.run_round()
                        st["window"] = window
                    else:
                        outcome = await s.rebalancer.run_round()
                    after = locations(tbl)
                    assert set(after) == set(before), \
                        f"Phase K: silo {si} lost or gained a key"
                    moved = sorted((i, after[i][0]) for i in after
                                   if after[i][0] != before[i][0])
                    assert outcome["rows_moved"] == len(moved), \
                        (f"Phase K round {r + 1} silo {si}: rows_moved "
                         f"{outcome['rows_moved']} != {len(moved)} moved")
                    assert outcome["migrated"] == 0
                    res["moves"].append(moved)
                    res["rows_moved"].append(outcome["rows_moved"])
                    packed = 1 if outcome["planned"] else 0
                    st["k2_rounds"] += packed
                    want = packed if dev.type == "cuda" else 0
                    assert RANK_BY_DEST.launches - k2 == want, \
                        (f"Phase K round {r + 1} silo {si}: K2 launched "
                         f"{RANK_BY_DEST.launches - k2} times, want {want}")
        finally:
            for t in timers:
                t.restore()
        assert [t.active_count() for t in tbls] == active, \
            "Phase K: a silo's row count changed"
        assert sum(res["rows_moved"]) > 0, "Phase K: no row moved"
        for si in range(2):
            first, last = res["shares"][si], res["shares"][4 + si]
            assert last < first, \
                f"Phase K silo {si}: hot shard share {first} -> {last}"
        got = counts(tbls)
        assert np.array_equal(got, model), "Phase K: counts off the model"
        res["counts"] = got
        mgmt = cluster.client.get_grain(ManagementGrain, 0)
        stats = await mgmt.get_simple_grain_statistics()
        hosts = await mgmt.get_hosts()
        assert stats.get("RebalanceVec") == n_keys, stats
        names = {str(s.silo_address): i for i, s in enumerate(silos)}
        res["hosts"] = sorted((names[a], v) for a, v in hosts.items())
        assert res["hosts"] == [(0, "Active"), (1, "Active")], hosts
        # failover: the write-behind drain, a kill, its death, the reads
        victim, survivor = silos[1], silos[0]
        sample = np.flatnonzero(owner == 1)[:K_FAILOVER]
        # the bridge stores a hashed row under its key hash
        gids = [GrainId.for_grain(gt, hashes[i]) for i in sample]
        t0 = time.perf_counter()
        deadline = t0 + 120.0
        while True:
            stored = [await storage.read(Vec.__name__, g) for g in gids]
            vals = np.array([-1 if s is None else int(np.asarray(s["count"]))
                             for s, _ in stored], np.int64)
            if not victim.vector._dirty.get(Vec) and \
                    np.array_equal(vals, model[sample]):
                break
            assert time.perf_counter() < deadline, \
                "Phase K: the write-behind flush did not drain in 120 s"
            await asyncio.sleep(0.05)
        st["flush_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        await cluster.kill_silo(victim)
        await cluster.wait_for_death(victim, timeout=60.0)
        st["death_s"] = time.perf_counter() - t0
        res["views"] = [(sorted(names[str(a)] for a in s.membership.active),
                         sorted(names[str(a)] for a in s.membership.dead
                                if str(a) in names))
                        for s in cluster.alive_silos]
        assert res["views"] == [([0], [1])], res["views"]
        t0 = time.perf_counter()
        got = await call(sample, 0)
        st["failover_s"] = time.perf_counter() - t0
        assert np.array_equal(got, model[sample]), \
            "Phase K failover: a key lost its persisted count"
        assert survivor.stats.get("vector.storage.recovered") >= 1
        res["failover"] = got

    t0 = time.perf_counter()
    asyncio.run(run())
    st["wall_s"] = time.perf_counter() - t0
    return res, st


def phase_k(dev, card):
    """Phase K: the live cluster of ``drive_cluster`` at N_K keys on the
    card; prints where its time went, one planning round captured by the
    port's ``observability.profiling.Profiler``, and K2 at the planner's
    shapes; returns the kernels' launch counts."""
    from orleans_tpu_torch.ops import KERNELS, RANK_BY_DEST
    from orleans_tpu_torch.ops import rank_by_dest, rank_by_dest_ref
    trace_dir = build_tmpdir("phase_k_trace_")
    try:
        res, st = drive_cluster(dev, N_K, lambda: TraceWindow(trace_dir))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    launched = {k.name: k.launches for k in KERNELS}
    calls = K_ROUNDS * K_CALLS
    print(f"Phase K: live rebalancing, {N_K} string keys on a TestCluster "
          f"of 2 silos x {SHARDS_B} shards, on {card}; "
          f"{st['wall_s']:.3f} s in all")
    print(f"  activation ({N_K} keys, client.call_batch of {K_BATCH}): "
          f"{st['activate_s']:.3f} s, {N_K / st['activate_s']:.0f} keys/sec")
    print(f"  traffic rounds ({K_CALLS} bump calls each): "
          + ", ".join(f"{s:.3f} s ({K_CALLS / s:.0f} calls/sec)"
                      for s in st["round_s"]))
    print(f"  run_round x {len(st['plan_s'])}: plan "
          + ", ".join(f"{s * 1e3:.3f}" for s in st["plan_s"])
          + " ms; pack_by_dest (K2) "
          + ", ".join(f"{s * 1e3:.3f}" for s in st["pack_s"])
          + " ms at " + ", ".join(str(s) for s in st["k2_shapes"])
          + "; move_rows "
          + ", ".join(f"{s * 1e3:.3f}" for s in st["move_s"]) + " ms")
    print(f"  rows moved per (round, silo): {res['rows_moved']} "
          f"(= the keys whose shard changed); hot shard share of hits per "
          f"(round, silo): {[round(x, 6) for x in res['shares']]}")
    print(f"  write-behind drain before the kill {st['flush_s']:.3f} s, "
          f"death detected in {st['death_s']:.3f} s, {K_FAILOVER} failover "
          f"calls through the survivor {st['failover_s']:.3f} s (every "
          f"persisted count exact), stop_all {st['stop_s']:.3f} s "
          f"(bound 60 s)")
    print(f"  {calls} calls, every count exact; K2 launched in "
          f"{st['k2_rounds']} of {len(res['rows_moved'])} (silo, round) "
          f"planning rounds, {launched[RANK_BY_DEST.name]} in the phase")
    w = st["window"]
    k2 = [(t, c) for k, (t, c) in w.kernels.items()
          if "rank_by_dest_kernel" in k]
    seen = sum(c for _, c in k2)
    assert w.launched[RANK_BY_DEST.name] == 1, \
        "Phase K: the profiled planning round did not launch K2 once"
    print(f"  planning round (silo {st['profiled_silo']}, round 1, the silo "
          f"with more keys) in the port's Profiler: {w.wall_ms:.3f} ms wall, "
          f"{len(w.kernels)} device kernels, busy "
          f"{sum(t for t, _ in w.kernels.values()):.4f} ms; K2 launched "
          f"once, the capture kept {seen:g} of it"
          + (f" ({sum(t for t, _ in k2) / seen:.6f} ms device)" if seen
             else " (CUPTI drops some cluster launches)") + f" on {card}")
    # K2 held against its plain version on every operand the planner
    # handed it, and timed alone at the largest (these launches come
    # after the phase's count was read)
    for d in st["k2_operands"]:
        check_rank(d, SHARDS_B + 1, f"Phase K planner drain {tuple(d.shape)}")
    for d in [max(st["k2_operands"], key=len)]:
        def k2_call():
            return rank_by_dest(d, SHARDS_B + 1)

        k2 = [(t, c) for k, (t, c) in device_profile(k2_call, 100).items()
              if "rank_by_dest_kernel" in k]
        seen = sum(c for _, c in k2)
        dev_ms = f"{sum(t for t, _ in k2) / seen:.6f}" if seen \
            else "not measured (the profile kept no launch)"
        print(f"  K2 at the planner's {tuple(d.shape)}: wrapper "
              f"{time_ms(k2_call):.4f} ms (CUDA events), device {dev_ms} ms "
              f"a launch (the profile kept {seen:g} launches a call), plain "
              f"{time_ms(lambda: rank_by_dest_ref(d, SHARDS_B + 1), 5):.4f}"
              f" ms, bound {d.nbytes * 2 / HBM_BYTES_PER_S * 1e3:.6f} ms "
              f"(bytes) on {card}")
    return launched


def phase_k_cpu(dev):
    """Phase K's scenario at N_K_CPU keys on the card and on the CPU: the
    counts, the moved keys and their shards, the hot shares, the
    membership views and the failover answers equal exactly."""
    got = [drive_cluster(d, N_K_CPU)[0]
           for d in (dev, torch.device("cpu"))]
    for f in got[0]:
        a, b = got[0][f], got[1][f]
        same = np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
        assert same, f"Phase K {f}: card != CPU"
    print(f"Phase K: the same scenario at {N_K_CPU} keys, card == CPU, "
          f"exactly (counts, moves and destination shards, views, "
          f"failover reads)")


# ---------------------------------------------------------------------------
# Phase L: Presence over real TCP gateways
# ---------------------------------------------------------------------------

def native_check() -> None:
    """The port's native modules are the ones in use: its hotwire codec is
    loaded and writes 0xA7 frames, and the loop profiler installs the
    native runner (no pickle or pure-Python fallback can hide here)."""
    import orleans_tpu_torch.core.serialization as ser
    from orleans_tpu_torch.observability import profiling
    assert ser._hotwire is not None, "the port's hotwire codec did not load"
    frame = ser.serialize({"k": [1, 2.5, "x"], "a": np.arange(3)})
    assert frame[:1] == b"\xa7", "serialize() wrote no hotwire frame"
    loop = asyncio.new_event_loop()
    try:
        prof = profiling.install_loop_profiler(loop)
        kind = type(prof)
        profiling.uninstall_loop_profiler(loop)
    finally:
        loop.close()
    assert kind is profiling._NativeLoopProfiler, \
        f"install_loop_profiler gave {kind.__name__}, not the native runner"
    print(f"native: hotwire {os.path.basename(ser._hotwire.__file__)}, "
          f"hotloop {os.path.basename(profiling._hotloop.__file__)} "
          f"(orleans_tpu_torch/_build), {kind.__name__} installed")


class WireCount:
    """Counts the frames and bytes that each side of the port's socket
    fabric received, at its batched receive pump: what the silos received
    is what the clients and peer silos sent them, and what the clients
    received is what the silos sent them. ``counts`` maps "silo" and
    "client" to [frames, bytes]."""

    def __enter__(self):
        import contextvars

        import orleans_tpu_torch.runtime.socket_fabric as sf
        self._sf = sf
        self._read, self._decode = sf._read_frame_batches, sf.decode_frames
        side = contextvars.ContextVar("wire_side", default="?")
        counts = self.counts = {"silo": [0, 0], "client": [0, 0]}
        read_batches, decode_frames = self._read, self._decode

        async def read(reader, *args, strict_tail, **kwargs):
            # a silo's pump reads with a strict tail, a client's without
            side.set("silo" if strict_tail else "client")
            async for item in read_batches(reader, *args,
                                           strict_tail=strict_tail,
                                           **kwargs):
                yield item

        def decode(buf, stats=None):
            consumed, msgs, bounces = decode_frames(buf, stats)
            c = counts.setdefault(side.get(), [0, 0])
            c[0] += len(msgs) + len(bounces)
            c[1] += consumed
            return consumed, msgs, bounces

        sf._read_frame_batches, sf.decode_frames = read, decode
        return self

    def __exit__(self, *exc):
        self._sf._read_frame_batches = self._read
        self._sf.decode_frames = self._decode
        return False

    def line(self) -> str:
        (sf, sb), (cf, cb) = self.counts["silo"], self.counts["client"]
        return (f"clients and peers sent {sf} frames, {sb} bytes "
                f"(silos received); silos sent {cf} frames, {cb} bytes "
                f"(clients received)")


class GcPauses:
    """The garbage collector's pauses inside a window (``gc.callbacks``):
    after exit, ``count`` and ``longest`` (s) of the full (generation 2)
    collections and ``total`` (s) of all collections."""

    def __enter__(self):
        import gc
        self._gc, self.count, self.longest, self.total = gc, 0, 0.0, 0.0
        self._t0 = None

        def cb(phase, info):
            if phase == "start":
                self._t0 = time.perf_counter()
            elif self._t0 is not None:
                dt = time.perf_counter() - self._t0
                self.total += dt
                if info.get("generation") == 2:
                    self.count += 1
                    self.longest = max(self.longest, dt)
        self._cb = cb
        gc.callbacks.append(cb)
        return self

    def __exit__(self, *exc):
        self._gc.callbacks.remove(self._cb)
        return False

    def line(self) -> str:
        return (f"garbage collector: {self.count} full collections, the "
                f"longest {self.longest * 1e3:.1f} ms; all collections "
                f"{self.total:.3f} s")


def step_table(label, st, count, ref_label, st_ref, ref_count, card):
    """Each hosted step of two ``drive_presence`` runs side by side: wall,
    rate, the part of it that write-behind flushes overlapped and the
    longest loop stall; then the ``client.call_batch`` batches and
    summaries that no flush overlapped (their median is the per-call
    figure the wire's cost reads from)."""
    calls = 16 * 4096
    for name, what, per in (
            ("waves", "msgs", lambda n: 5 * n),
            ("batch", "calls", lambda n: calls),
            ("single", "calls", lambda n: 4096 + 1024),
            ("broadcast", "deliveries", lambda n: n),
            ("summary", "summaries", lambda n: 64)):
        parts = []
        for lab, stats, n in ((label, st, count), (ref_label, st_ref,
                                                   ref_count)):
            secs = stats[f"{name}_s"]
            parts.append(
                f"{lab} {per(n) / secs:.0f} {what}/sec ({secs:.3f} s, "
                f"{stats[f'{name}_flush_s']:.3f} s overlapped by flushes, "
                f"longest loop stall {stats[f'{name}_stall_s'] * 1e3:.1f} "
                f"ms)")
        print(f"  {name}: " + "; ".join(parts) + f" on {card}")
    for lab, stats in ((label, st), (ref_label, st_ref)):
        for key, what in (("batch_clear_s", "client.call_batch batches"),
                          ("summary_clear_s", "GameGrain.summary calls")):
            clear = stats[key]
            if not clear:
                print(f"  {lab}: every one of its {what} overlapped a "
                      f"write-behind flush")
                continue
            med = float(np.median(clear))
            extra = (f" ({4096 / med:.0f} calls/sec, "
                     f"{med / 4096 * 1e6:.2f} us a call)"
                     if key == "batch_clear_s" else "")
            print(f"  {lab}, the {len(clear)} {what} no flush overlapped: "
                  f"median {med * 1e3:.3f} ms{extra}, min "
                  f"{min(clear) * 1e3:.3f}, max {max(clear) * 1e3:.3f} ms "
                  f"on {card}")


def drive_gateway(dev, n_players, profile=None):
    """``presence_torch.drive_presence`` with its client over TCP: every
    silo the drive builds (8 shards on ``dev``, write-behind every 0.5 s,
    checkpoints, the default 30 s response timeout, batched egress) is
    hosted on a new ``SocketFabric`` and joined to a
    ``FileMembershipTable`` under ``orleans_tpu_torch/_build``, and a
    ``GatewayClient`` dials each one's gateway anew. Returns (results,
    stats)."""
    pt = presence_sample()
    from orleans_tpu_torch.membership import FileMembershipTable
    from orleans_tpu_torch.parallel import make_mesh
    from orleans_tpu_torch.storage import MemoryStorage
    mesh = make_mesh(SHARDS_B, dev)
    sched = pt.presence_schedule(n_players, seed=5)
    root = build_tmpdir("phase_l_")
    table = FileMembershipTable(os.path.join(root, "membership.json"))
    ckdir = os.path.join(root, "checkpoints")
    os.makedirs(ckdir)

    def build(storage, checkpoint_dir):
        return pt.build_silo(n_players, mesh, storage=storage,
                             checkpoint_dir=checkpoint_dir,
                             membership=table)

    try:
        return asyncio.run(pt.drive_presence(
            build, pt.gateway_client(), MemoryStorage(),
            pt.PlayerVectorGrain, pt.GameGrain, sched, ckdir,
            profile=profile))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def drive_call_batches(dev, n, tcp: bool, batches: int = 16,
                       batch: int = 4096, seed: int = 5) -> list:
    """One silo of ``n`` dense PlayerVectorGrains (8 shards on ``dev``,
    no storage, so no flush overlaps a call) called with ``batches``
    ``client.call_batch`` of ``batch`` heartbeats from Phase H's schedule,
    through a ``ClusterClient`` in process or, with ``tcp``, a
    ``GatewayClient`` over the silo's TCP gateway. Every answer is held
    against the model; returns each batch's seconds."""
    pt = presence_sample()
    from orleans_tpu_torch.membership import FileMembershipTable
    from orleans_tpu_torch.parallel import make_mesh
    from orleans_tpu_torch.runtime import ClusterClient
    sched = pt.presence_schedule(n, seed=seed, batches=batches,
                                 batch=batch)
    ks, ps, ds = sched.calls
    want = pt.PresenceModel(n).apply(ks, ps, ds)
    root = build_tmpdir("phase_l_calls_")

    async def run():
        table = FileMembershipTable(os.path.join(root, "membership.json")) \
            if tcp else None
        silo = pt.build_silo(n, make_mesh(SHARDS_B, dev), membership=table)
        await silo.start()
        client = None
        try:
            client = await (pt.gateway_client() if tcp else ClusterClient)(
                silo.fabric).connect()
            got, secs = [], []
            for lo in range(0, ks.size, batch):
                calls = [(int(k), {"pos": p, "delta": d}) for k, p, d in
                         zip(ks[lo:lo + batch], ps[lo:lo + batch],
                             ds[lo:lo + batch])]
                t0 = time.perf_counter()
                got += await asyncio.gather(*client.call_batch(
                    pt.PlayerVectorGrain, "heartbeat", calls))
                secs.append(time.perf_counter() - t0)
            pt._check("call_batch", np.asarray(got, np.int64), want)
            return secs
        finally:
            if client is not None:
                await client.close_async()
            await silo.stop()

    try:
        return asyncio.run(run())
    finally:
        shutil.rmtree(root, ignore_errors=True)


def drive_two_gateways(dev, n, calls, seed: int = 11) -> dict:
    """Phase L2: two silos, each on its own ``SocketFabric`` (a fabric
    delivers between its own silos in process, so the peer leg crosses
    TCP only between fabrics), joined to one ``FileMembershipTable``,
    sharing the card, with ``n`` dense PlayerVectorGrains split by the
    ring; no write-behind. A ``GatewayClient`` on silo 0's gateway sends
    ``calls`` heartbeats (keys uniform, numpy ``seed``) as
    ``client.call_batch`` batches of 4,096 (silo 0 forwards those silo 1
    owns over the peer socket), one ``broadcast_actors`` to every player
    (silo 1's partition crosses the peer socket) and a ``reduce_actors``.
    Every answer, the sum and each silo's rows are held against the numpy
    model; the heartbeats that reached silo 1 over the wire must be the
    calls whose key the ring gives silo 1. Returns stats."""
    pt = presence_sample()
    from orleans_tpu_torch.core.ids import GrainCategory, GrainId, GrainType
    from orleans_tpu_torch.core.message import Direction
    from orleans_tpu_torch.dispatch import add_vector_grains
    from orleans_tpu_torch.membership import (FileMembershipTable,
                                              join_cluster)
    from orleans_tpu_torch.parallel import make_mesh
    from orleans_tpu_torch.runtime import (GatewayClient, SiloBuilder,
                                           SocketFabric)
    Player = pt.PlayerVectorGrain
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n, calls)
    pos = rng.random((calls, 2), np.float32).astype(np.float16)
    delta = rng.integers(1, 4, calls).astype(np.int32)
    ev_pos, ev_delta = np.array([0.25, 0.75], np.float16), np.int32(2)
    model = pt.PresenceModel(n)
    root = build_tmpdir("phase_l2_")
    st: dict = {}
    clock = time.perf_counter

    async def run():
        table = FileMembershipTable(os.path.join(root, "membership.json"))
        silos = []
        for i in range(2):
            b = SiloBuilder().with_name(f"phase-l2-{i}").with_fabric(
                SocketFabric())
            add_vector_grains(b, Player, mesh=make_mesh(SHARDS_B, dev),
                              capacity_per_shard=-(-n // SHARDS_B),
                              dense={Player: n})
            silo = b.build()
            join_cluster(silo, table)
            silos.append(silo)
        # the heartbeats and bulk requests (the broadcast's partition, the
        # reduce) that reach silo 1 over its socket, at its fabric's
        # batched inbound route
        arrived = {"heartbeat": 0, "bulk": 0}
        fab1 = silos[1].fabric
        route_in = fab1._route_inbound_batch

        def counted(silo, msgs):
            for m in msgs:
                if m.direction != Direction.RESPONSE:
                    if m.method_name == "heartbeat":
                        arrived["heartbeat"] += 1
                    elif m.method_name.startswith("__bulk_"):
                        arrived["bulk"] += 1
            return route_in(silo, msgs)
        fab1._route_inbound_batch = counted
        started, client = [], None
        try:
            t0 = clock()
            for s in silos:
                await s.start()
                started.append(s)
            deadline = clock() + 60
            while not all(len(s.membership.active) == 2 for s in silos):
                assert clock() < deadline, "Phase L2: membership split"
                await asyncio.sleep(0.05)
            st["start_s"] = clock() - t0
            client = await GatewayClient(
                [silos[0].silo_address.endpoint]).connect()
            ring = silos[0].locator.ring
            tc = GrainType.of(Player.__name__).type_code
            owner1 = np.fromiter(
                (ring.owner(GrainId(GrainCategory.GRAIN, tc, int(k))
                            .uniform_hash) == silos[1].silo_address
                 for k in range(n)), bool, n)
            want = model.apply(keys, pos, delta)
            got = []
            t0 = clock()
            for lo in range(0, calls, 4096):
                got += await asyncio.gather(*client.call_batch(
                    Player, "heartbeat",
                    [(int(k), {"pos": p, "delta": d}) for k, p, d in zip(
                        keys[lo:lo + 4096], pos[lo:lo + 4096],
                        delta[lo:lo + 4096])]))
            st["batch_s"] = clock() - t0
            pt._check("Phase L2 call_batch", np.asarray(got, np.int64), want)
            st["forwarded"] = arrived["heartbeat"]
            st["owned_by_1"] = int(owner1[keys].sum())
            st["keys_of_1"] = int(owner1.sum())
            assert st["forwarded"] == st["owned_by_1"], \
                (f"Phase L2: {st['forwarded']} heartbeats reached silo 1, "
                 f"the ring gives it {st['owned_by_1']}")
            t0 = clock()
            st["delivered"] = int(await client.broadcast_actors(
                Player, "heartbeat", np.arange(n),
                {"pos": ev_pos, "delta": ev_delta}))
            st["broadcast_s"] = clock() - t0
            st["bulk_to_1"] = arrived["bulk"]
            model.apply(np.arange(n), np.broadcast_to(ev_pos, (n, 2)),
                        np.full(n, ev_delta))
            pt._check("Phase L2 broadcast deliveries", st["delivered"], n)
            assert st["bulk_to_1"] >= 1, \
                "Phase L2: no broadcast partition crossed to silo 1"
            st["score_sum"] = int(np.asarray(
                await client.reduce_actors(Player, "get_score")))
            pt._check("Phase L2 reduce_actors", st["score_sum"],
                      model.score.sum())
            rows = dense_rows(silos, Player, n)
            pt._check("Phase L2 scores", rows["score"].astype(np.int64),
                      model.score)
            assert (rows["silo"] == owner1.astype(np.int64)).all(), \
                "Phase L2: a row off its ring owner"
        finally:
            if client is not None:
                await client.close_async()
            for s in reversed(started):
                await s.stop()

    try:
        asyncio.run(run())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return st


def phase_l(dev, card, st_h) -> tuple[dict, dict]:
    """L1: Phase H's drive at N_L players with its client over a TCP
    gateway (``drive_gateway``), each step beside Phase H's in-process
    figure (``st_h``, at N_H players), the frames and bytes each side
    received, the longest loop stall and the device idle share of one
    profiled ``client.call_batch`` batch. L2: ``drive_two_gateways``.
    Returns the launch counts after L1 and after L2."""
    from orleans_tpu_torch.ops import KERNELS
    pt = presence_sample()
    windows = {}

    def profile(step):
        if step != "batch":
            return contextlib.nullcontext()
        windows[step] = DeviceWindow()
        return windows[step]

    t0 = time.perf_counter()
    with WireCount() as wire, GcPauses() as gc_l1:
        res, st = drive_gateway(dev, N_L, profile)
    wall = time.perf_counter() - t0
    after_l1 = {k.name: k.launches for k in KERNELS}
    print(f"Phase L1: Presence over a TCP gateway (GatewayClient -> "
          f"SocketFabric, hotwire frames, batched egress), {N_L} players x "
          f"{SHARDS_B} shards, off-loop tick, write-behind every 0.5 s, "
          f"beside Phase H in process at {N_H} players, on {card}; "
          f"{wall:.3f} s in all")
    step_table("L1", st, N_L, "H", st_h, N_H, card)
    # the wire's cost a call: the same batches with no write-behind, in
    # process and over TCP, in turns (in process, TCP, TCP, in process)
    runs = [(tcp, drive_call_batches(dev, N_L, tcp))
            for tcp in (False, True, True, False)]
    med = {tcp: float(np.median([x for t, r in runs if t == tcp
                                 for x in r])) / 4096 * 1e6
           for tcp in (False, True)}
    print(f"  the wire's cost a call: 16 client.call_batch of 4096 to "
          f"{N_L} players, no write-behind, in turns (in process, TCP, TCP,"
          f" in process): median "
          + ", ".join(f"{np.median(r) / 4096 * 1e6:.2f}" for _, r in runs)
          + f" us a call; in process {med[False]:.2f}, over TCP "
          f"{med[True]:.2f} us a call ({1e6 / med[True]:.0f} "
          f"calls/sec): the wire adds {med[True] - med[False]:.2f} us a "
          f"call on {card}")
    w = windows["batch"]
    print(f"  client.call_batch over TCP, last batch profiled: device busy "
          f"{w.busy_ms:.4f} ms of {w.wall_ms:.3f} ms wall (idle share "
          f"{max(0.0, 1 - w.busy_ms / w.wall_ms):.4f}) on {card}")
    print(f"  wire: {wire.line()}")
    longest = max(st[f"{s}_stall_s"] for s in
                  ("waves", "batch", "single", "broadcast", "summary",
                   "stop"))
    print(f"  longest event-loop stall {longest * 1e3:.1f} ms; write-behind "
          f"{st['periodic_flush_rows']} rows periodic in "
          f"{st['periodic_flush_s']:.3f} s, {st['final_flush_rows']} in the "
          f"final drain in {st['final_flush_s']:.3f} s; silo.stop "
          f"{st['stop_s']:.3f} s; checkpoint save {st['save_s']:.3f} s, "
          f"restore {st['restore_s']:.3f} s (bit for bit); "
          f"{res['loaded'].size} players reloaded from storage and called "
          f"again over a new gateway; delivered {res['delivered']}, "
          f"reduce {res['score_sum']}, join_when {res['joined']} on {card}")
    print(f"  {gc_l1.line()} (in L1's {wall:.3f} s)")
    t0 = time.perf_counter()
    with WireCount() as wire:
        st2 = drive_two_gateways(dev, N_L2, L2_CALLS)
    wall = time.perf_counter() - t0
    after_l2 = {k.name: k.launches for k in KERNELS}
    print(f"Phase L2: two silos on their own SocketFabrics sharing the "
          f"card, {N_L2} players split by the ring ({st2['keys_of_1']} on "
          f"silo 1), the client on silo 0's gateway; {wall:.3f} s in all "
          f"(start and membership {st2['start_s']:.3f} s) on {card}")
    print(f"  client.call_batch: {L2_CALLS} heartbeats in batches of 4096, "
          f"{L2_CALLS / st2['batch_s']:.0f} calls/sec ({st2['batch_s']:.3f} "
          f"s); {st2['forwarded']} forwarded to silo 1 over its socket == "
          f"the {st2['owned_by_1']} calls the ring gives it on {card}")
    print(f"  broadcast_actors: {st2['delivered']} deliveries, "
          f"{st2['delivered'] / st2['broadcast_s']:.0f}/sec "
          f"({st2['broadcast_s']:.3f} s), {st2['bulk_to_1']} bulk requests "
          f"to silo 1 over the wire; reduce_actors sum {st2['score_sum']}; "
          f"K2 launches in L2 {after_l2['rank_by_dest'] - after_l1['rank_by_dest']}"
          f"; every answer, the sum and each silo's rows exact on {card}")
    print(f"  wire: {wire.line()}")
    return after_l1, after_l2


def phase_l_cpu(dev, card, got_i, st_i) -> None:
    """L1's drive at N_I players over TCP on the card and on the CPU: the
    two equal exactly, and both equal Phase I's in-process results (the
    same schedule gives the same answers with or without the wire). The
    card's steps print beside Phase I's on the card at the same
    population: the per-call difference is the wire's cost."""
    got_cuda, st_cuda = drive_gateway(dev, N_I)
    got_cpu, _ = drive_gateway(torch.device("cpu"), N_I)
    same_results(got_cuda, got_cpu, "Phase L over TCP, card vs CPU")
    same_results(got_cuda, got_i, "Phase L over TCP vs Phase I in process")
    print(f"Phase L: L1's drive at {N_I} players over TCP, card == CPU == "
          f"Phase I in process, exactly (every answer and the final table);"
          f" over TCP beside in process, both on the card:")
    step_table("TCP", st_cuda, N_I, "in process", st_i, N_I, card)


# ---------------------------------------------------------------------------
# Phase M: multi-process and multi-loop silos with the observability stack
# ---------------------------------------------------------------------------

class OtlpReceiver:
    """A stdlib HTTP receiver on 127.0.0.1:0, in a thread, that answers
    every POST 200 and counts them by path (``posts[path]`` = [batches,
    bytes]): the collector the OTLP trace and metrics sinks of Phase M
    send to."""

    def __enter__(self):
        import http.server
        import threading
        posts = self.posts = {}
        lock = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server API
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                with lock:
                    c = posts.setdefault(self.path, [0, 0])
                    c[0] += 1
                    c[1] += len(body)
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                       Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="otlp-receiver", daemon=True)
        self._thread.start()
        return self

    def url(self, path: str) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}{path}"

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(10)
        assert not self._thread.is_alive(), "OTLP receiver did not stop"
        return False


def m_config(recv: OtlpReceiver) -> dict:
    """Phase M's observability stack: metrics with the Prometheus endpoint
    on an ephemeral port and the OTLP metrics push, the cost ledger, the
    SLO monitor, and tracing (1% of silo-rooted calls) with its OTLP
    sink, both sinks sending to ``recv``."""
    return dict(metrics_enabled=True, metrics_port=0,
                metrics_sample_period=0.5,
                metrics_otlp_endpoint=recv.url("/v1/metrics"),
                metrics_otlp_period=0.5,
                ledger_enabled=True, slo_enabled=True,
                trace_enabled=True, trace_sample_rate=0.01,
                trace_otlp_endpoint=recv.url("/v1/traces"))


class LoopStalls:
    """The event loop's stalls longer than 20 ms while it runs (a task
    that wakes every 5 ms): ``longest`` (s) after ``stop()``."""

    def __init__(self):
        self.longest, self._task = 0.0, None

    def start(self):
        async def watch():
            last = time.perf_counter()
            while True:
                await asyncio.sleep(0.005)
                now = time.perf_counter()
                if now - last > 0.02:
                    self.longest = max(self.longest, now - last)
                last = now
        self._task = asyncio.get_running_loop().create_task(watch())

    def stop(self):
        self._task.cancel()


async def dial_worker_clients(silo, want: int = 2, tries: int = 16) -> list:
    """``GatewayClient``s dialled to the silo's advertised SO_REUSEPORT
    endpoint until ``want`` of them sit on different worker processes
    (the kernel picks the worker a connection lands on); the others are
    closed. Returns one client a worker."""
    from orleans_tpu_torch.runtime import GatewayClient
    relays = silo.fabric.route_relays
    by_worker, extra = {}, []
    try:
        for _ in range(tries):
            c = await GatewayClient([silo.gateway_endpoint]).connect()
            deadline = time.perf_counter() + 10
            while c.silo_address not in relays:  # the worker's route+
                assert time.perf_counter() < deadline, \
                    "Phase M1: a client route never reached the owner"
                await asyncio.sleep(0.005)
            ep = relays[c.silo_address]
            if ep in by_worker:
                extra.append(c)
            else:
                by_worker[ep] = c
            if len(by_worker) == want:
                break
        assert len(by_worker) == want, \
            f"Phase M1: {tries} connections landed on {len(by_worker)} worker"
    finally:
        for c in extra:
            await c.close_async()
    return list(by_worker.values())


def drive_workers(dev, n, calls, recv, seed: int = 13) -> tuple:
    """Phase M1: a ``worker_procs=2`` silo (8 shards of ``n`` dense
    PlayerVectorGrains on ``dev`` in the owner, which forks its two
    workers at start) with Phase M's observability stack. Two
    ``GatewayClient``s, one on each worker, send ``calls`` heartbeats
    (keys uniform, numpy ``seed``; client c calls the keys with ``key % 2
    == c``, so no key crosses clients) as ``client.call_batch`` batches
    of 4,096, both clients at once; each call crosses its worker's
    staging ring into the owner's ``call_packed`` and its answer comes
    back on the response ring. Every answer is held against the numpy
    model, and the rings, the workers' CUDA state, the ledger's
    per-worker rows and charged tick walls, one ``/metrics`` scrape and
    the OTLP receiver are checked. Returns (answers, stats)."""
    import urllib.request
    pt = presence_sample()
    from orleans_tpu_torch.membership import FileMembershipTable
    from orleans_tpu_torch.observability.stats import RING_STATS
    from orleans_tpu_torch.parallel import make_mesh
    Player = pt.PlayerVectorGrain
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n, calls)
    pos = rng.random((calls, 2), np.float32).astype(np.float16)
    delta = rng.integers(1, 4, calls).astype(np.int32)
    model = pt.PresenceModel(n)
    parts = [np.flatnonzero(keys % 2 == c) for c in (0, 1)]
    want = [model.apply(keys[p], pos[p], delta[p]) for p in parts]
    root = build_tmpdir("phase_m1_")
    st: dict = {}
    clock = time.perf_counter

    async def run():
        table = FileMembershipTable(os.path.join(root, "membership.json"))
        t0 = clock()
        silo = pt.build_silo(n, make_mesh(SHARDS_B, dev), membership=table,
                             worker_procs=2, **m_config(recv))
        ticks: list = []  # each device tick's wall the ledger was charged
        charge = silo.ledger.charge_tick

        def charged(payload):
            ticks.append(payload[3])
            charge(payload)
        silo.ledger.charge_tick = charged
        await silo.start()
        st["start_s"] = clock() - t0
        sup = silo.workers
        clients, stalls = [], LoopStalls()
        try:
            clients = await dial_worker_clients(silo)
            clients[0].enable_tracing(sample_rate=0.01,
                                      name="phase-m1-client",
                                      otlp_endpoint=recv.url("/v1/traces"))

            async def send(c):
                got, p = [], parts[c]
                for lo in range(0, p.size, 4096):
                    q = p[lo:lo + 4096]
                    got += await asyncio.gather(*clients[c].call_batch(
                        Player, "heartbeat",
                        [(int(k), {"pos": ps, "delta": d}) for k, ps, d in
                         zip(keys[q], pos[q], delta[q])]))
                return np.asarray(got, np.int64)

            stalls.start()
            t0 = clock()
            got = await asyncio.gather(send(0), send(1))
            st["calls_s"] = clock() - t0
            stalls.stop()
            st["stall_s"] = stalls.longest
            for c in (0, 1):
                pt._check(f"Phase M1 client {c} call_batch", got[c],
                          want[c])
            d = sup.describe()
            st["describe"] = d
            for w in d["workers"]:
                assert w["alive"], ("Phase M1: a worker died", d)
                assert w["req_pushed"] == w["req_drained"] and \
                    w["resp_pushed"] == w["resp_drained"], \
                    ("Phase M1: a ring did not drain", d)
                assert w["req_pushed"] > 0, ("Phase M1: an idle worker", d)
                assert w["cuda_initialized"] is False, \
                    ("Phase M1: CUDA started in a worker", d)
            staged = sum(w["req_pushed"] for w in d["workers"])
            assert staged == calls, \
                f"Phase M1: {staged} ring-staged messages for {calls} calls"
            assert not silo.fabric.client_routes, \
                "Phase M1: the owner holds a client route"
            assert len(silo.fabric.route_relays) == len(clients)
            procs = {o: list(r) for o, r in silo.ledger.procs.items()}
            st["procs"] = procs
            for w in d["workers"]:
                rows, secs = procs[f"worker-{w['index']}"]
                assert rows == w["req_pushed"] and secs > 0, \
                    ("Phase M1: the ledger's worker rows", procs, d)
            st["ticks"], st["tick_s"] = len(ticks), sum(ticks)
            st["row_s"] = silo.ledger.total_row_seconds()
            assert 0 < st["tick_s"] <= st["calls_s"], \
                (f"Phase M1: the ledger charged {st['tick_s']} s of ticks "
                 f"in a {st['calls_s']} s drive")
            snap = silo.stats.snapshot()
            st["staging_dwell"] = snap["histograms"][
                RING_STATS["staging_dwell"]]
            st["owner_frames"] = snap["counters"].get("ingest.frames", 0)
            url = (f"http://127.0.0.1:{silo.metrics_server.port}"
                   f"/metrics")
            loop = asyncio.get_running_loop()

            def scrape():
                with urllib.request.urlopen(url, timeout=10) as r:
                    return r.status, r.read().decode()
            status, text = await loop.run_in_executor(None, scrape)
            assert status == 200, f"Phase M1: /metrics answered {status}"
            assert "workers_alive" in text and "_ledger_" in text, \
                "Phase M1: /metrics names no workers.alive or ledger. series"
            st["scrape_bytes"] = len(text)
        finally:
            for c in clients:
                await c.close_async()
            t0 = clock()
            await silo.stop()
            st["stop_s"] = clock() - t0
        exits = [lk.cuda_initialized for lk in sup.links]
        assert exits == [False, False], \
            f"Phase M1: the workers' exit records say CUDA {exits}"
        return np.concatenate(got)

    try:
        out = asyncio.run(run())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out, st


def drive_multiloop(dev, n, recv, profile=None) -> tuple:
    """Phase M2: Phase L1's drive (``presence_torch.drive_presence``,
    Phase H's schedule from seed 5) at ``n`` players through a silo with
    two ingress loops and two egress shards and Phase M's observability
    stack, without write-behind or checkpoints (Phases H and L cover the
    flush path): bulk waves, 16 ``client.call_batch`` of 4,096, single
    calls and ``whereis``, a broadcast (K2 each chunk), ``reduce_actors``,
    ``join_when`` and the 64 ``GameGrain.summary`` fan-ins (K1). The
    acceptor hands the drive's ``GatewayClient`` to one ingress loop, so
    after the drive, before the silo stops, a second ``GatewayClient``
    (handed to the other loop, its responses encoded on the other egress
    shard) reads ``whereis`` of 4,096 players, which must equal the
    engine's own read of them. Returns (results, stats, per-shard
    counters)."""
    pt = presence_sample()
    from orleans_tpu_torch.membership import FileMembershipTable
    from orleans_tpu_torch.parallel import make_mesh
    from orleans_tpu_torch.runtime import GatewayClient
    mesh = make_mesh(SHARDS_B, dev)
    sched = pt.presence_schedule(n, seed=5)
    root = build_tmpdir("phase_m2_")
    table = FileMembershipTable(os.path.join(root, "membership.json"))
    kept: dict = {}

    def build(storage, checkpoint_dir):
        silo = pt.build_silo(n, mesh, membership=table, ingress_loops=2,
                             egress_shards=2, **m_config(recv))
        stop = silo.stop

        async def stop_keeping_counters(graceful=True):
            keys = np.arange(0, n, max(1, n // 4096))
            side = await GatewayClient(
                [silo.silo_address.endpoint]).connect()
            try:
                got = await asyncio.gather(*side.call_batch(
                    pt.PlayerVectorGrain, "whereis",
                    [(int(k), {}) for k in keys]))
            finally:
                await side.close_async()
            want = silo.vector.call_batch(pt.PlayerVectorGrain, "whereis",
                                          keys, {})
            pt._check("Phase M2 whereis over the second loop",
                      np.stack([np.asarray(g) for g in got]),
                      np.asarray(want))
            ing, eg = silo.ingress_pool, silo.fabric.egress_pool
            kept["frames"] = [s.frames for s in ing.shards]
            kept["encoded"] = [s.encoded for s in eg.shards]
            kept["row_s"] = silo.ledger.total_row_seconds()
            await stop(graceful)
        silo.stop = stop_keeping_counters
        return silo

    try:
        res, st = asyncio.run(pt.drive_presence(
            build, pt.gateway_client(), None, pt.PlayerVectorGrain,
            pt.GameGrain, sched, None, profile=profile))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert len(kept["frames"]) == 2 and all(kept["frames"]), \
        f"Phase M2: an ingress shard pumped no frame: {kept['frames']}"
    assert len(kept["encoded"]) == 2 and all(kept["encoded"]), \
        f"Phase M2: an egress shard encoded nothing: {kept['encoded']}"
    return res, st, kept


def phase_m(dev, card, got_i) -> dict:
    """M1 (``drive_workers``) and M2 (``drive_multiloop``) at full width
    on the card with an OTLP receiver in the script; then M1's heartbeats
    and M2's drive at N_I players on the card and on the CPU, compared
    exactly, and M2's results against Phase I's where the steps are the
    same. Returns the launch counts of M1 and M2 on the card."""
    from orleans_tpu_torch.ops import KERNELS
    t_m = time.perf_counter()
    with OtlpReceiver() as recv:
        t0 = time.perf_counter()
        _, st1 = drive_workers(dev, N_M, M_CALLS, recv)
        wall1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        res2, st2, kept = drive_multiloop(dev, N_M, recv)
        wall2 = time.perf_counter() - t0
        launches = {k.name: k.launches for k in KERNELS}
        posts = {p: list(c) for p, c in recv.posts.items()}
    assert posts.get("/v1/traces", [0])[0] >= 1 and \
        posts.get("/v1/metrics", [0])[0] >= 1, \
        f"Phase M: the OTLP receiver got {posts}"
    d = st1["describe"]
    dw = st1["staging_dwell"]
    print(f"Phase M1: a worker_procs=2 silo, {N_M} players x {SHARDS_B} "
          f"shards on the owner's card, metrics (/metrics on an ephemeral "
          f"port, OTLP push), ledger, SLO, tracing with OTLP; {wall1:.3f} "
          f"s in all (build, fork and start {st1['start_s']:.3f} s, stop "
          f"{st1['stop_s']:.3f} s) on {card}")
    print(f"  client.call_batch through the workers' rings: {M_CALLS} "
          f"heartbeats, two clients (one a worker) at once, "
          f"{M_CALLS / st1['calls_s']:.0f} calls/sec ({st1['calls_s']:.3f} "
          f"s), longest loop stall {st1['stall_s'] * 1e3:.1f} ms; every "
          f"answer exact on {card}")
    for w in d["workers"]:
        print(f"  worker {w['index']} (pid {w['pid']}, silo {w['silo']}): "
              f"alive {w['alive']}, client routes {w['client_routes']}, "
              f"request ring {w['req_pushed']} pushed / {w['req_drained']} "
              f"drained, response ring {w['resp_pushed']} / "
              f"{w['resp_drained']}, torch.cuda.is_initialized() "
              f"{w['cuda_initialized']} (and False in its exit record)")
    print(f"  the workers' share of client ingress: "
          f"{sum(w['client_routes'] for w in d['workers'])} of "
          f"{len(d['workers'])} client routes on the workers, 0 on the "
          f"owner; the owner's socket pump decoded {st1['owner_frames']} "
          f"frames while its engine served {M_CALLS} calls")
    print(f"  staging-ring dwell (worker push -> owner pop): "
          f"{dw['count']} records, p50 {dw['p50'] * 1e6:.1f} us, p99 "
          f"{dw['p99'] * 1e6:.1f} us, mean {dw['mean'] * 1e6:.1f} us")
    print(f"  ledger: per-worker device rows {st1['procs']} "
          f"(rows, row-seconds); {st1['ticks']} ticks charged "
          f"{st1['tick_s']:.4f} s of tick wall in the {st1['calls_s']:.3f} s "
          f"drive, {st1['row_s']:.3f} row-seconds in all; /metrics "
          f"{st1['scrape_bytes']} bytes, status 200")
    print(f"Phase M2: Phase L1's drive without write-behind through a silo "
          f"of 2 ingress loops and 2 egress shards, the same observability, "
          f"{N_M} players; {wall2:.3f} s in all on {card}")
    for step in ("waves", "batch", "single", "broadcast", "summary",
                 "stop"):
        print(f"  {step}: {st2[step + '_s']:.3f} s, longest loop stall "
              f"{st2[step + '_stall_s'] * 1e3:.1f} ms")
    print(f"  client.call_batch {res2['call_batch'].size} calls at "
          f"{res2['call_batch'].size / st2['batch_s']:.0f} calls/sec; "
          f"ingress shards pumped {kept['frames']} frames, "
          f"egress shards encoded {kept['encoded']} batches; delivered "
          f"{res2['delivered']}, reduce {res2['score_sum']}, join_when "
          f"{res2['joined']}; every answer exact on {card}")
    print(f"  OTLP receiver: {posts} ([batches, bytes] by path)")
    print(f"Phase M at full width: {time.perf_counter() - t_m:.3f} s")
    # M at N_I players, card against the CPU
    t0 = time.perf_counter()
    with OtlpReceiver() as recv:
        hb_cuda, _ = drive_workers(dev, N_I, M_CALLS_CPU, recv)
        hb_cpu, _ = drive_workers(torch.device("cpu"), N_I, M_CALLS_CPU,
                                  recv)
        ml_cuda, _, _ = drive_multiloop(dev, N_I, recv)
        ml_cpu, _, _ = drive_multiloop(torch.device("cpu"), N_I, recv)
    same_results(hb_cuda, hb_cpu, "Phase M1, card vs CPU")
    same_results(ml_cuda, ml_cpu, "Phase M2, card vs CPU")
    same_results(ml_cuda, {k: got_i[k] for k in ml_cuda},
                 "Phase M2 vs Phase I")
    print(f"Phase M: M1's {M_CALLS_CPU} heartbeats and M2's drive at "
          f"{N_I} players, card == CPU exactly, and M2 == Phase I on "
          f"its steps ({', '.join(sorted(ml_cuda))}); "
          f"{time.perf_counter() - t0:.3f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase N: durable streams, reminders, event sourcing and transactions
# ---------------------------------------------------------------------------

def durable_adapter(kind: str, tmp: str):
    """A durable queue adapter of one queue on the file(s) under ``tmp``:
    ``SqliteQueueAdapter`` (``queue.db``) or ``FileQueueAdapter``
    (``queue/``). Each call opens the same file anew."""
    from orleans_tpu_torch.streams import FileQueueAdapter, SqliteQueueAdapter
    if kind == "sqlite":
        return SqliteQueueAdapter(os.path.join(tmp, "queue.db"), n_queues=1)
    return FileQueueAdapter(os.path.join(tmp, "queue"), n_queues=1)


def acked_seqs(kind: str, tmp: str) -> set:
    """The batch tokens the queue's file holds as acknowledged, read from
    the file itself (a connection of its own, or the ack log)."""
    if kind == "sqlite":
        import sqlite3
        db = sqlite3.connect(os.path.join(tmp, "queue.db"))
        try:
            return {s for (s,) in db.execute(
                "SELECT seq FROM stream_batches WHERE acked=1")}
        finally:
            db.close()
    path = os.path.join(tmp, "queue", "q0.ack")
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        return {int(x) for x in f.read().split()}


def drive_durable(dev, n, kind: str = "sqlite") -> tuple:
    """N1: the persistent provider's vector path over a durable queue file,
    across a stop and a restart. A silo (8 shards on ``dev``,
    ``StreamOptions(device_fanout=True)``, so each bulk item rides
    ``stream_fanout`` with K2 on every chunk) produces items 1 and 2 of
    ``{"keys": arange(n), "args": {"v": key % 7}}`` and delivers them; once
    the file holds both acks the silo stops. Items 3 and 4 are produced
    into the same file with no silo running, and a new silo on the file
    resumes from its durable cursor. Its rows must hold exactly the
    effect of items 3 and 4 (an item delivered twice or lost shows
    there). Returns (rows, stats)."""
    from orleans_tpu_torch.config import StreamOptions
    from orleans_tpu_torch.dispatch import add_vector_grains
    from orleans_tpu_torch.ops import RANK_BY_DEST
    from orleans_tpu_torch.parallel import make_mesh
    from orleans_tpu_torch.runtime import InProcFabric, SiloBuilder
    from orleans_tpu_torch.streams import StreamId, add_persistent_streams
    Sensor = sensor_class()
    v = (np.arange(n) % 7).astype(np.float32)
    item = {"keys": np.arange(n), "args": {"v": v}}
    stream = StreamId("queue", "telemetry", "bulk")
    tmp = build_tmpdir("phase_n_queue_")
    st: dict = {}
    clock = time.perf_counter

    async def silo_on(adapter):
        b = (SiloBuilder().with_name(f"phase-n-{kind}")
             .with_fabric(InProcFabric())
             .with_options(StreamOptions(device_fanout=True)))
        add_vector_grains(b, Sensor, mesh=make_mesh(SHARDS_B, dev),
                          capacity_per_shard=-(-n // SHARDS_B),
                          dense={Sensor: n})
        add_persistent_streams(b, "queue", adapter, pull_period=0.005)
        silo = b.build()
        await silo.start()
        return silo

    async def acked(want: set, label: str, timeout: float = 120.0):
        deadline = clock() + timeout
        while not want <= acked_seqs(kind, tmp):
            assert clock() < deadline, \
                f"{label}: acked {sorted(acked_seqs(kind, tmp))}"
            await asyncio.sleep(0.005)

    def close(adapter):
        if kind == "sqlite":
            adapter.close()

    async def run():
        k2 = RANK_BY_DEST.launches
        a1 = durable_adapter(kind, tmp)
        t0 = clock()
        silo = await silo_on(a1)
        st["start_s"] = clock() - t0
        try:
            got = lambda: silo.stats.get("streams.vector.delivered")  # noqa: E731
            t0 = clock()
            for _ in range(2):
                await silo.stream_providers["queue"].produce(stream, [item])
            st["produce_s"] = clock() - t0
            await await_count(got, 2 * n, f"Phase N1 {kind} items 1-2")
            await acked({0, 1}, f"Phase N1 {kind} acks of items 1-2")
            st["first_s"] = clock() - t0
        finally:
            t0 = clock()
            await silo.stop()
            close(a1)
            st["stop_s"] = clock() - t0
        a2 = durable_adapter(kind, tmp)
        t0 = clock()
        for _ in range(2):  # no silo runs: the file is the queue service
            await a2.queue_message_batch(a2.queue_of(stream), stream, [item])
        st["offline_produce_s"] = clock() - t0
        t0 = clock()
        silo = await silo_on(a2)
        try:
            got = lambda: silo.stats.get("streams.vector.delivered")  # noqa: E731
            await await_count(got, 2 * n, f"Phase N1 {kind} items 3-4")
            await acked({0, 1, 2, 3}, f"Phase N1 {kind} acks of items 3-4")
            st["resume_s"] = clock() - t0
            st["resumed_delivered"] = got()
            rows = dense_rows([silo], Sensor, n)
        finally:
            await silo.stop()
            close(a2)
        st["k2"] = RANK_BY_DEST.launches - k2
        return rows

    try:
        rows = asyncio.run(run())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert st["resumed_delivered"] == 2 * n, \
        f"Phase N1 {kind}: the resumed silo delivered {st['resumed_delivered']}"
    assert (rows["events"] == 2).all(), \
        f"Phase N1 {kind}: a row off the effect of items 3 and 4 " \
        f"(events {np.unique(rows['events'])})"
    assert (rows["total"] == 2 * v).all(), f"Phase N1 {kind}: totals"
    if dev.type == "cuda":
        want = 4 * -(-n // N_CHUNK)
        assert st["k2"] == want, \
            f"Phase N1 {kind}: K2 launched {st['k2']} times, not {want}"
    return rows, st


def transfer_classes():
    """A host-tier account and a bank that moves money between two
    accounts in one transaction (the accounts of tests/test_transactions.py,
    with no funds check, so the final balances do not depend on the order
    the transfers commit in)."""
    from orleans_tpu_torch.transactions import (TransactionalGrain,
                                                TransactionalState,
                                                transactional)

    class AccountGrain(TransactionalGrain):
        def __init__(self):
            self.balance = TransactionalState("balance", default=N_BALANCE)

        @transactional
        async def add(self, amount):
            v = await self.balance.get()
            await self.balance.set(v + amount)

        async def get_balance(self):
            return await self.balance.get()

    class BankGrain(TransactionalGrain):
        @transactional
        async def transfer(self, src, dst, amount):
            await self.get_grain(AccountGrain, src).add(-amount)
            await self.get_grain(AccountGrain, dst).add(amount)

    return AccountGrain, BankGrain


def drive_reminders(dev, n, seed: int = 17) -> tuple:
    """N2: reminder-driven summaries, journaled, and transfers. A Presence
    silo (``samples/presence_torch.py``, ``n`` players x 8 shards on
    ``dev``) with reminders on a ``SqliteReminderTable`` file,
    ``add_transactions`` over a ``SqliteTransactionLog`` file and the
    journals on a ``MemoryStorage``. One heartbeat wave sets every
    player's score; ``N_GAMES`` GameJournalGrains each register a
    ``N_PERIOD`` s reminder; each fire reads ``GameGrain.summary`` (one
    K1 fan-in under ``tick_fence``) and confirms it as a journal event.
    ``N_TRANSFERS`` transactional transfers among ``N_ACCOUNTS`` accounts
    run while the reminders fire. Once every reminder has fired
    ``N_FIRES`` times the timers stop between two fires; each journal's
    version must equal its counted fires, every event the numpy model's
    summary, K1's launches (on the card) the fires, and the balances the
    model's, their sum conserved. Then a new silo on the same reminder,
    log and journal files: the same wave, and every reminder fires again
    with no new registration; the same checks over both silos, and the
    balances read back. Returns (results, stats)."""
    pt = presence_sample()
    from orleans_tpu_torch.ops import SEGMENT_SUM
    from orleans_tpu_torch.parallel import make_mesh
    from orleans_tpu_torch.reminders import SqliteReminderTable, add_reminders
    from orleans_tpu_torch.runtime import ClusterClient
    from orleans_tpu_torch.storage import MemoryStorage
    from orleans_tpu_torch.transactions import (SqliteTransactionLog,
                                                add_transactions)
    Account, Bank = transfer_classes()
    Journal, Player = pt.GameJournalGrain, pt.PlayerVectorGrain
    games = pt.N_GAMES
    rng = np.random.default_rng(seed)
    delta = rng.integers(1, 100, n).astype(np.int32)
    pos = rng.random((n, 2)).astype(np.float16)
    g = np.arange(n) % games
    want = np.stack([np.bincount(g, delta.astype(np.int64), games),
                     np.bincount(g, minlength=games)], axis=1)
    src = rng.integers(0, N_ACCOUNTS, N_TRANSFERS)
    dst = (src + rng.integers(1, N_ACCOUNTS, N_TRANSFERS)) % N_ACCOUNTS
    amount = rng.integers(1, 50, N_TRANSFERS)
    balances = np.full(N_ACCOUNTS, N_BALANCE, np.int64)
    np.subtract.at(balances, src, amount)
    np.add.at(balances, dst, amount)
    tmp = build_tmpdir("phase_n_reminders_")
    journals = MemoryStorage()
    mesh = make_mesh(SHARDS_B, dev)
    fires = np.zeros(games, np.int64)
    st: dict = {"errors": 0}
    clock = time.perf_counter

    def build():
        def setup(b):
            b.add_grains(Journal, Account, Bank)
            b.with_storage("Default", journals)
            add_transactions(b, log_provider=SqliteTransactionLog(
                os.path.join(tmp, "txn.db")))
        silo = pt.build_silo(n, mesh, setup=setup)
        add_reminders(silo, SqliteReminderTable(
            os.path.join(tmp, "reminders.db")), refresh_period=1.0)
        return silo

    def count_fires(silo) -> list:
        """Count each reminder's completed fires; returns the in-flight
        count (a one-element list)."""
        svc = silo.reminders
        deliver = svc.deliver_tick
        flight = [0]

        async def counted(entry, status):
            flight[0] += 1
            try:
                await deliver(entry, status)
                fires[int(entry.grain_id.key)] += 1
            except Exception:
                st["errors"] += 1
                raise
            finally:
                flight[0] -= 1
        svc.deliver_tick = counted
        return flight

    async def fire_until(silo, flight, at_least, label, timeout=60.0):
        """Wait until every reminder has ``at_least`` fires, then stop the
        timers at a moment no fire is in flight (no await between the
        check and the stop)."""
        deadline = clock() + timeout
        while fires.min() < at_least:
            assert clock() < deadline, f"{label}: fires {fires.tolist()}"
            await asyncio.sleep(0.005)
        while flight[0]:
            assert clock() < deadline, f"{label}: a fire never ended"
            await asyncio.sleep(0.001)
        silo.reminders.stop()

    async def check(client, k1_0, label) -> np.ndarray:
        got = await asyncio.gather(*(client.get_grain(Journal, k).journal()
                                     for k in range(games)))
        versions = np.array([v for v, _ in got], np.int64)
        assert np.array_equal(versions, fires), \
            f"{label}: journal versions {versions.tolist()} != fires " \
            f"{fires.tolist()}"
        for k, (_, events) in enumerate(got):
            ev = np.asarray(events, np.int64).reshape(-1, 2)
            assert ev.shape[0] == fires[k] and (ev == want[k]).all(), \
                f"{label}: game {k}'s summaries off the model"
        if dev.type == "cuda":
            k1 = SEGMENT_SUM.launches - k1_0
            assert k1 == fires.sum(), \
                f"{label}: K1 launched {k1} times for {fires.sum()} fires"
        bal = np.asarray(await asyncio.gather(*(
            client.get_grain(Account, a).get_balance()
            for a in range(N_ACCOUNTS))), np.int64)
        assert np.array_equal(bal, balances), f"{label}: balances"
        assert bal.sum() == N_ACCOUNTS * N_BALANCE, f"{label}: money made"
        return bal

    async def wave(silo):
        rt = silo.vector
        keys = np.arange(n)
        t0 = clock()
        out = rt.call_batch(Player, "heartbeat", keys,
                            {"pos": pos, "delta": delta},
                            plan=rt.make_dense_plan(Player, keys))
        assert np.array_equal(np.asarray(out, np.int64), delta), "wave"
        return clock() - t0

    async def run():
        k1_0 = SEGMENT_SUM.launches
        t0 = clock()
        silo = build()
        await silo.start()
        st["start_s"] = clock() - t0
        client = await ClusterClient(silo.fabric).connect()
        try:
            flight = count_fires(silo)
            st["wave_s"] = await wave(silo)
            t0 = clock()
            await asyncio.gather(*(client.get_grain(Journal, k)
                                   .start_summaries(N_PERIOD)
                                   for k in range(games)))
            st["register_s"] = clock() - t0
            t_fire = clock()
            bank = client.get_grain(Bank, 0)
            t0 = clock()
            for lo in range(0, N_TRANSFERS, 16):
                await asyncio.gather(*(
                    bank.transfer(int(src[i]), int(dst[i]), int(amount[i]))
                    for i in range(lo, min(lo + 16, N_TRANSFERS))))
            st["transfers_s"] = clock() - t0
            await fire_until(silo, flight, N_FIRES, "Phase N2")
            st["fire_s"] = clock() - t_fire
            st["fires_1"] = int(fires.sum())
            t0 = clock()
            bal = await check(client, k1_0, "Phase N2")
            st["check_s"] = clock() - t0
        finally:
            await client.close_async()
            t0 = clock()
            await silo.stop()
            st["stop_s"] = clock() - t0
        # the restart: the same files, no new registration
        before = fires.copy()
        t0 = clock()
        silo = build()
        await silo.start()
        st["restart_s"] = clock() - t0
        client = await ClusterClient(silo.fabric).connect()
        try:
            flight = count_fires(silo)
            await wave(silo)
            t0 = clock()
            await fire_until(silo, flight, before.max() + 1,
                             "Phase N2 after the restart")
            st["refire_s"] = clock() - t0
            assert (fires > before).all(), "Phase N2: a reminder lost"
            bal2 = await check(client, k1_0, "Phase N2 after the restart")
        finally:
            await client.close_async()
            await silo.stop()
        assert np.array_equal(bal, bal2)
        return {"summaries": want.copy(), "balances": bal2}

    try:
        res = asyncio.run(run())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert st["errors"] == 0, f"Phase N2: {st['errors']} failed fires"
    st["fires"] = fires
    return res, st


def phase_n(dev, card) -> dict:
    """N1 at full width over a SQLite file (K2 on every delivered chunk)
    and N2 at full width (K1 once a fire); returns their launch counts.
    Then N1 (SQLite and file) and N2 at N_N_CPU players on the card and on
    the CPU, compared exactly."""
    from orleans_tpu_torch.ops import KERNELS
    t0 = time.perf_counter()
    rows, st1 = drive_durable(dev, N_N)
    wall1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    res2, st2 = drive_reminders(dev, N_N)
    wall2 = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    print(f"Phase N1: durable Presence heartbeats, {N_N} sensors x "
          f"{SHARDS_B} shards over a SQLite queue file, device_fanout on; "
          f"{wall1:.3f} s in all on {card}")
    print(f"  items 1-2 produced and delivered with durable acks in "
          f"{st1['first_s']:.3f} s ({2 * N_N / st1['first_s']:.0f} "
          f"events/sec; produce {st1['produce_s']:.3f} s), silo stop "
          f"{st1['stop_s']:.3f} s; items 3-4 produced offline in "
          f"{st1['offline_produce_s']:.3f} s; the new silo resumed from "
          f"the durable cursor and delivered {st1['resumed_delivered']} "
          f"events in {st1['resume_s']:.3f} s (start included); every "
          f"row holds exactly items 3 and 4; K2 {st1['k2']} launches "
          f"({st1['k2'] / 4:g} a delivered item)")
    fires = st2["fires"]
    games = fires.size
    print(f"Phase N2: reminder-driven summaries, journaled, {N_N} players, "
          f"{games} reminders of {N_PERIOD} s; {wall2:.3f} s in all on "
          f"{card}")
    print(f"  silo start {st2['start_s']:.3f} s, wave {st2['wave_s']:.3f} "
          f"s, {games} registrations {st2['register_s']:.3f} s; "
          f"{N_TRANSFERS} transfers among {N_ACCOUNTS} accounts in "
          f"{st2['transfers_s']:.3f} s "
          f"({N_TRANSFERS / st2['transfers_s']:.0f} transactions/sec) while "
          f"the reminders fired; {st2['fires_1']} fires in "
          f"{st2['fire_s']:.3f} s; checks {st2['check_s']:.3f} s, stop "
          f"{st2['stop_s']:.3f} s")
    print(f"  restarted silo on the same files: start "
          f"{st2['restart_s']:.3f} s, every reminder fired again in "
          f"{st2['refire_s']:.3f} s with no new registration; fires per "
          f"reminder {int(fires.min())}-{int(fires.max())}, "
          f"{int(fires.sum())} in all == K1 launches == journal versions; "
          f"every summary equals the model; balances conserved "
          f"({int(res2['balances'].sum())})")
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    for kind in ("sqlite", "file"):
        a, _ = drive_durable(dev, N_N_CPU, kind)
        b, _ = drive_durable(cpu, N_N_CPU, kind)
        same_results(a, b, f"Phase N1 {kind}, card vs CPU")
    a, _ = drive_reminders(dev, N_N_CPU)
    b, _ = drive_reminders(cpu, N_N_CPU)
    same_results(a, b, "Phase N2, card vs CPU")
    print(f"Phase N: N1 over SQLite and file queues and N2 at {N_N_CPU} "
          f"players, card == CPU exactly (rows, summaries, balances); "
          f"{time.perf_counter() - t0:.3f} s")
    return launches


def ranks_sample():
    sys.path.insert(0, os.path.join(ROOT, "samples"))
    import ranks_torch
    return ranks_torch


def phase_o(dev, card, b_games, b_state) -> dict:
    """Phase B's super across the ranks of an NCCL process group of one
    rank on this card (a FileStore in a temporary directory): the route
    goes through the process-group exchange (one ``all_to_all_single`` a
    tensor, K2 packing each rank's outbox), the delivered counts and the
    merged reads through ``all_reduce``. Held exactly against Phase B's
    one-device run (``b_games``, ``b_state``) and against the one-device
    merged reads and exchange of ``samples/ranks_torch.py``. Two ranks on
    one card are not tried (NCCL refuses a card shared by two ranks), so
    an exchange between cards is not verified here. Returns the phase's
    launches."""
    import torch.distributed as dist
    from orleans_tpu_torch.ops import KERNELS
    from orleans_tpu_torch.parallel import make_mesh
    rk = ranks_sample()
    tmp = build_tmpdir("phase_o_")
    t0 = time.perf_counter()
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            group = dist.group.WORLD
            for k in KERNELS:
                k.launches = 0
            t_super = time.perf_counter()
            games, state = phase_b(dev, card, group=group, label="Phase O")
            launches = {k.name: k.launches for k in KERNELS}
            wall = time.perf_counter() - t_super
            np.testing.assert_array_equal(games, b_games)
            for f, v in b_state.items():
                c = v.shape[1] - 1  # the sink row is undefined
                assert torch.equal(state[f][:, :c], v[:, :c]), f
            one, grouped = make_mesh(rk.N_SHARDS, dev), \
                make_mesh(rk.N_SHARDS, dev, group=group)
            for run in (rk.run_hits, rk.run_exchange):
                want, got = run(one), run(grouped)
                assert sorted(want) == sorted(got)
                for k, v in want.items():
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"Phase O: Phase B's super through an NCCL group of 1 rank "
          f"({wall:.3f} s with its set-up): games and player state == "
          f"Phase B exactly; merged reads (all_reduce SUM/MAX/MIN) and the "
          f"exchange == the one-device port; launches {launches}; "
          f"{time.perf_counter() - t0:.3f} s on {card}; an exchange "
          f"between cards is not verified (one card)")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from orleans_tpu_torch.ops import KERNELS, RANK_BY_DEST, SEGMENT_SUM
    from orleans_tpu_torch.ops._build import build_all

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    secs = build_all(KERNELS)
    print(f"build: {len(KERNELS)} kernels in {secs:.3f} s")
    for k in KERNELS:
        for line in k.build_log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")) or "error" in line.lower():
                print(f"  {k.name}: {line.strip()}")
        sass_summary(k)

    errs, main_inputs = kernel_checks(dev)
    print("kernel times at the main path's shapes:")
    times = kernel_times(*main_inputs)
    for k in KERNELS:
        k.launches = 0  # the main path's count starts here
    rate_a = phase_a(dev, card)
    before_b = {k.name: k.launches for k in KERNELS}
    b_games, b_state = phase_b(dev, card)
    for k in KERNELS:  # Phase B's route and fan-in went through both
        assert k.launches > before_b[k.name], f"{k.name} not launched in B"
    phase_c(dev)
    launches = {k.name: k.launches for k in KERNELS}
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was not launched on the main path"
    phase_d(dev)

    # Phase E: the per-key path, inline then on the off-loop worker, from
    # the same schedule; it launches neither K1 nor K2 (its tick is the
    # gather / handler / scatter of the engine)
    for k in KERNELS:
        k.launches = 0
    e_inline, _ = phase_e(dev, card)
    e_offloop, _ = phase_e(dev, card, offloop=True)
    for name in e_inline:
        same_state(e_inline[name], e_offloop[name], f"Phase E {name}")
    print("Phase E: inline and off-loop runs left identical state")
    launches_e = {k.name: k.launches for k in KERNELS}
    del e_inline, e_offloop
    phase_f(dev)
    # Phase G: the bulk collectives; every broadcast chunk ranks through K2
    for k in KERNELS:
        k.launches = 0
    _, _, launches_g = phase_g(dev, card)
    assert launches_g[RANK_BY_DEST.name] > 0, "K2 not launched in Phase G"
    # Phase H: the hosted silo; its broadcast ranks through K2 and its
    # summaries fan in through K1
    for k in KERNELS:
        k.launches = 0
    t_hi = time.perf_counter()
    launches_h, st_h = phase_h(dev, card)
    for name, count in launches_h.items():
        assert count > 0, f"kernel {name} was not launched in Phase H"
    got_i, st_i = phase_i(dev)
    print(f"Phases H and I: {time.perf_counter() - t_hi:.3f} s")
    # Phase J: device streams; every delivery chunk ranks through K2
    for k in KERNELS:
        k.launches = 0
    t_j = time.perf_counter()
    launches_j = phase_j(dev, card)
    assert launches_j[RANK_BY_DEST.name] > 0, "K2 not launched in Phase J"
    phase_j_cpu(dev)
    print(f"Phase J with its CPU comparison: "
          f"{time.perf_counter() - t_j:.3f} s")
    # Phase K: the live cluster; each planning round with drain
    # candidates packs them through K2
    for k in KERNELS:
        k.launches = 0
    t_k = time.perf_counter()
    launches_k = phase_k(dev, card)
    assert launches_k[RANK_BY_DEST.name] > 0, "K2 not launched in Phase K"
    t_kc = time.perf_counter()
    phase_k_cpu(dev)
    print(f"Phase K: {t_kc - t_k:.3f} s, its CPU comparison "
          f"{time.perf_counter() - t_kc:.3f} s")
    # Phase L: Presence over real TCP gateways; the native codec and loop
    # runner must be the ones in use. L1's 64 summaries fan in through K1
    # and its broadcast ranks each of its 64 chunks through K2; L2's
    # broadcast ranks both silos' chunks
    native_check()
    for k in KERNELS:
        k.launches = 0
    t_l = time.perf_counter()
    after_l1, launches_l = phase_l(dev, card, st_h)
    assert after_l1[SEGMENT_SUM.name] == 64, \
        f"K1 launched {after_l1[SEGMENT_SUM.name]} times in L1, not 64"
    assert after_l1[RANK_BY_DEST.name] >= 64, \
        f"K2 launched {after_l1[RANK_BY_DEST.name]} times in L1"
    assert launches_l[SEGMENT_SUM.name] == 64
    assert launches_l[RANK_BY_DEST.name] > after_l1[RANK_BY_DEST.name], \
        "K2 not launched in Phase L2"
    t_lc = time.perf_counter()
    phase_l_cpu(dev, card, got_i, st_i)
    print(f"Phase L: {t_lc - t_l:.3f} s, its CPU comparison "
          f"{time.perf_counter() - t_lc:.3f} s")
    # Phase M: the multi-process silo (its workers forked after the
    # owner's tables were built on the card) and the multi-loop silo, both
    # with the observability stack; M2's 64 summaries fan in through K1
    # and its broadcast ranks each chunk through K2
    for k in KERNELS:
        k.launches = 0
    t_m = time.perf_counter()
    launches_m = phase_m(dev, card, got_i)
    for name, count in launches_m.items():
        assert count > 0, f"kernel {name} was not launched in Phase M"
    print(f"Phase M with its CPU comparison: "
          f"{time.perf_counter() - t_m:.3f} s")
    # Phase N: durable streams (N1: each delivered chunk ranks through
    # K2) and reminder-driven journaled summaries (N2: one K1 a fire)
    for k in KERNELS:
        k.launches = 0
    t_n = time.perf_counter()
    launches_n = phase_n(dev, card)
    for name, count in launches_n.items():
        assert count > 0, f"kernel {name} was not launched in Phase N"
    print(f"Phase N with its CPU comparison: "
          f"{time.perf_counter() - t_n:.3f} s")
    # Phase O: Phase B across the ranks of a process group; every route
    # packs its outbox through K2, every fan-in through K1
    launches_o = phase_o(dev, card, b_games, b_state)
    for name, count in launches_o.items():
        assert count > 0, f"kernel {name} was not launched in Phase O"
    del b_state
    print(f"launches on the main path: A-C {launches}, E {launches_e}, "
          f"G {launches_g}, H {launches_h}, J {launches_j}, K {launches_k}, "
          f"L {launches_l}, M {launches_m}, N {launches_n}, O {launches_o}")
    launches = {name: launches[name] + launches_e[name] + launches_g[name]
                + launches_h[name] + launches_j[name] + launches_k[name]
                + launches_l[name] + launches_m[name] + launches_n[name]
                + launches_o[name] for name in launches}

    sources = {SEGMENT_SUM.name: ("orleans_tpu/ops/segment_reduce.py:87",
                                  "orleans_tpu_torch/ops/csrc/segment_sum.cu"),
               RANK_BY_DEST.name: ("orleans_tpu/ops/route.py:52",
                                   "orleans_tpu_torch/ops/csrc/"
                                   "rank_by_dest.cu")}
    rows = []
    for k in KERNELS:
        ms, device_ms, plain, lib, bound, per_call = times[k.name]
        rows.append({
            "name": k.name, "route": "cuda", "source": sources[k.name][1],
            "replaces": sources[k.name][0], "launches": launches[k.name],
            "max_abs_err": errs[k.name], "ms": ms, "kernel_ms": ms,
            "device_ms": device_ms, "device_kernels_per_call": per_call,
            "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib})
    assert all(math.isfinite(r["ms"]) for r in rows)
    print(f"Phase A headline: {rate_a:.0f} msgs/sec on {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
