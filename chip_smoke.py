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
   phase 4 — hashed keys resolved through the on-device directory, one
   actor targeted twice so that the apply defers a tick;
6. Phase D: a small Phase B on the card and on the CPU, compared exactly.

The launch counts are set to 0 just before Phase A and read just after
Phase C: a kernel the main path did not launch fails the run. The last
two lines are the ``kernels`` JSON (launches on the main path, errors and
times in ms) and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (NVIDIA data sheet)
FLOAT_RTOL = 1e-6
N_PLAYERS = 1_000_000
N_GAMES = 1024
K = 8
SHARDS_B = 8


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms, n = out.get(e.key, (0.0, 0.0))
        out[e.key] = (ms + us / 1e3 / iters, n + e.count / iters)
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
    return errs, (dest, values, ids)


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


def phase_b(dev, card, n_players=N_PLAYERS, supers=3, warm=1, quiet=False):
    """bench.py --devices 8's super-round on ``dev``; returns the game
    counts and the player state for a cross-device comparison."""
    from orleans_tpu_torch.dispatch import VectorRuntime
    from orleans_tpu_torch.ops import segment_sum
    from orleans_tpu_torch.parallel import make_mesh
    Player, Game, _ = player_classes()
    n = SHARDS_B
    rt = VectorRuntime(make_mesh(n, dev),
                       capacity_per_shard=-(-n_players // n))
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
    route_capacity = -(-5 * n_players // (4 * n * n))
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
    d, x = int(delivered.sum()), int(dropped.sum())
    assert x == 0, f"exchange dropped {x} messages"
    assert d == total * n_players, (d, total * n_players)
    games = gt.state["count"][:, :gps].reshape(-1)[:N_GAMES].cpu().numpy()
    want = np.bincount(keys % N_GAMES, minlength=N_GAMES) * total
    np.testing.assert_array_equal(games, want)
    beats = tbl.state["beats"][:, :tbl.dense_per_shard].reshape(-1)
    assert bool((beats[:n_players] == 1 + total * K).all())
    if not quiet:
        report_breakdown("Phase B super", device_breakdown(
            lambda: super_round(0), iters=3), wall / supers * 1e3)
        rate = supers * K * n_players / wall
        print(f"Phase B: {n_players} players over {n} shards on one card, "
              f"{supers} supers (K={K} scan + route + fan-in + game tick): "
              f"{rate:.0f} heartbeat msgs/sec, {supers * n_players / wall:.0f}"
              f" routed msgs/sec ({wall / supers * 1e3:.3f} ms/super), "
              f"delivered {d}, dropped {x} on {card}")
    return games, {k: v.cpu() for k, v in tbl.state.items()}


def activate_hashed(rt, cls, method, hashes, amount):
    """Allocate each hashed key's slot and fresh-init it in one tick."""
    tbl = rt.table(cls)
    locs = [tbl.lookup_or_allocate(h)[:2] for h in hashes]
    n = tbl.n_shards
    B = max(sum(1 for s, _ in locs if s == sh) for sh in range(n))
    slots = np.full((n, B), tbl.sink_slot, np.int32)
    khash = np.zeros((n, B), np.int32)
    valid = np.zeros((n, B), bool)
    amt = np.zeros((n, B), np.int32)
    fill = [0] * n
    for h, (s, slot), a in zip(hashes, locs, amount):
        i = fill[s]
        fill[s] += 1
        slots[s, i], khash[s, i], valid[s, i], amt[s, i] = \
            slot, h & 0x7FFFFFFF, True, a

    def dev(x):
        return torch.from_numpy(x).to(rt.device)
    rt.call_batch_device(cls, method, dev(slots), dev(khash), dev(valid),
                         dev(valid), {"amount": dev(amt)})


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
    activate_hashed(rt, Counter, "add", hashes, [0] * len(hashes))
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
    phase_b(dev, card)
    for k in KERNELS:  # Phase B's route and fan-in went through both
        assert k.launches > before_b[k.name], f"{k.name} not launched in B"
    phase_c(dev)
    launches = {k.name: k.launches for k in KERNELS}
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was not launched on the main path"
    phase_d(dev)

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
