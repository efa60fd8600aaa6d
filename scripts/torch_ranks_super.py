#!/usr/bin/env python3
"""Phase B's super (``bench.py --devices 8``) across the ranks of a
process group, one rank a card, at its full width.

Each rank runs ``chip_smoke.phase_b`` on a mesh over an NCCL group of
``--world`` ranks (8 shards, ``8 // world`` a rank): the K=8 scanned
heartbeat rounds on its players, the route through the process-group
exchange (K2 packs each rank's outbox, one ``all_to_all_single`` a
tensor between the cards), the K1 fan-in and the game tick. Every rank
checks its games and players against the closed form, and the delivered
and dropped counts are summed over the ranks (every message must
arrive). Each rank prints its super's wall, its device busy time and its
launches.

    python3 scripts/torch_ranks_super.py --world 4      # 4 cards
    python3 scripts/torch_ranks_super.py --world 4 --cpu --players 20000

``--cpu`` rehearses it with gloo ranks on the CPU (no timing).
"""

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(rank: int, world: int, init: str, players: int,
              cpu: bool) -> None:
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    import chip_smoke as c
    from orleans_tpu_torch.ops import KERNELS
    from orleans_tpu_torch.ops._build import build_all
    if cpu:
        dev, card, backend = torch.device("cpu"), "cpu", "gloo"
    else:
        dev, card, backend = torch.device("cuda", rank), c.card_line(), \
            "nccl"
        torch.cuda.set_device(dev)
        build_all(KERNELS)
    dist.init_process_group(backend, init_method=f"file://{init}",
                            world_size=world, rank=rank)
    try:
        for k in KERNELS:
            k.launches = 0
        c.phase_b(dev, card, n_players=players, quiet=cpu,
                  group=dist.group.WORLD,
                  label=f"Phase B over {world} ranks, rank {rank}")
        print(f"rank {rank}: launches "
              f"{ {k.name: k.launches for k in KERNELS} }")
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--players", type=int, default=1_000_000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init")
    a = ap.parse_args()
    if a.rank is not None:
        rank_main(a.rank, a.world, a.init, a.players, a.cpu)
        return 0
    sys.path.insert(0, os.path.join(ROOT, "samples"))
    from ranks_torch import launch
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        logs = launch([[sys.executable, os.path.abspath(__file__),
                        "--rank", str(r), "--world", str(a.world),
                        "--init", init, "--players", str(a.players)]
                       + (["--cpu"] if a.cpu else [])
                       for r in range(a.world)], a.timeout)
    for r, log in enumerate(logs):
        print(f"--- rank {r} ---")
        print("\n".join(line for line in log.splitlines()
                        if "Warning" not in line and "_warn_once" not in
                        line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
