#!/usr/bin/env python3
"""Time K1 and K2 of the PyTorch/CUDA port under several launch plans,
and K2's phases.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_kernel_plans.py

1. Plans. At K1's main-path shape (``chip_smoke.py``'s Phase B fan-in)
   and at K2's one-row edge shape, each plan is made by the
   wrapper's own plan function (``rank_plan`` with a smaller
   ``max_cluster``; ``segment_sum_plan`` on ``rows x blocks per row``
   SMs), held against the plain version (exact), and timed: device ms per
   call from torch.profiler. The plans the wrappers choose are marked *.
2. K2 at the Phase B route, under each cluster plan, held and timed as
   above; then the ``RANK_PHASE_MARKS`` build of ``csrc/rank_by_dest.cu``
   under the same plan: the mean time of each phase over the blocks, the
   span of the launch from the first block's start to the last block's
   end, and how many blocks shared an SM. The marks cost a few tens of ns
   per block.

Prints one line per measurement and writes them all to
``orleans_tpu_torch/_build/kernel_plans.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from orleans_tpu_torch.ops._build import check  # noqa: E402

PHASES = ("setup", "load", "count", "scan", "push+barrier", "earlier tiles",
          "scratch", "rank+store")
CLUSTERS = (16, 2, 1)
K1_BLOCKS_PER_ROW = (8, 10, 12, 16, 17, 20, 24, 33)


def device_ms(fn, own):
    """(device ms of the kernels named ``own``, device kernels) per call;
    asked again where the profiler's trace lost the kernel."""
    for _ in range(3):
        prof = chip_smoke.device_profile(fn, iters=20)
        ms = sum(t for k, (t, _) in prof.items() if own in k)
        if ms > 0:
            return ms, sum(c for _, c in prof.values())
    raise RuntimeError(f"no device time for {own} in three traces")


def phase_marks(kernel, grid: int) -> dict:
    """The RANK_PHASE_MARKS build's marks of its last launch."""
    torch.cuda.synchronize()
    marks = np.zeros((grid, len(PHASES) + 2), np.uint64)
    check(kernel.lib().oat_rank_by_dest_phase_marks(marks.ctypes.data, grid),
          "rank_by_dest phase marks")
    t = marks[:, :len(PHASES) + 1].astype(np.int64)
    _, owners = np.unique(marks[:, -1], return_counts=True)
    return {"phase_ns": dict(zip(PHASES, (t[:, 1:] - t[:, :-1]).mean(0)
                                 .round(1).tolist())),
            "span_ns": int(t[:, -1].max() - t[:, 0].min()),
            "blocks_sharing_an_sm": int(owners[owners > 1].sum()),
            "blocks": grid}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_plans: needs a CUDA card", file=sys.stderr)
        return 1
    from orleans_tpu_torch.ops import (KERNELS, rank_by_dest_ref, rank_plan,
                                       segment_sum_plan, segment_sum_ref)
    from orleans_tpu_torch.ops._build import BUILD_DIR, Kernel, build_all
    from orleans_tpu_torch.ops.route import RANK_BY_DEST, launch_rank
    from orleans_tpu_torch.ops.segment_reduce import launch_segment_sum
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"card: {card}")

    marks = Kernel("rank_by_dest_marks", "rank_by_dest.cu", {
        **RANK_BY_DEST.signatures,
        "oat_rank_by_dest_phase_marks": (ctypes.c_int, [ctypes.c_void_p,
                                                        ctypes.c_int])},
        ("RANK_PHASE_MARKS",))
    secs = build_all([*KERNELS, marks])
    print(f"build: {secs:.3f} s")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dest, values, ids = chip_smoke.main_path_inputs(dev, gen)
    n_dest = chip_smoke.SHARDS_B + 1
    print(f"K2 cluster limit at {n_dest} dests: "
          f"{RANK_BY_DEST.lib().oat_rank_by_dest_max_cluster(n_dest)}")
    rows = []

    def k2(label, d, nd, plan, chosen, marked=False):
        try:
            got = launch_rank(d, nd, plan)
        except RuntimeError as e:  # a cluster the card cannot hold
            print(f"{label} {tuple(plan)}: refused ({e})")
            return
        want = rank_by_dest_ref(d, nd)
        ok = torch.equal(got, want)
        ms, per_call = device_ms(lambda: launch_rank(d, nd, plan),
                                 "rank_by_dest_kernel")
        row = {"case": label, "plan": plan._asdict(), "chosen": chosen,
               "exact": ok, "device_ms": ms, "kernels_per_call": per_call}
        line = (f"{label} {tuple(plan)}{' *' if chosen else ''}: "
                f"exact={ok} device {ms:.5f} ms")
        if marked:  # the marks of the last of a few launches
            for _ in range(5):
                got = launch_rank(d, nd, plan, marks)
            row["exact"] = ok = ok and torch.equal(got, want)
            row["marked"] = phase_marks(
                marks, d.shape[0] * plan.cluster_size * plan.clusters_per_row)
            m = row["marked"]
            line += (f"; marked build: span {m['span_ns']} ns, "
                     f"{m['blocks_sharing_an_sm']} of {m['blocks']} blocks "
                     f"shared an SM; mean ns: " + " ".join(
                         f"{k} {v:.0f}" for k, v in m["phase_ns"].items()))
        rows.append(row)
        print(line)

    big = torch.randint(0, 2, (1, 1 << 20), generator=gen, device=dev,
                        dtype=torch.int32)
    chosen = rank_plan(*big.shape, 2)
    for c in CLUSTERS:
        plan = rank_plan(*big.shape, 2, max_cluster=c)
        k2("K2 one row [1, 1048576]", big, 2, plan, plan == chosen)
    chosen = rank_plan(*dest.shape, n_dest)
    for c in CLUSTERS:
        plan = rank_plan(*dest.shape, n_dest, max_cluster=c)
        k2("K2 main path [8, 131072]", dest, n_dest, plan, plan == chosen,
           marked=True)

    S = 128
    v3, want = values[..., None], segment_sum_ref(values, ids, S)
    n, B = ids.shape
    chosen = segment_sum_plan(n, B, 1, S, sms)
    for per_row in K1_BLOCKS_PER_ROW:
        plan = segment_sum_plan(n, B, 1, S, n * per_row)
        got = launch_segment_sum(v3, ids, S, plan)[..., 0]
        ok = torch.equal(got, want)
        ms, per_call = device_ms(lambda: launch_segment_sum(v3, ids, S, plan),
                                 "segment_sum_kernel")
        rows.append({"case": "K1 main path [8, 156256]",
                     "plan": plan._asdict(), "chosen": plan == chosen,
                     "exact": ok, "device_ms": ms,
                     "kernels_per_call": per_call})
        print(f"K1 main path {tuple(plan)}{' *' if plan == chosen else ''}: "
              f"exact={ok} device {ms:.5f} ms")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    (BUILD_DIR / "kernel_plans.json").write_text(json.dumps(
        {"card": card, "sms": sms, "rows": rows}, indent=1))
    assert all(r["exact"] for r in rows), "a plan gave a wrong result"
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
