#!/usr/bin/env python3
"""Time one write-behind flush of the port and how long it holds the loop.

    python3 scripts/torch_flush_stall.py [--root TREE] [--n ROWS] [--cpu]

Builds ``samples/presence_torch.py``'s PlayerVectorGrain table of ``--n``
dense players over 8 shards (on the CUDA card unless ``--cpu``), runs one
heartbeat wave so every row is dirty, and flushes every row through a
``VectorStorageBridge`` over ``MemoryStorage`` on an event loop with the
eager task factory a silo installs, while a watcher task records each
gap between its wake-ups. Prints one JSON line: rows, seconds, rows/s,
the longest gap (the longest stretch the flush held the loop) and the
number of wake-ups the watcher got during the flush. ``--root`` imports
``orleans_tpu_torch`` and the sample from another checkout, so two trees
can be compared in one call.
"""

import argparse
import asyncio
import json
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path[:0] = [root, os.path.join(root, "samples")]

    import numpy as np
    import torch

    import presence_torch as pt
    from orleans_tpu_torch.dispatch import VectorRuntime
    from orleans_tpu_torch.parallel import make_mesh
    from orleans_tpu_torch.storage import MemoryStorage, VectorStorageBridge

    dev = "cpu" if a.cpu else None
    n = a.n
    rt = VectorRuntime(make_mesh(8, dev), capacity_per_shard=-(-n // 8))
    rt.table(pt.PlayerVectorGrain).ensure_dense(n)
    rt.enable_dirty_tracking()
    bridge = VectorStorageBridge(rt, pt.PlayerVectorGrain, MemoryStorage())
    rt.call_batch(pt.PlayerVectorGrain, "heartbeat", np.arange(n), {
        "pos": np.zeros((n, 2), np.float16),
        "delta": np.ones(n, np.int32)})
    keys = rt.drain_dirty(pt.PlayerVectorGrain)
    if not a.cpu:
        torch.cuda.synchronize()

    async def run():
        asyncio.get_running_loop().set_task_factory(
            asyncio.eager_task_factory)
        gaps = []

        async def watch():
            last = time.perf_counter()
            while True:
                await asyncio.sleep(0)
                now = time.perf_counter()
                gaps.append(now - last)
                last = now

        watcher = asyncio.ensure_future(watch())
        t0 = time.perf_counter()
        rows = await bridge.flush(keys)
        secs = time.perf_counter() - t0
        watcher.cancel()
        return rows, secs, gaps

    rows, secs, gaps = asyncio.run(run())
    print(json.dumps({
        "root": root, "device": str(rt.device), "rows": rows,
        "seconds": secs, "rows_per_s": rows / secs,
        "longest_gap_ms": max(gaps, default=secs) * 1e3,
        "wakeups": len(gaps)}))


if __name__ == "__main__":
    main()
