"""Ops entry points: the OrleansManager CLI analog.

Re-design of Orleans' src/OrleansManager/Program.cs:62-94
(grainstats / collect / lookup / unregister / setcompatibilitystrategy /
fullgrainstats) as a library of async ops over a connected client, plus an
``python -m orleans_tpu_torch.manage`` demo runner (the in-proc fabric has no
cross-process transport, so the CLI hosts a demo cluster to operate on;
deployments embed these ops next to their own client).
"""

from __future__ import annotations

import argparse
import asyncio
import json
from typing import Any

from .management import ManagementGrain

__all__ = ["grain_stats", "runtime_stats", "hosts", "collect",
           "debug_dump", "set_compatibility_strategy", "main"]


def _mgmt(client) -> Any:
    return client.get_grain(ManagementGrain, 0)


async def grain_stats(client) -> dict[str, int]:
    """`orleansmanager grainstats`: activations per grain class."""
    return await _mgmt(client).get_simple_grain_statistics()


async def runtime_stats(client) -> dict:
    return await _mgmt(client).get_runtime_statistics()


async def hosts(client) -> dict[str, str]:
    return await _mgmt(client).get_hosts()


async def collect(client, age_seconds: float = 0.0) -> int:
    """`orleansmanager collect`: force idle-activation collection."""
    return await _mgmt(client).force_activation_collection(age_seconds)


async def debug_dump(client) -> dict:
    return await _mgmt(client).get_debug_dump()


async def set_compatibility_strategy(client, compat: str | None = None,
                                     selector: str | None = None) -> None:
    await _mgmt(client).set_compatibility_strategy(compat, selector)


async def _demo(args) -> None:
    """Spin a demo cluster and run the requested op against it."""
    from .management import add_management
    from .runtime import ClusterClient, Grain, InProcFabric, SiloBuilder
    from .storage import MemoryStorage

    class DemoGrain(Grain):
        async def hello(self) -> str:
            return "hello"

    fabric = InProcFabric()
    storage = MemoryStorage()
    silos = []
    for i in range(args.silos):
        b = (SiloBuilder().with_name(f"demo{i}").with_fabric(fabric)
             .add_grains(DemoGrain).with_storage("Default", storage))
        add_management(b)
        silo = b.build()
        await silo.start()
        silos.append(silo)
    client = await ClusterClient(fabric).connect()
    for k in range(args.grains):
        await client.get_grain(DemoGrain, k).hello()

    op = {
        "grainstats": grain_stats, "runtimestats": runtime_stats,
        "hosts": hosts, "collect": collect, "dump": debug_dump,
    }[args.command]
    print(json.dumps(await op(client), indent=2, default=str))

    await client.close_async()
    for s in silos:
        await s.stop()


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        prog="orleans_tpu_torch.manage",
        description="Cluster ops (OrleansManager analog) — demo runner")
    p.add_argument("command", choices=["grainstats", "runtimestats", "hosts",
                                       "collect", "dump"])
    p.add_argument("--silos", type=int, default=2)
    p.add_argument("--grains", type=int, default=10)
    args = p.parse_args(argv)
    asyncio.run(_demo(args))


if __name__ == "__main__":
    main()
