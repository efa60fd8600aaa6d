"""Parity of the port's grain services (orleans_tpu_torch.services:
ring-partitioned per-silo services and their client) and of interface
versioning under them with the JAX package's, on the CPU: the grain
service and versioning scenarios of
tests/test_services_versions_multicluster.py run through each package one
after the other, and what each observed must be equal exactly. Silo
addresses differ from run to run, so a scenario reports silos by index.

The port holds the tasks that run a coroutine ``on_start``/``on_stop``
hook until they end (the JAX package leaves them to the event loop's weak
references).

Grains and services of a pair are built by one factory per package;
every async body runs under ``asyncio.wait_for(..., 30)``.
"""

import asyncio
import gc
import time
import weakref
from types import SimpleNamespace

import pytest

import orleans_tpu.membership as jm
import orleans_tpu.runtime as jr
import orleans_tpu.services as jsv
import orleans_tpu.storage as js
import orleans_tpu.versions as jv
import orleans_tpu_torch.membership as tm
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.services as tsv
import orleans_tpu_torch.storage as ts
import orleans_tpu_torch.versions as tv

TIMEOUT = 30


def _service(rt, sv):
    class KvService(sv.GrainService):
        def __init__(self, silo):
            super().__init__(silo)
            self.data = {}

        async def put(self, key, value):
            self.data[key] = value
            return self.silo.silo_address

        async def get_value(self, key):
            return self.data.get(key)

    class ServiceUserGrain(rt.Grain):
        async def put_via_service(self, key, value):
            client = sv.GrainServiceClient(self._activation.runtime,
                                           KvService)
            return str(await client.call(key, "put", key, value))

    return KvService, ServiceUserGrain


def _versions(rt, v):
    @v.grain_version(1)
    class ApiGrainV1(rt.Grain):
        async def ping(self):
            return ("v1", self.runtime_identity)

    @v.grain_version(2)
    class ApiGrainV2(rt.Grain):
        async def ping(self):
            return ("v2", self.runtime_identity)

    ApiGrainV1.__name__ = ApiGrainV2.__name__ = "ApiGrain"
    return ApiGrainV1, ApiGrainV2


def _pkg(name, rt, sv, mb, storage, v):
    kv, user = _service(rt, sv)
    v1, v2 = _versions(rt, v)
    return SimpleNamespace(name=name, rt=rt, sv=sv, mb=mb, storage=storage,
                           Kv=kv, User=user, V1=v1, V2=v2)


J = _pkg("jax", jr, jsv, jm, js, jv)
T = _pkg("torch", tr, tsv, tm, ts, tv)


async def _parity(scenario):
    got = []
    for pkg in (J, T):
        got.append(await asyncio.wait_for(scenario(pkg), TIMEOUT))
    assert got[0] == got[1], (scenario.__name__, got[0], got[1])
    return got[1]


async def _partitions(pkg):
    fabric = pkg.rt.InProcFabric()
    mbr = pkg.mb.InMemoryMembershipTable()
    silos = []
    for i in range(3):
        b = (pkg.rt.SiloBuilder().with_name(f"gs{i}").with_fabric(fabric)
             .add_grains(pkg.User)
             .with_storage("Default", pkg.storage.MemoryStorage())
             .with_config(membership_probe_period=0.1,
                          membership_probe_timeout=0.15,
                          membership_missed_probes_limit=2,
                          membership_refresh_period=0.3,
                          response_timeout=2.0))
        pkg.sv.add_grain_service(b, pkg.Kv)
        silo = b.build()
        pkg.mb.join_cluster(silo, mbr)
        await silo.start()
        silos.append(silo)
    client = await pkg.rt.ClusterClient(fabric).connect()
    try:
        index = {str(s.silo_address): i for i, s in enumerate(silos)}
        grain = client.get_grain(pkg.User, 1)
        owners = [await grain.put_via_service(f"k{k}", k) for k in range(20)]
        svc = pkg.sv.GrainServiceClient(silos[0], pkg.Kv)
        values = [await svc.call(f"k{k}", "get_value", f"k{k}")
                  for k in range(20)]
        victim = silos[2]
        await victim.stop(graceful=False)
        deadline = time.monotonic() + 8
        while time.monotonic() < deadline and not all(
                victim.silo_address in s.membership.dead for s in silos[:2]):
            await asyncio.sleep(0.05)
        after = []
        for k in range(20):
            await svc.call(f"k{k}", "put", f"k{k}", k * 2)
            after.append(await svc.call(f"k{k}", "get_value", f"k{k}"))
        return len({index[o] for o in owners}) > 1, values, after
    finally:
        await client.close_async()
        for s in silos:
            if s.status not in ("Stopped", "Dead"):
                await s.stop()


async def test_grain_service_partitions_by_key_and_reranges():
    spread, values, after = await _parity(_partitions)
    assert spread and values == list(range(20))
    assert after == [2 * k for k in range(20)]


async def _version_gated(pkg):
    fabric = pkg.rt.InProcFabric()
    storage = pkg.storage.MemoryStorage()
    old = (pkg.rt.SiloBuilder().with_name("old").with_fabric(fabric)
           .add_grains(pkg.V1).with_storage("Default", storage).build())
    await old.start()
    new = (pkg.rt.SiloBuilder().with_name("new").with_fabric(fabric)
           .add_grains(pkg.V2).with_storage("Default", storage).build())
    await new.start()
    try:
        v2 = [(await new.grain_factory.get_grain(pkg.V2, k).ping())[0]
              for k in range(10)]
        v1 = {(await old.grain_factory.get_grain(pkg.V1, k).ping())[0]
              for k in range(20, 40)}
        return v2, bool(v1 & {"v1", "v2"})
    finally:
        await new.stop()
        await old.stop()


async def test_version_gated_placement_backward_compat():
    v2, served = await _parity(_version_gated)
    assert v2 == ["v2"] * 10 and served


async def _strict(pkg):
    fabric = pkg.rt.InProcFabric()
    old = (pkg.rt.SiloBuilder().with_name("old2").with_fabric(fabric)
           .add_grains(pkg.V1)
           .with_storage("Default", pkg.storage.MemoryStorage()).build())
    await old.start()
    old.locator.versions.set_strategy(compat="strict")
    try:
        with pytest.raises(Exception, match="compatible") as e:
            await old.grain_factory.get_grain(pkg.V2, 99).ping()
        return type(e.value).__name__
    finally:
        await old.stop()


async def test_strict_compat_rejects_mismatch():
    await _parity(_strict)


def test_service_hook_tasks_are_held_until_they_end():
    """A coroutine ``on_start`` hook runs in a task the service holds: a
    collection while it waits on a future nothing else holds leaves it
    alive, and it completes."""
    async def run():
        loop = asyncio.get_running_loop()
        waiting: list = []
        done: list = []

        class Hooked(tsv.GrainService):
            refresh_period = 60.0

            def __init__(self, silo):
                self.silo = silo
                self._task = None
                self._hooks = set()
                self._range = None

            def _update_ring(self):
                pass

            async def on_start(self):
                fut = loop.create_future()
                waiting.append(weakref.ref(fut))
                await fut
                done.append("started")

        svc = Hooked(SimpleNamespace(membership=None))
        svc.start()
        for _ in range(3):
            await asyncio.sleep(0)
        gc.collect()
        fut = waiting[0]()
        assert fut is not None, "the on_start task was collected mid-flight"
        fut.set_result(None)
        for _ in range(3):
            await asyncio.sleep(0)
        svc.stop()
        return done, len(svc._hooks)

    assert asyncio.run(asyncio.wait_for(run(), TIMEOUT)) == (["started"], 0)
