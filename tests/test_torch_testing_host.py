"""Parity of the port's test harness (orleans_tpu_torch.testing:
TestClusterBuilder/TestCluster over the port's membership and management)
with the JAX package's, on the CPU; the stop-time forward loop repaired
in the port's dispatcher; and the multi-silo scenarios of
tests/test_vector_hosting.py through the port's TestCluster.

Scenarios run through each package one after the other, never
interleaved on one loop, and what each observed must be equal exactly.
One exception, on purpose: the restart scenario runs through the port
only, several times: the reference's copy can recurse in ``stop_all()``
until the loop hangs (ROADMAP Queue 3), which no ``asyncio.wait_for`` can
bound. The reminder and transaction opt-in test keeps the name it had
when the port refused both opt-ins.

Vector grains of a pair share ``__name__`` (part of every hashed key's
GrainId and of the ring owner's hash); the port's TestCluster gets
``mesh=make_mesh(8, device="cpu")`` (a mesh of None means CUDA). Every
async body runs under ``asyncio.wait_for(..., 30)``.
"""

import asyncio
from types import SimpleNamespace

import jax.numpy as jnp
import pytest
import torch

import orleans_tpu.dispatch as jd
import orleans_tpu.management as jmg
import orleans_tpu.parallel as jp
import orleans_tpu.runtime as jr
import orleans_tpu.storage as js
import orleans_tpu.testing as jt
import orleans_tpu_torch.dispatch as td
import orleans_tpu_torch.management as tmg
import orleans_tpu_torch.parallel as tp
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.storage as ts
import orleans_tpu_torch.testing as tt
from orleans_tpu_torch.core.errors import SiloUnavailableError
from orleans_tpu_torch.core.ids import GrainId, SiloAddress, type_code_of
from orleans_tpu_torch.core.message import Category
from orleans_tpu_torch.directory.locator import (
    DIRECTORY_TARGET,
    DirectoryTarget,
)

TIMEOUT = 30


class JCounterVec(jd.VectorGrain):
    STATE = {"count": (jnp.int32, ()), "last": (jnp.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"count": jnp.int32(0), "last": jnp.float32(0)}

    @jd.actor_method(args={"x": (jnp.float32, ())})
    def add(state, args):
        new = {"count": state["count"] + 1, "last": args["x"]}
        return new, new["count"]


class TCounterVec(td.VectorGrain):
    STATE = {"count": (torch.int32, ()), "last": (torch.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"count": torch.zeros_like(key_hash),
                "last": key_hash.new_zeros((), dtype=torch.float32)}

    @td.actor_method(args={"x": (torch.float32, ())})
    def add(state, args):
        new = {"count": state["count"] + 1, "last": args["x"]}
        return new, new["count"]


for _cls in (JCounterVec, TCounterVec):
    _cls.__name__ = _cls.__qualname__ = "CounterVec"


def _host_grains(rt, vec):
    class EchoGrain(rt.Grain):
        async def echo(self, v):
            return v

        async def where(self):
            return self.runtime_identity

    class CounterGrain(rt.StatefulGrain):
        async def incr(self):
            self.state["n"] = self.state.get("n", 0) + 1
            await self.write_state()
            return self.state["n"]

    class HostGrain(rt.Grain):
        """Host-tier grain calling into the device tier."""

        async def poke_vector(self, key: int, x: float) -> int:
            return int(await self.get_grain(vec, key).add(x=x))

    return SimpleNamespace(Echo=EchoGrain, Counter=CounterGrain,
                           Host=HostGrain)


J = SimpleNamespace(rt=jr, d=jd, mg=jmg, storage=js, testing=jt,
                    Vec=JCounterVec, mesh=lambda n: jp.make_mesh(n),
                    g=_host_grains(jr, JCounterVec))
T = SimpleNamespace(rt=tr, d=td, mg=tmg, storage=ts, testing=tt,
                    Vec=TCounterVec,
                    mesh=lambda n: tp.make_mesh(n, device="cpu"),
                    g=_host_grains(tr, TCounterVec))


async def _parity(scenario, *args):
    got = []
    for pkg in (J, T):
        got.append(await asyncio.wait_for(scenario(pkg, *args), TIMEOUT))
    assert got[0] == got[1], (scenario.__name__, got[0], got[1])
    return got[1]


# ---------------------------------------------------------------------------
# tests/test_testing_host.py
# ---------------------------------------------------------------------------

async def _deploy_and_call(pkg):
    async with (pkg.testing.TestClusterBuilder(3).add_grains(pkg.g.Echo)
                .build()) as cluster:
        hosts = {await cluster.grain(pkg.g.Echo, k).where()
                 for k in range(24)}
        return (len(cluster.alive_silos),
                await cluster.grain(pkg.g.Echo, 1).echo("hi"),
                len(hosts) > 1)


async def test_deploy_and_call():
    assert await _parity(_deploy_and_call) == (3, "hi", True)


async def _kill_and_recover(pkg):
    async with (pkg.testing.TestClusterBuilder(3)
                .add_grains(pkg.g.Echo, pkg.g.Counter).build()) as cluster:
        g = cluster.grain(pkg.g.Counter, "c")
        first = await g.incr()
        victim = cluster.alive_silos[-1]
        await cluster.kill_silo(victim)
        await cluster.wait_for_death(victim)
        # state survives via storage; calls keep working
        return first, await g.incr(), len(cluster.alive_silos)


async def test_kill_and_cluster_recovers():
    assert await _parity(_kill_and_recover) == (1, 2, 2)


async def _restart(pkg):
    async with (pkg.testing.TestClusterBuilder(2).add_grains(pkg.g.Echo)
                .build()) as cluster:
        victim = cluster.silos[0]
        old_addr = victim.silo_address
        reborn = await cluster.restart_silo(victim)
        await cluster.wait_for_liveness()
        return (reborn.silo_address.same_endpoint(old_addr),
                reborn.silo_address.generation - old_addr.generation,
                len(cluster.alive_silos),
                await cluster.grain(pkg.g.Echo, 5).echo("x"))


@pytest.mark.parametrize("run", range(5))
async def test_restart_silo_same_endpoint_new_generation(run):
    """The port's restart, five times, each with its stop inside the
    bound (the reference's can hang there: ROADMAP Queue 3)."""
    got = await asyncio.wait_for(_restart(T), TIMEOUT)
    assert got == (True, 1, 2, "x")


async def _restarted_silo_serves_its_system_targets(pkg):
    async with (pkg.testing.TestClusterBuilder(2).add_grains(pkg.g.Echo)
                .build()) as cluster:
        reborn = await cluster.restart_silo(cluster.silos[0])
        await cluster.wait_for_liveness()
        mgmt = cluster.client.get_grain(pkg.mg.ManagementGrain, 0)
        hosts = await mgmt.get_hosts()
        # a fan-out to every active silo's SiloControl target
        runtime = await mgmt.get_runtime_statistics()
        return (hosts.get(str(reborn.silo_address)),
                runtime.get(str(reborn.silo_address), {}).get("status"))


async def test_restarted_silo_is_reachable_at_its_new_generation():
    """The reborn silo is built with its new address, so its system
    targets (membership, directory, management control) answer there;
    the reference re-addresses it after building, which leaves them
    keyed to the first address."""
    got = await asyncio.wait_for(
        _restarted_silo_serves_its_system_targets(T), TIMEOUT)
    assert got == ("Active", "Running")


async def _elastic_grow(pkg):
    async with (pkg.testing.TestClusterBuilder(2).add_grains(pkg.g.Echo)
                .build()) as cluster:
        await cluster.start_additional_silo()
        await cluster.wait_for_liveness()
        return len(cluster.alive_silos)


async def test_elastic_grow():
    assert await _parity(_elastic_grow) == 3


async def _partition_heals(pkg):
    async with (pkg.testing.TestClusterBuilder(3).add_grains(pkg.g.Echo)
                .build()) as cluster:
        a, b = cluster.silos[0], cluster.silos[1]
        cluster.partition(a, b)
        await asyncio.sleep(0.5)
        cluster.heal_partition(a, b)
        await cluster.wait_for_liveness()
        return len(cluster.alive_silos)


async def test_partition_heals():
    assert await _parity(_partition_heals) == 3


async def _feature_optins(pkg, tx):
    ticks: list = []

    class TickerGrain(pkg.rt.Grain):
        async def arm(self):
            await self.register_reminder("tick", 0.1, 0.2)

        async def receive_reminder(self, name, status):
            ticks.append(status.current_tick_time)

    class Acct(tx.TransactionalGrain):
        def __init__(self):
            self.v = tx.TransactionalState("v", default=0)

        @tx.transactional
        async def add(self, d):
            await self.v.set(await self.v.get() + d)

        async def get(self):
            return await self.v.get()

    cluster = (pkg.testing.TestClusterBuilder(2)
               .add_grains(TickerGrain, Acct)
               .with_reminders()
               .with_transactions()
               .build())
    async with cluster:
        await cluster.grain(TickerGrain, 1).arm()
        await cluster.grain(Acct, "a").add(5)
        got = await cluster.grain(Acct, "a").get()
        await cluster.wait_until(lambda: len(ticks) >= 2,
                                 msg="reminder ticks")
        return (got, ticks == sorted(ticks),
                [s.reminders is not None and s.transactions is not None
                 for s in cluster.alive_silos])


async def test_feature_optins_reminders_and_transactions_are_refused(
        tmp_path):
    """The port's copy of the reference's
    ``test_feature_optins_reminders_and_transactions``: a two-silo
    cluster with reminders and transactions opted in, run through each
    package one after the other (the name is kept from when the port
    refused both opt-ins). Then the Perfetto export writes a Chrome trace
    file, here of a cluster that recorded no span."""
    import json

    import orleans_tpu.transactions as jtx
    import orleans_tpu_torch.transactions as ttx
    got = []
    for pkg, tx in ((J, jtx), (T, ttx)):
        got.append(await asyncio.wait_for(_feature_optins(pkg, tx),
                                          TIMEOUT))
    assert got[0] == got[1] == (5, True, [True, True])
    path = tt.TestClusterBuilder(2).build().export_trace(
        str(tmp_path / "trace.json"))
    assert json.load(open(path))["traceEvents"] == []


# ---------------------------------------------------------------------------
# the stop-time forward loop (ROADMAP Queue 3), repaired in the port
# ---------------------------------------------------------------------------

async def test_stopping_silo_rejects_a_system_target_request_it_lost():
    """A system-target request reaching a silo that no longer hosts the
    target (its catalog is torn down while it stops) is rejected at once:
    never re-sent to the silo it is on, and no directory request about
    the target's id is sent on (each such request missed in turn on a
    silo whose targets were gone, and the fan-out recursed). Peer ``b``
    is re-addressed after it was built, as the reference's
    ``restart_silo`` does, so a request to any of its targets misses
    too."""
    fabric = tr.InProcFabric()
    a = tr.SiloBuilder().with_name("a").with_fabric(fabric).build()
    b = tr.SiloBuilder().with_name("b").with_fabric(fabric).build()
    first = b.silo_address
    b.silo_address = SiloAddress(first.host, first.port,
                                 first.generation + 1)
    misses = {"a": 0, "b": 0}
    cascade = []

    def count(name, silo):
        inner = silo.dispatcher.receive_message

        def receive_message(msg):
            if msg.target_grain is not None and \
                    msg.target_grain.is_system_target() and \
                    not silo.catalog.by_grain.get(msg.target_grain):
                misses[name] += 1
                if sum(misses.values()) > 50:
                    # bound the parent's recursion so it fails, not hangs
                    cascade.append(msg.method_name)
                    raise RuntimeError("system-target miss cascade")
            return inner(msg)
        silo.dispatcher.receive_message = receive_message

    async def probe():
        target = GrainId.system_target(type_code_of(DIRECTORY_TARGET),
                                       a.silo_address)
        fut = b.runtime_client.send_request(
            target_grain=target, grain_class=DirectoryTarget,
            interface_name=DIRECTORY_TARGET, method_name="dir_lookup_many",
            args=([],), kwargs={}, target_silo=a.silo_address,
            category=Category.SYSTEM)
        with pytest.raises(SiloUnavailableError):
            await asyncio.wait_for(fut, 5)

    async def body():
        await a.start()
        await b.start()
        count("a", a)
        count("b", b)
        handoff = a.locator.handoff_all
        probed = []

        async def handoff_all():
            # ``a`` is ShuttingDown and its catalog (system targets
            # included) is gone; the fabric still delivers to it
            await probe()
            probed.append(True)
            await handoff()
        a.locator.handoff_all = handoff_all
        try:
            await a.stop()
        finally:
            await b.stop()
        return probed

    assert await asyncio.wait_for(body(), TIMEOUT) == [True]
    assert cascade == []
    assert misses == {"a": 1, "b": 0}
    assert a.stats.get("messaging.forwarded") == 0


# ---------------------------------------------------------------------------
# tests/test_vector_hosting.py through the TestCluster
# ---------------------------------------------------------------------------

def _owners(cluster, pkg, key):
    out = []
    for i, s in enumerate(cluster.silos):
        tbl = s.vector.table(pkg.Vec)
        if tbl.lookup(key) is not None or (
                0 <= key < tbl.dense_n and bool(tbl.dense_active[key])):
            out.append(i)
    return out


async def _single_owner(pkg):
    cluster = (pkg.testing.TestClusterBuilder(3)
               .add_grains(pkg.g.Host)
               .with_vector_grains(pkg.Vec, mesh=pkg.mesh(8),
                                   capacity_per_shard=16)
               .build())
    async with cluster:
        got = [await cluster.grain(pkg.g.Host, i).poke_vector(11, float(i))
               for i in range(6)]
        return got, _owners(cluster, pkg, 11)


async def test_multi_silo_single_owner_routing():
    """A device-tier key has one owning silo (ring ownership), whichever
    silo first receives the call."""
    got, owners = await _parity(_single_owner)
    assert got == [1, 2, 3, 4, 5, 6]
    assert len(owners) == 1


async def _failover(pkg, flush_period, sleep):
    storage = pkg.storage.MemoryStorage()
    cluster = (pkg.testing.TestClusterBuilder(2)
               .add_grains(pkg.g.Host)
               .with_vector_grains(pkg.Vec, mesh=pkg.mesh(8),
                                   capacity_per_shard=16, storage=storage,
                                   flush_period=flush_period)
               .build())
    async with cluster:
        key = 21
        g = cluster.client.get_grain(pkg.Vec, key)
        before = [int(await g.add(x=float(i))) for i in range(3)]
        owners = _owners(cluster, pkg, key)
        owner = cluster.silos[owners[0]]
        await asyncio.sleep(sleep)  # the flushes that precede the kill
        await cluster.kill_silo(owner)
        await cluster.wait_for_death(owner)
        after = int(await g.add(x=9.0))
        survivor = next(s for s in cluster.silos if s is not owner)
        row = survivor.vector.table(pkg.Vec).read_row(key)
        return (before, owners, after,
                survivor.stats.get("vector.storage.recovered") >= 1,
                float(row["last"]))


async def test_vector_failover_resurrects_state_on_new_owner():
    """Kill the silo owning a key's device state: the new ring owner
    rehydrates the row from write-behind storage before executing."""
    before, owners, after, recovered, last = \
        await _parity(_failover, 0.05, 0.25)
    assert before == [1, 2, 3] and len(owners) == 1
    assert after == 4 and recovered and last == 9.0


async def test_vector_failover_unpersisted_key_starts_fresh():
    """A key the dead owner never flushed starts over on the new owner."""
    before, owners, after, recovered, last = \
        await _parity(_failover, 30.0, 0.0)
    assert before == [1, 2, 3] and len(owners) == 1
    assert after == 1 and not recovered and last == 9.0


async def _both_tiers(pkg):
    b = pkg.rt.SiloBuilder().with_name("mgmt").add_grains(pkg.g.Host)
    pkg.d.add_vector_grains(b, pkg.Vec, mesh=pkg.mesh(8),
                            capacity_per_shard=16)
    pkg.mg.add_management(b)
    silo = b.build()
    await silo.start()
    client = await pkg.rt.ClusterClient(silo.fabric).connect()
    try:
        await client.get_grain(pkg.Vec, 1).add(x=1.0)
        await client.get_grain(pkg.Vec, 2).add(x=1.0)
        await client.get_grain(pkg.g.Host, 0).poke_vector(3, 1.0)
        mgmt = client.get_grain(pkg.mg.ManagementGrain, 0)
        stats = await mgmt.get_simple_grain_statistics()
        rs = await mgmt.get_runtime_statistics()
        vec = next(iter(rs.values()))["vector"]
        return (stats.get("CounterVec", 0), stats.get("HostGrain", 0),
                vec["messages_processed"] >= 3, vec["classes"])
    finally:
        await client.close_async()
        await silo.stop()


async def test_management_sees_both_tiers():
    assert await _parity(_both_tiers) == (3, 1, True, {"CounterVec": 3})
