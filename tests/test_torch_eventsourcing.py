"""Parity of the port's event sourcing (orleans_tpu_torch.eventsourcing:
JournaledGrain with its three consistency providers, replicated journals
with confirmed-event notifications, and geo replication over the
multicluster substrate) with the JAX package's, on the CPU: the scenarios
of tests/test_eventsourcing.py and tests/test_geo_journal.py run through
each package one after the other, and what each observed must be equal
exactly. Also the silo hook for replicated journals (the notification
target and the relay grain) and the ``journal.unconfirmed_events`` gauge
against the JAX package's.

Grains of a pair are built by one factory per package and share their
class names; sockets bind 127.0.0.1 on port 0; every async body runs
under ``asyncio.wait_for(..., 30)``.
"""

import asyncio
from types import SimpleNamespace

import orleans_tpu.core.ids as jids
import orleans_tpu.eventsourcing as jes
import orleans_tpu.membership as jm
import orleans_tpu.multicluster as jmc
import orleans_tpu.runtime as jr
import orleans_tpu.runtime.grain as jgrain
import orleans_tpu.storage as js
import orleans_tpu_torch.core.ids as tids
import orleans_tpu_torch.eventsourcing as tes
import orleans_tpu_torch.membership as tm
import orleans_tpu_torch.multicluster as tmc
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.runtime.grain as tgrain
import orleans_tpu_torch.storage as ts

TIMEOUT = 30


def _journals(es, external):
    class CounterJournal(es.JournaledGrain):
        def initial_state(self):
            return {"count": 0, "ops": []}

        def apply_event(self, state, event):
            return {"count": state["count"] + event["delta"],
                    "ops": state["ops"] + [event["op"]]}

        async def bump(self, delta, op, confirm=True):
            self.raise_event({"delta": delta, "op": op})
            if confirm:
                await self.confirm_events()

        async def snapshot(self):
            return {"state": self.state, "tentative": self.tentative_state,
                    "version": self.version,
                    "unconfirmed": len(self.unconfirmed_events)}

        async def flush(self):
            await self.confirm_events()

        async def die(self):
            self.deactivate_on_idle()

    @es.log_consistency("state_storage")
    class SnapshotJournal(CounterJournal):
        pass

    @es.log_consistency("custom")
    class CustomJournal(CounterJournal):
        async def read_state_from_storage(self):
            rec = external.get(self.primary_key)
            if rec is None:
                return self.initial_state(), 0
            return rec["state"], rec["version"]

        async def apply_updates_to_storage(self, events, expected_version):
            rec = external.get(self.primary_key,
                               {"state": self.initial_state(), "version": 0})
            if rec["version"] != expected_version:
                return False
            state = rec["state"]
            for e in events:
                state = self.apply_event(state, e)
            external[self.primary_key] = {
                "state": state, "version": rec["version"] + len(events)}
            return True

    @es.replicated_journal
    class ReplCounter(CounterJournal):
        pass

    @es.replicated_journal
    class LedgerGrain(es.JournaledGrain):
        def initial_state(self):
            return {"total": 0, "entries": 0}

        def apply_event(self, state, event):
            return {"total": state["total"] + event["amount"],
                    "entries": state["entries"] + 1}

        async def credit(self, amount: int) -> int:
            self.raise_event({"amount": amount})
            await self.confirm_events()
            return self.version

        async def view(self):
            return (self.version, dict(self.state))

    return SimpleNamespace(Counter=CounterJournal, Snapshot=SnapshotJournal,
                           Custom=CustomJournal, Repl=ReplCounter,
                           Ledger=LedgerGrain)


def _counting(storage):
    class CountingStorage(storage.MemoryStorage):
        def __init__(self):
            super().__init__()
            self.reads = 0

        async def read(self, grain_type, grain_id):
            self.reads += 1
            return await super().read(grain_type, grain_id)

    class CountingFacade:
        """A per-cluster counting facade over a shared primary store."""

        def __init__(self, backend):
            self._backend = backend
            self.read_count = 0

        async def read(self, grain_type, grain_id):
            self.read_count += 1
            return await self._backend.read(grain_type, grain_id)

        async def write(self, grain_type, grain_id, state, etag):
            return await self._backend.write(grain_type, grain_id, state,
                                             etag)

        def __getattr__(self, name):
            return getattr(self._backend, name)

    return CountingStorage, CountingFacade


def _pkg(name, ids, es, mb, mc, rt, grain, storage):
    external: dict = {}
    counting, facade = _counting(storage)
    return SimpleNamespace(name=name, ids=ids, es=es, mb=mb, mc=mc, rt=rt,
                           grain=grain, storage=storage, external=external,
                           g=_journals(es, external), Counting=counting,
                           Facade=facade)


J = _pkg("jax", jids, jes, jm, jmc, jr, jgrain, js)
T = _pkg("torch", tids, tes, tm, tmc, tr, tgrain, ts)


async def _parity(scenario, *args):
    got = []
    for pkg in (J, T):
        pkg.external.clear()
        got.append(await asyncio.wait_for(scenario(pkg, *args), TIMEOUT))
    assert got[0] == got[1], (scenario.__name__, got[0], got[1])
    return got[1]


def _all(pkg):
    return [pkg.g.Counter, pkg.g.Snapshot, pkg.g.Custom]


async def _single(pkg, storage=None, extra=()):
    fabric = pkg.rt.InProcFabric()
    storage = storage or pkg.storage.MemoryStorage()
    silo = (pkg.rt.SiloBuilder().with_name("es").with_fabric(fabric)
            .add_grains(*_all(pkg), *extra).with_storage("Default", storage)
            .build())
    await silo.start()
    client = await pkg.rt.ClusterClient(fabric).connect()
    return silo, client


async def _stop(silo, client):
    await client.close_async()
    await silo.stop()


# ---------------------------------------------------------------------------
# tests/test_eventsourcing.py
# ---------------------------------------------------------------------------

async def _raise_and_confirm(pkg):
    silo, client = await _single(pkg)
    try:
        g = client.get_grain(pkg.g.Counter, "c1")
        await g.bump(5, "a")
        await g.bump(3, "b")
        return await g.snapshot()
    finally:
        await _stop(silo, client)


async def test_raise_and_confirm_updates_confirmed_view():
    snap = await _parity(_raise_and_confirm)
    assert snap["state"] == {"count": 8, "ops": ["a", "b"]}
    assert snap["version"] == 2 and snap["unconfirmed"] == 0


async def _tentative(pkg):
    silo, client = await _single(pkg)
    try:
        g = client.get_grain(pkg.g.Counter, "c2")
        await g.bump(5, "a", confirm=False)
        before = await g.snapshot()
        await g.flush()
        return before, await g.snapshot()
    finally:
        await _stop(silo, client)


async def test_tentative_state_reflects_unconfirmed_events():
    before, after = await _parity(_tentative)
    assert before["state"]["count"] == 0 and before["tentative"]["count"] == 5
    assert before["unconfirmed"] == 1
    assert after["state"]["count"] == 5 and after["unconfirmed"] == 0


async def _recovers(pkg):
    silo, client = await _single(pkg, pkg.storage.MemoryStorage())
    try:
        out = []
        for cls in _all(pkg):
            g = client.get_grain(cls, "r1")
            await g.bump(2, "x")
            await g.bump(4, "y")
            await g.die()
            await asyncio.sleep(0.05)
            snap = await g.snapshot()
            out.append((snap["state"], snap["version"]))
        return out
    finally:
        await _stop(silo, client)


async def test_journal_recovers_after_deactivation_all_providers():
    got = await _parity(_recovers)
    assert got == [({"count": 6, "ops": ["x", "y"]}, 2)] * 3


async def _retention(pkg):
    storage = pkg.storage.MemoryStorage()
    silo, client = await _single(pkg, storage)
    try:
        await client.get_grain(pkg.g.Counter, "k1").bump(1, "e1")
        await client.get_grain(pkg.g.Snapshot, "k1").bump(1, "e1")
        ids = pkg.ids
        log_row, _ = await storage.read(
            "journal-log:CounterJournal",
            ids.GrainId.for_grain(ids.GrainType.of("CounterJournal"), "k1"))
        snap_row, _ = await storage.read(
            "journal-state:SnapshotJournal",
            ids.GrainId.for_grain(ids.GrainType.of("SnapshotJournal"), "k1"))
        return log_row, snap_row
    finally:
        await _stop(silo, client)


async def test_state_storage_does_not_retain_log_but_log_storage_does():
    log_row, snap_row = await _parity(_retention)
    assert "log" in log_row and len(log_row["log"]) == 1
    assert "snapshot" in snap_row and "log" not in snap_row


async def _batched(pkg):
    silo, client = await _single(pkg)
    try:
        g = client.get_grain(pkg.g.Counter, "b1")
        for d, op in ((1, "a"), (2, "b"), (3, "c")):
            await g.bump(d, op, confirm=False)
        await g.flush()
        return await g.snapshot()
    finally:
        await _stop(silo, client)


async def test_batched_events_confirm_atomically():
    snap = await _parity(_batched)
    assert snap["version"] == 3 and snap["state"]["count"] == 6


async def _two_silos(pkg, storage):
    fabric = pkg.rt.InProcFabric()
    silos = []
    for i in range(2):
        s = (pkg.rt.SiloBuilder().with_name(f"es{i}").with_fabric(fabric)
             .add_grains(*_all(pkg), pkg.g.Repl)
             .with_storage("Default", storage).build())
        await s.start()
        silos.append(s)
    client = await pkg.rt.ClusterClient(fabric).connect()
    return silos, client


async def _stop_all(silos, client):
    await client.close_async()
    for s in silos:
        await s.stop()


async def _no_storage_read(pkg):
    storage = pkg.Counting()
    silos, client = await _two_silos(pkg, storage)
    try:
        a = silos[0].grain_factory.get_grain(pkg.g.Repl, "r1")
        b = silos[1].grain_factory.get_grain(pkg.g.Repl, "r1")
        versions = ((await a.snapshot())["version"],
                    (await b.snapshot())["version"])
        reads_before = storage.reads
        await a.bump(5, "x")
        for _ in range(100):
            snap = await b.snapshot()
            if snap["version"] == 1:
                break
            await asyncio.sleep(0.01)
        return versions, snap["state"], storage.reads - reads_before <= 1
    finally:
        await _stop_all(silos, client)


async def test_replica_sees_confirmed_events_without_storage_read():
    got = await _parity(_no_storage_read)
    assert got == ((0, 0), {"count": 5, "ops": ["x"]}, True)


def _instance(pkg, silo, cls, key):
    gid = pkg.ids.GrainId.for_grain(pkg.grain.grain_type_of(cls), key)
    return silo.catalog.by_grain[gid][0].grain_instance


async def _out_of_order(pkg):
    silos, client = await _two_silos(pkg, pkg.Counting())
    try:
        b = silos[1].grain_factory.get_grain(pkg.g.Repl, "r2")
        await b.snapshot()
        inst = _instance(pkg, silos[1], pkg.g.Repl, "r2")
        inst._fold_notification(1, [{"delta": 2, "op": "b"}], 2)
        gapped = inst.version
        inst._fold_notification(0, [{"delta": 1, "op": "a"}], 1)
        folded = (inst.version, inst.state)
        inst._fold_notification(0, [{"delta": 9, "op": "dup"}], 1)
        return gapped, folded, (inst.version, inst.state)
    finally:
        await _stop_all(silos, client)


async def test_replica_buffers_out_of_order_notifications():
    gapped, folded, after = await _parity(_out_of_order)
    assert gapped == 0
    assert folded == after == (2, {"count": 3, "ops": ["a", "b"]})


async def _cas_writers(pkg):
    silos, client = await _two_silos(pkg, pkg.Counting())
    try:
        a = silos[0].grain_factory.get_grain(pkg.g.Repl, "r3")
        b = silos[1].grain_factory.get_grain(pkg.g.Repl, "r3")
        await a.snapshot()
        await b.snapshot()
        await asyncio.gather(*(a.bump(1, f"a{i}") for i in range(5)),
                             *(b.bump(1, f"b{i}") for i in range(5)))
        for _ in range(200):
            sa, sb = await a.snapshot(), await b.snapshot()
            if sa["version"] == 10 and sb["version"] == 10:
                break
            await asyncio.sleep(0.01)
        return (sa["version"], sa["state"]["count"], sb["version"],
                sb["state"]["count"], sorted(sa["state"]["ops"]),
                sorted(sb["state"]["ops"]))
    finally:
        await _stop_all(silos, client)


async def test_concurrent_replica_writers_serialize_via_cas():
    got = await _parity(_cas_writers)
    ops = sorted([f"a{i}" for i in range(5)] + [f"b{i}" for i in range(5)])
    assert got == (10, 10, 10, 10, ops, ops)


async def _gap_catch_up(pkg):
    silos, client = await _two_silos(pkg, pkg.Counting())
    try:
        a = silos[0].grain_factory.get_grain(pkg.g.Repl, "r4")
        b = silos[1].grain_factory.get_grain(pkg.g.Repl, "r4")
        await a.snapshot()
        await b.snapshot()
        inst = _instance(pkg, silos[1], pkg.g.Repl, "r4")
        await a.bump(1, "a")
        await a.bump(2, "b")
        inst._version = 0
        inst._confirmed = inst.initial_state()
        inst._notif_buffer.clear()
        inst._fold_notification(1, [{"delta": 2, "op": "b"}], 2)
        gapped = inst.version
        for _ in range(40):
            await asyncio.sleep(0.1)
            if inst.version >= 2:
                break
        return gapped, inst.version, inst.state["count"]
    finally:
        await _stop_all(silos, client)


async def test_replica_gap_catches_up_from_storage():
    assert await _parity(_gap_catch_up) == (0, 2, 3)


async def _silo_hook(pkg):
    """A silo with a replicated journaled grain builds, installs the
    journal notification target and registers the relay grain."""
    silo = pkg.rt.SiloBuilder().add_grains(pkg.g.Repl).build()
    await silo.start()
    try:
        names = sorted(c.__name__ for c in silo.registry.all_classes())
        target = pkg.es.journaled.JOURNAL_NOTIFY_TARGET
        gid = pkg.ids.GrainId.system_target(
            pkg.ids.type_code_of(target), silo.silo_address)
        act = silo.catalog.by_grain[gid][0]
        return names, type(act.grain_instance).__name__
    finally:
        await silo.stop()


async def test_replicated_journal_installs_the_notifier_and_relay():
    names, target = await _parity(_silo_hook)
    assert "JournalRelayGrain" in names and "ReplCounter" in names
    assert target == "JournalNotificationTarget"


async def _unconfirmed_gauge(pkg):
    """``journal.unconfirmed_events`` counts the events raised and not
    yet confirmed over the silo's journaled activations."""
    fabric = pkg.rt.InProcFabric()
    silo = (pkg.rt.SiloBuilder().with_name("gauge").with_fabric(fabric)
            .add_grains(*_all(pkg))
            .with_storage("Default", pkg.storage.MemoryStorage())
            .with_config(metrics_enabled=True).build())
    await silo.start()
    client = await pkg.rt.ClusterClient(fabric).connect()
    try:
        m = silo.metrics
        read = m._sources["journal.unconfirmed_events"]
        out = [read()]
        for k in range(3):
            g = client.get_grain(pkg.g.Counter, k)
            for i in range(k + 1):
                await g.bump(1, f"e{i}", confirm=False)
        await client.get_grain(pkg.g.Snapshot, 9).bump(1, "s",
                                                      confirm=False)
        out.append(read())
        await client.get_grain(pkg.g.Counter, 1).flush()
        out.append(read())
        return out
    finally:
        await _stop(silo, client)


async def test_journal_gauge_reads_the_same_count_as_the_jax_package():
    assert await _parity(_unconfirmed_gauge) == [0.0, 7.0, 5.0]


# ---------------------------------------------------------------------------
# tests/test_geo_journal.py
# ---------------------------------------------------------------------------

FAST = dict(
    membership_probe_period=0.1,
    membership_probe_timeout=0.2,
    membership_missed_probes_limit=2,
    membership_votes_needed=1,
    membership_iam_alive_period=0.5,
    membership_refresh_period=0.2,
    response_timeout=5.0,
)


async def _geo_cluster(pkg, cluster_id, channel, storage, tmp, n_silos=1):
    table = pkg.mb.FileMembershipTable(str(tmp / f"mbr-{cluster_id}.json"))
    silos = []
    for i in range(n_silos):
        b = (pkg.rt.SiloBuilder().with_name(f"{cluster_id}-s{i}")
             .with_fabric(pkg.rt.SocketFabric("127.0.0.1"))
             .add_grains(pkg.g.Ledger).with_storage("Default", storage)
             .with_config(**FAST))
        pkg.mc.add_multicluster(b, cluster_id, [channel], gossip_period=0.1,
                                maintainer_period=0.5)
        silo = b.build()
        pkg.mb.join_cluster(silo, table)
        await silo.start()
        silos.append(silo)
    return silos


async def _wait_gossip(a, b, timeout=10.0):
    async def ready():
        while not (a.multicluster.gateways_of("B")
                   and b.multicluster.gateways_of("A")):
            await asyncio.sleep(0.05)
    await asyncio.wait_for(ready(), timeout)


async def _wait_version(pkg, client, key, want, timeout=10.0):
    async def poll():
        while True:
            v, state = await client.get_grain(pkg.g.Ledger, key).view()
            if v >= want:
                return v, state
            await asyncio.sleep(0.05)
    return await asyncio.wait_for(poll(), timeout)


async def _gateway(pkg, silo):
    return await pkg.rt.GatewayClient([silo.silo_address.endpoint],
                                      response_timeout=5.0).connect()


async def _remote_fold(pkg, tmp):
    d = tmp / pkg.name
    d.mkdir()
    channel = pkg.mc.FileGossipChannel(str(d / "gossip.json"))
    primary = pkg.storage.MemoryStorage()
    sa, sb = pkg.Facade(primary), pkg.Facade(primary)
    (a,) = await _geo_cluster(pkg, "A", channel, sa, d)
    (b,) = await _geo_cluster(pkg, "B", channel, sb, d)
    ca = cb = None
    try:
        await _wait_gossip(a, b)
        ca, cb = await _gateway(pkg, a), await _gateway(pkg, b)
        first = await cb.get_grain(pkg.g.Ledger, "book").view()
        reads = sb.read_count
        credits = (await ca.get_grain(pkg.g.Ledger, "book").credit(10),
                   await ca.get_grain(pkg.g.Ledger, "book").credit(5))
        v, state = await _wait_version(pkg, cb, "book", 2)
        return first, credits, (v, state), sb.read_count == reads
    finally:
        for c in (ca, cb):
            if c is not None:
                await c.close_async()
        await a.stop()
        await b.stop()


async def test_replica_in_remote_cluster_folds_without_storage_read(
        tmp_path):
    got = await _parity(_remote_fold, tmp_path)
    assert got == ((0, {"total": 0, "entries": 0}), (1, 2),
                   (2, {"total": 15, "entries": 2}), True)


async def _relay_fan_out(pkg, tmp):
    d = tmp / pkg.name
    d.mkdir()
    channel = pkg.mc.FileGossipChannel(str(d / "gossip.json"))
    storage = pkg.storage.MemoryStorage()
    (a,) = await _geo_cluster(pkg, "A", channel, storage, d)
    b1, b2 = await _geo_cluster(pkg, "B", channel, storage, d, n_silos=2)
    ca = None
    try:
        async def b_converged():
            while len(b1.membership.active) != 2 or \
                    len(b2.membership.active) != 2:
                await asyncio.sleep(0.05)
        await asyncio.wait_for(b_converged(), timeout=15.0)
        await _wait_gossip(a, b1)
        ca = await _gateway(pkg, a)
        first = [(await bs.grain_factory.get_grain(
            pkg.g.Ledger, "shared").view())[0] for bs in (b1, b2)]
        await ca.get_grain(pkg.g.Ledger, "shared").credit(7)

        async def both_converged():
            while True:
                views = [await bs.grain_factory.get_grain(
                    pkg.g.Ledger, "shared").view() for bs in (b1, b2)]
                if all(v == 1 and st["total"] == 7 for v, st in views):
                    return views
                await asyncio.sleep(0.05)
        return first, await asyncio.wait_for(both_converged(), timeout=10.0)
    finally:
        if ca is not None:
            await ca.close_async()
        for s in (a, b1, b2):
            await s.stop()


async def test_relay_fans_out_to_every_silo_of_the_remote_cluster(tmp_path):
    first, views = await _parity(_relay_fan_out, tmp_path)
    assert first == [0, 0]
    assert views == [(1, {"total": 7, "entries": 1})] * 2


async def _partition_heal(pkg, tmp):
    d = tmp / pkg.name
    d.mkdir()
    channel = pkg.mc.FileGossipChannel(str(d / "gossip.json"))
    storage = pkg.Facade(pkg.storage.MemoryStorage())
    (a,) = await _geo_cluster(pkg, "A", channel, storage, d)
    (b,) = await _geo_cluster(pkg, "B", channel, storage, d)
    ca = cb = None
    try:
        await _wait_gossip(a, b)
        ca, cb = await _gateway(pkg, a), await _gateway(pkg, b)
        await cb.get_grain(pkg.g.Ledger, "ledger").view()
        await ca.get_grain(pkg.g.Ledger, "ledger").credit(1)
        await _wait_version(pkg, cb, "ledger", 1)
        real_client_for = a.gsi._client_for

        async def cut(cluster_id):
            raise ConnectionError("partitioned")
        a.gsi._client_for = cut
        await ca.get_grain(pkg.g.Ledger, "ledger").credit(2)
        await asyncio.sleep(1.0)
        during = (await cb.get_grain(pkg.g.Ledger, "ledger").view())[0]
        a.gsi._client_for = real_client_for
        await ca.get_grain(pkg.g.Ledger, "ledger").credit(3)
        return during, await _wait_version(pkg, cb, "ledger", 3,
                                           timeout=15.0)
    finally:
        for c in (ca, cb):
            if c is not None:
                await c.close_async()
        await a.stop()
        await b.stop()


async def test_partitioned_cluster_catches_up_on_heal(tmp_path):
    during, healed = await _parity(_partition_heal, tmp_path)
    assert during == 1 and healed == (3, {"total": 6, "entries": 3})
