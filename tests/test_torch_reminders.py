"""Parity of the port's reminders (orleans_tpu_torch.reminders: the
in-memory and SQLite tables and the local reminder service over the
virtual-bucket ring) with the JAX package's, on the CPU: the scenarios of
tests/test_reminders.py run through each package one after the other, and
what each observed must be equal exactly. Tick times are wall clock, so
what is compared is what a scenario asserts of them (counts reached,
order, ownership), not the times.

Also: the SQLite table's plain rows are equal across the packages, and a
silo restarted on a reminder file keeps firing its reminders with no new
registration.

Host grains of a pair are built by one factory per package; every async
body runs under ``asyncio.wait_for(..., 30)``.
"""

import asyncio
import json
import sqlite3
import time
from types import SimpleNamespace

import orleans_tpu.core.ids as jids
import orleans_tpu.membership as jm
import orleans_tpu.reminders as jrem
import orleans_tpu.runtime as jr
import orleans_tpu.storage as js
import orleans_tpu_torch.core.ids as tids
import orleans_tpu_torch.membership as tm
import orleans_tpu_torch.reminders as trem
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.storage as ts

TIMEOUT = 30


def _alarm(rt, ticks):
    class AlarmGrain(rt.Grain):
        async def arm(self, name, due, period):
            await self.register_reminder(name, due, period)
            return True

        async def disarm(self, name):
            await self.unregister_reminder(name)

        async def lookup(self, name):
            h = await self.get_reminder(name)
            return None if h is None else h.name

        async def receive_reminder(self, name, status):
            ticks.setdefault((self.primary_key, name), []).append(
                status.current_tick_time)

        async def die(self):
            self.deactivate_on_idle()

    return AlarmGrain


def _pkg(name, ids, rt, rem, mb, storage):
    ticks: dict = {}
    return SimpleNamespace(name=name, ids=ids, rt=rt, rem=rem, mb=mb,
                           storage=storage, ticks=ticks,
                           Alarm=_alarm(rt, ticks))


J = _pkg("jax", jids, jr, jrem, jm, js)
T = _pkg("torch", tids, tr, trem, tm, ts)


async def _parity(scenario, *args):
    got = []
    for pkg in (J, T):
        pkg.ticks.clear()
        got.append(await asyncio.wait_for(scenario(pkg, *args), TIMEOUT))
    assert got[0] == got[1], (scenario.__name__, got[0], got[1])
    return got[1]


async def _table_contract(pkg, table):
    gid = pkg.ids.GrainId.for_grain(pkg.ids.GrainType.of("AlarmGrain"), 7)
    out = [await table.read_all()]
    e = pkg.rem.ReminderEntry(gid, "AlarmGrain", "wake", 100.0, 60.0)
    tag1 = await table.upsert_row(e)
    row = await table.read_row(gid, "wake")
    out.append((row.period, row.etag == tag1))
    tag2 = await table.upsert_row(
        pkg.rem.ReminderEntry(gid, "AlarmGrain", "wake", 100.0, 30.0))
    out.append((tag2 != tag1, (await table.read_row(gid, "wake")).period,
                len(await table.read_grain_rows(gid))))
    out.append((await table.remove_row(gid, "wake", tag1),
                await table.remove_row(gid, "wake", tag2),
                await table.read_row(gid, "wake")))
    await table.delete_table()
    return out


async def test_reminder_table_contract(tmp_path):
    for kind in ("memory", "sqlite"):
        async def scenario(pkg):
            table = pkg.rem.InMemoryReminderTable() if kind == "memory" \
                else pkg.rem.SqliteReminderTable(
                    str(tmp_path / f"{pkg.name}.sqlite"))
            return await _table_contract(pkg, table)
        got = await _parity(scenario)
        assert got == [[], (60.0, True), (True, 30.0, 1),
                       (False, True, None)]


async def _sqlite_rows(pkg, path):
    table = pkg.rem.SqliteReminderTable(path)
    for k, name in ((7, "wake"), (8, "sleep"), (7, "nap")):
        gid = pkg.ids.GrainId.for_grain(pkg.ids.GrainType.of("AlarmGrain"),
                                        k)
        await table.upsert_row(pkg.rem.ReminderEntry(
            gid, "AlarmGrain", name, 100.0 + k, 60.0))
    db = sqlite3.connect(path)
    try:
        rows = db.execute("SELECT gkey, name, entry, etag FROM reminders "
                          "ORDER BY gkey, name").fetchall()
    finally:
        db.close()
    return [(g, n, json.loads(e), t) for g, n, e, t in rows]


async def test_sqlite_reminder_rows_are_equal(tmp_path):
    """The SQLite table stores plain JSON rows: equal across the packages
    for the same registrations."""
    async def scenario(pkg):
        return await _sqlite_rows(pkg, str(tmp_path / f"{pkg.name}.db"))
    got = await _parity(scenario)
    assert [(r[1], r[3]) for r in got] == [("nap", 3), ("wake", 1),
                                          ("sleep", 2)]


async def _start_cluster(pkg, n, rem=None):
    fabric = pkg.rt.InProcFabric()
    mbr = pkg.mb.InMemoryMembershipTable()
    rem = rem or pkg.rem.InMemoryReminderTable()
    silos = []
    for i in range(n):
        silo = (pkg.rt.SiloBuilder().with_name(f"r{i}").with_fabric(fabric)
                .add_grains(pkg.Alarm)
                .with_storage("Default", pkg.storage.MemoryStorage())
                .with_config(membership_probe_period=0.1,
                             membership_probe_timeout=0.15,
                             membership_missed_probes_limit=2,
                             membership_refresh_period=0.3,
                             response_timeout=2.0)
                .build())
        pkg.mb.join_cluster(silo, mbr)
        pkg.rem.add_reminders(silo, rem, refresh_period=0.2)
        await silo.start()
        silos.append(silo)
    client = await pkg.rt.ClusterClient(fabric).connect()
    return silos, client


async def _stop_all(silos, client):
    await client.close_async()
    for s in silos:
        if s.status not in ("Stopped", "Dead"):
            await s.stop()


async def _wait_ticks(pkg, key, name, count, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(pkg.ticks.get((key, name), [])) >= count:
            return pkg.ticks[(key, name)]
        await asyncio.sleep(0.05)
    raise AssertionError(
        f"reminder {name} got {len(pkg.ticks.get((key, name), []))} "
        f"ticks, wanted {count}")


async def _fires_periodically(pkg):
    silos, client = await _start_cluster(pkg, 1)
    try:
        g = client.get_grain(pkg.Alarm, 1)
        armed = await g.arm("beat", 0.1, 0.2)
        ticks = list(await _wait_ticks(pkg, 1, "beat", 3))
        looked = await g.lookup("beat")
        await g.disarm("beat")
        n = len(pkg.ticks[(1, "beat")])
        await asyncio.sleep(0.6)
        after = len(pkg.ticks[(1, "beat")])
        return (armed, ticks == sorted(ticks), looked, after <= n + 1,
                await g.lookup("beat"))
    finally:
        await _stop_all(silos, client)


async def test_reminder_fires_periodically():
    assert await _parity(_fires_periodically) == (True, True, "beat", True,
                                                  None)


async def _survives_deactivation(pkg):
    silos, client = await _start_cluster(pkg, 1)
    try:
        g = client.get_grain(pkg.Alarm, 2)
        await g.arm("persist", 0.1, 0.25)
        await _wait_ticks(pkg, 2, "persist", 1)
        await g.die()
        before = len(pkg.ticks[(2, "persist")])
        await _wait_ticks(pkg, 2, "persist", before + 2)
        return silos[0].stats.get("reminders.ticks") >= before + 2
    finally:
        await _stop_all(silos, client)


async def test_reminder_survives_deactivation():
    assert await _parity(_survives_deactivation) is True


async def _reranges(pkg):
    silos, client = await _start_cluster(pkg, 3)
    try:
        for k in range(12):
            await client.get_grain(pkg.Alarm, 100 + k).arm("spread", 0.1,
                                                            0.3)
        for k in range(12):
            await _wait_ticks(pkg, 100 + k, "spread", 1)
        owned = sum(len(s.reminders.local) for s in silos)
        victim = max(silos, key=lambda s: len(s.reminders.local))
        had = len(victim.reminders.local) > 0
        await victim.stop(graceful=False)
        survivors = [s for s in silos if s is not victim]
        counts = {k: len(pkg.ticks[(100 + k, "spread")]) for k in range(12)}
        for k in range(12):
            await _wait_ticks(pkg, 100 + k, "spread", counts[k] + 2,
                              timeout=15.0)
        return owned, had, sum(len(s.reminders.local) for s in survivors)
    finally:
        await _stop_all(silos, client)


async def test_reminder_reranges_to_survivor_on_silo_death():
    assert await _parity(_reranges) == (12, True, 12)


async def _restart_on_file(pkg, path):
    """A silo restarted on the same SQLite reminder file keeps firing its
    reminders with no new registration."""
    silos, client = await _start_cluster(
        pkg, 1, pkg.rem.SqliteReminderTable(path))
    try:
        for k in range(4):
            await client.get_grain(pkg.Alarm, k).arm("file", 0.05, 0.15)
        for k in range(4):
            await _wait_ticks(pkg, k, "file", 2)
    finally:
        await _stop_all(silos, client)
    before = {k: len(pkg.ticks[(k, "file")]) for k in range(4)}
    silos, client = await _start_cluster(
        pkg, 1, pkg.rem.SqliteReminderTable(path))
    try:
        for k in range(4):
            await _wait_ticks(pkg, k, "file", before[k] + 2)
        return sorted(e.name for e in await silos[0].reminders.table
                      .read_all()), len(silos[0].reminders.local)
    finally:
        await _stop_all(silos, client)


async def test_reminders_fire_again_on_a_restarted_silo(tmp_path):
    async def scenario(pkg):
        return await _restart_on_file(pkg, str(tmp_path / f"{pkg.name}.db"))
    assert await _parity(scenario) == (["file"] * 4, 4)


async def test_reopened_sqlite_table_never_reissues_an_etag(tmp_path):
    """A table reopened on its file (a restarted silo) continues the
    etags of the rows there: a CAS remove with an etag read before the
    restart must not match a row written after it. The JAX package
    restarts its counter at 0 (a fault of the reference, kept there), so
    this runs through the port only."""
    path = str(tmp_path / "reminders.db")
    gid = tids.GrainId.for_grain(tids.GrainType.of("AlarmGrain"), 7)

    def entry(due):
        return trem.ReminderEntry(gid, "AlarmGrain", "wake", due, 60.0)

    before = trem.SqliteReminderTable(path)
    stale = await before.upsert_row(entry(100.0))
    await before.upsert_row(entry(101.0))
    after = trem.SqliteReminderTable(path)
    fresh = await after.upsert_row(entry(102.0))
    assert fresh > stale + 1
    assert not await after.remove_row(gid, "wake", etag=stale)
    assert (await after.read_row(gid, "wake")).etag == fresh
    assert await after.remove_row(gid, "wake", etag=fresh)
