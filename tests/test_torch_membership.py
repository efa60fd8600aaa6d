"""Parity of the port's membership (orleans_tpu_torch.membership: the CAS
tables and the probe/vote oracle) with the JAX package's, on the CPU.

The eight scenarios of tests/test_membership.py run through each package
one after the other, never interleaved on one loop (each package's silo
installs its own eager task factory). Every scenario returns what it
observed: the table rows and the active/dead views, with silos named by
their index in the scenario (fabric ports and generations are allocated
per package) and no wall-clock stamp the scenario did not write itself.
The two packages' observations must be equal exactly. Every async body
runs under ``asyncio.wait_for(..., 30)``.
"""

import asyncio
import time
from types import SimpleNamespace

import orleans_tpu.core.ids as jids
import orleans_tpu.membership as jm
import orleans_tpu.runtime as jr
import orleans_tpu.storage as js
import orleans_tpu_torch.core.ids as tids
import orleans_tpu_torch.membership as tm
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.storage as ts

TIMEOUT = 30

FAST = dict(
    membership_probe_period=0.1,
    membership_probe_timeout=0.15,
    membership_missed_probes_limit=2,
    membership_votes_needed=2,
    membership_iam_alive_period=0.5,
    membership_refresh_period=0.3,
    membership_vote_expiration=5.0,
    response_timeout=2.0,
)


def _ping_grain(rt):
    class PingGrain(rt.Grain):
        async def ping(self):
            return self.runtime_identity
    return PingGrain


J = SimpleNamespace(mbr=jm, ids=jids, rt=jr, storage=js,
                    Ping=_ping_grain(jr))
T = SimpleNamespace(mbr=tm, ids=tids, rt=tr, storage=ts,
                    Ping=_ping_grain(tr))


async def _parity(scenario, *args):
    got = []
    for pkg in (J, T):
        got.append(await asyncio.wait_for(scenario(pkg, *args), TIMEOUT))
    assert got[0] == got[1], (scenario.__name__, got[0], got[1])
    return got[1]


def _tables(pkg, tmp_path, tag):
    m = pkg.mbr
    return [m.InMemoryMembershipTable(),
            m.FileMembershipTable(str(tmp_path / f"{tag}.json")),
            m.SqliteMembershipTable(str(tmp_path / f"{tag}.sqlite"))]


def _addr(pkg, i, gen=1):
    return pkg.ids.SiloAddress("host", 1000 + i, gen)


def _rows(snap, names=None):
    """Table rows as (silo, status), silo named by ``names`` (address →
    index) or by (host, port, generation)."""
    def name(a):
        if names is not None:
            return names.get(a, ("other", a.host, a.port, a.generation))
        return (a.host, a.port, a.generation)
    return sorted((name(e.address), e.status) for e, _etag in snap.entries)


def _names(silos):
    return {s.silo_address: i for i, s in enumerate(silos)}


def _view(silo, names):
    m = silo.membership
    return (sorted(names[a] for a in m.active),
            sorted(names[a] for a in m.dead if a in names))


# ---------------------------------------------------------------------------
# table contract (all backends)
# ---------------------------------------------------------------------------

async def _table_contract(pkg, tmp_path):
    m = pkg.mbr
    out = []
    for table in _tables(pkg, tmp_path, pkg.rt.__name__):
        obs = []
        snap = await table.read_all()
        obs.append((len(snap.entries), snap.version.version))
        e0 = m.MembershipEntry(_addr(pkg, 0), m.SiloStatus.ACTIVE,
                               start_time=1.0)
        obs.append(await table.insert_row(e0, snap.version.next()))
        obs.append(await table.insert_row(
            m.MembershipEntry(_addr(pkg, 1), m.SiloStatus.ACTIVE),
            snap.version.next()))
        snap = await table.read_all()
        obs.append(snap.version.version)
        entry, etag = snap.get(_addr(pkg, 0))
        obs.append((entry.status, entry.start_time))
        entry = entry.copy()
        entry.status = m.SiloStatus.DEAD
        obs.append(await table.update_row(entry, etag, snap.version.next()))
        obs.append(await table.update_row(entry, etag, snap.version.next()))
        snap = await table.read_all()
        obs.append(_rows(snap))
        await table.update_iam_alive(_addr(pkg, 0), 42.0)
        snap = await table.read_all()
        obs.append((snap.get(_addr(pkg, 0))[0].iam_alive_time,
                    snap.version.version))
        await table.delete_table()
        out.append(obs)
    return out


async def test_table_contract(tmp_path):
    got = await _parity(_table_contract, tmp_path)
    assert got[0][1] is True and got[0][2] is False
    assert got[0][5] is True and got[0][6] is False
    assert all(obs == got[0] for obs in got)  # every backend alike


async def _concurrent_cas(pkg, tmp_path):
    m = pkg.mbr
    out = []
    for table in _tables(pkg, tmp_path, "cas-" + pkg.rt.__name__):
        base = await table.read_all()
        e = m.MembershipEntry(_addr(pkg, 0), m.SiloStatus.ACTIVE)
        assert await table.insert_row(e, base.version.next())
        snap = await table.read_all()
        entry, etag = snap.get(_addr(pkg, 0))

        async def contend(status):
            mod = entry.copy()
            mod.status = status
            return await table.update_row(mod, etag, snap.version.next())

        results = await asyncio.gather(
            contend(m.SiloStatus.SHUTTING_DOWN), contend(m.SiloStatus.DEAD))
        out.append((results, _rows(await table.read_all())))
        await table.delete_table()
    return out


async def test_table_concurrent_cas_single_winner(tmp_path):
    got = await _parity(_concurrent_cas, tmp_path)
    for results, rows in got:
        assert sum(results) == 1  # exactly one CAS winner
        assert results == [True, False]  # the first CAS in loop order wins
        assert rows == [(("host", 1000, 1), "ShuttingDown")]


# ---------------------------------------------------------------------------
# oracle protocol over an in-proc fabric
# ---------------------------------------------------------------------------

async def _start_cluster(pkg, n, table=None):
    fabric = pkg.rt.InProcFabric()
    table = table if table is not None else pkg.mbr.InMemoryMembershipTable()
    silos = []
    for i in range(n):
        silo = (pkg.rt.SiloBuilder().with_name(f"m{i}").with_fabric(fabric)
                .add_grains(pkg.Ping)
                .with_storage("Default", pkg.storage.MemoryStorage())
                .with_config(**FAST).build())
        pkg.mbr.join_cluster(silo, table)
        await silo.start()
        silos.append(silo)
    return fabric, table, silos


async def _wait_until(cond, timeout=8.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


async def _stop_all(silos):
    for s in silos:
        if s.status not in ("Stopped", "Dead"):
            await s.stop()


async def _all_see_each_other(pkg):
    fabric, table, silos = await _start_cluster(pkg, 3)
    try:
        await _wait_until(
            lambda: all(len(s.membership.active) == 3 for s in silos),
            msg="full active view")
        names = _names(silos)
        return ([_view(s, names) for s in silos],
                _rows(await table.read_all(), names))
    finally:
        await _stop_all(silos)


async def test_oracle_all_silos_see_each_other():
    views, rows = await _parity(_all_see_each_other)
    assert views == [([0, 1, 2], [])] * 3
    assert rows == [(i, "Active") for i in range(3)]


async def _killed_silo(pkg):
    fabric, table, silos = await _start_cluster(pkg, 3)
    client = await pkg.rt.ClusterClient(fabric).connect()
    try:
        await _wait_until(
            lambda: all(len(s.membership.active) == 3 for s in silos))
        victim = silos[2]
        await victim.stop(graceful=False)  # kill: no goodbye row
        survivors = silos[:2]
        await _wait_until(
            lambda: all(victim.silo_address in s.membership.dead
                        for s in survivors),
            msg="victim declared dead via probe+vote")
        names = _names(silos)
        rows = _rows(await table.read_all(), names)
        hosts = [await client.get_grain(pkg.Ping, k).ping()
                 for k in range(20)]
        return ([_view(s, names) for s in survivors], rows,
                len(hosts), str(victim.silo_address) in hosts)
    finally:
        await client.close_async()
        await _stop_all(silos)


async def test_oracle_detects_killed_silo_and_cluster_recovers():
    views, rows, n_served, victim_served = await _parity(_killed_silo)
    assert views == [([0, 1], [2])] * 2
    assert (2, "Dead") in rows
    assert n_served == 20 and not victim_served


async def _graceful_shutdown(pkg):
    fabric, table, silos = await _start_cluster(pkg, 3)
    try:
        await _wait_until(
            lambda: all(len(s.membership.active) == 3 for s in silos))
        leaver = silos[0]
        await leaver.stop(graceful=True)
        names = _names(silos)
        rows = _rows(await table.read_all(), names)
        await _wait_until(
            lambda: all(leaver.silo_address not in s.membership.active
                        for s in silos[1:]),
            msg="survivors drop leaver from active view")
        return rows, [sorted(names[a] for a in s.membership.active)
                      for s in silos[1:]]
    finally:
        await _stop_all(silos)


async def test_oracle_graceful_shutdown_writes_dead_row():
    rows, active = await _parity(_graceful_shutdown)
    assert rows == [(0, "Dead"), (1, "Active"), (2, "Active")]
    assert active == [[1, 2]] * 2


async def _partitioned(pkg):
    fabric, table, silos = await _start_cluster(pkg, 3)
    try:
        await _wait_until(
            lambda: all(len(s.membership.active) == 3 for s in silos))
        victim = silos[2]
        for s in silos[:2]:
            fabric.partition(s.silo_address, victim.silo_address)
        await _wait_until(
            lambda: victim.membership.declared_dead,
            msg="victim learns of its death and self-terminates")
        await _wait_until(
            lambda: victim.status in ("Stopped", "Dead"),
            msg="victim stopped")
        await _wait_until(
            lambda: all(victim.silo_address not in s.membership.active
                        for s in silos[:2]),
            msg="survivors converge on 2-silo view")
        names = _names(silos)
        return ([_view(s, names) for s in silos[:2]],
                _rows(await table.read_all(), names))
    finally:
        await _stop_all(silos)


async def test_oracle_partitioned_silo_kills_itself():
    views, rows = await _parity(_partitioned)
    assert views == [([0, 1], [2])] * 2
    assert rows == [(0, "Active"), (1, "Active"), (2, "Dead")]


async def _elastic_join(pkg):
    fabric, table, silos = await _start_cluster(pkg, 2)
    try:
        await _wait_until(
            lambda: all(len(s.membership.active) == 2 for s in silos))
        newcomer = (pkg.rt.SiloBuilder().with_name("m-new")
                    .with_fabric(fabric).add_grains(pkg.Ping)
                    .with_storage("Default", pkg.storage.MemoryStorage())
                    .with_config(**FAST).build())
        pkg.mbr.join_cluster(newcomer, table)
        await newcomer.start()
        silos.append(newcomer)
        await _wait_until(
            lambda: all(len(s.membership.active) == 3 for s in silos),
            msg="all three converge after join")
        names = _names(silos)
        return ([_view(s, names) for s in silos],
                _rows(await table.read_all(), names))
    finally:
        await _stop_all(silos)


async def test_oracle_elastic_join_updates_views():
    views, rows = await _parity(_elastic_join)
    assert views == [([0, 1, 2], [])] * 3
    assert rows == [(i, "Active") for i in range(3)]


async def _restart_same_endpoint(pkg):
    m = pkg.mbr
    table = m.InMemoryMembershipTable()
    old = m.MembershipEntry(pkg.ids.SiloAddress("host", 7777, 1),
                            m.SiloStatus.ACTIVE)
    base = await table.read_all()
    assert await table.insert_row(old, base.version.next())
    fabric = pkg.rt.InProcFabric()
    silo = (pkg.rt.SiloBuilder().with_name("reborn").with_fabric(fabric)
            .add_grains(pkg.Ping)
            .with_storage("Default", pkg.storage.MemoryStorage())
            .with_config(**FAST).build())
    # pin the same endpoint, newer generation
    silo.silo_address = pkg.ids.SiloAddress("host", 7777, 2)
    m.join_cluster(silo, table)
    try:
        await silo.start()
        return _rows(await table.read_all())
    finally:
        await silo.stop()


async def test_restart_same_endpoint_supersedes_old_generation():
    """A restarted silo at the same endpoint declares its prior
    incarnation dead on join (the prior-generation sweep)."""
    rows = await _parity(_restart_same_endpoint)
    assert rows == [(("host", 7777, 1), "Dead"),
                    (("host", 7777, 2), "Active")]
