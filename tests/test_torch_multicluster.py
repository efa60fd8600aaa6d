"""Parity of the port's multicluster federation
(orleans_tpu_torch.multicluster: gossip over in-memory, file and SQLite
channels, the admin configuration, Global-Single-Instance ownership with
cross-cluster forwarding and the Doubtful-retry maintainer) with the JAX
package's, on the CPU: the scenarios of tests/test_multicluster_admin.py,
tests/test_multicluster_transport.py and the multicluster part of
tests/test_services_versions_multicluster.py run through each package one
after the other, and what each observed must be equal exactly. A silo
address differs from run to run, so a scenario reports which cluster
served a call, not its address.

The port repairs two faults of the JAX package's copies (ROADMAP Queue 3),
each with a test here that fails on the unrepaired copy:

* ``MultiClusterData.merge`` and the SQLite channel compared stamps with a
  strict ``>``, so two clusters holding different entries at one stamp
  never converged; the port orders equal stamps by the serialized entry;
* ``GsiRuntime._on_config`` created its demotion task with no strong
  reference (the event loop holds tasks weakly), so it could be collected
  while it waited; the port holds it until it ends.

Sockets bind 127.0.0.1 on port 0; every async body runs under
``asyncio.wait_for(..., 30)``.
"""

import asyncio
import gc
import weakref
from types import SimpleNamespace

import pytest

import orleans_tpu.core.ids as jids
import orleans_tpu.management as jmg
import orleans_tpu.membership as jm
import orleans_tpu.multicluster as jmc
import orleans_tpu.runtime as jr
import orleans_tpu.runtime.grain as jgrain
import orleans_tpu.storage as js
import orleans_tpu_torch.core.ids as tids
import orleans_tpu_torch.management as tmg
import orleans_tpu_torch.membership as tm
import orleans_tpu_torch.multicluster as tmc
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.runtime.grain as tgrain
import orleans_tpu_torch.storage as ts
from orleans_tpu_torch.multicluster.gossip import MultiClusterData
from orleans_tpu_torch.multicluster.gsi import GsiRuntime

TIMEOUT = 30

FAST = dict(
    membership_probe_period=0.1,
    membership_probe_timeout=0.2,
    membership_missed_probes_limit=2,
    membership_votes_needed=1,
    membership_iam_alive_period=0.5,
    membership_refresh_period=0.2,
    membership_vote_expiration=5.0,
    response_timeout=5.0,
)


def _grains(rt, mc):
    @mc.global_single_instance
    class ItemGrain(rt.Grain):
        async def put(self, v):
            self._v = v
            return self.runtime_identity

        async def get(self):
            return (getattr(self, "_v", None), self.runtime_identity)

    @mc.global_single_instance
    class ProfileGrain(rt.Grain):
        async def set_name(self, name):
            self._name = name
            return self.runtime_identity

        async def get_name(self):
            return (getattr(self, "_name", None), self.runtime_identity)

    return ItemGrain, ProfileGrain


def _pkg(name, ids, mg, mb, mc, rt, grain, storage):
    item, profile = _grains(rt, mc)
    return SimpleNamespace(name=name, ids=ids, mg=mg, mb=mb, mc=mc, rt=rt,
                           grain=grain, storage=storage, Item=item,
                           Profile=profile)


J = _pkg("jax", jids, jmg, jm, jmc, jr, jgrain, js)
T = _pkg("torch", tids, tmg, tm, tmc, tr, tgrain, ts)


async def _parity(scenario, tmp_path=None):
    got = []
    for pkg in (J, T):
        args = ()
        if tmp_path is not None:
            d = tmp_path / pkg.name
            d.mkdir()
            args = (d,)
        got.append(await asyncio.wait_for(scenario(pkg, *args), TIMEOUT))
    assert got[0] == got[1], (scenario.__name__, got[0], got[1])
    return got[1]


async def _start(pkg, cluster_id, channel, tmp, grain, n_silos=1,
                 management=False, maintainer_period=0.2):
    fabric = pkg.rt.SocketFabric("127.0.0.1")
    table = pkg.mb.FileMembershipTable(str(tmp / f"mbr-{cluster_id}.json"))
    silos = []
    for i in range(n_silos):
        b = (pkg.rt.SiloBuilder().with_name(f"{cluster_id}-s{i}")
             .with_fabric(fabric).add_grains(grain).with_config(**FAST))
        pkg.mc.add_multicluster(b, cluster_id, [channel], gossip_period=0.1,
                                maintainer_period=maintainer_period)
        if management:
            pkg.mg.add_management(b)
        silo = b.build()
        pkg.mb.join_cluster(silo, table)
        await silo.start()
        silos.append(silo)
    return silos


async def _wait(cond, timeout=10.0, msg="condition"):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        await asyncio.sleep(0.05)


def _gossiped(a, b):
    return (set(a.multicluster.known_clusters()) >= {"A", "B"}
            and set(b.multicluster.known_clusters()) >= {"A", "B"}
            and a.multicluster.gateways_of("B")
            and b.multicluster.gateways_of("A"))


async def _client(pkg, silo):
    return await pkg.rt.GatewayClient([silo.silo_address.endpoint],
                                      response_timeout=5.0).connect()


async def _close(clients, silos):
    for c in clients:
        if c is not None:
            await c.close_async()
    for s in silos:
        await s.stop()


def _gid(pkg, cls, key):
    return pkg.ids.GrainId.for_grain(pkg.grain.grain_type_of(cls), key)


# ---------------------------------------------------------------------------
# tests/test_multicluster_admin.py
# ---------------------------------------------------------------------------

async def _inject(pkg, tmp):
    channel = pkg.mc.FileGossipChannel(str(tmp / "gossip.json"))
    (a,) = await _start(pkg, "A", channel, tmp, pkg.Item, management=True)
    (b,) = await _start(pkg, "B", channel, tmp, pkg.Item, management=True)
    ca = None
    try:
        await _wait(lambda: set(a.multicluster.known_clusters())
                    >= {"A", "B"} and a.multicluster.gateways_of("B"),
                    msg="initial gossip")
        ca = await _client(pkg, a)
        mgmt = ca.get_grain(pkg.mg.ManagementGrain, 0)
        before = await mgmt.get_multicluster_configuration()
        cfg = await mgmt.inject_multicluster_configuration(
            ["A", "B", "C"], comment="add planned cluster C")
        known_a = a.multicluster.known_clusters()
        await _wait(lambda: b.multicluster.config_stamp() == cfg["stamp"],
                    msg="config convergence on B")
        return (before, cfg["clusters"], known_a,
                b.multicluster.known_clusters(),
                (await mgmt.get_multicluster_configuration())["comment"])
    finally:
        await _close([ca], [a, b])


async def test_inject_configuration_gossips_to_all_clusters(tmp_path):
    got = await _parity(_inject, tmp_path)
    assert got == (None, ["A", "B", "C"], ["A", "B", "C"], ["A", "B", "C"],
                   "add planned cluster C")


async def _rehome(pkg, tmp):
    channel = pkg.mc.FileGossipChannel(str(tmp / "gossip.json"))
    (a,) = await _start(pkg, "A", channel, tmp, pkg.Item, management=True)
    (b,) = await _start(pkg, "B", channel, tmp, pkg.Item, management=True)
    ca = cb = None
    try:
        await _wait(lambda: _gossiped(a, b), msg="initial gossip")
        who = {str(a.silo_address): "A", str(b.silo_address): "B"}
        ca, cb = await _client(pkg, a), await _client(pkg, b)
        out = [who[await ca.get_grain(pkg.Item, "it1").put("v1")]]
        out.append(who[(await cb.get_grain(pkg.Item, "it1").get())[1]])
        gid = _gid(pkg, pkg.Item, "it1")
        out.append(tuple(await b.gsi.status(gid)))
        cfg = await cb.get_grain(pkg.mg.ManagementGrain, 0) \
            .inject_multicluster_configuration(["B"],
                                               comment="decommission A")
        out.append((cfg["clusters"], b.multicluster.known_clusters()))
        deadline = asyncio.get_running_loop().time() + 10
        while tuple(await b.gsi.status(gid)) != (
                pkg.mc.GsiState.OWNED.value, "B"):
            assert asyncio.get_running_loop().time() < deadline, \
                "entry never re-homed to B"
            await asyncio.sleep(0.1)
        out.append(who[(await cb.get_grain(pkg.Item, "it1").get())[1]])
        return out
    finally:
        await _close([ca, cb], [a, b])


async def test_removed_cluster_entries_rehome(tmp_path):
    got = await _parity(_rehome, tmp_path)
    assert got == ["A", "A", ("Cached", "A"), (["B"], ["B"]), "B"]


async def _lagging(pkg, tmp):
    channel = pkg.mc.FileGossipChannel(str(tmp / "gossip.json"))
    s0, s1 = await _start(pkg, "A", channel, tmp, pkg.Item, n_silos=2,
                          management=True)
    ca = None
    try:
        await _wait(lambda: len(s0.locator.alive_list) == 2,
                    msg="2-silo membership")
        ca = await _client(pkg, s0)
        mgmt = ca.get_grain(pkg.mg.ManagementGrain, 0)
        first = await mgmt.inject_multicluster_configuration(["A", "B"])
        lagger = s1 if s1.multicluster.config_stamp() == first["stamp"] \
            else s0
        lagger.multicluster.data.config = {
            "clusters": ["A"], "stamp": first["stamp"] - 100,
            "comment": "stale"}
        with pytest.raises(Exception, match="not stabilized"):
            await mgmt.inject_multicluster_configuration(["A"])
        await _wait(lambda: s0.multicluster.config_stamp()
                    == s1.multicluster.config_stamp(),
                    msg="stamp convergence")
        cfg = await mgmt.inject_multicluster_configuration(
            ["A"], check_for_lagging_silos=True)
        return first["clusters"], cfg["clusters"]
    finally:
        await _close([ca], [s0, s1])


async def test_inject_refuses_on_lagging_silo(tmp_path):
    assert await _parity(_lagging, tmp_path) == (["A", "B"], ["A"])


# ---------------------------------------------------------------------------
# tests/test_multicluster_transport.py
# ---------------------------------------------------------------------------

async def _file_gossip(pkg, tmp):
    channel = pkg.mc.FileGossipChannel(str(tmp / "gossip.json"))
    (a,) = await _start(pkg, "A", channel, tmp, pkg.Profile)
    (b,) = await _start(pkg, "B", channel, tmp, pkg.Profile)
    try:
        await _wait(lambda: _gossiped(a, b), msg="gossip")
        return (a.multicluster.gateways_of("B")[0].endpoint
                == b.silo_address.endpoint,
                b.multicluster.gateways_of("A")[0].endpoint
                == a.silo_address.endpoint)
    finally:
        await _close([], [a, b])


async def test_gossip_over_file_channel_between_fabrics(tmp_path):
    assert await _parity(_file_gossip, tmp_path) == (True, True)


async def _sqlite_gossip(pkg, tmp):
    channel = pkg.mc.SqliteGossipChannel(str(tmp / "gossip.db"))
    (a,) = await _start(pkg, "A", channel, tmp, pkg.Profile)
    (b,) = await _start(pkg, "B", channel, tmp, pkg.Profile)
    try:
        await _wait(lambda: _gossiped(a, b), msg="gossip")
        return (len(a.multicluster.gateways_of("B")),
                len(b.multicluster.gateways_of("A")))
    finally:
        await _close([], [a, b])
        channel.close()


async def test_gossip_over_sqlite_channel(tmp_path):
    assert await _parity(_sqlite_gossip, tmp_path) == (1, 1)


async def _forwarding(pkg, tmp):
    channel = pkg.mc.FileGossipChannel(str(tmp / "gossip.json"))
    (a,) = await _start(pkg, "A", channel, tmp, pkg.Profile)
    (b,) = await _start(pkg, "B", channel, tmp, pkg.Profile)
    ca = cb = None
    try:
        await _wait(lambda: _gossiped(a, b), msg="gossip")
        who = {str(a.silo_address): "A", str(b.silo_address): "B"}
        ca, cb = await _client(pkg, a), await _client(pkg, b)
        where_a = who[await ca.get_grain(pkg.Profile, "p1").set_name("ada")]
        name, where_b = await cb.get_grain(pkg.Profile, "p1").get_name()
        gid = _gid(pkg, pkg.Profile, "p1")
        return (where_a, name, who[where_b], tuple(await b.gsi.status(gid)),
                tuple(await a.gsi.status(gid)))
    finally:
        await _close([ca, cb], [a, b])


async def test_gsi_ownership_and_cross_cluster_forwarding(tmp_path):
    got = await _parity(_forwarding, tmp_path)
    assert got == ("A", "ada", "A", ("Cached", "A"), ("Owned", "A"))


async def _doubtful(pkg, tmp):
    channel = pkg.mc.FileGossipChannel(str(tmp / "gossip.json"))
    (a,) = await _start(pkg, "A", channel, tmp, pkg.Profile)
    (b,) = await _start(pkg, "B", channel, tmp, pkg.Profile)
    ca = cb = None
    try:
        await _wait(lambda: _gossiped(a, b), msg="gossip")
        who = {str(a.silo_address): "A", str(b.silo_address): "B"}
        ca, cb = await _client(pkg, a), await _client(pkg, b)
        await ca.get_grain(pkg.Profile, "p2").set_name("alice")
        gid = _gid(pkg, pkg.Profile, "p2")
        real_client_for = b.gsi._client_for

        async def cut(cluster_id):
            if cluster_id == "A":
                raise ConnectionError("partitioned")
            return await real_client_for(cluster_id)

        b.gsi._client_for = cut
        name, where = await cb.get_grain(pkg.Profile, "p2").get_name()
        out = [(name, who[where]), tuple(await b.gsi.status(gid))]
        b.gsi._client_for = real_client_for

        async def ceded():
            while True:
                state, owner = await b.gsi.status(gid)
                if state == pkg.mc.GsiState.CACHED.value and owner == "A" \
                        and not b.catalog.by_grain.get(gid):
                    return
                await asyncio.sleep(0.05)
        await asyncio.wait_for(ceded(), timeout=10.0)
        name, where = await cb.get_grain(pkg.Profile, "p2").get_name()
        out.append((name, who[where]))
        return out
    finally:
        await _close([ca, cb], [a, b])


async def test_doubtful_ownership_resolves_via_maintainer(tmp_path):
    got = await _parity(_doubtful, tmp_path)
    assert got == [(None, "B"), ("Doubtful", "B"), ("alice", "A")]


# ---------------------------------------------------------------------------
# tests/test_services_versions_multicluster.py, multicluster part
# ---------------------------------------------------------------------------

async def _in_memory_gossip(pkg):
    channel = pkg.mc.InMemoryGossipChannel()
    silos = []
    for name in ("clusterA", "clusterB"):
        fabric = pkg.rt.InProcFabric()
        b = (pkg.rt.SiloBuilder().with_name(name).with_fabric(fabric)
             .with_storage("Default", pkg.storage.MemoryStorage()))
        pkg.mc.add_multicluster(b, name, [channel], gossip_period=0.1)
        silo = b.build()
        await silo.start()
        silos.append(silo)
    a, b = silos
    try:
        await _wait(lambda: set(a.multicluster.known_clusters()) >=
                    {"clusterA", "clusterB"} and
                    set(b.multicluster.known_clusters()) >=
                    {"clusterA", "clusterB"}, timeout=5, msg="gossip")
        return (a.multicluster.gateways_of("clusterB") == [b.silo_address],
                b.multicluster.gateways_of("clusterA") == [a.silo_address])
    finally:
        await _close([], silos)


async def test_gossip_exchanges_gateways_between_clusters():
    assert await _parity(_in_memory_gossip) == (True, True)


async def _race(pkg):
    registrars = {}

    async def peer_query(cluster_id, grain_id):
        return registrars[cluster_id].status_of(grain_id)

    for cid in ("alpha", "beta"):
        registrars[cid] = pkg.mc.GlobalSingleInstanceRegistrar(
            cid, lambda: ["alpha", "beta"], peer_query)
    gid = pkg.ids.GrainId.for_grain(pkg.ids.GrainType.of("GeoGrain"), 1)
    e1 = await registrars["alpha"].register(gid)
    e2 = await registrars["beta"].register(gid)
    out = [(e1.state.value, e1.owner_cluster),
           (e2.state.value, e2.owner_cluster)]
    gid2 = pkg.ids.GrainId.for_grain(pkg.ids.GrainType.of("GeoGrain"), 2)
    r_alpha, r_beta = await asyncio.gather(
        registrars["alpha"].register(gid2),
        registrars["beta"].register(gid2))
    out += [(r_alpha.state.value, r_alpha.owner_cluster),
            (r_beta.state.value, r_beta.owner_cluster)]
    await registrars["alpha"].retry_doubtful()
    await registrars["beta"].retry_doubtful()
    out.append(registrars["beta"].entries[gid2].state.value)
    return out


async def test_gsi_ownership_cached_and_race_resolution():
    got = await _parity(_race)
    assert got[0] == ("Owned", "alpha") and got[1] == ("Cached", "alpha")
    assert got[2][0] in ("Owned", "Doubtful", "RequestedOwnership")
    assert got[3][0] in ("RaceLoser", "Cached")


async def _unreachable(pkg):
    async def peer_query(cluster_id, grain_id):
        raise ConnectionError("DCN down")

    reg = pkg.mc.GlobalSingleInstanceRegistrar(
        "alpha", lambda: ["alpha", "beta"], peer_query)
    gid = pkg.ids.GrainId.for_grain(pkg.ids.GrainType.of("GeoGrain"), 3)
    return (await reg.register(gid)).state.value


async def test_gsi_doubtful_when_peer_unreachable():
    assert await _parity(_unreachable) == "Doubtful"


# ---------------------------------------------------------------------------
# The port's repairs
# ---------------------------------------------------------------------------

def _entry(port, stamp=5.0):
    return {"stamp": stamp,
            "gateways": [tids.SiloAddress("127.0.0.1", port, 1, 0)]}


def test_gossip_merge_breaks_equal_stamps_the_same_way_everywhere():
    """Two clusters holding different entries (and configurations) at one
    stamp converge after a merge each way; the JAX package's copy keeps
    each side's own."""
    def pair(mod, ids):
        def entry(port):
            return {"stamp": 5.0,
                    "gateways": [ids.SiloAddress("127.0.0.1", port, 1, 0)]}
        x = mod.MultiClusterData({"C": entry(1111)},
                                 {"clusters": ["A"], "stamp": 7.0,
                                  "comment": "x"})
        y = mod.MultiClusterData({"C": entry(2222)},
                                 {"clusters": ["B"], "stamp": 7.0,
                                  "comment": "y"})
        x2, y2 = x.copy(), y.copy()
        x2.merge(y)
        y2.merge(x)
        return x2, y2

    x, y = pair(tmc.gossip, tids)
    assert x.clusters == y.clusters and x.config == y.config
    assert x.clusters["C"]["gateways"][0].port == 2222
    assert x.config["clusters"] == ["B"]
    jx, jy = pair(jmc.gossip, jids)
    assert jx.clusters != jy.clusters and jx.config != jy.config


async def test_sqlite_gossip_channel_breaks_equal_stamps_alike(tmp_path):
    """Publishing two entries of one stamp in either order leaves the
    same row in the SQLite channel."""
    async def run():
        x = MultiClusterData({"C": _entry(1111)},
                             {"clusters": ["A"], "stamp": 7.0,
                              "comment": "x"})
        y = MultiClusterData({"C": _entry(2222)},
                             {"clusters": ["B"], "stamp": 7.0,
                              "comment": "y"})
        reads = []
        for i, order in enumerate(((x, y), (y, x))):
            ch = tmc.SqliteGossipChannel(str(tmp_path / f"g{i}.db"))
            try:
                for data in order:
                    await ch.publish(data)
                got = await ch.read()
                reads.append((got.clusters["C"]["gateways"][0].port,
                              got.config["clusters"]))
            finally:
                ch.close()
        return reads

    assert await asyncio.wait_for(run(), TIMEOUT) == [(2222, ["B"])] * 2


def test_gsi_config_task_is_held_until_it_ends():
    """The demotion task a configuration change starts is held by the
    runtime: a collection while it waits on a future nothing else holds
    leaves it alive, and it completes."""
    async def run():
        loop = asyncio.get_running_loop()
        waiting: list = []
        demoted: list = []

        class Directory:
            async def demote_removed_owners(self, active):
                fut = loop.create_future()
                waiting.append(weakref.ref(fut))
                await fut
                demoted.append(list(active))
                return 0

        rt = GsiRuntime(SimpleNamespace(status="Running"),
                        SimpleNamespace(cluster_id="A", config_listeners=[]))
        rt._directory = Directory
        rt._on_config({"clusters": ["A"], "stamp": 1.0})
        for _ in range(3):
            await asyncio.sleep(0)
        gc.collect()
        fut = waiting[0]()
        assert fut is not None, "the demotion task was collected mid-flight"
        fut.set_result(None)
        for _ in range(3):
            await asyncio.sleep(0)
        return demoted, len(rt._tasks)

    assert asyncio.run(asyncio.wait_for(run(), TIMEOUT)) == ([["A"]], 0)
