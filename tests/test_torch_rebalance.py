"""Parity of the port's live rebalancing (orleans_tpu_torch.rebalance: the
planner, the executor and the service) with the JAX package's, on the CPU.

Thirteen of the fourteen scenarios of tests/test_rebalance.py run through
each package one after the other, never interleaved on one loop (each
package's silo installs its own eager task factory), and what each
observed must be equal exactly: rows moved, the shards keys end on,
every counter, the silos activations end on (named by index).
``test_ledger_hot_actor_gets_move_counts_never_planned`` waits for the
cost ledger (ROADMAP Queue 1 item 17).

The planner's device-tier plan is held against the reference's exactly:
the same table (built in the JAX package, carried across with
``interop.carry_table``, hit counters included) gives the same keys, the
same destination shards and the same drop count, at the pack's edge
shapes (one candidate, exactly ``budget``, more than ``budget``). The
port packs with ``pack_by_dest`` on the table's device: the plain
version of K2 here, K2 itself on a CUDA table. Vector grains of a pair
share ``__name__``. Every async body runs under
``asyncio.wait_for(..., 30)``.
"""

import asyncio
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orleans_tpu.core.ids as jids
import orleans_tpu.dispatch as jd
import orleans_tpu.observability.stats as jstats
import orleans_tpu.parallel as jp
import orleans_tpu.placement.strategies as jps
import orleans_tpu.rebalance as jrb
import orleans_tpu.rebalance.planner as jplanner
import orleans_tpu.runtime as jr
import orleans_tpu.testing as jt
import orleans_tpu_torch.core.ids as tids
import orleans_tpu_torch.dispatch as td
import orleans_tpu_torch.observability.stats as tstats
import orleans_tpu_torch.ops.route as troute
import orleans_tpu_torch.parallel as tp
import orleans_tpu_torch.placement.strategies as tps
import orleans_tpu_torch.rebalance as trb
import orleans_tpu_torch.rebalance.planner as tplanner
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.testing as tt
from orleans_tpu_torch.dispatch.table import ShardedActorTable
from orleans_tpu_torch.interop import carry_table

TIMEOUT = 30


class JCounterVec(jd.VectorGrain):
    STATE = {"count": (jnp.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"count": jnp.int32(0)}

    @jd.actor_method(args={"x": (jnp.int32, ())})
    def bump(state, args):
        new = {"count": state["count"] + args["x"]}
        return new, new["count"]


class TCounterVec(td.VectorGrain):
    STATE = {"count": (torch.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"count": torch.zeros_like(key_hash)}

    @td.actor_method(args={"x": (torch.int32, ())})
    def bump(state, args):
        new = {"count": state["count"] + args["x"]}
        return new, new["count"]


for _cls in (JCounterVec, TCounterVec):
    _cls.__name__ = _cls.__qualname__ = "CounterVec"


def _host_grains(rt):
    class HotGrain(rt.StatefulGrain):
        __orleans_placement__ = "pin_first"

        async def incr(self) -> int:
            self.state["n"] = self.state.get("n", 0) + 1
            await self.write_state()
            return self.state["n"]

        async def where(self) -> str:
            return str(self.runtime.silo_address)

    return HotGrain


class PinFirstDirector:
    """Everything lands on one silo: the skew generator."""

    def __init__(self, pinned):
        self.pinned = pinned

    def place(self, grain_id, requester, silos):
        return self.pinned if self.pinned in silos else silos[0]


J = SimpleNamespace(rt=jr, d=jd, rb=jrb, stats=jstats, testing=jt, ids=jids,
                    ps=jps, Vec=JCounterVec, Hot=_host_grains(jr),
                    mesh=lambda n: jp.make_mesh(n), arg=jnp.int32)
T = SimpleNamespace(rt=tr, d=td, rb=trb, stats=tstats, testing=tt, ids=tids,
                    ps=tps, Vec=TCounterVec, Hot=_host_grains(tr),
                    mesh=lambda n: tp.make_mesh(n, device="cpu"),
                    arg=lambda v: torch.tensor(v, dtype=torch.int32))


async def _parity(scenario, *args):
    got = []
    for pkg in (J, T):
        got.append(await asyncio.wait_for(scenario(pkg, *args), TIMEOUT))
    assert got[0] == got[1], (scenario.__name__, got[0], got[1])
    return got[1]


def _pin(cluster, pinned) -> None:
    for s in cluster.silos:
        s.locator.placement.directors["pin_first"] = PinFirstDirector(pinned)


def _stat(pkg, name):
    return pkg.stats.REBALANCE_STATS[name]


# ----------------------------------------------------------------------
# device tier: hot-shard telemetry + live row migration
# ----------------------------------------------------------------------

async def _device_silo(pkg, name, body):
    b = pkg.rt.SiloBuilder().with_name(name).with_config(
        rebalance_budget=16, rebalance_imbalance_ratio=1.1)
    pkg.d.add_vector_grains(b, pkg.Vec, mesh=pkg.mesh(8),
                            capacity_per_shard=64)
    pkg.rb.add_rebalancer(b)  # period 0: manual rounds
    silo = b.build()
    await silo.start()
    silo.vector.enable_load_tracking()  # manual rounds: opt in explicitly
    client = await pkg.rt.ClusterClient(silo.fabric).connect()
    try:
        return await body(silo, client)
    finally:
        await client.close_async()
        await silo.stop()


async def _hot_shard_drain(pkg):
    async def body(silo, client):
        keys = [k * 8 for k in range(12)]  # all hash to shard 0
        rounds = []
        for _ in range(3):
            rounds.append([int(v) for v in await asyncio.gather(*(
                client.get_grain(pkg.Vec, k).bump(x=1) for k in keys))])
        tbl = silo.vector.table(pkg.Vec)
        before = [tbl.key_to_slot[k][0] for k in keys]
        hot_hits = int(tbl.shard_hits()[0])
        outcome = await silo.rebalancer.run_round()
        after = [tbl.key_to_slot[k][0] for k in keys]
        out = [int(v) for v in await asyncio.gather(*(
            client.get_grain(pkg.Vec, k).bump(x=1) for k in keys))]
        return rounds, before, hot_hits, outcome, after, out
    return await _device_silo(pkg, "dev-rebalance", body)


async def test_device_hot_shard_drains_to_cool_shards():
    """Keys engineered onto one shard; after a round the hot shard's row
    count drops and every key's state row survives."""
    rounds, before, hot_hits, outcome, after, out = \
        await _parity(_hot_shard_drain)
    assert rounds == [[1] * 12, [2] * 12, [3] * 12]
    assert before == [0] * 12 and hot_hits == 36
    assert outcome["rows_moved"] > 0 and len(set(after)) > 1
    assert sum(1 for s in after if s == 0) < 12
    assert out == [4] * 12  # counts continue from 3


async def _fence(pkg):
    async def body(silo, client):
        rt = silo.vector
        keys = [k * 8 for k in range(10)]
        await asyncio.gather(*(
            client.get_grain(pkg.Vec, k).bump(x=1) for k in keys))
        tbl = rt.table(pkg.Vec)
        fut = rt.call(pkg.Vec, keys[0], "bump", x=pkg.arg(5))
        queued = keys[0] in rt.pending_key_hashes(pkg.Vec)
        loc_before = tbl.key_to_slot[keys[0]]
        outcome = await silo.rebalancer.run_round()
        return (queued, tbl.key_to_slot[keys[0]] == loc_before,
                outcome["rows_moved"], int(await fut))
    return await _device_silo(pkg, "dev-fence", body)


async def test_device_move_fences_pending_invocations():
    """A key with a queued invocation does not move mid-flight."""
    queued, stayed, moved, value = await _parity(_fence)
    assert queued and stayed and moved > 0
    assert value == 6  # the queued call still lands correctly


async def _string_keys(pkg):
    gt = pkg.ids.GrainType.of("CounterVec")
    names, i = [], 0
    while len(names) < 10:
        key = f"user-{i}"
        i += 1
        if pkg.ids.GrainId.for_grain(gt, key).uniform_hash % 8 == 0:
            names.append(key)
    hashes = [pkg.ids.GrainId.for_grain(gt, k).uniform_hash for k in names]

    async def body(silo, client):
        for _ in range(2):
            await asyncio.gather(*(
                client.get_grain(pkg.Vec, k).bump(x=1) for k in names))
        tbl = silo.vector.table(pkg.Vec)
        before = [tbl.key_to_slot[h][0] for h in hashes]
        outcome = await silo.rebalancer.run_round()
        after = [tbl.key_to_slot[h][0] for h in hashes]
        ratio = silo.stats.gauge(_stat(pkg, "device_hot_ratio"))
        out = [int(v) for v in await asyncio.gather(*(
            client.get_grain(pkg.Vec, k).bump(x=1) for k in names))]
        return hashes, before, outcome["rows_moved"], after, ratio, out
    return await _device_silo(pkg, "dev-strkeys", body)


async def test_device_rebalance_string_keys_63bit_hashes():
    """String keys ride the full 63-bit hash; the plan packs candidate
    indices, so a key with bit 62 set still moves."""
    hashes, before, moved, after, ratio, out = await _parity(_string_keys)
    assert any(h >> 62 for h in hashes), "want at least one bit-62 hash"
    assert before == [0] * 10 and moved > 0 and len(set(after)) > 1
    assert ratio >= 1.0 and out == [3] * 10


# ----------------------------------------------------------------------
# host tier: cross-silo activation migration
# ----------------------------------------------------------------------

async def _skewed_live(pkg):
    n_grains, n_rounds = 16, 12
    cluster = (pkg.testing.TestClusterBuilder(2).add_grains(pkg.Hot)
               .with_rebalancer(period=0.15, budget=6, imbalance_ratio=1.1)
               .build())
    async with cluster:
        silo_a, silo_b = cluster.silos
        _pin(cluster, silo_a.silo_address)
        grains = [cluster.grain(pkg.Hot, f"hot-{i}") for i in range(n_grains)]
        first = await asyncio.gather(*(g.incr() for g in grains))
        count_a_before = silo_a.catalog.activation_count()
        b_before = silo_b.catalog.activation_count()
        rounds_ok = []
        for r in range(2, n_rounds + 2):
            out = await asyncio.gather(*(g.incr() for g in grains))
            rounds_ok.append(out == [r] * n_grains)
            await asyncio.sleep(0.05)
        await cluster.wait_until(
            lambda: silo_b.catalog.activation_count() > 0
            and silo_a.catalog.activation_count() < count_a_before,
            timeout=10.0, msg="a migration round to drain silo A")
        last = await asyncio.gather(*(g.incr() for g in grains))
        hosts = await asyncio.gather(*(g.where() for g in grains))
        return (first, count_a_before >= n_grains, b_before, rounds_ok,
                last, str(silo_b.silo_address) in hosts,
                silo_a.stats.get(_stat(pkg, "migrated")) > 0,
                silo_a.stats.get("catalog.activations.migrated_out") > 0,
                silo_b.stats.get("catalog.activations.migrated_in") > 0,
                silo_a.stats.gauge(_stat(pkg, "last_imbalance")) > 0)


async def test_two_silo_skewed_workload_rebalances_live():
    """Every HotGrain skewed onto silo A, traffic driven while the
    rebalancer loop runs: A drains to B with no invocation lost or
    duplicated."""
    got = await _parity(_skewed_live)
    assert got == ([1] * 16, True, 0, [True] * 12, [14] * 16, True,
                   True, True, True, True)


async def _mid_flight(pkg):
    cluster = (pkg.testing.TestClusterBuilder(2).add_grains(pkg.Hot)
               .with_rebalancer(period=0.0).build())
    async with cluster:
        silo_a, silo_b = cluster.silos
        _pin(cluster, silo_a.silo_address)
        g = cluster.grain(pkg.Hot, "racer")
        first = await g.incr()
        act = silo_a.catalog.by_grain[g.grain_id][0]
        mig = asyncio.ensure_future(
            silo_a.rebalancer.executor.migrate_activation(
                act, silo_b.silo_address))
        burst = [asyncio.ensure_future(g.incr()) for _ in range(8)]
        ok = await mig
        vals = sorted(await asyncio.gather(*burst))
        return (first, ok, vals, bool(silo_b.catalog.by_grain.get(g.grain_id)),
                bool(silo_a.catalog.by_grain.get(g.grain_id)),
                await g.incr())


async def test_migration_mid_flight_messages_redispatch():
    """Messages racing a migration park at the source and re-address to
    the destination: none lost, none run twice."""
    assert await _parity(_mid_flight) == (
        1, True, list(range(2, 10)), True, False, 10)


async def _hotlane_fence(pkg):
    cluster = (pkg.testing.TestClusterBuilder(2).add_grains(pkg.Hot)
               .with_rebalancer(period=0.0).build())
    async with cluster:
        silo_a, silo_b = cluster.silos
        _pin(cluster, silo_a.silo_address)
        client = cluster.client
        g = cluster.grain(pkg.Hot, "hot-mover")
        out = [await g.incr()]
        h0 = client.hot_hits
        out.append(await g.incr())
        lane = client.hot_hits == h0 + 1
        act = silo_a.catalog.by_grain[g.grain_id][0]
        mig = asyncio.ensure_future(
            silo_a.rebalancer.executor.migrate_activation(
                act, silo_b.silo_address))
        burst = [asyncio.ensure_future(g.incr()) for _ in range(6)]
        ok = await mig
        vals = sorted(await asyncio.gather(*burst))
        on_b = bool(silo_b.catalog.by_grain.get(g.grain_id))
        h1 = client.hot_hits
        out += [await g.incr(), await g.incr()]
        return (out, lane, ok, vals, on_b, client.hot_hits > h1,
                await g.where() == str(silo_b.silo_address))


async def test_hotlane_migration_fence_falls_back_cleanly():
    """Hot-lane calls across a live migration: before the fence on the
    lane, during it through messaging, after it on the destination's
    lane; no lost or duplicated increments."""
    assert await _parity(_hotlane_fence) == (
        [1, 2, 9, 10], True, True, list(range(3, 9)), True, True, True)


async def _locality_after_kill(pkg):
    cluster = (pkg.testing.TestClusterBuilder(2).add_grains(pkg.Hot)
               .with_rebalancer(period=0.0).build())
    async with cluster:
        silo_a, silo_b = cluster.silos
        _pin(cluster, silo_a.silo_address)
        client = cluster.client
        g = cluster.grain(pkg.Hot, "phoenix")
        out = [await g.incr(), await g.incr()]
        hint_a = client._hot_silo_cache.get(g.grain_id) == silo_a.silo_address
        await cluster.kill_silo(silo_a)
        _pin(cluster, silo_b.silo_address)
        out.append(await asyncio.wait_for(g.incr(), 10))
        h0 = client.hot_hits
        out.append(await g.incr())
        return (out, hint_a, client.hot_hits > h0,
                client._hot_silo_cache.get(g.grain_id) == silo_b.silo_address)


async def test_hotlane_locality_hint_survives_silo_kill():
    """A killed silo's stale locality hint re-resolves once the grain
    reactivates on a survivor."""
    assert await _parity(_locality_after_kill) == (
        [1, 2, 3, 4], True, True, True)


async def _rollback(pkg):
    cluster = (pkg.testing.TestClusterBuilder(2).add_grains(pkg.Hot)
               .with_rebalancer(period=0.0).build())
    async with cluster:
        silo_a, silo_b = cluster.silos
        _pin(cluster, silo_a.silo_address)
        g = cluster.grain(pkg.Hot, "stayer")
        first = await g.incr()
        act = silo_a.catalog.by_grain[g.grain_id][0]
        silo_b.registry._classes.pop("HotGrain")  # sabotage the destination
        ok = await silo_a.rebalancer.executor.migrate_activation(
            act, silo_b.silo_address)
        undone = silo_a.stats.get(_stat(pkg, "rolled_back")) + \
            silo_a.stats.get(_stat(pkg, "refused"))
        return first, ok, undone > 0, act.state.name, await g.incr()


async def test_migration_rolls_back_when_destination_refuses():
    """A transfer failure leaves the source activation serving with its
    registration intact."""
    assert await _parity(_rollback) == (1, False, True, "VALID", 2)


def _placement(pkg):
    silos = [pkg.ids.SiloAddress(f"s{i}", 1000 + i, 1) for i in range(5)]
    loads = {s: i * 10 for i, s in enumerate(silos)}
    full = pkg.ps.ActivationCountPlacement(lambda s: loads[s])
    scans = {full.place(None, silos[3], silos) for _ in range(10)}
    p2c = pkg.ps.ActivationCountP2CPlacement(lambda s: loads[s])
    picks = {p2c.place(None, silos[4], silos) for _ in range(50)}
    return ([silos.index(s) for s in scans], 4 in
            [silos.index(s) for s in picks], silos[0] in picks)


def test_activation_count_placement_full_scan_and_p2c():
    got = [_placement(pkg) for pkg in (J, T)]
    assert got[0] == got[1] == ([0], False, True)


def test_placement_manager_exposes_p2c_by_name():
    for pkg in (J, T):
        mgr = pkg.ps.PlacementManager(lambda s: 0)
        assert type(mgr.director_by_name("activation_count")) is \
            pkg.ps.ActivationCountPlacement
        assert isinstance(mgr.director_by_name("activation_count_p2c"),
                          pkg.ps.ActivationCountP2CPlacement)


async def _forward_notifies(pkg):
    cluster = (pkg.testing.TestClusterBuilder(3).add_grains(pkg.Hot)
               .with_rebalancer(period=0.0).build())
    async with cluster:
        silo_a, silo_b, silo_c = cluster.silos
        _pin(cluster, silo_a.silo_address)
        g = cluster.grain(pkg.Hot, "cached")
        first = await g.incr()
        gid = g.grain_id
        act = silo_a.catalog.by_grain[gid][0]
        silo_c.locator.cache.put(gid, silo_a.silo_address)
        ok = await silo_a.rebalancer.executor.migrate_activation(
            act, silo_b.silo_address)
        ref = silo_c.grain_factory.get_grain(pkg.Hot, "cached")
        second = await ref.incr()
        await cluster.wait_until(
            lambda: silo_c.locator.cache.get(gid) != silo_a.silo_address,
            timeout=5.0, msg="stale cache entry on C to be invalidated")
        return first, ok, second


async def test_forward_notifies_sender_cache_invalidation():
    """After a migration, a peer whose cache still names the old host has
    its entry dropped by the forwarding silo."""
    assert await _parity(_forward_notifies) == (1, True, 2)


async def _noop_round(pkg):
    cluster = (pkg.testing.TestClusterBuilder(2).add_grains(pkg.Hot)
               .with_rebalancer(period=0.0).build())
    async with cluster:
        silo_a, _ = cluster.silos
        outcome = await silo_a.rebalancer.run_round()
        return (outcome["planned"],
                silo_a.stats.get(_stat(pkg, "rounds")),
                silo_a.stats.gauge(_stat(pkg, "last_moved")))


async def test_rebalance_round_is_noop_when_balanced():
    assert await _parity(_noop_round) == (0, 1, 0)


async def _soak(pkg):
    n_grains = 30
    cluster = (pkg.testing.TestClusterBuilder(3).add_grains(pkg.Hot)
               .with_rebalancer(period=0.2, budget=5, imbalance_ratio=1.2)
               .build())
    async with cluster:
        silo_a = cluster.silos[0]
        _pin(cluster, silo_a.silo_address)
        grains = [cluster.grain(pkg.Hot, f"soak-{i}")
                  for i in range(n_grains)]
        first = await asyncio.gather(*(g.incr() for g in grains))

        def converged() -> bool:
            counts = [s.catalog.activation_count() for s in cluster.silos]
            mean = sum(counts) / len(counts)
            return mean > 0 and max(counts) <= 1.3 * mean

        await cluster.wait_until(converged, timeout=20.0,
                                 msg="cluster load convergence")
        out = await asyncio.gather(*(g.incr() for g in grains))
        moves = sum(s.stats.get(_stat(pkg, "migrated"))
                    for s in cluster.silos)
        return (first, out, n_grains // 3 <= moves <= n_grains * 3)


async def test_three_silo_convergence_soak():
    """A heavily skewed 3-silo cluster converges within the imbalance
    ratio over several rounds without thrashing."""
    assert await _parity(_soak) == ([1] * 30, [2] * 30, True)


# ----------------------------------------------------------------------
# the planner's device-tier plan, exactly
# ----------------------------------------------------------------------

def _planner_tables(n_hot, seed, capacity=64):
    """A JAX table with ``n_hot`` hashed keys on shard 0 and 4 on each
    other shard, random per-key hits (hot keys hotter), and the port's
    table carried from it."""
    rng = np.random.default_rng(seed)
    jtbl = jd.ShardedActorTable(JCounterVec, jp.make_mesh(8), capacity)
    # multiples of 8 land on shard 0; a few above 2**62 keep bit 62 set
    hot = rng.choice(np.arange(1, 1 << 20), n_hot, replace=False) * 8
    hot[: n_hot // 2] += (1 << 62) - ((1 << 62) % 8)
    cool = [int(k) * 8 + s for s in range(1, 8)
            for k in rng.integers(1, 1 << 20, 4)]
    locs = [jtbl.lookup_or_allocate(k)[:2]
            for k in [int(x) for x in hot] + cool]
    hits = np.zeros((8, jtbl.capacity + 1), np.int32)
    for shard, slot in locs:
        hits[shard, slot] = rng.integers(20, 100) if shard == 0 \
            else rng.integers(1, 10)
    jtbl.hits = jnp.asarray(hits)
    ttbl = ShardedActorTable(TCounterVec, tp.make_mesh(8, device="cpu"),
                             capacity)
    carry_table(jtbl, ttbl)
    return jtbl, ttbl


def _shard_plan(planner_mod, cls, tbl, budget):
    silo = SimpleNamespace(vector=SimpleNamespace(
        track_load=True, tables={cls: tbl}))
    planner = planner_mod.RebalancePlanner(silo, budget=budget,
                                           imbalance_ratio=1.2)
    plan = planner_mod.MigrationPlan()
    planner._plan_shard_moves(plan)
    return [(np.asarray(m.keys).tolist(), np.asarray(m.dest_shards).tolist(),
             int(m.dropped)) for m in plan.shard_moves], plan.imbalance


@pytest.mark.parametrize("n_hot, budget", [(1, 16), (16, 16), (40, 16),
                                           (200, 128)],
                         ids=["one", "budget", "over-budget", "wide"])
def test_planner_shard_moves_match_the_reference(n_hot, budget):
    jtbl, ttbl = _planner_tables(n_hot, seed=n_hot)
    assert np.array_equal(jtbl.shard_hits(), ttbl.shard_hits())
    jmoves, jimb = _shard_plan(jplanner, JCounterVec, jtbl, budget)
    before = troute.RANK_BY_DEST.launches
    tmoves, timb = _shard_plan(tplanner, TCounterVec, ttbl, budget)
    assert troute.RANK_BY_DEST.launches == before  # CPU: the plain version
    assert tmoves == jmoves and timb == jimb
    assert len(tmoves) == 1
    keys, dests, drops = tmoves[0]
    assert 1 <= len(keys) <= min(n_hot, budget) and drops == 0
    assert 0 not in dests and all(k % 8 == 0 for k in keys)
    if n_hot == 1:
        assert len(keys) == 1


def test_move_rows_both_ways_in_one_call_matches_the_reference():
    """One call moving rows into and out of the same shards (the free
    lists take the claimed tail off and the freed slots on, in order)
    leaves the free lists, the host map and the on-device directory of
    the reference's ``move_rows``, exactly."""
    jtbl, ttbl = _planner_tables(40, seed=3)
    by_shard = {}
    for k, (sh, _) in jtbl.key_to_slot.items():
        by_shard.setdefault(sh, []).append(k)
    moves = [(k, 1 + i % 7) for i, k in enumerate(by_shard[0][:30])]
    moves += [(k, 0) for k in by_shard[1][:3]] + \
        [(k, 2) for k in by_shard[3][:2]]
    ks, ds = (list(x) for x in zip(*moves))
    n = jtbl.move_rows(ks, ds)
    assert ttbl.move_rows(np.asarray(ks), np.asarray(ds)) == n == 35
    assert ttbl.free == jtbl.free
    assert ttbl.key_to_slot == jtbl.key_to_slot
    for a in ("tk_lo", "tk_hi", "tvals"):
        np.testing.assert_array_equal(getattr(ttbl.device_dir, a),
                                      getattr(jtbl.device_dir, a))
    np.testing.assert_array_equal(ttbl.slot_hits(),
                                  np.asarray(jtbl.slot_hits()))
