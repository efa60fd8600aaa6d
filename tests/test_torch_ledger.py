"""The port's cost-attribution ledger (orleans_tpu_torch.observability.
ledger), on the CPU: the port's copy of tests/test_ledger.py — bounded
space-saving sketches with deterministic merge, host-turn / device-tick /
wire / stream charging across both tiers, the on-device per-slot cost
twin, the loop-confinement stamp-and-replay discipline (tick worker +
egress shards), the ``ledger_enabled`` off-by-default lever, and the
management drill-down (``ctl_ledger`` → ``get_cluster_ledger``) — and
the same call sequence through the JAX package's silo and the port's
giving the same ledger and metrics counts. Every async body runs under
``asyncio.wait_for(..., 30)``.
"""

import asyncio
import functools
import random

import numpy as np
import pytest
import torch

from orleans_tpu_torch.core.message import set_debug_pool
from orleans_tpu_torch.dispatch import VectorGrain, actor_method, add_vector_grains
from orleans_tpu_torch.dispatch.table import ShardedActorTable
from orleans_tpu_torch.management import ManagementGrain
from orleans_tpu_torch.membership import FileMembershipTable, join_cluster
from orleans_tpu_torch.observability.ledger import (
    LEDGER_STATS,
    TENANT_KEY,
    CostLedger,
    SpaceSavingSketch,
)
from orleans_tpu_torch.parallel import make_mesh
from orleans_tpu_torch.runtime import (ClusterClient, GatewayClient, Grain,
                                 SiloBuilder, SocketFabric)
from orleans_tpu_torch.runtime.context import RequestContext
from orleans_tpu_torch.testing import TestClusterBuilder


TIMEOUT = 30


def bounded(fn):
    """Run the test coroutine under ``asyncio.wait_for(..., TIMEOUT)``."""
    @functools.wraps(fn)
    async def run(*args, **kwargs):
        await asyncio.wait_for(fn(*args, **kwargs), TIMEOUT)
    return run


class EchoGrain(Grain):
    async def ping(self, x: int) -> int:
        return x

    async def burn(self, n: int) -> int:
        # measurable exec seconds: worst-burner assertions must not
        # ride the wall clock of a trivial turn (one GC pause under a
        # cold ping can out-bill a dozen hot ones)
        total = 0
        for i in range(n):
            total += i
        return total

    async def where(self) -> str:
        return str(self.runtime.silo_address)


class CounterVec(VectorGrain):
    STATE = {"total": (torch.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"total": key_hash.new_zeros((), dtype=torch.float32)}

    @actor_method(args={"x": (torch.float32, ())})
    def add(state, args):
        return ({"total": state["total"] + args["x"]},
                state["total"] + args["x"])


@pytest.fixture
def debug_pool():
    prev = set_debug_pool(True)
    try:
        yield
    finally:
        set_debug_pool(prev)


# ---------------------------------------------------------------------------
# Space-saving sketch: bound, overflow, deterministic merge
# ---------------------------------------------------------------------------

def test_sketch_bound_and_overflow():
    sk = SpaceSavingSketch(4)
    for i in range(16):
        sk.add(f"k{i:02d}", 1.0)
    assert len(sk.counts) == 4          # never exceeds k
    assert sk.overflow == 12            # every eviction counted
    # a newcomer inherits the evicted floor as count AND err bound
    label, count, err = sk.top(1)[0]
    assert count >= err >= 1.0


def test_sketch_hot_label_survives_cold_churn():
    """The space-saving guarantee the drill-down rides: a label holding
    more than total/k of the weight is always present, regardless of
    how many cold labels churn through."""
    sk = SpaceSavingSketch(8)
    rng = random.Random(17)
    for i in range(2000):
        sk.add("hot/actor", 0.05)
        sk.add(f"cold/{rng.randrange(500)}", 0.001)
    top = sk.top(1)[0]
    assert top[0] == "hot/actor"
    # true count within the err bound
    assert top[1] - top[2] <= 2000 * 0.05 <= top[1] + 1e-9


def _charge_stream(n_events: int, seed: int, n_labels: int):
    """Deterministic skewed charge stream: (label, seconds) pairs."""
    rng = random.Random(seed)
    out = []
    for _ in range(n_events):
        z = rng.paretovariate(1.3)
        label = f"Grain/key-{min(int(z * 3), n_labels - 1):03d}"
        out.append((label, round(rng.uniform(0.001, 0.01), 6)))
    return out


@pytest.mark.parametrize("seed", [3, 11, 42])
def test_sketch_merge_invariant_across_splits(seed):
    """Property: while per-silo sketches stay exact (label cardinality
    ≤ k — no evictions), one charge stream split across 1, 2, or 4
    'silos' merges to the SAME answer regardless of the split or the
    snapshot order — silo count cannot change the cluster ranking."""
    stream = _charge_stream(600, seed, n_labels=16)
    merges = []
    for n_silos in (1, 2, 4):
        sketches = [SpaceSavingSketch(16) for _ in range(n_silos)]
        for i, (label, amount) in enumerate(stream):
            sketches[i % n_silos].add(label, amount)
        assert all(s.overflow == 0 for s in sketches)
        snaps = [s.snapshot() for s in sketches]
        for order in (snaps, list(reversed(snaps))):
            merges.append(SpaceSavingSketch.merge(order, k=16))
    for m in merges[1:]:
        assert m["counts"].keys() == merges[0]["counts"].keys()
        for label, (count, err) in m["counts"].items():
            c0, _e0 = merges[0]["counts"][label]
            assert count == pytest.approx(c0, abs=1e-9)
        assert m["k"] == merges[0]["k"]


@pytest.mark.parametrize("seed", [5, 23])
def test_sketch_merge_order_independent_under_eviction(seed):
    """Property: even when every per-silo sketch overflowed (wide label
    space ≫ k), merging the SAME four snapshots in any order gives one
    byte-identical answer — the flat fold has no pairwise path to
    disagree over."""
    rng = random.Random(seed)
    sketches = [SpaceSavingSketch(8) for _ in range(4)]
    for i, (label, amount) in enumerate(
            _charge_stream(800, seed, n_labels=120)):
        sketches[i % 4].add(label, amount)
    assert all(s.overflow > 0 for s in sketches)
    snaps = [s.snapshot() for s in sketches]
    base = SpaceSavingSketch.merge(snaps)
    for _ in range(6):
        order = snaps[:]
        rng.shuffle(order)
        m = SpaceSavingSketch.merge(order)
        assert m["counts"] == base["counts"]
        assert m["overflow"] == base["overflow"] and m["k"] == base["k"]


def test_ledger_merge_sums_tables_and_names_worst():
    a, b = CostLedger(top_k=8), CostLedger(top_k=8)
    a.charge_turn("IEcho", "ping", 0.2, queue_s=0.1, key="Echo/1")
    b.charge_turn("IEcho", "ping", 0.3, key="Echo/1")
    b.charge_turn("IEcho", "ping", 0.1, key="Echo/2")
    a.charge_tick(("Vec", "add", 8, 0.01, ()))
    a.charge_wire("peer:x", rx=100, tx=50)
    b.charge_wire("peer:x", rx=10, tx=5)
    b.charge_stream("ns", 7)
    merged = CostLedger.merge([a.snapshot(), b.snapshot()])
    assert merged["turns"]["IEcho.ping"] == [3, pytest.approx(0.6),
                                             pytest.approx(0.1)]
    assert merged["device"]["Vec.add"] == [1, 8, pytest.approx(0.08)]
    assert merged["wire"]["peer:x"] == [110, 55]
    assert merged["streams"]["ns"] == 7
    assert merged["worst_burner"]["key"] == "Echo/1"
    assert merged["worst_burner"]["seconds"] == pytest.approx(0.6)
    # merge of empty snapshots stays well-formed
    empty = CostLedger.merge([{}, {}])
    assert empty["worst_burner"] is None and empty["worst_tenant"] is None


def test_ledger_row_cap_counts_overflow():
    led = CostLedger()
    from orleans_tpu_torch.observability import ledger as mod
    for i in range(mod._MAX_ROWS + 5):
        led.charge_turn(f"I{i}", "m", 0.001)
    assert len(led.turns) == mod._MAX_ROWS
    assert led.row_overflow == 5


def test_tenant_hook_wins_over_baggage():
    led = CostLedger(top_k=4, tenant_of=lambda label: "hooked")
    led.charge_turn("I", "m", 0.1, key="G/1")
    assert led.top_burners(1)[0]["tenant"] == "hooked"
    led2 = CostLedger(top_k=4)
    RequestContext.set(TENANT_KEY, "bagged")
    try:
        led2.charge_turn("I", "m", 0.1, key="G/1")
    finally:
        RequestContext.remove(TENANT_KEY)
    assert ("bagged", pytest.approx(0.1), 0.0) in led2.tenants.top()


# ---------------------------------------------------------------------------
# Disabled = costs nothing
# ---------------------------------------------------------------------------

@bounded
async def test_disabled_ledger_constructs_nothing():
    """``ledger_enabled=False`` (the default) wires NO ledger anywhere:
    no object, no gauges, no per-turn charge branch beyond a None check."""
    b = SiloBuilder().with_name("led-off").add_grains(EchoGrain)
    add_vector_grains(b, CounterVec, mesh=make_mesh(1, device="cpu"),
                      capacity_per_shard=16)
    silo = b.build()
    await silo.start()
    client = await ClusterClient(silo.fabric).connect()
    try:
        assert silo.ledger is None
        assert silo.dispatcher._ledger is None
        assert silo.vector.ledger is None
        assert silo.vector.track_cost is False
        assert await client.get_grain(EchoGrain, 1).ping(3) == 3
        assert float(await client.get_grain(CounterVec, 1).add(x=1.0)) == 1.0
        assert silo.vector.table(CounterVec).cost is None
        snap = silo.stats.snapshot()
        gauges = snap.get("gauges", snap)
        assert not any(k.startswith("ledger.") for k in gauges)
    finally:
        await client.close_async()
        await silo.stop()


# ---------------------------------------------------------------------------
# Host tier: dispatcher + hot lane turns, tenant attribution
# ---------------------------------------------------------------------------

@bounded
async def test_host_turns_charged_with_key_and_tenant():
    b = (SiloBuilder().with_name("led-host").add_grains(EchoGrain)
         .with_config(ledger_enabled=True, ledger_top_k=8))
    silo = b.build()
    await silo.start()
    client = await ClusterClient(silo.fabric).connect()
    try:
        g = client.get_grain(EchoGrain, 7)
        for i in range(5):
            assert await g.ping(i) == i
        # baggage-carrying call: declined by the hot lane, charged by the
        # dispatcher epilogue with the caller's tenant tag
        RequestContext.set(TENANT_KEY, "acme")
        try:
            assert await g.ping(99) == 99
        finally:
            RequestContext.remove(TENANT_KEY)
        led = silo.ledger
        row = led.turns[("EchoGrain", "ping")]
        assert row[0] >= 6 and row[1] > 0.0
        labels = [r[0] for r in led.keys.top()]
        assert "EchoGrain/7" in labels
        assert any(t[0] == "acme" for t in led.tenants.top())
        # gauges registered and live
        assert silo.stats.gauge(LEDGER_STATS["turn_seconds"]) > 0.0
        assert silo.stats.gauge(LEDGER_STATS["charges"]) >= 6
        burner = led.top_burners(1)[0]
        assert burner["key"] == "EchoGrain/7"
    finally:
        await client.close_async()
        await silo.stop()


# ---------------------------------------------------------------------------
# Device tier: engine charges + the on-device cost twin
# ---------------------------------------------------------------------------

def _vector_silo(name, *, offloop: bool, tenant_of=None, n_shards=1):
    b = (SiloBuilder().with_name(name).add_grains(EchoGrain)
         .with_config(ledger_enabled=True, ledger_top_k=16,
                      ledger_tenant_of=tenant_of, offloop_tick=offloop))
    add_vector_grains(b, CounterVec, mesh=make_mesh(n_shards, device="cpu"),
                      capacity_per_shard=16)
    return b.build()


@bounded
async def test_device_ticks_charged_inline():
    silo = _vector_silo("led-dev", offloop=False,
                        tenant_of=lambda label: "vec-tenant")
    await silo.start()
    client = await ClusterClient(silo.fabric).connect()
    try:
        refs = [client.get_grain(CounterVec, k) for k in range(4)]
        for rnd in range(3):
            await asyncio.gather(*(r.add(x=1.0) for r in refs))
        led = silo.ledger
        row = led.device[("CounterVec", "add")]
        assert row[1] >= 12 and row[2] > 0.0          # rows, row-seconds
        assert led.total_row_seconds() > 0.0
        # per-key device labels + hook tenancy (no baggage on batches)
        assert any(lbl.startswith("CounterVec#")
                   for lbl, _c, _e in led.keys.top())
        assert any(t[0] == "vec-tenant" for t in led.tenants.top())
        # the on-device twin was enabled by hosting and accumulated
        tbl = silo.vector.table(CounterVec)
        assert silo.vector.track_cost and tbl.cost is not None
        assert tbl.cost_seconds() > 0.0
        assert led.charges > 0
    finally:
        await client.close_async()
        await silo.stop()


@bounded
async def test_offloop_tick_charges_replay_loop_side(debug_pool):
    """The tick worker may not touch the loop-confined ledger: charges
    stamp into the job's deferred list and replay in _complete_job.
    Runs under ORLEANS_TPU_DEBUG_POOL=1 so the charged batched path also
    proves pool discipline."""
    silo = _vector_silo("led-offloop", offloop=True)
    await silo.start()
    client = await ClusterClient(silo.fabric).connect()
    try:
        for rnd in range(3):
            futs = client.call_batch(
                CounterVec, "add",
                [(k, {"x": float(rnd + 1)}) for k in range(8)])
            await asyncio.gather(*futs)
        await silo.vector.flush()
        led = silo.ledger
        assert ("CounterVec", "add") in led.device
        assert led.device[("CounterVec", "add")][1] >= 24
        assert led.total_row_seconds() > 0.0
        assert silo.vector.table(CounterVec).cost_seconds() > 0.0
    finally:
        await client.close_async()
        await silo.stop()


def test_table_cost_twin_mirrors_moves_and_growth():
    """record_cost accumulates per-slot µs beside the hit counters; the
    sink column is excluded from cost_seconds; move_rows carries a row's
    accumulated cost to its new shard; grow preserves it."""
    tbl = ShardedActorTable(CounterVec, mesh=make_mesh(2, device="cpu"),
                            capacity_per_shard=8)
    tbl.enable_cost_tracking()
    shard, slot, _fresh = tbl.lookup_or_allocate(2)   # key 2 -> shard 0
    assert (shard, slot) == (0, 0)
    slots_b = np.full((2, 4), tbl.sink_slot, np.int32)
    valid_b = np.zeros((2, 4), bool)
    slots_b[shard, 0] = slot
    valid_b[shard, 0] = True
    tbl.record_cost(torch.as_tensor(slots_b), torch.as_tensor(valid_b), 1500)
    tbl.record_cost(torch.as_tensor(slots_b), torch.as_tensor(valid_b), 500)
    assert tbl.slot_cost()[shard, slot] == 2000
    # padding lanes addressed the sink row; the fold masks it out
    assert tbl.cost_seconds() == pytest.approx(2000e-6)
    # live migration carries the charge, zeroes the source
    assert tbl.move_rows(np.array([2], np.int64),
                         np.array([1], np.int32)) == 1
    new_shard, new_slot = tbl.key_to_slot[2]
    assert new_shard == 1
    cost = tbl.slot_cost()
    assert cost[1, new_slot] == 2000 and cost[0, slot] == 0
    assert tbl.cost_seconds() == pytest.approx(2000e-6)
    # growth preserves accumulated cost at the old slots
    tbl.grow(32)
    assert tbl.slot_cost()[1, new_slot] == 2000
    tbl.reset_cost()
    assert tbl.cost_seconds() == 0.0


# ---------------------------------------------------------------------------
# Wire tier: socket fabric routes, egress-shard stamp-and-replay
# ---------------------------------------------------------------------------

class _PinDirector:
    def __init__(self, pinned):
        self.pinned = pinned

    def place(self, grain_id, requester, silos):
        return self.pinned if self.pinned in silos else silos[0]


class PinnedEcho(Grain):
    __orleans_placement__ = "pin_led"

    async def ping(self, x: int) -> int:
        return x


_FAST = dict(
    membership_probe_period=0.1, membership_probe_timeout=0.2,
    membership_missed_probes_limit=2, membership_votes_needed=1,
    membership_iam_alive_period=0.5, membership_refresh_period=0.2,
    membership_vote_expiration=5.0, response_timeout=5.0,
    ledger_enabled=True,
)


async def _socket_pair(tmp_path, **cfg):
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    silos = []
    for i in (1, 2):
        silo = (SiloBuilder().with_name(f"led-sock{i}")
                .with_fabric(SocketFabric())
                .add_grains(EchoGrain, PinnedEcho)
                .with_config(**{**_FAST, **cfg}).build())
        join_cluster(silo, table)
        await silo.start()
        silos.append(silo)
    s1, s2 = silos
    while not all(len(s.membership.active) == 2 for s in silos):
        await asyncio.sleep(0.05)
    for s in silos:
        s.locator.placement.directors["pin_led"] = \
            _PinDirector(s2.silo_address)
    return s1, s2


async def _wait_for(cond, timeout=5.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, \
            "condition not reached"
        await asyncio.sleep(0.05)


@bounded
async def test_wire_bytes_charged_per_route_single_loop(tmp_path):
    """Gateway→s1→peer s2 traffic: s1 charges client rx/tx plus peer tx,
    s2 charges peer rx — every byte lands on a named route."""
    s1, s2 = await _socket_pair(tmp_path)
    client = await GatewayClient(
        [s1.silo_address.endpoint], response_timeout=5.0).connect()
    try:
        g = client.get_grain(PinnedEcho, 5)
        for i in range(6):
            assert await g.ping(i) == i
        led1, led2 = s1.ledger, s2.ledger
        await _wait_for(lambda: any(r.startswith("client:")
                                    for r in led1.wire))
        assert any(r.startswith("in:") and v[0] > 0
                   for r, v in led1.wire.items())       # gateway ingress
        assert any(r.startswith("client:") and v[1] > 0
                   for r, v in led1.wire.items())       # responses out
        await _wait_for(lambda: any(
            r.startswith("peer:") and v[1] > 0 for r, v in led1.wire.items()))
        await _wait_for(lambda: any(
            r.startswith("in:") and v[0] > 0 for r, v in led2.wire.items()))
        rx, tx = led1.total_wire()
        assert rx > 0 and tx > 0
    finally:
        await client.close_async()
        await s2.stop()
        await s1.stop()


@bounded
async def test_wire_charges_replay_from_egress_shards(tmp_path):
    """ingress_loops=2 + egress_shards=2: wire bytes measured on shard
    loops ride the stat rings as (WIRE_STAMP, ...) stamps and replay on
    the main loop — the sharded half of the OTPU007 discipline, live."""
    s1, s2 = await _socket_pair(tmp_path, ingress_loops=2, egress_shards=2)
    client = await GatewayClient(
        [s1.silo_address.endpoint], response_timeout=5.0).connect()
    try:
        g = client.get_grain(PinnedEcho, 9)
        for i in range(10):
            assert await g.ping(i) == i
        led1, led2 = s1.ledger, s2.ledger
        # ingress shards tag rx by shard route
        await _wait_for(lambda: any(r.startswith("in:shard") and v[0] > 0
                                    for r, v in led1.wire.items()))
        # shard-side peer sends replay through the stat ring
        await _wait_for(lambda: any(r.startswith("peer:") and v[1] > 0
                                    for r, v in led1.wire.items()))
        await _wait_for(lambda: any(r.startswith("peer:") and v[1] > 0
                                    for r, v in led2.wire.items()))
    finally:
        await client.close_async()
        await s2.stop()
        await s1.stop()


# ---------------------------------------------------------------------------
# Management surface: ctl_ledger + cluster merge
# ---------------------------------------------------------------------------

@bounded
async def test_ctl_ledger_and_cluster_merge_names_worst_burner():
    cluster = (TestClusterBuilder(2).add_grains(EchoGrain)
               .with_config(ledger_enabled=True, ledger_top_k=8,
                            ledger_tenant_of=lambda label:
                            f"tenant-{label.split('/')[-1]}")
               .build())
    async with cluster:
        hot = cluster.grain(EchoGrain, "hot")
        cold = cluster.grain(EchoGrain, "cold")
        for i in range(12):
            await hot.ping(i)
        # dominate the bill with real exec seconds (~100 ms) so the
        # worst-burner ranking cannot be inverted by scheduler noise
        # under a cold ping
        await hot.burn(2_000_000)
        await cold.ping(0)
        mgmt = cluster.client.get_grain(ManagementGrain, 0)
        merged = await mgmt.get_cluster_ledger(8)
        assert merged["worst_burner"]["key"] == "EchoGrain/hot"
        assert merged["worst_tenant"]["tenant"] == "tenant-hot"
        assert merged["turns"]["EchoGrain.ping"][0] >= 13
        assert set(merged["per_silo"]) == \
            {str(s.silo_address) for s in cluster.silos}
        # the SLO drill-down shape rides ctl_slo only when SLO is on;
        # the per-silo leaf is always queryable
        leaf = await cluster.silos[0].silo_control.ctl_ledger(4)
        assert "top_burners" in leaf and "keys" in leaf


# ---------------------------------------------------------------------------
# Parity: the same calls give the same ledger and metrics counts
# ---------------------------------------------------------------------------

def _jax_pkg():
    """The JAX package's silo pieces and its grains of the same names."""
    import jax.numpy as jnp

    import orleans_tpu.dispatch as jd
    import orleans_tpu.parallel as jp
    import orleans_tpu.runtime as jr

    class EchoGrain(jr.Grain):
        async def ping(self, x: int) -> int:
            return x

    class CounterVec(jd.VectorGrain):
        STATE = {"total": (jnp.float32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"total": jnp.float32(0.0)}

        @jd.actor_method(args={"x": (jnp.float32, ())})
        def add(state, args):
            return ({"total": state["total"] + args["x"]},
                    state["total"] + args["x"])

    return (jr, lambda b: jd.add_vector_grains(
        b, CounterVec, mesh=jp.make_mesh(1), capacity_per_shard=16),
        EchoGrain, CounterVec)


def _port_pkg():
    import orleans_tpu_torch.runtime as tr
    return (tr, lambda b: add_vector_grains(
        b, CounterVec, mesh=make_mesh(1, device="cpu"),
        capacity_per_shard=16), EchoGrain, CounterVec)


async def _observed_counts(pkg) -> dict:
    rt, add_vec, echo, vec = pkg
    b = (rt.SiloBuilder().with_name("led-par").add_grains(echo)
         .with_config(ledger_enabled=True, ledger_top_k=16,
                      metrics_enabled=True, offloop_tick=False))
    add_vec(b)
    silo = b.build()
    await silo.start()
    client = await rt.ClusterClient(silo.fabric).connect()
    try:
        g = client.get_grain(echo, 7)
        pings = [await g.ping(i) for i in range(5)]
        refs = [client.get_grain(vec, k) for k in range(4)]
        adds = []
        for _ in range(3):
            adds += [float(v) for v in
                     await asyncio.gather(*(r.add(x=1.0) for r in refs))]
        led = silo.ledger
        snap = silo.stats.snapshot()
        return {
            "answers": (pings, adds),
            "counters": snap["counters"],
            "histogram_counts": {k: h["count"]
                                 for k, h in snap["histograms"].items()},
            "turns": {k: v[0] for k, v in led.turns.items()},
            "device": {k: v[:2] for k, v in led.device.items()},
            "keys": sorted(led.keys.counts),
            "charges": led.charges,
            "row_seconds_positive": led.total_row_seconds() > 0,
        }
    finally:
        await client.close_async()
        await silo.stop()


async def test_same_calls_give_the_jax_package_ledger_and_metrics_counts():
    """Host pings and device adds through a silo with the ledger and
    metrics on: the ledger's turn and device counts, its key labels and
    charges, and the metrics registry's counters and histogram counts are
    those of the JAX package's silo for the same calls."""
    j = await asyncio.wait_for(_observed_counts(_jax_pkg()), TIMEOUT)
    t = await asyncio.wait_for(_observed_counts(_port_pkg()), TIMEOUT)
    assert t == j
    assert t["device"][("CounterVec", "add")][1] == 12
    assert t["counters"]["ingest.messages"] == 12
    assert t["row_seconds_positive"]
