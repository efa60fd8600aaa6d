"""The port's multi-process silos (orleans_tpu_torch.runtime.multiproc):
forked SO_REUSEPORT worker processes and shared-memory staging rings, on
the CPU over real localhost sockets.

* The port's copy of tests/test_multiprocess_silo.py: a pickle-only child
  process negotiating the codec with a native parent, ``worker_procs=2``
  accumulator reads equal to ``worker_procs=1`` under pool poisoning,
  SIGKILL of a worker, a real cross-process cluster with a kill, the
  trace waterfall across the rings, and the per-worker ledger.
* The same call sequence gives the same accumulator reads through the
  JAX package's silo.
* The owner serves no client ingress once its workers are ready: no
  client route on the owner, every client route relayed to a worker,
  and the advertised listener closed in the owner.
* A forked worker never initializes CUDA (``describe()`` reports it from
  each worker's ready and exit records), and in a process marked as a
  worker the device entry points raise ``WorkerProcessError`` while the
  profiler captures the CPU only without a ``torch.cuda`` call.
* A torch tensor in a ring record is refused at push
  (``WireTypeError`` naming the type), on the request ring and on the
  response ring.

Every silo binds 127.0.0.1, and every async body runs under
``asyncio.wait_for(..., 30)``.
"""

import asyncio
import functools
import multiprocessing
import os
import signal
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orleans_tpu.dispatch as jd
import orleans_tpu.membership as jm
import orleans_tpu.parallel as jp
import orleans_tpu.runtime as jr
import orleans_tpu_torch.dispatch as td
from orleans_tpu_torch.core.errors import SiloUnavailableError
from orleans_tpu_torch.core.ids import SiloAddress
from orleans_tpu_torch.core.serialization import WireTypeError
from orleans_tpu_torch.membership import FileMembershipTable, join_cluster
from orleans_tpu_torch.parallel import make_mesh
from orleans_tpu_torch.runtime import Grain, SiloBuilder
from orleans_tpu_torch.runtime import multiproc as mp
from orleans_tpu_torch.runtime.socket_fabric import (GatewayClient,
                                                     SocketFabric)

pytestmark = pytest.mark.skipif(sys.platform == "win32", reason="posix only")

TIMEOUT = 30


def bounded(fn):
    """Run the test coroutine under ``asyncio.wait_for(..., TIMEOUT)``."""
    @functools.wraps(fn)
    async def run(*args, **kwargs):
        await asyncio.wait_for(fn(*args, **kwargs), TIMEOUT)
    return run


class EchoGrain(Grain):
    async def echo(self, x):
        return f"{self.primary_key}:{x}"

    async def where(self) -> str:
        return self._activation.runtime.silo_address.endpoint


# one source of truth for liveness tuning — asymmetric probe timings
# between the two processes would make kill detection flaky
LIVENESS = dict(membership_probe_period=0.25,
                membership_probe_timeout=1.0,
                membership_missed_probes_limit=2,
                membership_votes_needed=1,
                membership_iam_alive_period=0.5,
                membership_refresh_period=0.2)


CHILD = textwrap.dedent("""
    import asyncio, sys
    sys.path.insert(0, {repo!r})
    from orleans_tpu_torch.membership import FileMembershipTable, join_cluster
    from orleans_tpu_torch.runtime import Grain, SiloBuilder
    from orleans_tpu_torch.runtime.socket_fabric import SocketFabric

    class EchoGrain(Grain):
        async def echo(self, x):
            return f"{{self.primary_key}}:{{x}}"

        async def where(self) -> str:
            return self._activation.runtime.silo_address.endpoint

    async def main():
        table = FileMembershipTable({table!r})
        silo = (SiloBuilder().with_name("child").with_fabric(SocketFabric())
                .add_grains(EchoGrain)
                .with_config(**{cfg!r})).build()
        join_cluster(silo, table)
        await silo.start()
        print("CHILD-READY", silo.silo_address.endpoint, flush=True)
        await asyncio.sleep(3600)

    asyncio.run(main())
""")


async def _converged(silo, n):
    """Parent-side convergence: membership and placement views both at n."""
    while len(silo.membership.active) != n or \
            len(silo.locator.alive_list) != n:
        await asyncio.sleep(0.05)


async def _spread_over_both(client, parent_ep, deadline_s=20.0):
    """Touch grains until placement lands some in EACH process and return
    (child_endpoint, child_keys); fresh keys per attempt (a child that has
    not yet refreshed to see the parent places its share on itself)."""
    deadline = time.monotonic() + deadline_s
    base = 0
    while True:
        keys = list(range(base, base + 32))
        wheres = await asyncio.gather(
            *(client.get_grain(EchoGrain, k).where() for k in keys))
        endpoints = set(wheres)
        if len(endpoints) == 2:
            child_ep = next(e for e in endpoints if e != parent_ep)
            return child_ep, [k for k, w in zip(keys, wheres)
                              if w == child_ep]
        assert time.monotonic() < deadline, \
            f"placement never spread over both processes: {endpoints}"
        base += 32
        await asyncio.sleep(0.5)


def _start_child(tmp_path, table_path, **env):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.Popen(
        [sys.executable, "-c",
         CHILD.format(repo=repo, table=table_path, cfg=LIVENESS)],
        stdout=subprocess.PIPE, stderr=open(tmp_path / "child.err", "w"),
        text=True, env={**os.environ, **env})


async def _child_ready(child, tmp_path):
    loop = asyncio.get_running_loop()
    line = await asyncio.wait_for(
        loop.run_in_executor(None, child.stdout.readline), timeout=25)
    assert line.startswith("CHILD-READY"), (
        line, (tmp_path / "child.err").read_text()[-2000:])


@bounded
async def test_mixed_build_cluster_negotiates_codec(tmp_path):
    """A silo whose native hotwire build is unavailable interoperates with
    a native-enabled peer: the handshake advertises codec support and each
    link falls back to pickle toward the pickle-only peer."""
    from orleans_tpu_torch.core import serialization as ser
    if ser._hotwire is None:
        pytest.skip("native codec unavailable in this build")

    table_path = str(tmp_path / "mbr.json")
    child = _start_child(tmp_path, table_path, ORLEANS_TPU_NATIVE="0")
    silo = None
    client = None
    try:
        await _child_ready(child, tmp_path)
        silo = (SiloBuilder().with_name("parent").with_fabric(SocketFabric())
                .add_grains(EchoGrain)
                .with_config(**LIVENESS)).build()
        join_cluster(silo, FileMembershipTable(table_path))
        await silo.start()
        await asyncio.wait_for(_converged(silo, 2), timeout=15)
        client = await GatewayClient(
            [silo.silo_address.endpoint], response_timeout=10.0).connect()
        child_ep, child_keys = await _spread_over_both(
            client, silo.silo_address.endpoint)
        # round-trips through the pickle-only child prove both directions
        # negotiated down (a hotwire frame would be undecodable there)
        outs = await asyncio.gather(
            *(client.get_grain(EchoGrain, k).echo("mixed")
              for k in child_keys))
        assert outs == [f"{k}:mixed" for k in child_keys]
    finally:
        try:
            if child.poll() is None:
                child.kill()
            child.wait(timeout=10)
        finally:
            try:
                if client is not None:
                    await client.close_async()
            finally:
                if silo is not None:
                    await silo.stop()


# --------------------------------------------------------------------------
# worker_procs silos: forked SO_REUSEPORT workers + shm rings
# --------------------------------------------------------------------------

def _vector_grain():
    """Deterministic accumulating vector grain: ``add`` folds each call's
    float into per-key state, so the same call sequence gives the same
    accumulator reads whichever way the calls reach the engine."""
    class AccumVec(td.VectorGrain):
        STATE = {"acc": (torch.float32, ()), "n": (torch.int32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"acc": key_hash.new_zeros((), dtype=torch.float32),
                    "n": torch.zeros_like(key_hash)}

        @td.actor_method(args={"x": (torch.float32, ())})
        def add(state, args):
            new = {"acc": state["acc"] + args["x"], "n": state["n"] + 1}
            return new, new["acc"]

    return AccumVec


def _jax_vector_grain():
    """The JAX package's AccumVec (same ``__name__``: the name is part of
    every hashed key's GrainId)."""
    class AccumVec(jd.VectorGrain):
        STATE = {"acc": (jnp.float32, ()), "n": (jnp.int32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"acc": jnp.float32(0), "n": jnp.int32(0)}

        @jd.actor_method(args={"x": (jnp.float32, ())})
        def add(state, args):
            new = {"acc": state["acc"] + args["x"], "n": state["n"] + 1}
            return new, new["acc"]

    return AccumVec


def _build_mp_silo(table_path, vec_cls, worker_procs, name="mp", **cfg):
    b = (SiloBuilder().with_name(name).with_fabric(SocketFabric())
         .add_grains(EchoGrain)
         .with_config(**LIVENESS, worker_procs=worker_procs, **cfg))
    td.add_vector_grains(b, vec_cls, mesh=make_mesh(8, device="cpu"),
                         capacity_per_shard=32)
    silo = b.build()
    join_cluster(silo, FileMembershipTable(table_path))
    return silo


async def _accum_sequence(endpoint, vec_cls, gateway_client=GatewayClient,
                          n_clients=4, keys=24, rounds=3):
    """The shared parity workload: ``rounds`` waves of one ``add`` per
    key, keys striped over ``n_clients`` gateway connections, results
    collected IN ORDER. Returns the flat list of accumulator reads."""
    clients = []
    out = []
    try:
        for _ in range(n_clients):
            clients.append(await gateway_client(
                [endpoint], response_timeout=15.0).connect())
        for r in range(rounds):
            vals = await asyncio.gather(*(
                clients[k % n_clients].get_grain(vec_cls, k)
                .add(x=float(k) * 0.5 + r)
                for k in range(keys)))
            out.extend(float(v) for v in vals)
    finally:
        for c in clients:
            await c.close_async()
    return out


def _assert_rings_drained(d):
    # clean-shutdown accounting: every staged record drained, every
    # completion delivered (single-writer cumulative counters)
    assert all(w["req_pushed"] == w["req_drained"] and
               w["resp_pushed"] == w["resp_drained"]
               for w in d["workers"]), d


@bounded
async def test_worker_procs_vector_parity_debug_pool(tmp_path):
    """The same call sequence against worker_procs=1 and worker_procs=2
    silos gives IDENTICAL accumulator reads — the rings change where the
    bytes travel, never what the engine computes — under debug
    pool-poisoning (forked workers inherit the flag)."""
    from orleans_tpu_torch.core.message import set_debug_pool

    vec_cls = _vector_grain()
    prev = set_debug_pool(True)
    try:
        results = {}
        for procs in (1, 2):
            silo = _build_mp_silo(str(tmp_path / f"mbr{procs}.json"),
                                  vec_cls, procs, name=f"par{procs}")
            await silo.start()
            try:
                results[procs] = await _accum_sequence(
                    silo.gateway_endpoint, vec_cls)
                if procs == 2:
                    d = silo.workers.describe()
                    _assert_rings_drained(d)
                    # every one of the 24 keys x 3 rounds staged exactly
                    # one message (route/ready records count 0)
                    assert sum(w["req_pushed"]
                               for w in d["workers"]) == 24 * 3, d
            finally:
                await silo.stop()
        assert results[2] == results[1], (
            "shm-ring vector path diverged from the in-process path")
    finally:
        set_debug_pool(prev)


async def _jax_accum_sequence(table_path):
    vec_cls = _jax_vector_grain()
    b = (jr.SiloBuilder().with_name("jaxpar")
         .with_fabric(jr.SocketFabric())
         .with_config(**LIVENESS))
    jd.add_vector_grains(b, vec_cls, mesh=jp.make_mesh(8),
                         capacity_per_shard=32)
    silo = b.build()
    jm.join_cluster(silo, jm.FileMembershipTable(table_path))
    await silo.start()
    try:
        return await _accum_sequence(silo.silo_address.endpoint, vec_cls,
                                     gateway_client=jr.GatewayClient)
    finally:
        await silo.stop()


async def test_worker_procs_reads_equal_the_jax_package():
    """The port's worker_procs=2 silo and the JAX package's silo give the
    same accumulator reads for the same call sequence (float32 adds in
    the same order: exact)."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        silo = _build_mp_silo(os.path.join(d, "t.json"), _vector_grain(), 2,
                              name="tpar")

        async def port():
            await silo.start()
            try:
                return await _accum_sequence(silo.gateway_endpoint,
                                             silo.vector_interfaces[
                                                 "AccumVec"])
            finally:
                await silo.stop()

        t = await asyncio.wait_for(port(), TIMEOUT)
        j = await asyncio.wait_for(
            _jax_accum_sequence(os.path.join(d, "j.json")), TIMEOUT)
    assert t == j
    assert len(t) == 72 and t[:3] == [0.0, 0.5, 1.0]


@bounded
async def test_worker_sigkill_rebalance(tmp_path):
    """SIGKILL one worker mid-traffic: new connections land on the
    survivor, the owner's probes declare the worker silo dead, the
    supervisor drops its relay routes, and traffic through the survivor —
    host and vector — keeps answering; the survivor's rings still account
    every staged record."""
    vec_cls = _vector_grain()
    silo = _build_mp_silo(str(tmp_path / "mbr.json"), vec_cls, 2,
                          name="killmp")
    await silo.start()
    clients = []
    try:
        for _ in range(4):
            clients.append(await GatewayClient(
                [silo.gateway_endpoint], response_timeout=15.0).connect())
        vals = await asyncio.gather(*(
            clients[k % 4].get_grain(vec_cls, k).add(x=1.0)
            for k in range(16)))
        assert [float(v) for v in vals] == [1.0] * 16

        d = silo.workers.describe()
        assert sum(w["client_routes"] for w in d["workers"]) == 4
        victim = d["workers"][0]
        survivor = d["workers"][1]
        os.kill(victim["pid"], signal.SIGKILL)

        async def worker_reaped():
            while True:
                dd = silo.workers.describe()
                if not dd["workers"][0]["alive"]:
                    return
                await asyncio.sleep(0.1)
        await asyncio.wait_for(worker_reaped(), timeout=10)

        async def declared_dead():
            while not any(victim["silo"] in str(a)
                          for a in silo.membership.dead):
                await asyncio.sleep(0.1)
        await asyncio.wait_for(declared_dead(), timeout=15)

        fresh = []
        for _ in range(3):
            fresh.append(await GatewayClient(
                [silo.gateway_endpoint], response_timeout=15.0).connect())
        clients.extend(fresh)
        vals = await asyncio.gather(*(
            c.get_grain(vec_cls, 100 + i).add(x=2.0)
            for i, c in enumerate(fresh)))
        assert [float(v) for v in vals] == [2.0] * 3
        outs = await asyncio.gather(*(
            c.get_grain(EchoGrain, 200 + i).echo("hi")
            for i, c in enumerate(fresh)))
        assert outs == [f"{200 + i}:hi" for i in range(3)]

        d2 = silo.workers.describe()
        assert d2["workers"][0]["client_routes"] == 0, d2
        assert d2["workers"][1]["client_routes"] >= 3, d2
        assert d2["workers"][1]["alive"]
        assert survivor["silo"] == d2["workers"][1]["silo"]
        w = d2["workers"][1]
        assert w["req_pushed"] == w["req_drained"], d2
        assert w["resp_pushed"] == w["resp_drained"], d2
    finally:
        for c in clients:
            try:
                await c.close_async()
            except Exception:  # noqa: BLE001 — a client of the dead worker
                pass
        await silo.stop()


@bounded
async def test_cross_os_process_cluster_and_kill(tmp_path):
    """A silo in a child interpreter joined through the file membership
    table: calls cross the process boundary, and after SIGKILL probes
    declare it dead and its grains re-place onto the survivor."""
    table_path = str(tmp_path / "mbr.json")
    child = _start_child(tmp_path, table_path)
    silo = None
    client = None
    try:
        await _child_ready(child, tmp_path)
        silo = (SiloBuilder().with_name("parent").with_fabric(SocketFabric())
                .add_grains(EchoGrain)
                .with_config(**LIVENESS)).build()
        join_cluster(silo, FileMembershipTable(table_path))
        await silo.start()
        await asyncio.wait_for(_converged(silo, 2), timeout=15)
        client = await GatewayClient(
            [silo.silo_address.endpoint], response_timeout=10.0).connect()
        child_ep, child_keys = await _spread_over_both(
            client, silo.silo_address.endpoint)
        outs = await asyncio.gather(
            *(client.get_grain(EchoGrain, k).echo("hi") for k in child_keys))
        assert outs == [f"{k}:hi" for k in child_keys]

        child.send_signal(signal.SIGKILL)
        child.wait(timeout=10)

        async def declared_dead():
            while not silo.membership.dead:
                await asyncio.sleep(0.1)
        await asyncio.wait_for(declared_dead(), timeout=15)

        k = child_keys[0]
        out = await asyncio.wait_for(
            client.get_grain(EchoGrain, k).echo("back"), timeout=10)
        assert out == f"{k}:back"
        assert (await client.get_grain(EchoGrain, k).where()) == \
            silo.silo_address.endpoint
    finally:
        try:
            if child.poll() is None:
                child.kill()
            child.wait(timeout=10)
        finally:
            try:
                if client is not None:
                    await client.close_async()
            finally:
                if silo is not None:
                    await silo.stop()


# --------------------------------------------------------------------------
# cross-process observability: trace context over the rings, per-worker
# ledger attribution, the cluster-wide span merge
# --------------------------------------------------------------------------

def _build_obs_mp_silo(table_path, vec_cls, worker_procs, name="obsmp"):
    """worker_procs silo with the full observability stack + management
    (workers get their own SiloControl so cluster fan-outs reach every
    process)."""
    from orleans_tpu_torch.management import add_management

    b = (SiloBuilder().with_name(name).with_fabric(SocketFabric())
         .add_grains(EchoGrain)
         .with_config(**LIVENESS, worker_procs=worker_procs,
                      metrics_enabled=True, trace_enabled=True,
                      trace_sample_rate=0.0, ledger_enabled=True))
    td.add_vector_grains(b, vec_cls, mesh=make_mesh(8, device="cpu"),
                         capacity_per_shard=32)
    add_management(b)
    silo = b.build()
    join_cluster(silo, FileMembershipTable(table_path))
    return silo


@bounded
async def test_worker_procs_trace_waterfall(tmp_path):
    """A client-rooted request through a worker process yields ONE trace
    whose cluster-merged spans cover >= 95% of the request wall as
    contiguous segments: client network leg, staging-ring dwell, owner
    queue-wait + device tick, response-ring dwell, response network leg."""
    from benchmarks.multiproc_attribution import waterfall_coverage
    from orleans_tpu_torch.management import ManagementGrain

    vec_cls = _vector_grain()
    silo = _build_obs_mp_silo(str(tmp_path / "mbr.json"), vec_cls, 2)
    await silo.start()
    client = None
    try:
        client = await GatewayClient(
            [silo.gateway_endpoint], response_timeout=15.0).connect()
        warm = float(await client.get_grain(vec_cls, 0).add(x=1.0))

        client.enable_tracing(sample_rate=1.0, name="mp-client")
        traced = float(await client.get_grain(vec_cls, 0).add(x=2.0))
        assert (warm, traced) == (1.0, 3.0)
        await asyncio.sleep(0.1)  # let done-callbacks close their spans
        cspans = client.tracer.snapshot()
        tids = [s["trace_id"] for s in cspans if s["kind"] == "client"]
        assert len(tids) == 1, cspans
        tid = tids[0]

        mgmt = client.get_grain(ManagementGrain, 0)
        spans = cspans + await mgmt.get_trace_spans(tid)
        wf = waterfall_coverage(spans, tid)

        names = {s["name"] for s in wf["segments"]}
        assert "shm.staging_ring" in names, wf
        assert "shm.response_ring" in names, wf
        assert "engine.queue_wait" in names, wf
        assert any(n.startswith("tick ") for n in names), wf
        assert {"ring", "network", "server", "device_tick"} <= \
            set(wf["kinds"]), wf
        assert wf["coverage"] >= 0.95, wf
        seg = {s["name"]: s for s in wf["segments"]}
        tick = next(s for s in wf["segments"]
                    if s["name"].startswith("tick "))
        assert seg["shm.staging_ring"]["offset_us"] <= tick["offset_us"]
        resp = seg["shm.response_ring"]
        assert resp["offset_us"] + resp["dur_us"] >= \
            tick["offset_us"] + tick["dur_us"]
        assert len({s["silo"] for s in spans
                    if s["trace_id"] == tid}) >= 3, spans
    finally:
        if client is not None:
            await client.close_async()
        await silo.stop()


@bounded
async def test_worker_procs_ledger_attribution(tmp_path):
    """Device rows charged on the owner's engine land on the ORIGINATING
    worker's ``procs`` row (exactly its staged message count, with
    row-seconds above 0), the owner's wire charges are keyed by worker
    origin, the worker gauges sum the rings, and the cluster merge is
    fold-order independent."""
    from orleans_tpu_torch.management import ManagementGrain
    from orleans_tpu_torch.observability.ledger import CostLedger

    vec_cls = _vector_grain()
    silo = _build_obs_mp_silo(str(tmp_path / "mbr.json"), vec_cls, 2,
                              name="ledmp")
    await silo.start()
    clients = []
    try:
        for _ in range(4):
            clients.append(await GatewayClient(
                [silo.gateway_endpoint], response_timeout=15.0).connect())
        vals = await asyncio.gather(*(
            clients[k % 4].get_grain(vec_cls, k).add(x=1.0)
            for k in range(24)))
        assert [float(v) for v in vals] == [1.0] * 24

        d = silo.workers.describe()
        pushed = {f"worker-{w['index']}": w["req_pushed"]
                  for w in d["workers"]}
        assert sum(pushed.values()) == 24, d

        gauges = silo.stats.snapshot()["gauges"]
        assert gauges["workers.alive"] == 2, gauges
        assert gauges["workers.req_drained"] == 24, gauges
        assert gauges["workers.req_backlog"] == 0, gauges
        assert gauges["workers.resp_pushed"] == 24, gauges

        mgmt = clients[0].get_grain(ManagementGrain, 0)
        led = await mgmt.get_cluster_ledger(5)
        procs = led["procs"]
        assert set(procs) == {o for o, n in pushed.items() if n}, led
        for origin, (rows, secs) in procs.items():
            assert rows == pushed[origin], (origin, procs, pushed)
            assert secs > 0, (origin, procs)
        for origin in procs:
            rx, tx = led["wire"][origin]
            assert rx > 0 and tx > 0, (origin, led["wire"])
        snaps = [s for s in led["per_silo"].values() if s]
        a = CostLedger.merge(snaps)
        z = CostLedger.merge(list(reversed(snaps)))
        assert a["procs"] == z["procs"] and a["wire"] == z["wire"]
    finally:
        for c in clients:
            try:
                await c.close_async()
            except Exception:  # noqa: BLE001
                pass
        await silo.stop()


@bounded
async def test_owner_serves_no_client_ingress_once_workers_are_ready(
        tmp_path):
    """The multi-process structural signal, as counts: once the workers
    are ready the owner's advertised listener is closed, the owner holds
    no client route, and every client connection is a worker's route
    that the owner relays to."""
    silo = _build_mp_silo(str(tmp_path / "mbr.json"), _vector_grain(), 2,
                          name="ingress")
    await silo.start()
    clients = []
    try:
        adv = silo.gateway_endpoint
        assert adv != silo.silo_address.endpoint
        assert adv not in silo.fabric._listen_socks
        for _ in range(4):
            clients.append(await GatewayClient(
                [adv], response_timeout=15.0).connect())
        outs = await asyncio.gather(*(
            c.get_grain(EchoGrain, i).echo("x")
            for i, c in enumerate(clients)))
        assert outs == [f"{i}:x" for i in range(4)]
        d = silo.workers.describe()
        assert sum(w["client_routes"] for w in d["workers"]) == 4, d
        assert len(silo.fabric.route_relays) == 4
        assert not silo.fabric.client_routes
    finally:
        for c in clients:
            await c.close_async()
        await silo.stop()


@bounded
async def test_owner_keeps_the_rows_its_workers_own_on_the_ring(tmp_path):
    """The workers are cluster members, so the ring gives them keys, but
    the owner's engine is the one device engine of all three processes:
    a membership view change must not release the owner's rows of keys
    the ring gives one of its own workers (the ownership sweep did, so a
    key called before the owner saw its workers join came back fresh)."""
    vec_cls = _vector_grain()
    silo = _build_mp_silo(str(tmp_path / "mbr.json"), vec_cls, 2,
                          name="sweep")
    await silo.start()
    client = None
    try:
        while len(silo.locator.alive_list) != 3:  # owner + both workers
            await asyncio.sleep(0.05)
        client = await GatewayClient(
            [silo.gateway_endpoint], response_timeout=15.0).connect()
        keys = range(24)
        first = await asyncio.gather(*(
            client.get_grain(vec_cls, k).add(x=1.0) for k in keys))
        ring = silo.locator.ring
        mine = silo.workers.silo_addresses()
        assert len(mine) == 2
        on_workers = [k for k in keys if ring.owner(
            client.get_grain(vec_cls, k).grain_id.uniform_hash) in mine]
        assert on_workers  # the ring gives the workers keys
        for listener in list(silo.membership._listeners):
            listener(silo.membership.active_silos(), [])
        await asyncio.sleep(0.1)  # the sweep runs after the view applies
        again = await asyncio.gather(*(
            client.get_grain(vec_cls, k).add(x=1.0) for k in keys))
        assert [float(v) for v in first] == [1.0] * 24
        assert [float(v) for v in again] == [2.0] * 24
    finally:
        if client is not None:
            await client.close_async()
        await silo.stop()


# --------------------------------------------------------------------------
# the fork rule and the tensor refusal on the rings
# --------------------------------------------------------------------------

def _probe_worker_process(conn) -> None:
    """Forked child: what ``_worker_main`` does first, then every device
    entry point. Runs no torch op."""
    from orleans_tpu_torch.dispatch.engine import VectorRuntime
    from orleans_tpu_torch.observability.profiling import Profiler
    from orleans_tpu_torch.parallel import mesh
    out = {}
    try:
        mesh.mark_worker_process()
        for name, fn in (("make_mesh", lambda: mesh.make_mesh(8, "cpu")),
                         ("resolve_device", lambda: mesh.resolve_device()),
                         ("VectorRuntime", lambda: VectorRuntime(
                             mesh.Mesh(8, torch.device("cpu"))))):
            try:
                fn()
                out[name] = "returned"
            except mesh.WorkerProcessError as e:
                out[name] = str(e)

        def no_cuda(*_a, **_k):
            raise AssertionError("torch.cuda called in a worker")
        torch.cuda.is_available = no_cuda
        torch.cuda.synchronize = no_cuda
        import tempfile
        with tempfile.TemporaryDirectory() as d:
            prof = Profiler()
            with prof.capture(d):
                pass
            out["profiler"] = os.path.exists(os.path.join(d, "trace.json"))
        out["cuda_initialized"] = torch.cuda.is_initialized()
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        out["error"] = repr(e)
    conn.send(out)
    conn.close()
    os._exit(0)


def test_forked_worker_never_initializes_cuda_and_refuses_the_device():
    """In a forked process marked as a worker (the first thing
    ``_worker_main`` does), ``make_mesh``, ``resolve_device`` and engine
    construction raise ``WorkerProcessError`` naming what was called,
    and the profiler captures the CPU only with ``torch.cuda`` made to
    fail on any call; CUDA stays uninitialized."""
    ctx = multiprocessing.get_context("fork")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_probe_worker_process, args=(child,))
    proc.start()
    try:
        assert parent.poll(TIMEOUT), "worker probe did not answer"
        out = parent.recv()
    finally:
        proc.join(10)
        if proc.is_alive():
            proc.kill()
    assert not proc.is_alive()
    assert "error" not in out, out
    for name in ("make_mesh", "resolve_device", "VectorRuntime"):
        assert "forked worker process" in out[name], out
    assert out["profiler"] is True
    assert out["cuda_initialized"] is False


@bounded
async def test_real_workers_report_cuda_uninitialized(tmp_path):
    """Each worker of a ``worker_procs=2`` silo reports
    ``torch.cuda.is_initialized()`` False in its ready record
    (``describe()``) and again in its exit record, which the owner's final
    sweep reads at the stop."""
    silo = _build_mp_silo(str(tmp_path / "mbr.json"), _vector_grain(), 2,
                          name="cudaflag")
    await silo.start()
    sup = silo.workers
    try:
        d = sup.describe()
        assert [w["cuda_initialized"] for w in d["workers"]] == \
            [False, False], d
        for link in sup.links:
            link.cuda_initialized = None  # the exit record must set it
    finally:
        await silo.stop()
    assert [lk.cuda_initialized for lk in sup.links] == [False, False]


@bounded
async def test_a_tensor_in_a_ring_record_is_refused_at_push():
    """A worker's vector call with a tensor argument is refused before
    its record reaches the staging ring, and an owner result holding a
    tensor fails that call with the refusal instead of crossing the
    response ring; numpy crosses as it is."""
    ring = mp._make_ring(1 << 16)
    try:
        client = mp.VectorShmClient(ring, SiloAddress("127.0.0.1", 1, 1))
        vec_cls = _vector_grain()
        with pytest.raises(WireTypeError, match="torch.Tensor"):
            client.call_group(vec_cls, "add",
                              [(1, {"x": torch.ones(())}, True)])
        assert ring.pushed_msgs == 0
        futs = client.call_group(vec_cls, "add",
                                 [(1, {"x": np.float32(1)}, True)])
        assert ring.pushed_msgs == 1
        assert mp.pickle.loads(ring.pop()[0])[4][0][3] == [[np.float32(1)]]

        assert mp.VectorShmClient.key_hash_for(5, 99) == 5
        item = mp.WorkerSupervisor._portable((7, True, torch.zeros(2)))
        assert item[0] == 7 and item[1] is False
        assert isinstance(item[2], WireTypeError)
        assert "torch.Tensor" in str(item[2])
        ok = (8, True, np.float32(2))
        assert mp.WorkerSupervisor._portable(ok) is ok
        with pytest.raises(WireTypeError):
            mp._ring_dumps(("res", [(7, True, torch.zeros(2))]))
        client.fail_all(SiloUnavailableError("test over"))
        assert futs[0].done()
    finally:
        ring.close()
        ring.shm.unlink()


# --------------------------------------------------------------------------
# the shared file membership table under writers in several processes
# --------------------------------------------------------------------------

def _table_writer(path: str, index: int, conn) -> None:
    """Forked child: join the table with a CAS insert (retried on a lost
    race), then refresh its iam-alive time and read the table 60 times."""
    from orleans_tpu_torch.membership.table import MembershipEntry

    async def run():
        table = FileMembershipTable(path)
        entry = MembershipEntry(SiloAddress("127.0.0.1", 40000 + index, 1))
        while True:
            snap = await table.read_all()
            if await table.insert_row(entry, snap.version.next()):
                break
        for i in range(60):
            await table.update_iam_alive(entry.address, float(i))
            await table.read_all()
    try:
        asyncio.run(run())
        conn.send(None)
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        conn.send(repr(e))
    conn.close()
    os._exit(0)


def test_file_table_stays_whole_under_writers_in_four_processes(tmp_path):
    """Workers of a multi-process silo share the owner's file membership
    table. Four processes writing it at once: every read decodes, and no
    CAS insert is lost (each process's row is in the table at the end,
    the version counts the four inserts). The JAX package's table writes
    one ``.tmp`` name from every process with no lock between processes,
    so writes interleave in it and a read can fail to decode."""
    path = str(tmp_path / "mbr.json")
    ctx = multiprocessing.get_context("fork")
    pipes, procs = [], []
    for i in range(4):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_table_writer, args=(path, i, child))
        p.start()
        pipes.append(parent)
        procs.append(p)
    try:
        errors = []
        for parent in pipes:
            assert parent.poll(TIMEOUT), "a table writer did not finish"
            errors.append(parent.recv())
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
    assert errors == [None] * 4, errors
    snap = asyncio.run(FileMembershipTable(path).read_all())
    assert sorted(e.address.port for e, _ in snap.entries) == \
        [40000, 40001, 40002, 40003]
    assert snap.version.version == 4
