"""The port's sharded egress (orleans_tpu_torch.runtime.multiloop's
EgressShardPool and the fabric's shard-side send), on the CPU over real
localhost sockets: the port's copy of tests/test_sharded_egress.py —
per-shard template caches byte-identical to per-frame encodes, the
thread-safe recycle, the QoS bypass and FIFO guard, bounded ring
backpressure, co-hosted silos, link affinity, clean shutdown, the encode
bounce, options validation, and the ``egress_shards=0`` parity lever
(``test_sharded_egress_parity_and_zero_constructs_nothing``: two silos
started one after the other on one loop, which the multi-loop stop
repair lets answer).

Every silo binds 127.0.0.1:0, and every async body runs under
``asyncio.wait_for(..., 30)``.
"""

import asyncio
import functools
import threading

import pytest

import orleans_tpu_torch.core.message as msg_mod
import orleans_tpu_torch.core.serialization as ser
from orleans_tpu_torch.config import ConfigurationError, MessagingOptions
from orleans_tpu_torch.core.ids import GrainId, GrainType, SiloAddress
from orleans_tpu_torch.core.message import (Category, make_request,
                                      make_response, recycle_messages,
                                      set_debug_pool)
from orleans_tpu_torch.membership import FileMembershipTable, join_cluster
from orleans_tpu_torch.runtime import (GatewayClient, Grain, SiloBuilder,
                                 SocketFabric)
from orleans_tpu_torch.runtime.multiloop import _EGRESS_RING_CAPACITY
from orleans_tpu_torch.runtime.wire import (_TMPL_CACHE_CAP, _frame_template,
                                      decode_frames, encode_message,
                                      encode_message_batch)

hw = ser._hotwire

TIMEOUT = 30


def bounded(fn):
    """Run the test coroutine under ``asyncio.wait_for(..., TIMEOUT)``."""
    @functools.wraps(fn)
    async def run(*args, **kwargs):
        await asyncio.wait_for(fn(*args, **kwargs), TIMEOUT)
    return run


GT = GrainType.of("seg.Echo")
S1 = SiloAddress("10.15.0.1", 1111, 3)
S2 = SiloAddress("10.15.0.2", 2222, 5)

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


class SeqGrain(Grain):
    def __init__(self):
        super().__init__()
        self.seen = []

    async def add(self, tag, i):
        self.seen.append((tag, i))
        return i

    async def seen_list(self):
        return list(self.seen)


class EchoGrain(Grain):
    async def echo(self, x):
        return x * 2


def _corpus(n: int = 30) -> list:
    """Responses (template candidates) interleaved with requests and the
    headers that must PEEL — the per-shard cache must reproduce the
    main-loop cache's peel rules and bytes exactly."""
    from orleans_tpu_torch.core.message import (RejectionType, make_error_response,
                                          make_rejection)
    out = []
    for i in range(n):
        req = make_request(
            target_grain=GrainId.for_grain(GT, i),
            interface_name="seg.IEcho", method_name=f"m{i % 3}",
            body=((i,), {}), sending_silo=S2, target_silo=S1,
            timeout=None)
        if i % 7 == 0:
            resp = make_rejection(req, RejectionType.TRANSIENT, "stale")
        elif i % 5 == 0:
            resp = make_error_response(req, ValueError(f"e{i}"))
        else:
            resp = make_response(req, {"r": i})
        resp.target_silo = req.sending_silo
        out.append(resp)
        if i % 3 == 0:
            out.append(req)
    return out


# ---------------------------------------------------------------------------
# Satellite: per-shard header-template caches
# ---------------------------------------------------------------------------

@pytest.mark.skipif(hw is None, reason="native toolchain unavailable")
def test_per_shard_template_cache_byte_identical_to_per_frame():
    """Property: encoding through a FRESH per-shard cache produces
    byte-identical output to the per-frame encoder (and to the shared
    main-loop cache), with identical peel rules — the cache is per-loop
    state only, never semantics."""
    msgs = _corpus()
    per_frame = b"".join(encode_message(m) for m in msgs)
    shard_cache: dict = {}
    chunks = encode_message_batch(msgs, bounce=lambda m, e: None,
                                  tmpl_cache=shard_cache)
    assert b"".join(chunks) == per_frame
    assert shard_cache, "the per-shard cache never populated"
    # decode round-trips
    consumed, decoded, bounces = decode_frames(
        bytearray(b"".join(chunks)))
    assert consumed == len(per_frame) and not bounces
    assert len(decoded) == len(msgs)
    # peel rules identical per cache: rejections never template
    from orleans_tpu_torch.core.message import RejectionType, make_rejection
    req = make_request(target_grain=GrainId.for_grain(GT, 1),
                       interface_name="seg.IEcho", method_name="m",
                       body=((), {}), sending_silo=S2, target_silo=S1,
                       timeout=None)
    rej = make_rejection(req, RejectionType.TRANSIENT, "x")
    rej.target_silo = S2
    assert _frame_template(rej, shard_cache) is None
    ok = make_response(req, 1)
    ok.target_silo = S2
    assert _frame_template(ok, shard_cache) is not None


@pytest.mark.skipif(hw is None, reason="native toolchain unavailable")
def test_per_shard_template_cache_bounded_same_cap():
    """The per-shard cache honors the SAME cap as the main-loop cache:
    at capacity it clears rather than growing without bound."""
    req = make_request(target_grain=GrainId.for_grain(GT, 1),
                       interface_name="seg.IEcho", method_name="m",
                       body=((), {}), sending_silo=S2, target_silo=S1,
                       timeout=None)
    ok = make_response(req, 1)
    ok.target_silo = S2
    cache = {("junk", i): object() for i in range(_TMPL_CACHE_CAP)}
    assert _frame_template(ok, cache) is not None
    assert len(cache) == 1  # cleared at cap, then the one live entry


# ---------------------------------------------------------------------------
# Freelist: shard-safe release
# ---------------------------------------------------------------------------

def test_recycle_messages_thread_safe_release_bounded():
    """Concurrent release sweeps from worker threads (the egress shards'
    encode-then-recycle) while the main thread acquires: no exception,
    every shell marked free, and the pool stays bounded (per-append
    capacity check — overfill is at most one shell per concurrent
    releaser)."""
    n_threads, per_thread = 4, 300
    batches = []
    for _ in range(n_threads):
        batches.append([
            make_request(target_grain=GrainId.for_grain(GT, i),
                         interface_name="seg.IEcho", method_name="m",
                         body=((), {}), sending_silo=S2, target_silo=S1,
                         timeout=None)
            for i in range(per_thread)])
    errors = []

    def release(batch):
        try:
            recycle_messages(batch)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    prev = set_debug_pool(True)  # poisoning marks even cap-dropped shells
    try:
        ts = [threading.Thread(target=release, args=(b,)) for b in batches]
        for t in ts:
            t.start()
        # concurrent acquirer on the main thread
        acquired = [make_request(
            target_grain=GrainId.for_grain(GT, i),
            interface_name="seg.IEcho",
            method_name="m", body=((), {}), timeout=None)
            for i in range(200)]
        for t in ts:
            t.join()
        assert not errors
        # every released shell is either still in the freelist state OR
        # was legitimately re-acquired by the concurrent main-thread
        # acquirer (single-ownership hand-off through the pool)
        acquired_ids = {id(a) for a in acquired}
        for b in batches:
            for m in b:
                assert m._pool_free or id(m) in acquired_ids
        assert len(msg_mod._MSG_POOL) <= msg_mod._MSG_POOL_CAP + n_threads
        recycle_messages(acquired)
    finally:
        set_debug_pool(prev)


# ---------------------------------------------------------------------------
# Ring/direct boundary units
# ---------------------------------------------------------------------------

async def _start_silo(name, *, loops=1, shards=0, grains=(), table=None,
                      **cfg):
    fabric = SocketFabric()
    silo = (SiloBuilder().with_name(name).with_fabric(fabric)
            .add_grains(SeqGrain, EchoGrain, *grains)
            .with_config(**{**FAST, "ingress_loops": loops,
                            "egress_shards": shards, **cfg}).build())
    if table is not None:
        join_cluster(silo, table)
    await silo.start()
    return silo


@bounded
async def test_qos_never_enters_egress_ring_and_fifo_guard():
    """Unit-level invariants against a live pool: (1) a SYSTEM response
    to a shard-owned peer endpoint bypasses the ring (qos_direct, ring
    counters untouched); (2) the ``flush_dest`` FIFO guard's flushed
    group enters the ring BEFORE a subsequent per-message APPLICATION
    send (ring FIFO carries the ordering across the boundary)."""
    silo = await _start_silo("segqos", shards=2)
    try:
        fabric = silo.fabric
        pool = fabric.egress_pool
        assert pool is not None and not pool.on_ingress
        dest = SiloAddress("127.0.0.1", 59990, 7)  # never dialed-to

        def mk(cat=Category.APPLICATION):
            req = make_request(
                target_grain=GrainId.for_grain(GT, 1),
                interface_name="seg.IEcho", method_name="m",
                body=((), {}), category=cat,
                sending_silo=dest, target_silo=silo.silo_address)
            resp = make_response(req, "ok")
            resp.target_silo = dest
            return req, resp

        # (1) QoS bypass: SYSTEM response rides ring-free
        req, resp = mk(Category.SYSTEM)
        silo.dispatcher.send_response(req, resp)
        assert not silo.message_center.egress.groups  # never accumulated
        shard = pool.shard_for(dest.endpoint)
        assert shard.ring.pushed_msgs == 0
        for _ in range(100):
            if shard.qos_direct:
                break
            await asyncio.sleep(0.01)
        assert shard.qos_direct == 1

        # (2) flush_dest guard: accumulate an APPLICATION group, then a
        # per-message APPLICATION send to the same dest — the flushed
        # group must be ring-pushed ahead of the singleton
        for _ in range(3):
            r2, p2 = mk()
            silo.dispatcher.send_response(r2, p2)
        assert silo.message_center.egress.groups
        oneway = make_request(
            target_grain=GrainId.for_grain(GT, 2),
            interface_name="seg.IEcho", method_name="m", body=((), {}),
            sending_silo=silo.silo_address, target_silo=dest)
        silo.message_center.send_message(oneway)
        assert not silo.message_center.egress.groups  # guard drained it
        assert shard.ring.pushed_msgs == 4  # group(3) then singleton(1)
        items = list(shard.ring._items)
        if items:  # drain may already have run on the shard loop
            assert items[0][0] >= items[-1][0]
    finally:
        await silo.stop()


@bounded
async def test_egress_ring_backpressure_drops_bounded():
    """A ring past capacity DROPS application traffic (counted, the
    now-dead responses recycled) and never blocks the main loop; QoS
    bypass traffic is unaffected."""
    prev = set_debug_pool(True)
    silo = await _start_silo("segbp", shards=1, metrics_enabled=True)
    try:
        fabric = silo.fabric
        pool = fabric.egress_pool
        dest = SiloAddress("127.0.0.1", 59991, 9)
        shard = pool.shard_for(dest.endpoint)
        handle = fabric._sender_for(dest.endpoint)
        # simulate a wedged consumer: fake an un-drained backlog
        shard.ring.pushed_msgs += _EGRESS_RING_CAPACITY + 1
        req = make_request(
            target_grain=GrainId.for_grain(GT, 1),
            interface_name="seg.IEcho", method_name="m", body=((), {}),
            sending_silo=dest, target_silo=silo.silo_address)
        resp = make_response(req, "dropped")
        resp.target_silo = dest
        before = shard.ring.pushed_msgs
        handle.feed(resp)
        assert shard.ring.pushed_msgs == before  # never entered the ring
        assert shard.drops == 1
        assert resp._pool_free  # dead response recycled at the drop
        snap = silo.stats.snapshot()
        assert snap["counters"].get("egress.ring_drops", 0) == 1
        # the bound also covers the shard SENDER queue of THIS endpoint
        # (per-endpoint `pending`): a wedged peer blocks its sender
        # mid-write and the queue grows behind it — that, not the
        # instantly-drained ring, is where a peer stall accumulates
        shard.ring.pushed_msgs -= _EGRESS_RING_CAPACITY + 1  # restore
        shard.pending[dest.endpoint] = _EGRESS_RING_CAPACITY + 1
        req2, resp2 = (make_request(
            target_grain=GrainId.for_grain(GT, 3),
            interface_name="seg.IEcho", method_name="m", body=((), {}),
            sending_silo=dest, target_silo=silo.silo_address), None)
        resp2 = make_response(req2, "also dropped")
        resp2.target_silo = dest
        handle.feed(resp2)
        assert shard.drops == 2 and resp2._pool_free
        # ...but the wedged peer's backlog never drops traffic toward a
        # HEALTHY endpoint sharing the shard (per-endpoint isolation,
        # the classic path's property)
        other = SiloAddress("127.0.0.1", 59992, 9)
        assert pool.shard_for(other.endpoint) is shard  # 1 shard: same
        ok = make_response(make_request(
            target_grain=GrainId.for_grain(GT, 4),
            interface_name="seg.IEcho", method_name="m", body=((), {}),
            sending_silo=other, target_silo=silo.silo_address), "kept")
        ok.target_silo = other
        before = shard.ring.pushed_msgs
        fabric._sender_for(other.endpoint).feed(ok)
        assert shard.ring.pushed_msgs == before + 1  # entered the ring
        assert shard.drops == 2  # no new drop
        shard.pending.pop(dest.endpoint, None)  # restore
        # QoS is never dropped: a SYSTEM message still hands off direct
        sysreq = make_request(
            target_grain=GrainId.for_grain(GT, 2),
            interface_name="seg.IEcho", method_name="m", body=((), {}),
            category=Category.SYSTEM,
            sending_silo=silo.silo_address, target_silo=dest)
        handle.feed(sysreq)
        for _ in range(100):
            if shard.qos_direct:
                break
            await asyncio.sleep(0.01)
        assert shard.qos_direct == 1
    finally:
        set_debug_pool(prev)
        await silo.stop()


# ---------------------------------------------------------------------------
# End-to-end over real sockets
# ---------------------------------------------------------------------------

@bounded
async def test_cohosted_silo_never_binds_foreign_egress_shard():
    """Two silos sharing ONE SocketFabric, both multi-loop ingress: the
    fabric-wide egress pool borrows the FIRST silo's ingress loops, so
    the second silo's shard at the same index runs on a different
    thread. Its client routes must NOT bind to the foreign shard (loop
    identity gates the binding — a foreign-bound ShardWriter would make
    write_many a cross-thread call that raises and drops the route);
    they fall back to the main-loop write path and responses flow."""
    fabric = SocketFabric()

    def build(name, shards):
        return (SiloBuilder().with_name(name).with_fabric(fabric)
                .add_grains(SeqGrain, EchoGrain)
                .with_config(**{**FAST, "ingress_loops": 2,
                                "egress_shards": shards}).build())

    a = build("segcoa", 2)
    await a.start()
    b = build("segcob", 2)  # pool already exists: A's loops keep it
    await b.start()
    client = None
    try:
        pool = fabric.egress_pool
        assert pool is not None and pool.on_ingress
        a_loops = {s.loop for s in a.ingress_pool.shards}
        assert all(sh.loop in a_loops for sh in pool.shards)
        client = await GatewayClient(
            [b.silo_address.endpoint], response_timeout=5.0).connect()
        outs = await asyncio.gather(
            *(client.get_grain(EchoGrain, 700 + i).echo(i)
              for i in range(16)))
        assert outs == [i * 2 for i in range(16)]
        # the route B's ingress shard registered for this client is not
        # bound to A's shard — and any route that IS shard-bound (a
        # client of A) is bound to a shard on its OWN accept loop
        b_loops = {s.loop for s in b.ingress_pool.shards}
        bound = [getattr(w, "egress_shard", None)
                 for w in fabric.client_routes.values()]
        assert bound and all(
            es is None or es.loop not in b_loops for es in bound)
    finally:
        if client is not None:
            await client.close_async()
        await b.stop()
        await a.stop()


@bounded
async def test_sharded_egress_parity_and_zero_constructs_nothing():
    """egress_shards=0 (the default) constructs NO pool — today's path
    bit for bit — and the same workload returns the same results under
    both settings (borrowed-ingress-shard mode)."""
    results = {}
    for shards in (0, 2):
        silo = await _start_silo(f"segpar{shards}", loops=2, shards=shards)
        client = None
        try:
            assert (silo.fabric.egress_pool is None) == (shards == 0)
            client = await GatewayClient(
                [silo.silo_address.endpoint], response_timeout=5.0).connect()
            outs = await asyncio.gather(
                *(client.get_grain(EchoGrain, i).echo(i) for i in range(32)))
            results[shards] = outs
            if shards:
                pool = silo.fabric.egress_pool
                assert pool.on_ingress
                assert sum(s.ring.pushed_msgs for s in pool.shards) > 0
                assert sum(s.encoded for s in pool.shards) > 0
        finally:
            if client is not None:
                await client.close_async()
            await silo.stop()
    assert results[0] == results[2] == [2 * i for i in range(32)]


@bounded
async def test_client_routes_encode_on_shards_under_single_ingress():
    """The multi-loop residue fix: under
    ``ingress_loops=1`` client connections are accepted on the MAIN
    loop, and before the fix their response encodes ran there too while
    silo-peer links already encoded on standalone egress shards. Now
    ``_handle_conn`` pins every client route to a sticky shard
    (``shard_for_client``), the encode runs shard-side, and only the
    final fd write marshals back to the main-loop StreamWriter."""
    silo = await _start_silo("resid", loops=1, shards=2)
    client = None
    try:
        pool = silo.fabric.egress_pool
        assert pool is not None and not pool.on_ingress  # standalone
        client = await GatewayClient(
            [silo.silo_address.endpoint], response_timeout=5.0).connect()
        outs = await asyncio.gather(
            *(client.get_grain(EchoGrain, i).echo(i) for i in range(32)))
        assert outs == [2 * i for i in range(32)]
        # the route was pinned to a shard at registration...
        writers = list(silo.fabric.client_routes.values())
        assert writers and all(
            getattr(w, "egress_shard", None) is not None for w in writers)
        # ...and the responses actually encoded there (the main-loop
        # StreamWriter has no write_many, so a shard-side encode is only
        # observable through the shard's own counter)
        assert sum(s.encoded for s in pool.shards) > 0
    finally:
        if client is not None:
            await client.close_async()
        await silo.stop()


@bounded
async def test_recycle_discipline_under_debug_pool_sharded_egress():
    """ORLEANS_TPU_DEBUG_POOL=1 across the sharded response path:
    response batch → egress ring → shard encode (per-shard template
    cache) → writev → one-sweep shard-side recycle. Any shell touched
    after recycle trips PoolDisciplineError; the shard counters prove
    the sharded path (not the main-loop fallback) served the traffic."""
    prev = set_debug_pool(True)
    try:
        silo = await _start_silo("segpool", loops=2, shards=2)
        client = None
        try:
            client = await GatewayClient(
                [silo.silo_address.endpoint], response_timeout=5.0).connect()
            for _ in range(3):
                outs = await asyncio.gather(
                    *(client.get_grain(EchoGrain, i).echo(i)
                      for i in range(24)))
                assert outs == [2 * i for i in range(24)]
            pool = silo.fabric.egress_pool
            assert sum(s.recycled for s in pool.shards) > 0
            assert sum(s.encoded for s in pool.shards) > 0
        finally:
            if client is not None:
                await client.close_async()
            await silo.stop()
    finally:
        set_debug_pool(prev)


@bounded
async def test_peer_fifo_and_affinity_across_sharded_egress(tmp_path):
    """2-silo membership cluster, both running ingress_loops=2 +
    egress_shards=2: per-sender-per-grain FIFO survives the egress
    rings + shard senders; the inbound-half affinity map records peer
    endpoints; membership stays converged (probe responses never behind
    a ring — the QoS invariant under real probe traffic)."""
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    s1 = await _start_silo("segf1", loops=2, shards=2, table=table)
    s2 = await _start_silo("segf2", loops=2, shards=2, table=table)
    client = None
    try:
        async def converged():
            while True:
                views = [set(s.membership.active) for s in (s1, s2)]
                if all(len(v) == 2 for v in views) and views[0] == views[1]:
                    return
                await asyncio.sleep(0.05)
        await asyncio.wait_for(converged(), timeout=10.0)

        client = await GatewayClient(
            [s1.silo_address.endpoint], response_timeout=5.0).connect()
        n, grains = 60, 6
        # resolve placement first: the initial-activation directory
        # race can reorder forwarded requests on ANY configuration
        # (pre-existing, measured identical at egress_shards=0) — the
        # FIFO to preserve is the steady-state wire order
        # through rings + shard senders
        await asyncio.gather(*(client.get_grain(SeqGrain, k).add("w", -1)
                               for k in range(grains)))

        async def burst(tag):
            futs = []
            for i in range(n):
                g = client.get_grain(SeqGrain, i % grains)
                futs.append(asyncio.ensure_future(g.add(tag, i)))
            await asyncio.gather(*futs)

        await asyncio.gather(burst("a"), burst("b"))
        for k in range(grains):
            seen = await client.get_grain(SeqGrain, k).seen_list()
            for tag in ("a", "b"):
                seq = [i for t, i in seen if t == tag]
                assert seq == sorted(seq), \
                    f"grain {k} tag {tag} reordered: {seq}"
                assert len(seq) == n // grains
        # probes flowed ring-free while application traffic rode rings
        await asyncio.sleep(0.4)
        for s in (s1, s2):
            pool = s.fabric.egress_pool
            assert sum(sh.qos_direct for sh in pool.shards) > 0, \
                "no QoS traffic took the egress bypass"
            assert s.fabric._peer_shard, "inbound-half affinity not recorded"
        assert all(len(s.membership.active) == 2 for s in (s1, s2))
    finally:
        if client is not None:
            await client.close_async()
        await s2.stop()
        await s1.stop()


@bounded
async def test_sharded_egress_clean_shutdown_drains_and_joins():
    """Stop under load (standalone egress threads, 2 silos trading peer
    traffic): every egress ring is drained (pushed == drained), the
    dedicated egress loop threads join, and the silos exit cleanly."""
    table = None
    s1 = await _start_silo("segstop1", shards=2)
    s2 = await _start_silo("segstop2", shards=2)
    client = await GatewayClient(
        [s1.silo_address.endpoint, s2.silo_address.endpoint],
        response_timeout=5.0).connect()
    stop = asyncio.Event()

    async def hammer(k):
        i = 0
        g = client.get_grain(SeqGrain, k)
        while not stop.is_set():
            try:
                await g.add("h", i)
            except Exception:  # noqa: BLE001 — silo stopping under us
                return
            i += 1

    tasks = [asyncio.ensure_future(hammer(k)) for k in range(8)]
    await asyncio.sleep(0.3)
    pools = [s1.fabric.egress_pool, s2.fabric.egress_pool]
    assert all(p is not None and not p.on_ingress for p in pools)
    stop.set()
    await s2.stop()
    await s1.stop()
    await client.close_async()
    await asyncio.gather(*tasks, return_exceptions=True)
    for p in pools:
        assert p.closed
        for t in p._threads:
            assert not t.is_alive()
        for sh in p.shards:
            assert sh.ring.pushed_msgs == sh.ring.drained_msgs, \
                (sh.ring.pushed_msgs, sh.ring.drained_msgs)


@bounded
async def test_shard_bounce_keeps_envelope_for_main_loop():
    """A response whose body fails to encode shard-side is BOUNCED with
    the callback marshalled to the main loop — the shard's recycle
    sweep must leave that envelope alone (recycling it would let the
    pool re-issue the shell before the in-flight bounce reads it),
    while co-batched encodable responses still recycle."""
    prev = set_debug_pool(True)
    s1 = await _start_silo("segb1", shards=1)
    s2 = await _start_silo("segb2")
    try:
        req = make_request(
            target_grain=GrainId.for_grain(GT, 1),
            interface_name="seg.IEcho", method_name="m", body=((), {}),
            sending_silo=s2.silo_address, target_silo=s1.silo_address,
            timeout=None)
        bad = make_response(req, lambda: None)  # unpicklable body
        bad.target_silo = s2.silo_address
        good = make_response(req, "ok")
        good.target_silo = s2.silo_address
        s1.fabric.deliver(bad)
        s1.fabric.deliver(good)
        for _ in range(300):
            if good._pool_free:
                break
            await asyncio.sleep(0.01)
        assert good._pool_free, "encodable response never recycled"
        assert not bad._pool_free, \
            "bounced envelope recycled out from under the marshalled bounce"
    finally:
        set_debug_pool(prev)
        await s2.stop()
        await s1.stop()


@bounded
async def test_egress_shards_config_validation():
    with pytest.raises(ConfigurationError):
        MessagingOptions(egress_shards=-1).validate()
    with pytest.raises(ConfigurationError):
        MessagingOptions(egress_shards=2.5).validate()
    with pytest.raises(ConfigurationError):
        MessagingOptions(egress_shards=65).validate()
    MessagingOptions(egress_shards=0).validate()
    MessagingOptions(egress_shards=4).validate()
    silo = (SiloBuilder().with_name("segcfg")
            .with_options(MessagingOptions(egress_shards=3)).build())
    assert silo.config.egress_shards == 3
