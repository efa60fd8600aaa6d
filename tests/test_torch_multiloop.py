"""The port's multi-loop silo ingress and its socket paths
(orleans_tpu_torch.runtime.multiloop, the fabric's multi-loop acceptor),
on the CPU over real localhost sockets.

* The port's copy of tests/test_multiloop.py: the vectored pump
  against the Python decode, the SPSC ring, per-grain FIFO across two
  ingress loops, ``ingress_loops=1`` parity, the Python fallback pump,
  pipelined frames behind the handshake, the QoS bypass, clean shutdown,
  options validation, the stateless-worker hot lane and the profiler's
  eager guard.
* The multi-loop stop repair: a silo started on the same loop right
  after a two-loop silo stopped (no yield between) answers a gateway
  client.

Every silo binds 127.0.0.1:0, and every async body runs under
``asyncio.wait_for(..., 30)``.
"""

import asyncio
import functools
import os
import socket

import pytest

import orleans_tpu_torch.core.serialization as ser
import orleans_tpu_torch.runtime.multiloop as ml
from orleans_tpu_torch.config import ConfigurationError, MessagingOptions
from orleans_tpu_torch.core.ids import GrainId, GrainType, SiloAddress
from orleans_tpu_torch.core.message import (Category, Direction, Message,
                                      make_request, make_response)
from orleans_tpu_torch.membership import FileMembershipTable, join_cluster
from orleans_tpu_torch.runtime import (GatewayClient, Grain, SiloBuilder,
                                 SocketFabric)
from orleans_tpu_torch.runtime.grain import stateless_worker
from orleans_tpu_torch.runtime.multiloop import SpscRing
from orleans_tpu_torch.runtime.wire import decode_frames, encode_message

hw = ser._hotwire

TIMEOUT = 30


def bounded(fn):
    """Run the test coroutine under ``asyncio.wait_for(..., TIMEOUT)``."""
    @functools.wraps(fn)
    async def run(*args, **kwargs):
        await asyncio.wait_for(fn(*args, **kwargs), TIMEOUT)
    return run


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

GT = GrainType.of("mlt.Echo")
S1 = SiloAddress("10.7.0.1", 1111, 3)
S2 = SiloAddress("10.7.0.2", 2222, 5)


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

    async def where(self):
        return self.runtime_identity


# ---------------------------------------------------------------------------
# Vectored pump: byte/semantics identity vs the Python fallback
# ---------------------------------------------------------------------------

def _frame_corpus(n=24):
    msgs = []
    for i in range(n):
        m = make_request(
            target_grain=GrainId.for_grain(GT, i),
            interface_name="mlt.IEcho", method_name=f"m{i % 3}",
            body=((i,), {"k": bytes(i % 11)}), sending_silo=S2,
            target_silo=S1, timeout=None)
        msgs.append(m)
        if i % 5 == 0:
            r = make_response(m, {"r": i})
            r.target_silo = S2
            msgs.append(r)
    return msgs


def _slots_equal(a: Message, b: Message) -> bool:
    for s in Message.__slots__:
        if s in ("received_at", "_pool_free", "_pool_gen", "expires_at"):
            continue
        if getattr(a, s) != getattr(b, s):
            return False
    return True


@pytest.mark.skipif(hw is None or not hasattr(hw, "sock_recv_batch"),
                    reason="native toolchain unavailable")
@bounded
async def test_sock_recv_batch_identical_to_python_decode():
    """Property: for the SAME byte stream in adversarial chunk splits,
    the one-C-call vectored pump (recv + decode) yields exactly the
    messages the Python ``decode_frames`` path yields, frame for frame —
    including partial-tail resume across reads."""
    msgs = _frame_corpus()
    data = b"".join(encode_message(m) for m in msgs)
    # Python reference decode
    consumed, ref, bounces = decode_frames(bytearray(data))
    assert consumed == len(data) and not bounces

    for splits in ((1,), (7, 64, 3, 1024), (37,)):
        a, b = socket.socketpair()
        b.setblocking(False)
        got, bounces2, tail = [], [], b""
        pos = si = 0

        def drain_ready(tail):
            while True:
                r = hw.sock_recv_batch(b.fileno(), tail, Message, 4096)
                if r is None:
                    return tail, False
                entries, tail, eof, _n = r
                ml.finish_batch_entries(entries, got, bounces2)
                if eof:
                    return tail, True

        while pos < len(data):
            step = splits[si % len(splits)]
            si += 1
            a.sendall(data[pos:pos + step])
            pos += step
            tail, _ = drain_ready(tail)
        a.close()
        eof = False
        while not eof:
            tail, eof = drain_ready(tail)
            if not eof:
                await asyncio.sleep(0.005)
        b.close()
        assert not bounces2
        assert tail == b""
        assert len(got) == len(ref)
        for g, r_ in zip(got, ref):
            assert _slots_equal(g, r_)


@pytest.mark.skipif(hw is None or not hasattr(hw, "sock_writev"),
                    reason="native toolchain unavailable")
@bounded
async def test_sock_writev_bytes_identical_to_join():
    chunks = [bytes([i]) * (i * 13 + 1) for i in range(40)]
    a, b = socket.socketpair()
    a.setblocking(False)
    b.setblocking(False)
    want = b"".join(chunks)
    sent = 0
    rest = list(chunks)
    out = bytearray()
    while rest:
        try:
            n = hw.sock_writev(a.fileno(), rest)
        except BlockingIOError:
            n = 0
        sent += n
        # consume what was written from the chunk list
        while rest and n >= len(rest[0]):
            n -= len(rest[0])
            rest.pop(0)
        if rest and n:
            rest[0] = rest[0][n:]
        # drain the peer so the kernel buffer frees up
        try:
            out += b.recv(1 << 20)
        except BlockingIOError:
            pass
    b.setblocking(False)
    try:
        while True:
            chunk = b.recv(1 << 20)
            if not chunk:
                break
            out += chunk
    except BlockingIOError:
        pass
    a.close()
    b.close()
    assert bytes(out) == want


@pytest.mark.skipif(hw is None or not hasattr(hw, "sock_recv_batch"),
                    reason="native toolchain unavailable")
@bounded
async def test_sock_recv_batch_hostile_announcement_raises():
    a, b = socket.socketpair()
    b.setblocking(False)
    a.sendall(b"\xff\xff\xff\xff\xff\xff\xff\xff" + b"x" * 16)
    with pytest.raises(ValueError):
        hw.sock_recv_batch(b.fileno(), b"", Message, 4096)
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# SPSC ring
# ---------------------------------------------------------------------------

@bounded
async def test_spsc_ring_coalesced_wakeup_and_backlog():
    loop = asyncio.get_running_loop()
    drained = []
    ring = SpscRing(loop, drained.append)
    for i in range(5):
        ring.push((1, None, [i], 0.0, 0, 1), 1)
    assert ring.backlog() == 5
    await asyncio.sleep(0)          # one wakeup drains the whole burst
    assert [it[2][0] for it in drained] == [0, 1, 2, 3, 4]
    assert ring.backlog() == 0
    assert ring.drained_batches == 5


@bounded
async def test_spsc_ring_drain_now_recovers_unarmed_items():
    """The clean-shutdown drain: items sitting in the ring whose armed
    wakeup never ran (producer thread stopped mid-hand-off) are swept by
    ``drain_now`` so no decoded message is dropped."""
    loop = asyncio.get_running_loop()
    drained = []
    ring = SpscRing(loop, drained.append)
    # simulate a lost wakeup: enqueue without arming
    ring._items.append((1, None, ["x"], 0.0, 0, 1))
    ring.pushed_msgs += 1
    assert not drained
    ring.drain_now()
    assert drained and drained[0][2] == ["x"]
    assert ring.backlog() == 0


# ---------------------------------------------------------------------------
# End-to-end: 2 ingress loops over real TCP
# ---------------------------------------------------------------------------

async def _start_multiloop_silo(name, table=None, *, loops=2, grains=(),
                                **cfg):
    fabric = SocketFabric()
    silo = (SiloBuilder().with_name(name).with_fabric(fabric)
            .add_grains(SeqGrain, EchoGrain, *grains)
            .with_config(**{**FAST, "ingress_loops": loops, **cfg}).build())
    if table is not None:
        join_cluster(silo, table)
    await silo.start()
    return silo


@bounded
async def test_multiloop_fifo_per_grain_across_two_loops():
    """Two clients (two connections, round-robined onto different
    ingress loops) pipeline ordered bursts at the same grains: each
    sender's per-grain order must survive the shard pump + ring
    hand-off exactly (per-sender-per-target FIFO, the wire's one
    guarantee)."""
    silo = await _start_multiloop_silo("mlfifo")
    c1 = c2 = None
    try:
        ep = silo.silo_address.endpoint
        c1 = await GatewayClient([ep], response_timeout=5.0).connect()
        c2 = await GatewayClient([ep], response_timeout=5.0).connect()
        n, grains = 60, 4

        async def burst(client, tag):
            futs = []
            for i in range(n):
                g = client.get_grain(SeqGrain, i % grains)
                futs.append(asyncio.ensure_future(g.add(tag, i)))
            await asyncio.gather(*futs)

        await asyncio.gather(burst(c1, "a"), burst(c2, "b"))
        # both loops actually pumped
        used = [s for s in silo.ingress_pool.shards if s.frames > 0]
        assert len(used) >= 2, \
            f"connections not spread: {[s.frames for s in silo.ingress_pool.shards]}"
        for k in range(grains):
            seen = await c1.get_grain(SeqGrain, k).seen_list()
            for tag in ("a", "b"):
                seq = [i for t, i in seen if t == tag]
                assert seq == sorted(seq), \
                    f"grain {k} tag {tag} reordered: {seq}"
                assert len(seq) == n // grains
    finally:
        for c in (c1, c2):
            if c is not None:
                await c.close_async()
        await silo.stop()


@bounded
async def test_multiloop_parity_with_single_loop():
    """ingress_loops=1 (the default) constructs NO pool — today's
    start_server path bit for bit — and the same workload returns the
    same results under both settings."""
    results = {}
    for loops in (1, 2):
        silo = await _start_multiloop_silo(f"mlpar{loops}", loops=loops)
        client = None
        try:
            assert (silo.ingress_pool is None) == (loops == 1)
            client = await GatewayClient(
                [silo.silo_address.endpoint], response_timeout=5.0).connect()
            outs = await asyncio.gather(
                *(client.get_grain(EchoGrain, i).echo(i) for i in range(32)))
            results[loops] = outs
        finally:
            if client is not None:
                await client.close_async()
            await silo.stop()
    assert results[1] == results[2] == [2 * i for i in range(32)]


@bounded
async def test_multiloop_python_fallback_pump_parity(monkeypatch):
    """With the native vectored pump unavailable (ORLEANS_TPU_NATIVE=0
    form), the shard's Python sock_recv + decode_frames pump delivers
    identical results."""
    monkeypatch.setattr(ml, "_HW_SOCK", False)
    silo = await _start_multiloop_silo("mlpy")
    client = None
    try:
        client = await GatewayClient(
            [silo.silo_address.endpoint], response_timeout=5.0).connect()
        outs = await asyncio.gather(
            *(client.get_grain(EchoGrain, i).echo(i) for i in range(24)))
        assert outs == [2 * i for i in range(24)]
        assert any(s.frames for s in silo.ingress_pool.shards)
    finally:
        if client is not None:
            await client.close_async()
        await silo.stop()


@bounded
async def test_pipelined_frames_behind_handshake_are_served():
    """A conformant peer may write its handshake AND its first request
    in one burst; the bytes the shard reads behind the handshake seed
    the pump's tail and must be decoded immediately — not parked until
    the peer (which is waiting for the response) sends more."""
    from orleans_tpu_torch.runtime.wire import (decode_message, encode_handshake,
                                          read_frame)
    silo = await _start_multiloop_silo("mlpipe")
    writer = None
    try:
        pseudo = SiloAddress("127.0.0.1", 45999, 1234567)
        req = make_request(
            target_grain=GrainId.for_grain(GrainType.of("EchoGrain"), 5),
            interface_name="EchoGrain", method_name="echo",
            body=((7,), {}), sending_silo=pseudo, timeout=5.0)
        host, port = silo.silo_address.endpoint.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(encode_handshake("client", pseudo)
                     + encode_message(req))
        await writer.drain()
        await asyncio.wait_for(read_frame(reader), 5.0)  # handshake reply
        rh, rb = await asyncio.wait_for(read_frame(reader), 5.0)
        resp = decode_message(rh, rb)
        assert resp.direction == Direction.RESPONSE
        assert resp.body == 14  # echo(7) == 7 * 2
    finally:
        if writer is not None:
            writer.close()
        await silo.stop()


@bounded
async def test_multiloop_qos_ping_system_bypass_rings(tmp_path):
    """PING/SYSTEM traffic (membership probes, control RPCs) must NEVER
    ride the shard rings — it is handed to the main loop per-message,
    ring-free, so probes can't sit behind application drains (a delayed
    probe response gets healthy silos voted dead). Every shard must
    satisfy frames == qos_direct + ring-delivered application count, and
    membership must hold steady while both silos run multi-loop."""
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    s1 = await _start_multiloop_silo("mlq1", table)
    s2 = await _start_multiloop_silo("mlq2", table)
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
        # application traffic spread across both silos while probes flow
        for _ in range(6):
            await asyncio.gather(
                *(client.get_grain(EchoGrain, i).echo(i) for i in range(24)))
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.5)  # several probe periods under load

        saw_qos = 0
        for silo in (s1, s2):
            for sh in silo.ingress_pool.shards:
                ring_msgs = sh.ring.pushed_msgs
                assert sh.frames == sh.qos_direct + ring_msgs, \
                    (sh.frames, sh.qos_direct, ring_msgs)
                saw_qos += sh.qos_direct
        assert saw_qos > 0, "no PING/SYSTEM traffic crossed the shards"
        # membership stayed converged: no probe starved behind a ring
        assert all(len(s.membership.active) == 2 for s in (s1, s2))
    finally:
        if client is not None:
            await client.close_async()
        await s2.stop()
        await s1.stop()


@bounded
async def test_system_responses_never_enter_flush_accumulator():
    """The egress half of the QoS split (asserted here beside the ring
    half): PING/SYSTEM responses take the
    per-message path — the flush accumulator only ever holds
    APPLICATION responses."""
    silo = await _start_multiloop_silo("mlsys", loops=1)
    try:
        eg = silo.message_center.egress
        assert eg is not None
        req = make_request(
            target_grain=GrainId.for_grain(GT, 1),
            interface_name="mlt.IEcho", method_name="m", body=((), {}),
            category=Category.SYSTEM, sending_silo=S2,
            target_silo=silo.silo_address)
        resp = make_response(req, "pong")
        silo.dispatcher.send_response(req, resp)
        assert not eg.groups, "SYSTEM response parked in the accumulator"
        # APPLICATION responses DO group (the accumulator's purpose)
        areq = make_request(
            target_grain=GrainId.for_grain(GT, 2),
            interface_name="mlt.IEcho", method_name="m", body=((), {}),
            sending_silo=S2, target_silo=silo.silo_address)
        aresp = make_response(areq, "ok")
        silo.dispatcher.send_response(areq, aresp)
        assert eg.groups
        eg.flush()
    finally:
        await silo.stop()


@bounded
async def test_multiloop_clean_shutdown_drains_and_joins():
    """Stop under load: pump threads join, every ring is drained
    (pushed == drained, backlog 0), and the silo exits cleanly."""
    silo = await _start_multiloop_silo("mlstop")
    client = await GatewayClient(
        [silo.silo_address.endpoint], response_timeout=5.0).connect()
    stop = asyncio.Event()

    async def hammer():
        i = 0
        g = client.get_grain(EchoGrain, 1)
        while not stop.is_set():
            try:
                await g.echo(i)
            except Exception:  # noqa: BLE001 — silo stopping under us
                return
            i += 1

    tasks = [asyncio.ensure_future(hammer()) for _ in range(8)]
    await asyncio.sleep(0.3)
    pool = silo.ingress_pool
    stop.set()
    await silo.stop()
    await client.close_async()
    await asyncio.gather(*tasks, return_exceptions=True)
    assert silo.status == "Stopped"
    for sh in pool.shards:
        assert not sh.is_alive()
        assert sh.ring.backlog() == 0
        assert sh.ring.pushed_msgs == sh.ring.drained_msgs


@bounded
async def test_ingress_loops_config_validation():
    with pytest.raises(ConfigurationError):
        MessagingOptions(ingress_loops=0).validate()
    with pytest.raises(ConfigurationError):
        MessagingOptions(ingress_loops=2.5).validate()
    MessagingOptions(ingress_loops=4).validate()
    silo = (SiloBuilder().with_name("cfg")
            .with_options(MessagingOptions(ingress_loops=3)).build())
    assert silo.config.ingress_loops == 3


# ---------------------------------------------------------------------------
# Satellite: stateless-worker hot lane
# ---------------------------------------------------------------------------

@stateless_worker(max_local=4)
class Worker(Grain):
    async def work(self, x):
        return x + 1

    async def slow(self, x):
        await asyncio.sleep(0.03)
        return x


@bounded
async def test_stateless_worker_hot_lane_engages():
    """StatelessWorker grains no longer fall back to messaging: an idle
    replica serves the collapsed inline turn (the ROADMAP carry-over)."""
    silo = SiloBuilder().add_grains(Worker).build()
    await silo.start()
    try:
        rc = silo.runtime_client
        g = silo.grain_factory.get_grain(Worker, 1)
        await g.work(0)  # activate the first replica
        h0, f0 = rc.hot_hits, rc.hot_fallbacks
        for i in range(64):
            assert await g.work(i) == i + 1
        assert rc.hot_hits - h0 == 64
        assert rc.hot_fallbacks - f0 == 0
    finally:
        await silo.stop()


@bounded
async def test_stateless_worker_busy_set_falls_back_and_scales():
    """All replicas busy → the lane declines and the catalog's
    least-loaded pick + auto-scale stay authoritative (replicas grow
    under a concurrent suspending burst, bounded by the cap)."""
    silo = SiloBuilder().add_grains(Worker).build()
    await silo.start()
    try:
        g = silo.grain_factory.get_grain(Worker, 9)
        outs = await asyncio.gather(*(g.slow(i) for i in range(12)))
        assert sorted(outs) == list(range(12))
        acts = [a for k, v in silo.catalog.by_grain.items()
                for a in v if a.grain_class is Worker]
        assert 1 < len(acts) <= 4  # scaled out, capped at max_local
    finally:
        await silo.stop()


# ---------------------------------------------------------------------------
# Satellite: eager-aware profiler enter()
# ---------------------------------------------------------------------------

@bounded
async def test_profiler_enter_eager_guard(monkeypatch):
    """The guarded boundary: when the current task is in the
    interpreter's eager-task registry, enter() sets the contextvar (so
    post-suspension steps label correctly) but DEFERS the live-slice
    switch — the creator's slice never bleeds. Without the registry
    (py3.10 reference env) behavior is byte-identical to before."""
    from orleans_tpu_torch.observability import profiling
    from orleans_tpu_torch.observability.profiling import LOOP_CATEGORY, LoopProfiler

    lp = LoopProfiler(window=10.0)

    def run_enter():
        lp._depth = 1          # as inside a wrapped callback
        lp._cur = "pump"       # the creator's live category
        tok = lp.enter("turns", "lbl")
        cat = lp._cur
        LOOP_CATEGORY.reset(tok)
        lp._depth = 0
        return cat

    # non-eager (registry absent -> py3.10 path): live switch happens
    monkeypatch.setattr(profiling, "_EAGER_TASKS", None)
    assert run_enter() == "turns"

    # eager step: current task registered -> live switch deferred, the
    # creator's slice keeps accruing; the contextvar still labels the
    # task's own later steps
    lp2 = LoopProfiler(window=10.0)

    def run_enter2():
        lp2._depth = 1
        lp2._cur = "pump"
        tok = lp2.enter("turns")
        cat, var = lp2._cur, LOOP_CATEGORY.get()
        LOOP_CATEGORY.reset(tok)
        lp2._depth = 0
        return cat, var

    monkeypatch.setattr(profiling, "_EAGER_TASKS",
                        {asyncio.current_task()})
    cat, var = run_enter2()
    assert cat == "pump"      # live slice untouched (no bleed)
    assert var == "turns"     # future steps still labeled


# ---------------------------------------------------------------------------
# The multi-loop stop repair
# ---------------------------------------------------------------------------

async def _echo_within(silo, seconds=5.0) -> list:
    """Dial the silo's gateway and make 16 calls, all inside ``seconds``."""
    client = None
    try:
        client = await asyncio.wait_for(GatewayClient(
            [silo.silo_address.endpoint],
            response_timeout=seconds).connect(), seconds)
        return await asyncio.wait_for(asyncio.gather(
            *(client.get_grain(EchoGrain, i).echo(i) for i in range(16))),
            seconds)
    finally:
        if client is not None:
            await client.close_async()


@bounded
async def test_silo_after_a_stopped_multiloop_silo_answers():
    """Silos started one after another on one event loop, each right
    after the previous one stopped, with no yield between: 2, 1, 2 and 2
    ingress loops, so a one-loop and a two-loop silo each follow a
    stopped two-loop silo. Each answers a gateway client inside 5 s. The
    multi-loop acceptor used to close its listening socket in the same
    step as it cancelled its accept task; the loop's deferred
    ``remove_reader`` for that fd number then ran after the next silo's
    listener had taken the number, and that listener never accepted."""
    want = [2 * i for i in range(16)]
    for i, loops in enumerate((2, 1, 2, 2)):
        silo = await _start_multiloop_silo(f"mlseq{i}", loops=loops)
        try:
            assert (silo.ingress_pool is None) == (loops == 1)
            assert await _echo_within(silo) == want
        finally:
            await silo.stop()


def _fill_fd_holes_below(fd: int) -> list:
    """Take every free descriptor number below ``fd`` (which is open), so
    the next new descriptor after ``fd`` is closed gets ``fd``'s number."""
    held = []
    while True:
        n = os.dup(0)
        if n > fd:
            os.close(n)
            return held
        held.append(n)


def test_shard_writer_closed_mid_send_frees_its_fd_number_cleanly():
    """A client route's writer closed while its send is parked in
    ``sock_sendall`` (a peer that does not read, a small send buffer):
    the loop removes the parked send's writer registration in a callback
    the cancellation schedules, so the writer's socket must stay open
    until that removal has run. Closed in the same step, a new socket
    that takes the freed descriptor number in that window meets the stale
    registration, its own writability is never watched, and its send
    parks for good (its client hears no answer). The loop runs the eager
    task factory, as a silo's does, so a write starts its send at once."""
    async def run():
        loop = asyncio.get_running_loop()
        loop.set_task_factory(asyncio.eager_task_factory)
        big = b"x" * (1 << 21)
        a1, b1 = socket.socketpair()
        a2, b2 = socket.socketpair()
        held: list = []
        try:
            for s in (a1, a2):
                s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
            w1 = ml.ShardWriter(loop, a1)
            w1.write(big)
            await asyncio.sleep(0.05)  # parked: b1 never reads
            assert w1._task is not None and not w1._task.done()
            held = _fill_fd_holes_below(w1._sock.fileno())
            swapped = loop.create_future()

            def swap():
                # the route's teardown and a new client's first answer
                # in one loop iteration
                w1.close()
                loop.call_soon(start_second)

            def start_second():
                w2 = ml.ShardWriter(loop, a2)
                w2.write(big)
                swapped.set_result(w2)

            loop.call_soon(swap)
            w2 = await swapped
            b2.setblocking(False)
            got = 0
            while got < len(big):
                data = await asyncio.wait_for(
                    loop.sock_recv(b2, 1 << 16), 5.0)
                assert data, "the second route's socket closed early"
                got += len(data)
            w2.close()
            await asyncio.sleep(0.01)
            return got, w1.is_closing()
        finally:
            for n in held:
                os.close(n)
            for s in (a1, b1, a2, b2):
                s.close()

    assert asyncio.run(asyncio.wait_for(run(), TIMEOUT)) == (1 << 21, True)
