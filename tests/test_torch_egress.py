"""The port's batched egress (orleans_tpu_torch.runtime.egress) and the
batched ingress hand-off into the engine, on the CPU.

The port's copies of tests/test_batched_egress.py and of the engine
hand-off tests of tests/test_batched_ingress.py: the header-prefix
template's bytes, the per-destination flush accumulator and its FIFO
guard, the QoS bypass for PING/SYSTEM responses, batched client
correlation, pool discipline, vector and host traffic over real sockets
with either lever, the egress stage metrics when on and nothing when off,
and the response-leg span over the batched path, through the port.
Vector grains use ``make_mesh(1, device="cpu")``. Every async body runs
under ``asyncio.wait_for(..., 30)``.
"""

import asyncio
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import orleans_tpu_torch.core.serialization as ser
from orleans_tpu_torch.core.ids import GrainId, GrainType, SiloAddress
from orleans_tpu_torch.core.message import (Direction, Message,
                                            RejectionType,
                                            make_error_response,
                                            make_rejection, make_request,
                                            make_response, pool_generation,
                                            recycle_messages, set_debug_pool)
from orleans_tpu_torch.observability.stats import EGRESS_STATS
from orleans_tpu_torch.parallel import make_mesh
from orleans_tpu_torch.runtime import Grain, SiloBuilder
from orleans_tpu_torch.runtime.egress import EgressBatcher
from orleans_tpu_torch.runtime.runtime_client import (RuntimeClient,
                                                      _fresh_callback)
from orleans_tpu_torch.runtime.wire import (decode_frames, encode_message,
                                            encode_message_batch)

hw = ser._hotwire
TIMEOUT = 30


def bounded(fn):
    """Run the test coroutine under ``asyncio.wait_for(..., TIMEOUT)``."""
    @functools.wraps(fn)
    async def run(*args, **kwargs):
        await asyncio.wait_for(fn(*args, **kwargs), TIMEOUT)
    return run


native = pytest.mark.skipif(hw is None, reason="native toolchain unavailable")

GT = GrainType.of("eg.Echo")
S1 = SiloAddress("10.9.0.1", 1111, 3)
S2 = SiloAddress("10.9.0.2", 2222, 5)



def _response_corpus(n: int = 36) -> list:
    """Responses with the header variety the template must carry —
    traced (TRACE_KEY stamps), txn-join piggybacks, errors — plus the
    headers that must PEEL (rejections), interleaved with requests.
    ``timeout=None`` keeps TTLs out so two encodes are byte-identical."""
    out = []
    for i in range(n):
        req = make_request(
            target_grain=GrainId.for_grain(GT, i),
            interface_name="eg.IEcho", method_name=f"m{i % 4}",
            body=((i,), {}), sending_silo=S2, target_silo=S1,
            timeout=None)
        if i % 9 == 0:
            resp = make_rejection(req, RejectionType.TRANSIENT, "stale")
        elif i % 5 == 0:
            resp = make_error_response(req, ValueError(f"boom-{i}"))
        else:
            resp = make_response(req, {"r": i, "blob": b"x" * (i % 7)})
        if i % 4 == 0:
            # sampled response: the _stamp_response wall stamp rides the
            # varying request_context field of the template
            resp.request_context = {
                "__otpu_trace__": (0xABC0 + i, i, 1700000000.0 + i)}
        if i % 6 == 0:
            resp.transaction_info = (i, {i: "participant"})
        resp.target_silo = req.sending_silo
        out.append(resp)
        if i % 3 == 0:
            out.append(req)  # mixed run: requests interleave
    return out


def _slots_equal(a: Message, b: Message) -> bool:
    for s in Message.__slots__:
        if s in ("received_at", "_pool_free", "_pool_gen", "expires_at"):
            continue
        va, vb = getattr(a, s), getattr(b, s)
        if isinstance(va, BaseException) or isinstance(vb, BaseException):
            # exceptions never compare equal instance-wise: type + args
            # is what the wire round-trip preserves
            if type(va) is not type(vb) or va.args != vb.args:
                return False
            continue
        if va != vb:
            return False
    return True


@native
def test_template_batch_bytes_identical_to_per_frame():
    msgs = _response_corpus()
    per_frame = b"".join(encode_message(m) for m in msgs)
    chunks = encode_message_batch(msgs, bounce=lambda m, e: None)
    assert b"".join(chunks) == per_frame
    # the template actually engaged: templated response runs split the
    # output into more than one chunk (requests/rejections peel)
    assert len(chunks) > 1
    # and the A/B lever's encoder produces the same bytes
    plain = encode_message_batch(msgs, bounce=lambda m, e: None,
                                 templates=False)
    assert b"".join(plain) == per_frame


@native
def test_template_batch_decodes_slot_identical():
    msgs = [m for m in _response_corpus() if True]
    buf = bytearray(b"".join(
        encode_message_batch(msgs, bounce=lambda m, e: None)))
    consumed, decoded, bounces = decode_frames(buf)
    assert consumed == len(buf) and not bounces
    assert len(decoded) == len(msgs)
    for got, orig in zip(decoded, msgs):
        assert _slots_equal(got, orig)


def _request_corpus(n: int = 40) -> list:
    """call_batch-shaped REQUEST batches plus the variety the request
    template must carry: one-ways, traced request_context, in-grain
    senders with a non-empty call chain, interleaved responses, and the
    headers that must PEEL (forwarded/resent requests)."""
    from orleans_tpu_torch.core.message import make_request_fast
    from orleans_tpu_torch.core.message import Category
    chain = (GrainId.for_grain(GT, 999),)
    out = []
    for i in range(n):
        d = Direction.ONE_WAY if i % 7 == 0 else Direction.REQUEST
        ctx = ({"__otpu_trace__": (0xD0 + i, i, 1700000000.0 + i)}
               if i % 4 == 0 else ({"bag": i} if i % 5 == 0 else None))
        m = make_request_fast(
            Category.APPLICATION, d, S2, None, None, S1,
            GrainId.for_grain(GT, i), "eg.IEcho", f"m{i % 3}",
            ((), {"x": i}), None,
            chain if i % 3 == 0 else (), i % 2 == 0, False, ctx, i % 2)
        if i % 11 == 0:
            m.forward_count = 1  # must peel
        out.append(m)
        if i % 6 == 0:
            req = make_request(
                target_grain=GrainId.for_grain(GT, i),
                interface_name="eg.IEcho", method_name="m",
                body=((i,), {}), sending_silo=S1, target_silo=S2,
                timeout=None)
            resp = make_response(req, i)
            resp.target_silo = S2
            out.append(resp)  # mixed run: responses interleave
    return out


@native
def test_request_template_batch_bytes_identical_to_per_frame():
    """The request-side header-prefix template (the call_batch native
    sender half): batch bytes == concatenated per-frame bytes across
    one-ways, traced headers, chain-carrying senders, and peels."""
    msgs = _request_corpus()
    per_frame = b"".join(encode_message(m) for m in msgs)
    chunks = encode_message_batch(msgs, bounce=lambda m, e: None)
    assert b"".join(chunks) == per_frame
    assert len(chunks) > 1  # template/plain runs actually split
    plain = encode_message_batch(msgs, bounce=lambda m, e: None,
                                 templates=False)
    assert b"".join(plain) == per_frame
    # round trip: every header slot survives the template encode
    consumed, decoded, bounces = decode_frames(
        bytearray(b"".join(chunks)))
    assert consumed == len(per_frame) and not bounces
    assert len(decoded) == len(msgs)
    for got, orig in zip(decoded, msgs):
        assert _slots_equal(got, orig)


def test_pickle_fallback_path_unchanged(monkeypatch):
    """ORLEANS_TPU_NATIVE=0 form: no template machinery, per-frame
    chunks, same decodable bytes."""
    msgs = _response_corpus(12)
    monkeypatch.setattr(ser, "_hotwire", None)
    chunks = encode_message_batch(msgs, bounce=lambda m, e: None)
    assert len(chunks) == len(msgs)
    consumed, decoded, _ = decode_frames(bytearray(b"".join(chunks)))
    assert len(decoded) == len(msgs)
    assert all(_slots_equal(g, o) for g, o in zip(decoded, msgs))


@native
def test_template_peels_headers_it_cannot_carry():
    """Rejections, forwarded and chain-carrying responses must NOT ride
    the template (their headers fall outside the invariant constants) —
    and must still encode byte-identically via the per-frame run."""
    from orleans_tpu_torch.runtime.wire import _frame_template

    req = make_request(target_grain=GrainId.for_grain(GT, 1),
                       interface_name="eg.IEcho", method_name="m",
                       body=((), {}), sending_silo=S2, target_silo=S1,
                       timeout=None)
    ok = make_response(req, 1)
    ok.target_silo = S2
    assert _frame_template(ok) is not None
    rej = make_rejection(req, RejectionType.OVERLOADED, "busy")
    rej.target_silo = S2
    assert _frame_template(rej) is None
    fwd = make_response(req, 1)
    fwd.target_silo = S2
    fwd.forward_count = 1
    assert _frame_template(fwd) is None
    chained = make_response(req, 1)
    chained.target_silo = S2
    chained.call_chain = (GrainId.for_grain(GT, 2),)
    assert _frame_template(chained) is None
    # requests template too since the call_batch sender half landed —
    # but a forwarded request still peels
    assert _frame_template(req) is not None
    fwd_req = make_request(target_grain=GrainId.for_grain(GT, 3),
                           interface_name="eg.IEcho", method_name="m",
                           body=((), {}), sending_silo=S2, target_silo=S1,
                           timeout=None)
    fwd_req.forward_count = 1
    assert _frame_template(fwd_req) is None
    batch = [ok, rej, fwd, chained]
    chunks = encode_message_batch(batch, bounce=lambda m, e: None)
    assert b"".join(chunks) == b"".join(encode_message(m) for m in batch)


def _fake_center(metrics: bool = False):
    from orleans_tpu_torch.observability.stats import StatsRegistry
    sent = []
    stats = StatsRegistry() if metrics else None
    center = SimpleNamespace(
        silo=SimpleNamespace(ingest_stats=stats),
        send_batch=lambda dest, msgs: sent.append((dest, list(msgs))))
    return center, sent


@bounded
async def test_accumulator_groups_per_destination_one_flush():
    center, sent = _fake_center()
    eg = EgressBatcher(center)
    msgs = _response_corpus(8)
    for i, m in enumerate(msgs):
        eg.add(S1 if i % 2 else S2, m)
    assert not sent  # armed, not flushed: nothing handed off yet
    await asyncio.sleep(0)  # the armed call_soon flush runs
    assert len(sent) == 2   # ONE send_batch per destination
    assert sorted(len(g) for _, g in sent) == [len(msgs) // 2,
                                               (len(msgs) + 1) // 2]
    assert not eg.groups and eg.last_group > 0


@bounded
async def test_flush_dest_is_the_fifo_guard():
    center, sent = _fake_center()
    eg = EgressBatcher(center)
    msgs = _response_corpus(4)
    eg.add(S1, msgs[0])
    eg.add(S2, msgs[1])
    eg.flush_dest(S1)           # a per-message send to S1 drains S1 only
    assert sent == [(S1, [msgs[0]])]
    await asyncio.sleep(0)      # the armed flush still drains S2
    assert sent[1][0] == S2 and sent[1][1] == [msgs[1]]


@bounded
async def test_system_and_ping_responses_bypass_accumulator():
    """PING/SYSTEM responses (membership probes, control RPCs) must take
    the per-message path: the accumulator's end-of-ready-run flush can
    sit behind a saturated loop's whole callback run, and a probe
    response delayed past the probe timeout gets a healthy silo voted
    dead (observed as a false-death spiral in the chaos soak)."""
    from orleans_tpu_torch.core.message import Category
    from orleans_tpu_torch.runtime.cluster import InProcFabric

    class Echo(Grain):
        async def ping(self):
            return 1

    fabric = InProcFabric()
    silo = (SiloBuilder().with_fabric(fabric).add_grains(Echo)).build()
    fabric.is_dead = lambda a: False
    sent = []
    fabric.deliver_group = lambda dest, msgs: sent.append(("group", dest))
    fabric.deliver = lambda msg: sent.append(("single", msg.category))
    for cat in (Category.PING, Category.SYSTEM):
        req = make_request(target_grain=GrainId.for_grain(GT, 1),
                          interface_name="Echo", method_name="ping",
                          body=((), {}), sending_silo=S2, target_silo=S1,
                          category=cat)
        silo.dispatcher.send_response(req, make_response(req, 1))
    assert not silo.message_center.egress.groups
    assert sent == [("single", Category.PING), ("single", Category.SYSTEM)]
    # APPLICATION responses still accumulate
    req = make_request(target_grain=GrainId.for_grain(GT, 2),
                      interface_name="Echo", method_name="ping",
                      body=((), {}), sending_silo=S2, target_silo=S1)
    silo.dispatcher.send_response(req, make_response(req, 2))
    assert silo.message_center.egress.groups


@bounded
async def test_send_message_drains_pending_group_for_fifo():
    """MessageCenter.send_message must flush a pending response group to
    its destination before the per-message send — per-sender FIFO per
    target is the wire's one ordering guarantee."""
    from orleans_tpu_torch.runtime.cluster import InProcFabric

    class Echo(Grain):
        async def ping(self):
            return 1

    fabric = InProcFabric()
    silo = (SiloBuilder().with_fabric(fabric).add_grains(Echo)).build()
    order = []
    fabric.is_dead = lambda a: False  # S1/S2 are stand-in peers
    fabric.deliver_group = lambda dest, msgs: order.append(
        ("group", dest, len(msgs)))
    fabric.deliver = lambda msg: order.append(("single", msg.target_silo))
    req = make_request(target_grain=GrainId.for_grain(GT, 1),
                      interface_name="Echo", method_name="ping",
                      body=((), {}), sending_silo=S2, target_silo=S1)
    resp = make_response(req, 1)
    silo.dispatcher.send_response(req, resp)        # accumulates for S2
    assert silo.message_center.egress.groups
    follow = make_request(target_grain=GrainId.for_grain(GT, 2),
                          interface_name="Echo", method_name="ping",
                          body=((), {}), target_silo=S2)
    silo.message_center.send_message(follow)
    assert order[0][0] == "group" and order[0][1] == S2
    assert order[1][0] == "single"


class _StubClient(RuntimeClient):
    """RuntimeClient with a recording transmit/deliver surface."""

    def __init__(self):
        super().__init__(response_timeout=5.0)
        self.delivered = []

    @property
    def silo_address(self):
        return S2

    def transmit(self, msg):
        pass

    def deliver(self, msg):
        # the real client deliver contract: responses correlate,
        # everything else dispatches (observers)
        if msg.direction == Direction.RESPONSE:
            self.receive_response(msg)
        else:
            self.delivered.append(msg)


@bounded
async def test_receive_response_batch_resolves_and_sweeps():
    client = _StubClient()
    loop = asyncio.get_running_loop()
    reqs, futs, resps = [], [], []
    for i in range(6):
        req = make_request(target_grain=GrainId.for_grain(GT, i),
                           interface_name="eg.IEcho", method_name="m",
                           body=((), {}), sending_silo=S2, target_silo=S1)
        fut = loop.create_future()
        client.callbacks[req.id] = _fresh_callback(req, fut, None, None)
        if i % 3 == 2:
            resp = make_error_response(req, ValueError(f"e{i}"))
        else:
            resp = make_response(req, i * 10)
        reqs.append(req)
        futs.append(fut)
        resps.append(resp)
    client.receive_response_batch(resps)
    assert not client.callbacks
    for i, fut in enumerate(futs):
        if i % 3 == 2:
            with pytest.raises(ValueError):
                fut.result()
        else:
            assert fut.result() == i * 10
    # ONE release sweep retired both envelopes of every settled RPC
    assert all(m._pool_free for m in reqs)
    assert all(m._pool_free for m in resps)


@bounded
async def test_receive_response_batch_rejection_delegates():
    """Rejections keep their exact per-message semantics (here: the
    terminal rejection error) through the batched entry."""
    client = _StubClient()
    loop = asyncio.get_running_loop()
    req = make_request(target_grain=GrainId.for_grain(GT, 1),
                       interface_name="eg.IEcho", method_name="m",
                       body=((), {}), sending_silo=S2, target_silo=S1)
    req.resend_count = 3  # over MAX_RESEND_COUNT: rejection is terminal
    fut = loop.create_future()
    client.callbacks[req.id] = _fresh_callback(req, fut, None, None)
    rej = make_rejection(req, RejectionType.TRANSIENT, "nope")
    ok_req = make_request(target_grain=GrainId.for_grain(GT, 2),
                          interface_name="eg.IEcho", method_name="m",
                          body=((), {}), sending_silo=S2, target_silo=S1)
    ok_fut = loop.create_future()
    client.callbacks[ok_req.id] = _fresh_callback(ok_req, ok_fut, None, None)
    client.receive_response_batch([rej, make_response(ok_req, "ok")])
    from orleans_tpu_torch.core.errors import RejectionError
    with pytest.raises(RejectionError):
        fut.result()
    assert ok_fut.result() == "ok"


@bounded
async def test_deliver_batch_mixed_runs_preserve_order():
    client = _StubClient()
    loop = asyncio.get_running_loop()
    req = make_request(target_grain=GrainId.for_grain(GT, 1),
                       interface_name="eg.IEcho", method_name="m",
                       body=((), {}), sending_silo=S2, target_silo=S1)
    fut = loop.create_future()
    client.callbacks[req.id] = _fresh_callback(req, fut, None, None)
    notify = make_request(target_grain=GrainId.for_grain(GT, 9),
                          interface_name="Observer", method_name="notify",
                          body=((), {}), direction=Direction.ONE_WAY)
    client.deliver_batch([notify, make_response(req, 5)])
    assert client.delivered == [notify]
    assert fut.result() == 5
    # the per-message lever: batched correlation off, deliver() sees all
    client.batched_egress = False
    req2 = make_request(target_grain=GrainId.for_grain(GT, 3),
                        interface_name="eg.IEcho", method_name="m",
                        body=((), {}), sending_silo=S2, target_silo=S1)
    fut2 = loop.create_future()
    client.callbacks[req2.id] = _fresh_callback(req2, fut2, None, None)
    client.deliver_batch([make_response(req2, 6)])
    assert fut2.result() == 6  # deliver() -> receive_response per message


def test_recycle_messages_batch_sweep_semantics():
    req = make_request(target_grain=GrainId.for_grain(GT, 1),
                       interface_name="eg.IEcho", method_name="m",
                       body=((1,), {}), sending_silo=S2, target_silo=S1)
    resp = make_response(req, {"big": [1, 2, 3]})
    prev = set_debug_pool(True)
    try:
        g_req, g_resp = pool_generation(req), pool_generation(resp)
        recycle_messages([req, resp])
        assert req._pool_free and resp._pool_free
        assert pool_generation(req) == g_req + 1
        assert pool_generation(resp) == g_resp + 1
        assert req.body is None and resp.body is None
        # idempotent: a second sweep is a no-op (no double generation)
        recycle_messages([req, resp])
        assert pool_generation(req) == g_req + 1
    finally:
        set_debug_pool(prev)


# ---------------------------------------------------------------------------
# End to end over real sockets
# ---------------------------------------------------------------------------

def _vector_counter():
    from orleans_tpu_torch.dispatch import VectorGrain, actor_method

    class CounterVec(VectorGrain):
        STATE = {"count": (torch.int32, ())}

        @staticmethod
        def initial_state(key_hash):
            return {"count": torch.zeros_like(key_hash)}

        @actor_method(args={"x": (torch.int32, ())})
        def bump(state, args):
            return {"count": state["count"] + 1}, state["count"]

        @actor_method(args={})
        def read(state, args):
            return state, state["count"]

    return CounterVec


async def _socket_cluster(vec_cls=None, n_keys: int = 32,
                          extra_grains=(), **cfg):
    from orleans_tpu_torch.runtime.socket_fabric import (GatewayClient,
                                                         SocketFabric)

    class EchoGrain(Grain):
        def __init__(self):
            self.seen = []

        async def ping(self, x):
            return x

        async def record(self, x):
            self.seen.append(x)
            return x

        async def seen_list(self):
            return list(self.seen)

    fabric = SocketFabric()
    b = (SiloBuilder().with_name("eg").with_fabric(fabric)
         .add_grains(EchoGrain, *extra_grains).with_config(**cfg))
    if vec_cls is not None:
        from orleans_tpu_torch.dispatch import add_vector_grains
        add_vector_grains(b, vec_cls, mesh=make_mesh(1, device="cpu"),
                          dense={vec_cls: n_keys})
    silo = b.build()
    await silo.start()
    client = await GatewayClient([silo.silo_address.endpoint]).connect()
    return silo, client, EchoGrain


@pytest.mark.parametrize("egress", [True, False])
@bounded
async def test_vector_call_batch_results_identical_either_lever(egress):
    CounterVec = _vector_counter()
    silo, client, EchoGrain = await _socket_cluster(
        CounterVec, batched_egress=egress)
    client.batched_egress = egress
    try:
        assert (silo.message_center.egress is not None) == egress
        # vector burst through call_batch: responses resolve from one
        # inbound batch — the exact shape the egress pipeline groups
        outs = await asyncio.gather(*client.call_batch(
            CounterVec, "bump",
            [(k, {"x": np.int32(0)}) for k in range(32)]))
        assert [int(v) for v in outs] == [0] * 32
        outs2 = await asyncio.gather(*client.call_batch(
            CounterVec, "bump",
            [(k, {"x": np.int32(0)}) for k in range(32)]))
        assert [int(v) for v in outs2] == [1] * 32
        # host-tier burst: eager-ish turn completions group the same way
        g = client.get_grain(EchoGrain, "h")
        vals = await asyncio.gather(*(g.ping(i) for i in range(50)))
        assert vals == list(range(50))
    finally:
        await client.close_async()
        await silo.stop()


@bounded
async def test_recycle_discipline_under_debug_pool_batched_egress():
    """ORLEANS_TPU_DEBUG_POOL=1 across the whole batched response path:
    send_response_batch → egress accumulator → wire template → client
    batch correlation → one freelist sweep. Any shell touched after
    recycle (or recycled twice into service) trips PoolDisciplineError."""
    prev = set_debug_pool(True)
    try:
        CounterVec = _vector_counter()
        silo, client, EchoGrain = await _socket_cluster(CounterVec,
                                                        n_keys=16)
        try:
            g = client.get_grain(EchoGrain, "pool")
            for _ in range(3):
                outs = await asyncio.gather(
                    *(g.ping(i) for i in range(20)),
                    *client.call_batch(
                        CounterVec, "bump",
                        [(k, {"x": np.int32(0)}) for k in range(16)]))
                assert list(outs[:20]) == list(range(20))
        finally:
            await client.close_async()
            await silo.stop()
    finally:
        set_debug_pool(prev)


# ---------------------------------------------------------------------------
# tests/test_batched_ingress.py: the batched hand-off into the engine
# ---------------------------------------------------------------------------


@bounded
async def test_batch_preserves_order_within_grain():
    silo, client, EchoGrain = await _socket_cluster()
    try:
        g = client.get_grain(EchoGrain, "ordered")
        await g.record(-1)  # activate
        # burst without awaiting: the whole window rides few socket
        # reads, so ordering must survive the batched hand-off
        out = await asyncio.gather(*(g.record(i) for i in range(100)))
        assert out == list(range(100))
        assert await g.seen_list() == [-1] + list(range(100))
    finally:
        await client.close_async()
        await silo.stop()


@bounded
async def test_vector_batch_correct_and_ordered():
    CounterVec = _vector_counter()
    silo, client, _ = await _socket_cluster(CounterVec, n_keys=64,
                                            metrics_enabled=True)
    try:
        refs = [client.get_grain(CounterVec, k) for k in range(64)]
        # concurrent burst across keys: one bump each
        out = await asyncio.gather(*(r.bump(x=np.int32(0)) for r in refs))
        assert all(int(v) == 0 for v in out)
        # same-key burst: conflict-deferred ticks must preserve arrival
        # order (returned counts strictly increasing)
        r0 = refs[0]
        seq = await asyncio.gather(*(r0.bump(x=np.int32(i))
                                     for i in range(10)))
        assert [int(v) for v in seq] == list(range(1, 11))
        reads = await asyncio.gather(*(r.read() for r in refs))
        expect = [11] + [1] * 63
        assert [int(v) for v in reads] == expect
    finally:
        await client.close_async()
        await silo.stop()


@bounded
async def test_recycle_discipline_under_debug_pool():
    """ORLEANS_TPU_DEBUG_POOL=1 over the batched socket path: no pooled
    shell may be touched after recycle anywhere in the batch pipeline."""
    prev = set_debug_pool(True)
    try:
        CounterVec = _vector_counter()
        silo, client, EchoGrain = await _socket_cluster(CounterVec,
                                                        n_keys=16)
        try:
            g = client.get_grain(EchoGrain, "pool")
            refs = [client.get_grain(CounterVec, k) for k in range(16)]
            for _ in range(3):
                out = await asyncio.gather(
                    *(g.record(i) for i in range(20)),
                    *(r.bump(x=np.int32(0)) for r in refs))
                assert list(out[:20]) == list(range(20))
        finally:
            await client.close_async()
            await silo.stop()
    finally:
        set_debug_pool(prev)


@bounded
async def test_staging_double_buffer_stale_lane_reset():
    """Alternating batch sizes over one (class, method, B) bucket: a
    large fill followed by a smaller one on the recycled buffer must
    leave the stale tail lanes inert (no ghost writes into rows the
    smaller batch never touched) — the staging reset discipline under
    concurrent fill/tick."""
    CounterVec = _vector_counter()
    silo, client, _ = await _socket_cluster(CounterVec, n_keys=64)
    try:
        refs = [client.get_grain(CounterVec, k) for k in range(64)]
        # wave 1: all 64 keys (fills lanes 0..63 of the B=64 bucket)
        await asyncio.gather(*(r.bump(x=np.int32(0)) for r in refs))
        # waves 2..4: only the first 40 keys — the same bucket's OTHER
        # buffer, then the recycled first buffer with 24 stale lanes
        for _ in range(3):
            await asyncio.gather(*(r.bump(x=np.int32(0))
                                   for r in refs[:40]))
        reads = await asyncio.gather(*(r.read() for r in refs))
        assert [int(v) for v in reads] == [4] * 40 + [1] * 24
        assert silo.vector.staging_lanes() > 0  # double buffers live
    finally:
        await client.close_async()
        await silo.stop()


def test_staging_reset_repoints_all_lanes_on_sink_move():
    """reset() with an unchanged sink only re-arms the used prefix; when
    the sink MOVED (a table grow() made the old sink row — == old
    capacity — a real allocatable slot) every lane must re-point, else a
    stale idle lane scatters into whichever actor lands on that row."""
    from orleans_tpu_torch.dispatch.engine import _StagingSet

    st = _StagingSet(1, 8, 8, {"x": (np.int32, ())}, pin=False)
    st.used = [6]
    st.slots[0, :6] = np.arange(6)
    st.valid[0, :6] = True
    st.fresh[0, :6] = True
    st.reset(8)  # same sink: prefix re-arm
    assert (st.slots == 8).all() and not st.valid.any()
    st.used = [2]
    st.slots[0, :2] = [3, 4]
    st.valid[0, :2] = True
    st.reset(16)  # sink moved: EVERY lane re-points, fresh cleared
    assert (st.slots == 16).all()
    assert not st.valid.any() and not st.fresh.any()
    assert st.used == [0]


@bounded
async def test_staging_survives_table_growth():
    """End to end over the recycled staging pair: growing the table must
    not let a stale idle lane (still aimed at the old sink) scatter into
    the actor that now occupies the old sink row."""
    from orleans_tpu_torch.dispatch import VectorRuntime

    CounterVec = _vector_counter()
    rt = VectorRuntime(mesh=make_mesh(1, device="cpu"),
                       capacity_per_shard=8)
    tbl = rt.table(CounterVec)
    old_sink = tbl.sink_slot

    def group(keys):
        return [(k, {"x": np.int32(0)}, True) for k in keys]

    # two waves through one B-bucket so BOTH staging buffers exist and
    # hold the old sink in their never-used lanes
    for _ in range(2):
        await asyncio.gather(
            *rt.call_group(CounterVec, "bump", group(range(1, 7))))
    # drain the free list → grow(): the old sink row becomes allocatable
    await asyncio.gather(
        *rt.call_group(CounterVec, "bump", group(range(100, 160))))
    assert tbl.sink_slot > old_sink
    victim = next(k for k, (_s, slot) in tbl.key_to_slot.items()
                  if slot == old_sink)
    before = int(await rt.call(CounterVec, victim, "read"))
    # small waves through the recycled pair, victim in the batch: its
    # bump must not race a stale-lane write-back of the pre-bump row
    for _ in range(2):
        await asyncio.gather(*rt.call_group(
            CounterVec, "bump", group([victim, 1, 2])))
    assert int(await rt.call(CounterVec, victim, "read")) == before + 2


@bounded
async def test_call_group_all_failed_leaves_no_pending_entry():
    """A group whose every item fails (schema violations) must neither
    leave an empty pending entry behind nor schedule a tick over it — an
    empty batch would crash first-batch schema inference (items[0])."""
    from orleans_tpu_torch.dispatch import VectorRuntime

    CounterVec = _vector_counter()
    rt = VectorRuntime(mesh=make_mesh(1, device="cpu"))
    await rt.call(CounterVec, 1, "bump", x=np.int32(0))  # infer schema
    ticks = rt.ticks
    futs = rt.call_group(CounterVec, "bump",
                         [(2, {"bogus": np.int32(0)}, True),
                          (3, {}, True)])
    for f in futs:
        with pytest.raises(TypeError):
            await f
    assert not rt.pending
    await asyncio.sleep(0)  # a (wrongly) scheduled tick would run here
    assert rt.ticks == ticks
    assert rt.call_group(CounterVec, "bump", []) == []  # degenerate
    assert not rt.pending


@bounded
async def test_per_frame_fallback_config_still_works():
    """batched_ingress=False restores the per-frame hand-off end to end
    (the A/B lever the floor test leans on)."""
    CounterVec = _vector_counter()
    silo, client, EchoGrain = await _socket_cluster(
        CounterVec, n_keys=8, batched_ingress=False)
    try:
        g = client.get_grain(EchoGrain, "pf")
        assert await asyncio.gather(*(g.record(i) for i in range(10))) == \
            list(range(10))
        r = client.get_grain(CounterVec, 3)
        assert int(await r.bump(x=np.int32(0))) == 0
    finally:
        await client.close_async()
        await silo.stop()


@bounded
async def test_vector_batch_bad_kwargs_scoped_to_one_message():
    """A vector-tier message whose body carries a non-dict kwargs payload
    must bounce alone — the rest of its ingress group still executes
    (previously the whole group was error-bounced AND the enqueued slice
    still ticked)."""
    CounterVec = _vector_counter()
    silo, client, _ = await _socket_cluster(CounterVec, n_keys=8)
    try:
        vecg = GrainType.of("CounterVec")
        batch = []
        for i in range(4):
            body = ((), [1, 2]) if i == 2 else ((), {"x": np.int32(0)})
            batch.append(make_request(
                target_grain=GrainId.for_grain(vecg, i),
                interface_name="CounterVec", method_name="bump",
                body=body, direction=Direction.ONE_WAY))
        silo.message_center.deliver_batch(batch)
        await silo.vector.flush()
        reads = await asyncio.gather(
            *(client.get_grain(CounterVec, k).read() for k in range(4)))
        assert [int(v) for v in reads] == [1, 1, 0, 1]
    finally:
        await client.close_async()
        await silo.stop()


@bounded
async def test_deliver_batch_honors_receiver_batched_ingress_off():
    """A co-hosted batched-mode silo's fabric pump may hand a grouped
    read to a batched_ingress=False silo: the RECEIVER's A/B lever must
    still route per-message."""
    CounterVec = _vector_counter()
    silo, client, EchoGrain = await _socket_cluster(
        CounterVec, n_keys=4, batched_ingress=False)
    try:
        mc = silo.message_center
        mc._route_batch = lambda msgs: pytest.fail(
            "batched route taken with batched_ingress=False")
        vecg = GrainType.of("CounterVec")
        msgs = [make_request(
            target_grain=GrainId.for_grain(vecg, k),
            interface_name="CounterVec", method_name="bump",
            body=((), {"x": np.int32(0)}), direction=Direction.ONE_WAY)
            for k in range(4)]
        mc.deliver_batch(msgs)
        await silo.vector.flush()
        reads = await asyncio.gather(
            *(client.get_grain(CounterVec, k).read() for k in range(4)))
        assert [int(v) for v in reads] == [1] * 4
    finally:
        await client.close_async()
        await silo.stop()


# ---------------------------------------------------------------------------
# Metrics: stages populated when on, nothing when off
# ---------------------------------------------------------------------------

@bounded
async def test_egress_stats_populated_and_gauge_registered():
    CounterVec = _vector_counter()
    silo, client, _ = await _socket_cluster(CounterVec,
                                            metrics_enabled=True,
                                            metrics_sample_period=0.05)
    try:
        await asyncio.gather(*client.call_batch(
            CounterVec, "bump",
            [(k, {"x": np.int32(0)}) for k in range(32)]))
        await asyncio.sleep(0.15)  # a sampler tick
        snap = silo.stats.snapshot()
        assert snap["counters"].get(EGRESS_STATS["responses"], 0) > 0
        hists = snap["histograms"]
        for stage in ("build", "dwell", "group"):
            assert hists.get(EGRESS_STATS[stage], {}).get("count", 0) > 0, \
                f"egress stage {stage} never observed"
        # encode is observed fabric-side (shared senders) — present too
        assert hists.get(EGRESS_STATS["encode"], {}).get("count", 0) > 0
        assert hists[EGRESS_STATS["group"]]["mean"] > 1.0, \
            "responses are not grouping (mean flush-group size <= 1)"
        assert "vector.egress_group" in snap["gauges"]
    finally:
        await client.close_async()
        await silo.stop()


@bounded
async def test_egress_disabled_costs_nothing():
    """metrics_enabled=False: no EGRESS series may materialize — the off
    path pays one None check per site, the ingest-stage discipline."""
    CounterVec = _vector_counter()
    silo, client, _ = await _socket_cluster(CounterVec)
    try:
        await asyncio.gather(*client.call_batch(
            CounterVec, "bump",
            [(k, {"x": np.int32(0)}) for k in range(16)]))
        for name in EGRESS_STATS.values():
            assert name not in silo.stats.histograms
            assert name not in silo.stats.counters
    finally:
        await client.close_async()
        await silo.stop()


# ---------------------------------------------------------------------------
# Tracing parity on the batched path
# ---------------------------------------------------------------------------

@bounded
async def test_response_leg_span_rides_batched_egress():
    """_stamp_response's wall stamp crosses the batched wire in the
    template's varying request_context field; the client's batched
    correlation records the response-leg network span identically."""
    CounterVec = _vector_counter()
    silo, client, EchoGrain = await _socket_cluster(
        CounterVec, trace_enabled=True, metrics_enabled=True)
    client.enable_tracing(sample_rate=1.0)
    try:
        g = client.get_grain(EchoGrain, "traced")
        assert await asyncio.gather(*(g.ping(i) for i in range(8))) == \
            list(range(8))
        # the batched pipeline actually carried the responses
        assert silo.stats.get(EGRESS_STATS["responses"]) > 0
        spans = client.tracer.snapshot()
        legs = [s for s in spans if s["kind"] == "network"
                and s["attrs"].get("leg") == "response"]
        assert legs, f"no response-leg network span in {spans}"
    finally:
        await client.close_async()
        await silo.stop()
