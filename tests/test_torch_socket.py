"""The port's TCP socket fabric (orleans_tpu_torch.runtime.socket_fabric)
on the CPU, over real localhost sockets.

* The port's copies of tests/test_socket_transport.py (wire framing,
  gateway clients, two silos in separate fabrics with a shared file
  membership table, death detection, reconnects, undecodable payloads,
  version maps, a garbled handshake), of
  tests/test_vector_hosting.py::test_vector_hosting_over_tcp (the device
  tier behind a gateway, ``make_mesh(8, device="cpu")``),
  tests/test_observers.py::test_observer_push_over_tcp and the two wire
  tests of tests/test_cancellation.py, run through the port.
* The fabric options once refused (``ingress_loops > 1``,
  ``egress_shards > 0``, ``worker_procs > 1``), set by ``with_config`` or
  their options group, start a silo on a ``SocketFabric`` that answers a
  gateway client, and the SO_REUSEPORT listener joins its port's group.
* samples/presence_torch.py's drive at 2,000 players: over a
  ``GatewayClient`` on the port, over ``ClusterClient`` on the port, and
  over the JAX package's ``GatewayClient`` to its own silo; every answer,
  the table and the reloaded rows must be equal exactly.

Every silo binds 127.0.0.1:0, clients and silos close in ``finally``,
and every async body runs under ``asyncio.wait_for(..., 30)``; the
package pairs run one after the other, never on one loop.
"""

import asyncio
import functools
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orleans_tpu.dispatch as jd
import orleans_tpu.membership as jm
import orleans_tpu.parallel as jp
import orleans_tpu.runtime as jr
import orleans_tpu.storage as js
import orleans_tpu_torch.dispatch as td
import orleans_tpu_torch.membership as tm
import orleans_tpu_torch.parallel as tp
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.storage as ts
from orleans_tpu_torch.core.ids import GrainId, GrainType, SiloAddress
from orleans_tpu_torch.core.message import make_request, make_response
from orleans_tpu_torch.membership import FileMembershipTable, join_cluster
from orleans_tpu_torch.runtime import (
    GatewayClient,
    GrainCancellationToken,
    GrainCancellationTokenSource,
    Grain,
    ObserverRef,
    SiloBuilder,
    SocketFabric,
)
from orleans_tpu_torch.runtime.wire import (
    decode_message,
    encode_message,
    read_frame,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "samples"))
import presence_torch  # noqa: E402

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


class EchoGrain(Grain):
    async def echo(self, text: str) -> str:
        return f"{self.primary_key}:{text}"

    async def where(self) -> str:
        return self.runtime_identity


class RelayGrain(Grain):
    """Cross-silo grain→grain call path."""

    async def relay(self, target_key: int, text: str) -> str:
        target = self.get_grain(EchoGrain, target_key)
        return await target.echo(text)


# ---------------------------------------------------------------------------
# Wire framing
# ---------------------------------------------------------------------------

class _BufReader:
    """Minimal StreamReader stand-in over a bytes buffer."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    async def readexactly(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise asyncio.IncompleteReadError(b"", n)
        out = self._data[self._pos:self._pos + n]
        self._pos += n
        return out


@bounded
async def test_wire_roundtrip_preserves_headers_and_rebases_ttl():
    gid = GrainId.for_grain(GrainType.of("EchoGrain"), 42)
    msg = make_request(
        target_grain=gid, interface_name="EchoGrain", method_name="echo",
        body=(("hello",), {}), timeout=10.0,
        sending_silo=SiloAddress("10.0.0.1", 5000, 7),
        request_context={"trace": "abc"})
    msg.call_chain = (GrainId.for_grain(GrainType.of("Caller"), 1),)
    data = encode_message(msg)
    headers, body = await read_frame(_BufReader(data))
    out = decode_message(headers, body)
    assert out.target_grain == gid
    assert out.method_name == "echo"
    assert out.body == (("hello",), {})
    assert out.id == msg.id
    assert out.sending_silo == msg.sending_silo
    assert out.call_chain == msg.call_chain
    assert out.request_context == {"trace": "abc"}
    # TTL rebased to the receiver's monotonic clock, not copied raw
    assert out.expires_at is not None
    remaining = out.expires_at - time.monotonic()
    assert 8.0 < remaining <= 10.0

    resp = make_response(out, "result")
    headers, body = await read_frame(_BufReader(encode_message(resp)))
    rout = decode_message(headers, body)
    assert rout.body == "result"
    assert rout.id == msg.id


# ---------------------------------------------------------------------------
# Single silo + TCP gateway client
# ---------------------------------------------------------------------------

async def _start_socket_silo(name, table, *, grains=(EchoGrain, RelayGrain)):
    fabric = SocketFabric()
    silo = (SiloBuilder().with_name(name).with_fabric(fabric)
            .add_grains(*grains).with_config(**FAST).build())
    join_cluster(silo, table)
    await silo.start()
    return fabric, silo


@bounded
async def test_gateway_client_end_to_end(tmp_path):
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    fabric, silo = await _start_socket_silo("s1", table)
    client = None
    try:
        gw = silo.silo_address.endpoint
        client = await GatewayClient([gw], response_timeout=5.0).connect()
        g = client.get_grain(EchoGrain, 7)
        assert await g.echo("hi") == "7:hi"
        # many concurrent calls through the same socket
        outs = await asyncio.gather(
            *(client.get_grain(EchoGrain, i).echo("x") for i in range(50)))
        assert outs == [f"{i}:x" for i in range(50)]
    finally:
        if client is not None:
            await client.close_async()
        await silo.stop()


@bounded
async def test_two_silos_over_sockets_cross_silo_calls(tmp_path):
    """Two silos in separate fabrics (the process-boundary shape): placement
    spreads grains, grain→grain calls cross the TCP wire, and the client
    reaches grains on both silos through one gateway."""
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    fabric1, silo1 = await _start_socket_silo("s1", table)
    fabric2, silo2 = await _start_socket_silo("s2", table)
    client = None
    try:
        # membership convergence across fabrics
        async def converged():
            while True:
                views = [set(s.membership.active) for s in (silo1, silo2)]
                if all(len(v) == 2 for v in views) and views[0] == views[1]:
                    return
                await asyncio.sleep(0.05)
        await asyncio.wait_for(converged(), timeout=10.0)

        client = await GatewayClient(
            [silo1.silo_address.endpoint], response_timeout=5.0).connect()
        # touch many grains; hash placement must land some on each silo
        wheres = await asyncio.gather(
            *(client.get_grain(EchoGrain, i).where() for i in range(40)))
        assert len(set(wheres)) == 2, f"all activations on one silo: {set(wheres)}"
        counts = (silo1.catalog.activation_count(),
                  silo2.catalog.activation_count())
        assert all(c > 0 for c in counts)

        # grain→grain across the wire: relay grain on some silo calls echo
        # grains wherever they live
        outs = await asyncio.gather(
            *(client.get_grain(RelayGrain, i).relay(100 + i, "r")
              for i in range(10)))
        assert outs == [f"{100 + i}:r" for i in range(10)]
    finally:
        if client is not None:
            await client.close_async()
        await silo2.stop()
        await silo1.stop()


@bounded
async def test_gateway_client_multiple_gateways_affinity(tmp_path):
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    fabric1, silo1 = await _start_socket_silo("s1", table)
    fabric2, silo2 = await _start_socket_silo("s2", table)
    client = None
    try:
        client = await GatewayClient(
            [silo1.silo_address.endpoint, silo2.silo_address.endpoint],
            response_timeout=5.0).connect()
        assert len(client._live()) == 2
        outs = await asyncio.gather(
            *(client.get_grain(EchoGrain, i).echo("y") for i in range(30)))
        assert outs == [f"{i}:y" for i in range(30)]
        # same grain always routes through the same gateway (affinity)
        g = client.get_grain(EchoGrain, 3)
        first = await g.echo("a")
        assert first == "3:a"
    finally:
        if client is not None:
            await client.close_async()
        await silo2.stop()
        await silo1.stop()


@bounded
async def test_silo_death_detected_over_sockets(tmp_path):
    """Kill one of two socket silos: the survivor's probe/vote protocol must
    declare it dead over the real wire, and client calls must re-route
    (virtual-actor recreation) instead of hanging."""
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    fabric1, silo1 = await _start_socket_silo("s1", table)
    fabric2, silo2 = await _start_socket_silo("s2", table)
    client = None
    try:
        async def converged(n):
            while True:
                if all(len(s.membership.active) == n
                       for s in (silo1,) if s.status == "Running"):
                    if n != 2 or len(silo2.membership.active) == 2:
                        return
                await asyncio.sleep(0.05)
        await asyncio.wait_for(converged(2), timeout=10.0)

        client = await GatewayClient(
            [silo1.silo_address.endpoint], response_timeout=5.0).connect()
        await asyncio.gather(
            *(client.get_grain(EchoGrain, i).echo("pre") for i in range(20)))

        dead_addr = silo2.silo_address
        await silo2.stop(graceful=False)  # kill: no goodbye row

        async def declared_dead():
            while dead_addr not in silo1.membership.dead:
                await asyncio.sleep(0.05)
        await asyncio.wait_for(declared_dead(), timeout=10.0)

        # every grain is callable again — recreated on the survivor
        outs = await asyncio.gather(
            *(client.get_grain(EchoGrain, i).echo("post") for i in range(20)),
            return_exceptions=True)
        errs = [o for o in outs if isinstance(o, Exception)]
        assert not errs, f"calls failed after failover: {errs[:3]}"
        assert outs == [f"{i}:post" for i in range(20)]
    finally:
        if client is not None:
            await client.close_async()
        await silo1.stop()


@bounded
async def test_gateway_client_reconnects_after_connection_blip(tmp_path):
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    fabric, silo = await _start_socket_silo("s1", table)
    client = None
    try:
        client = await GatewayClient(
            [silo.silo_address.endpoint], response_timeout=5.0).connect()
        client._reconnect_period = 0.05
        g = client.get_grain(EchoGrain, 1)
        assert await g.echo("a") == "1:a"
        # sever the TCP connection out from under the client
        client.conns[0].writer.close()
        await asyncio.sleep(0.3)  # reconnect loop revives the link

        async def retry():
            while True:
                try:
                    return await g.echo("b")
                except Exception:
                    await asyncio.sleep(0.05)
        out = await asyncio.wait_for(retry(), timeout=5.0)
        assert out == "1:b"
    finally:
        if client is not None:
            await client.close_async()
        await silo.stop()


class _ModuleLevelUnregistered:
    """Pickles by reference to the 'tests' module, which is outside the wire
    allowlist — decodes fail at the receiving silo."""


@bounded
async def test_undecodable_payload_is_rejected_not_hung(tmp_path):
    """Payload types the wire cannot carry must produce a prompt error at
    the caller (the serializer registration gate), not a timeout — on both
    the encode side (unpicklable local class) and the decode side
    (unregistered module)."""
    class NotEncodable:
        pass

    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    fabric, silo = await _start_socket_silo("s1", table)
    client = None
    try:
        client = await GatewayClient(
            [silo.silo_address.endpoint], response_timeout=5.0).connect()
        g = client.get_grain(EchoGrain, 1)
        t0 = time.monotonic()
        with pytest.raises(Exception, match="encode"):
            await g.echo(NotEncodable())
        with pytest.raises(Exception, match="decode"):
            await g.echo(_ModuleLevelUnregistered())
        assert time.monotonic() - t0 < 4.0, "should fail fast, not time out"
        # the connection survives for subsequent valid calls
        assert await g.echo("ok") == "1:ok"
    finally:
        if client is not None:
            await client.close_async()
        await silo.stop()


# ---------------------------------------------------------------------------
# Cross-process version-map exchange (TypeManager.cs:15 over the wire)
# ---------------------------------------------------------------------------

from orleans_tpu_torch.versions import grain_version  # noqa: E402


@grain_version(1)
class _WireApiV1(Grain):
    async def ping(self):
        return ("v1", self.runtime_identity)


@grain_version(2)
class _WireApiV2(Grain):
    async def ping(self):
        return ("v2", self.runtime_identity)


# one interface name, two versions — the rolling-upgrade shape
_WireApiV1.__name__ = "WireApi"
_WireApiV2.__name__ = "WireApi"


@bounded
async def test_version_map_exchanged_across_fabrics(tmp_path):
    """Two silos in separate socket fabrics (the process-boundary shape):
    the type maps ride the wire, and a v2-only call is routed away from
    the v1 silo — the gating that used to be silently skipped when no
    version info was reachable cross-process."""
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    fabric1, silo1 = await _start_socket_silo("v1silo", table,
                                              grains=(_WireApiV1,))
    fabric2, silo2 = await _start_socket_silo("v2silo", table,
                                              grains=(_WireApiV2,))
    client = None
    try:
        async def converged():
            while True:
                views = [set(s.membership.active) for s in (silo1, silo2)]
                if all(len(v) == 2 for v in views) and views[0] == views[1]:
                    return
                await asyncio.sleep(0.05)
        await asyncio.wait_for(converged(), timeout=10.0)

        # maps exchanged over the wire (refresh loop / membership hook)
        async def maps_arrived():
            while not (
                silo1.locator.versions.remote_maps.get(
                    silo2.silo_address, {}).get("WireApi") == 2
                and silo2.locator.versions.remote_maps.get(
                    silo1.silo_address, {}).get("WireApi") == 1
            ):
                await asyncio.sleep(0.05)
        await asyncio.wait_for(maps_arrived(), timeout=10.0)

        # a v2-compiled caller entering through the v1 silo's gateway must
        # still land on the v2 silo, for every key
        client = await GatewayClient(
            [silo1.silo_address.endpoint], response_timeout=5.0).connect()
        for k in range(12):
            v, where = await client.get_grain(_WireApiV2, k).ping()
            assert v == "v2", f"key {k} served by {where}"

        # strict compat cluster-wide: with only a v1 silo hosting the
        # directory range... v2 calls with no exact-version host are
        # rejected at addressing (gating runs on the directory owner)
        silo1.locator.versions.set_strategy(compat="strict")
        silo2.locator.versions.set_strategy(compat="strict")
        await silo2.stop()  # v2 host gone: nothing can serve v2 strictly
        with pytest.raises(Exception):
            await asyncio.wait_for(
                silo1.grain_factory.get_grain(_WireApiV2, 999).ping(), 6.0)
    finally:
        if client is not None:
            await client.close_async()
        await silo1.stop()
        await silo2.stop()


@bounded
async def test_garbled_handshake_reply_fails_the_dial():
    """A garbled/truncated handshake reply leaves the stream
    misaligned — negotiation must raise into the redial path, never keep
    reading frames from the corrupt stream."""
    from orleans_tpu_torch.runtime.socket_fabric import _read_peer_codec

    async def feed(data: bytes):
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        return reader

    # garbage bytes: unreadable frame -> ConnectionError (OSError)
    with pytest.raises(ConnectionError):
        await _read_peer_codec(await feed(b"\xff\xfe garbage not a frame"))
    # truncated (EOF mid-frame) -> same
    with pytest.raises(ConnectionError):
        await _read_peer_codec(await feed(b"\x00"))



# ---------------------------------------------------------------------------
# The device tier behind a gateway (tests/test_vector_hosting.py)
# ---------------------------------------------------------------------------

class CounterVec(td.VectorGrain):
    STATE = {"count": (torch.int32, ()), "last": (torch.float32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"count": torch.zeros_like(key_hash),
                "last": key_hash.new_zeros((), dtype=torch.float32)}

    @td.actor_method(args={"x": (torch.float32, ())})
    def add(state, args):
        new = {"count": state["count"] + 1, "last": args["x"]}
        return new, new["count"]


class HostGrain(Grain):
    async def poke_vector(self, key: int, x: float) -> int:
        return int(await self.get_grain(CounterVec, key).add(x=x))


@bounded
async def test_vector_hosting_over_tcp(tmp_path):
    """Device-tier grains reachable from an out-of-process-style client
    over real TCP gateways (the full remote path: GatewayClient → socket
    fabric → dispatcher vector bridge → kernel tick → response)."""
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    fabric = SocketFabric()
    b = (SiloBuilder().with_name("vec-tcp").with_fabric(fabric)
         .add_grains(HostGrain).with_config(response_timeout=5.0))
    td.add_vector_grains(b, CounterVec, mesh=tp.make_mesh(8, device="cpu"),
                         capacity_per_shard=16)
    silo = b.build()
    join_cluster(silo, table)
    await silo.start()
    client = None
    try:
        gw = f"127.0.0.1:{silo.silo_address.port}"
        client = await GatewayClient([gw]).connect()
        g = client.get_grain(CounterVec, 3)
        assert int(await g.add(x=1.0)) == 1
        assert int(await g.add(x=2.0)) == 2
        out = await asyncio.gather(*(
            client.get_grain(CounterVec, k).add(x=0.5) for k in range(10)))
        assert all(int(v) >= 1 for v in out)
        # a host grain's call into the device tier, answered over the wire
        assert await client.get_grain(HostGrain, 0).poke_vector(3, 4.0) == 4
    finally:
        if client is not None:
            await client.close_async()
        await silo.stop()


# ---------------------------------------------------------------------------
# Observers and cancellation over the wire (tests/test_observers.py,
# tests/test_cancellation.py)
# ---------------------------------------------------------------------------

class ChatGrain(Grain):
    def __init__(self):
        self.subscribers: list[ObserverRef] = []

    async def subscribe(self, ref: ObserverRef) -> int:
        self.subscribers.append(ref)
        return len(self.subscribers)

    async def publish(self, text: str) -> int:
        for ref in self.subscribers:
            ref.on_message(text)  # one-way push
        return len(self.subscribers)


class Listener:
    def __init__(self):
        self.received: list[str] = []
        self.event = asyncio.Event()

    async def on_message(self, text: str) -> None:
        self.received.append(text)
        self.event.set()


@bounded
async def test_observer_push_over_tcp(tmp_path):
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    fabric = SocketFabric()
    silo = (SiloBuilder().with_name("obs-tcp").with_fabric(fabric)
            .add_grains(ChatGrain)
            .with_config(response_timeout=5.0).build())
    join_cluster(silo, table)
    await silo.start()
    client = None
    try:
        gw = f"127.0.0.1:{silo.silo_address.port}"
        client = await GatewayClient([gw]).connect()
        listener = Listener()
        ref = client.create_observer(listener)
        chat = client.get_grain(ChatGrain, 0)
        await chat.subscribe(ref)
        await chat.publish("over-the-wire")
        await asyncio.wait_for(listener.event.wait(), 5.0)
        assert listener.received == ["over-the-wire"]
    finally:
        if client is not None:
            await client.close_async()
        await silo.stop()


class Worker(Grain):
    async def run_until_cancelled(self, token: GrainCancellationToken) -> str:
        try:
            await asyncio.wait_for(token.wait(), timeout=5.0)
            return "cancelled"
        except asyncio.TimeoutError:
            return "timed-out"

    async def check(self, token: GrainCancellationToken) -> bool:
        return token.is_cancelled

    async def relay(self, key: int, token: GrainCancellationToken) -> str:
        # pass the token one hop further (target recording must chain)
        return await self.get_grain(Worker, key).run_until_cancelled(token)


async def _worker_pair(table, *names):
    silos = []
    for name in names:
        silo = (SiloBuilder().with_name(name).with_fabric(SocketFabric())
                .add_grains(Worker)
                .with_config(membership_probe_period=0.25,
                             membership_refresh_period=0.2)).build()
        join_cluster(silo, table)
        await silo.start()
        silos.append(silo)

    async def converged():
        while True:
            views = [set(s.membership.active) for s in silos]
            if all(len(v) == 2 for v in views) and views[0] == views[1]:
                return
            await asyncio.sleep(0.05)
    await asyncio.wait_for(converged(), timeout=10.0)
    return silos


def _hosted_on(silo, key) -> bool:
    from orleans_tpu_torch.runtime.grain import grain_type_of
    return bool(silo.catalog.by_grain.get(
        GrainId.for_grain(grain_type_of(Worker), key)))


@bounded
async def test_cancel_cascades_across_second_wire_hop(tmp_path):
    """Client → B (remote silo) → C (back on another silo): B's silo is
    the only one that knows the token was forwarded to C, so its interner
    must cascade the cancel to C's twin (the twin-targets fan-out)."""
    table = FileMembershipTable(str(tmp_path / "mbr2.json"))
    silo1, silo2 = await _worker_pair(table, "ch1", "ch2")
    client = None
    try:
        client = await GatewayClient(
            [silo1.silo_address.endpoint], response_timeout=10.0).connect()
        # find relay key on silo2 and a waiter key on silo1 (cross hops)
        relay_key = waiter_key = None
        for k in range(60):
            src0 = GrainCancellationTokenSource()
            await client.get_grain(Worker, k).check(src0.token)
            if relay_key is None and _hosted_on(silo2, k):
                relay_key = k
            elif waiter_key is None and _hosted_on(silo1, k):
                waiter_key = k
            if relay_key is not None and waiter_key is not None:
                break
        assert relay_key is not None and waiter_key is not None

        src = GrainCancellationTokenSource()
        call = asyncio.ensure_future(
            client.get_grain(Worker, relay_key).relay(waiter_key, src.token))
        await asyncio.sleep(0.3)  # let the forward reach the second hop
        await src.cancel()
        assert await asyncio.wait_for(call, timeout=5.0) == "cancelled"
    finally:
        if client is not None:
            await client.close_async()
        await silo1.stop()
        await silo2.stop()


@bounded
async def test_cancel_crosses_the_wire(tmp_path):
    """Two silos over real sockets: a token passed to a grain on silo 2 is
    rebuilt as a twin there; source.cancel() from the external client
    fires it."""
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    silo1, silo2 = await _worker_pair(table, "cx1", "cx2")
    client = None
    try:
        client = await GatewayClient(
            [silo1.silo_address.endpoint], response_timeout=10.0).connect()
        # find a key hosted on silo 2 so the token genuinely crosses TCP
        key = None
        for k in range(40):
            src0 = GrainCancellationTokenSource()
            await client.get_grain(Worker, k).check(src0.token)  # activates
            if _hosted_on(silo2, k):
                key = k
                break
        assert key is not None
        src = GrainCancellationTokenSource()
        call = asyncio.ensure_future(
            client.get_grain(Worker, key).run_until_cancelled(src.token))
        await asyncio.sleep(0.2)
        await src.cancel()
        assert await asyncio.wait_for(call, timeout=5.0) == "cancelled"
    finally:
        if client is not None:
            await client.close_async()
        await silo1.stop()
        await silo2.stop()


# ---------------------------------------------------------------------------
# The fabric options of the multi-loop and multi-process silos, once
# refused at build(), start a silo that answers (the refusal tests' ids)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option, value, group, module", [
    ("ingress_loops", 2, "MessagingOptions.ingress_loops",
     "runtime/multiloop.py"),
    ("egress_shards", 1, "MessagingOptions.egress_shards",
     "runtime/multiloop.py"),
    ("worker_procs", 2, "MessagingOptions.worker_procs",
     "runtime/multiproc.py"),
])
@pytest.mark.parametrize("how", ["with_config", "with_options"])
@bounded
async def test_socket_silo_refuses_unported_fabric_options(option, value,
                                                           group, module,
                                                           how):
    """A silo on a ``SocketFabric`` with the option set through
    ``with_config`` or its options group builds, starts the module's
    machinery (ingress shards, egress shards, forked workers) and answers
    a gateway client on its gateway endpoint."""
    from orleans_tpu_torch.config import MessagingOptions
    b = SiloBuilder().with_fabric(SocketFabric()).add_grains(EchoGrain)
    if how == "with_config":
        b.with_config(**{option: value})
    else:
        b.with_options(MessagingOptions(**{option: value}))
    silo = b.build()
    assert getattr(silo.config, option) == value
    await silo.start()
    client = None
    try:
        started = {"ingress_loops": silo.ingress_pool,
                   "egress_shards": silo.fabric.egress_pool,
                   "worker_procs": silo.workers}[option]
        assert started is not None, module
        client = await GatewayClient([silo.gateway_endpoint],
                                     response_timeout=10.0).connect()
        assert await client.get_grain(EchoGrain, 3).echo("x") == "3:x"
    finally:
        if client is not None:
            await client.close_async()
        await silo.stop()


def test_reuseport_listener_is_refused():
    """``allocate_address(reuseport=True)`` (a multi-process silo's
    advertised endpoint, once refused) reserves a port in an SO_REUSEPORT
    group: another reuseport listener binds the same port."""
    import socket
    from orleans_tpu_torch.runtime.multiproc import _reuseport_listener
    fabric = SocketFabric()
    addr = fabric.allocate_address("gw", reuseport=True)
    sock = fabric._listen_socks[addr.endpoint]
    try:
        assert sock.getsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT)
        second = _reuseport_listener(addr.host, addr.port)
        assert second.getsockname() == sock.getsockname()
        second.close()
    finally:
        sock.close()


def test_generations_made_in_one_millisecond_are_distinct(monkeypatch):
    """A gateway client's pseudo address is the gateway endpoint plus a
    fresh generation, so two clients of one gateway differ only by it.
    4,096 generations made in one millisecond (the clock held still) are
    all distinct and carry that millisecond in their high bits. With 12
    random low bits, two clients made in one millisecond collided (about
    one run in six of the churn-storm gauntlet), the later one's route
    replaced the earlier one's, and its teardown dropped the route of a
    live client, whose next answer never arrived."""
    import orleans_tpu_torch.runtime.socket_fabric as sf
    monkeypatch.setattr(sf.time, "time", lambda: 1_700_000_000.0)
    gens = [sf._fresh_generation() for _ in range(4096)]
    assert len(set(gens)) == 4096
    assert {g >> 12 for g in gens} == {1_700_000_000_000}


# ---------------------------------------------------------------------------
# samples/presence_torch.py's drive over TCP gateways, at 2,000 players
# ---------------------------------------------------------------------------

class JPlayer(jd.VectorGrain):
    """samples/presence_tpu.py's PlayerVectorGrain with the read-only
    score and readiness methods of samples/presence_torch.py."""

    STATE = {"pos": (jnp.float32, (2,)), "score": (jnp.int32, ()),
             "game": (jnp.int32, ())}

    @staticmethod
    def initial_state(key_hash):
        return {"pos": jnp.zeros(2, jnp.float32), "score": jnp.int32(0),
                "game": key_hash % presence_torch.N_GAMES}

    @jd.actor_method(args={"pos": (jnp.float16, (2,)),
                           "delta": (jnp.int32, ())})
    def heartbeat(state, args):
        new = {"pos": args["pos"].astype(jnp.float32),
               "score": state["score"] + args["delta"],
               "game": state["game"]}
        return new, new["score"]

    @jd.actor_method(args={}, read_only=True)
    def whereis(state, args):
        return state, state["pos"]

    @jd.actor_method(args={}, read_only=True)
    def get_score(state, args):
        return state, state["score"]

    @jd.actor_method(args={}, read_only=True)
    def ready(state, args):
        return state, (state["score"] > 0).astype(jnp.int32)


class JGame(jr.Grain):
    """The JAX twin of presence_torch.GameGrain: the same masked fan-in
    through orleans_tpu.ops.segment_sum."""

    async def summary(self) -> dict:
        from orleans_tpu.ops import segment_sum
        rt = self.runtime.vector
        tbl = rt.table(JPlayer)
        game = int(self.primary_key)
        with rt.tick_fence():
            per, n = tbl.dense_per_shard, tbl.dense_n
            g = tbl.state["game"][:, :per].reshape(-1)[:n]
            score = tbl.state["score"][:, :per].reshape(-1)[:n]
            ids = jnp.where(jnp.asarray(tbl.dense_active), g, -1)
            values = jnp.stack([score, jnp.ones_like(score)], axis=1)
            totals = np.asarray(segment_sum(values, ids,
                                            presence_torch.N_GAMES))[game]
        return {"game": game, "total_score": int(totals[0]),
                "players": int(totals[1])}


# one grain name per pair: the name is part of every hashed key's GrainId
JPlayer.__name__ = JPlayer.__qualname__ = "PlayerVectorGrain"
JGame.__name__ = JGame.__qualname__ = "GameGrain"

JAX = dict(rt=jr, mb=jm, st=js, Player=JPlayer, Game=JGame,
           add=jd.add_vector_grains, mesh=lambda n: jp.make_mesh(n))
TORCH = dict(rt=tr, mb=tm, st=ts, Player=presence_torch.PlayerVectorGrain,
             Game=presence_torch.GameGrain, add=td.add_vector_grains,
             mesh=lambda n: tp.make_mesh(n, device="cpu"))


async def _presence_over(pkg, root, tcp, n=2000):
    sched = presence_torch.presence_schedule(
        n, 0, waves=2, batches=4, batch=256, singles=256, reads=64,
        sample=256)
    table = pkg["mb"].FileMembershipTable(os.path.join(root, "mbr.json")) \
        if tcp else None

    def build(storage, checkpoint_dir):
        b = pkg["rt"].SiloBuilder().with_name("presence") \
            .add_grains(pkg["Game"])
        if tcp:
            b.with_fabric(pkg["rt"].SocketFabric())
        pkg["add"](b, pkg["Player"], dense={pkg["Player"]: n},
                   mesh=pkg["mesh"](8), capacity_per_shard=n // 8,
                   storage=storage, flush_period=0.5,
                   checkpoint_dir=checkpoint_dir)
        silo = b.build()
        if tcp:
            pkg["mb"].join_cluster(silo, table)
        return silo

    client_cls = presence_torch.gateway_client(pkg["rt"].GatewayClient) \
        if tcp else pkg["rt"].ClusterClient
    res, _ = await asyncio.wait_for(presence_torch.drive_presence(
        build, client_cls, pkg["st"].MemoryStorage(), pkg["Player"],
        pkg["Game"], sched, os.path.join(root, "ckpt")), TIMEOUT)
    return res


def _assert_same_results(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):  # the table snapshot, field by field
            assert a[k].keys() == b[k].keys(), k
            for f in a[k]:
                x, y = np.asarray(a[k][f]), np.asarray(b[k][f])
                assert x.dtype == y.dtype and np.array_equal(x, y), (k, f)
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), k


async def test_presence_drive_over_gateways_matches_in_proc_and_jax(
        tmp_path):
    runs = {}
    for name, pkg, tcp in (("torch-tcp", TORCH, True),
                           ("torch-inproc", TORCH, False),
                           ("jax-tcp", JAX, True)):
        root = str(tmp_path / name)
        os.makedirs(root)
        runs[name] = await _presence_over(pkg, root, tcp)
    t = runs["torch-tcp"]
    assert t["delivered"] == 2000 and t["joined"] == 2000
    assert t["summaries"][:, 1].sum() == 2000
    _assert_same_results(t, runs["torch-inproc"])
    _assert_same_results(t, runs["jax-tcp"])


@bounded
async def test_graceful_stop_over_sockets_gets_its_directory_answers(
        tmp_path):
    """A silo stopping gracefully writes ShuttingDown first and Dead last:
    its peers keep answering it meanwhile, so the directory unregisters of
    its deactivations and its partition handoff land at once. (The
    reference writes Dead first; over sockets its peers then drop every
    answer to it, and each of those requests waits out the response
    timeout: 60 s a stop at the default 30 s.)"""
    from orleans_tpu_torch.membership.table import SiloStatus
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    writes = []
    update_row = table.update_row

    async def recording_update_row(entry, *args, **kwargs):
        writes.append((entry.address, entry.status))
        return await update_row(entry, *args, **kwargs)
    table.update_row = recording_update_row
    silo1, silo2 = await _worker_pair(table, "g1", "g2")
    client = None
    try:
        client = await GatewayClient([silo1.silo_address.endpoint]).connect()
        await asyncio.gather(*(client.get_grain(Worker, k).check(
            GrainCancellationTokenSource().token) for k in range(60)))
        gids = [g for g in silo1.catalog.by_grain
                if not g.is_system_target()
                and silo1.locator.ring.owner(g.uniform_hash)
                == silo2.silo_address]
        assert gids, "no activation of silo 1 registered on silo 2"
        assert all(silo2.locator.partition.get(g) is not None for g in gids)
        await client.close_async()
        client = None
        t0 = time.monotonic()
        await silo1.stop()
        assert time.monotonic() - t0 < 5.0
        # the unregisters landed on the directory owner
        assert all(silo2.locator.partition.get(g) is None for g in gids)
        mine = [s for a, s in writes if a == silo1.silo_address]
        assert mine[-2:] == [SiloStatus.SHUTTING_DOWN, SiloStatus.DEAD]
        entry, _ = (await table.read_all()).get(silo1.silo_address)
        assert entry.status == SiloStatus.DEAD
    finally:
        if client is not None:
            await client.close_async()
        await silo1.stop()
        await silo2.stop()


@bounded
async def test_two_silo_gateway_keeps_per_key_order(tmp_path):
    """Heartbeats through silo 0's gateway for keys that silo 1 owns cross
    the peer socket in arrival order: every answer equals the model's,
    which applies each key's calls in the order they were sent. (Silo 0
    used to address such a call through a directory lookup, so a key's
    first calls waited on an async hop while its later ones went straight
    from the cache, and a later call could overtake an earlier one.)"""
    n, calls, batch = 20000, 16384, 4096
    table = FileMembershipTable(str(tmp_path / "mbr.json"))
    silos = []
    for i in range(2):
        b = SiloBuilder().with_name(f"order-{i}").with_fabric(SocketFabric())
        td.add_vector_grains(b, presence_torch.PlayerVectorGrain,
                             mesh=tp.make_mesh(8, device="cpu"),
                             capacity_per_shard=-(-n // 8),
                             dense={presence_torch.PlayerVectorGrain: n})
        silo = b.build()
        join_cluster(silo, table)
        silos.append(silo)
    started, client = [], None
    try:
        for s in silos:
            await s.start()
            started.append(s)
        while not all(len(s.membership.active) == 2 for s in silos):
            await asyncio.sleep(0.05)
        client = await GatewayClient([silos[0].silo_address.endpoint],
                                     response_timeout=10.0).connect()
        rng = np.random.default_rng(11)
        # a key's first calls reach silo 0 before its ring owner's address
        # is cached there, its later ones after
        keys = rng.integers(0, n, calls)
        pos = rng.random((calls, 2), np.float32).astype(np.float16)
        delta = rng.integers(1, 4, calls).astype(np.int32)
        want = presence_torch.PresenceModel(n).apply(keys, pos, delta)
        got = []
        for lo in range(0, calls, batch):
            hi = lo + batch
            got += await asyncio.gather(*client.call_batch(
                presence_torch.PlayerVectorGrain, "heartbeat",
                [(int(k), {"pos": p, "delta": d}) for k, p, d in zip(
                    keys[lo:hi], pos[lo:hi], delta[lo:hi])]))
        got = np.asarray(got, np.int64)
        assert np.array_equal(got, want), \
            f"{int((got != want).sum())} answers out of per-key order"
    finally:
        if client is not None:
            await client.close_async()
        for s in reversed(started):
            await s.stop()
