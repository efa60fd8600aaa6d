"""TCP socket fabric: cross-process silo-to-silo transport + client gateway.

Re-design of the reference's socket layer
(Orleans' src/Orleans.Core/Messaging/SocketManager.cs:1-261,
``IncomingMessageAcceptor.cs:12`` accept/receive loop,
``OutboundMessageQueue.cs:38-44`` per-target senders,
``Runtime/Messaging/Gateway.cs:17`` + ``GatewayAcceptor.cs`` client ingress,
``Core/Messaging/ClientMessageCenter.cs:63`` + ``GatewayManager.cs`` client
side) for silos living in **separate processes/hosts**.

Architecture (departures from the reference are deliberate):

* One asyncio TCP server per silo accepts both peer-silo and client
  connections; the first frame is a handshake declaring the peer kind and
  address (GatewayAcceptor.cs:63 handshake-carried client id analog).
* Outbound: one lazily-dialed connection + send queue per target endpoint
  (the reference hashes targets over N sender threads; one asyncio sender
  task per endpoint gives the same per-target FIFO order without threads).
* Clients are addressed *via their gateway*: a client's pseudo
  ``SiloAddress`` carries the gateway's host:port and a client-unique
  generation, so any silo can reply by dialing the gateway, which forwards
  over the client's live connection (``Gateway.TryDeliverToProxy:229``).
* This fabric carries the **control plane and host-tier grain calls**. The
  vectorized data plane rides device collectives (parallel.transport)
  and never touches these sockets.

In-process clusters and liveness tests keep using
runtime.cluster.InProcFabric; this module exists for real multi-process
deployments and is exercised by tests over localhost sockets.

The port's copy of ``orleans_tpu.runtime.socket_fabric``, with two
repairs: the multi-loop acceptor's listener closes only after its accept
task has ended (see ``_serve``), and addresses made in one millisecond get
distinct generations (see ``_fresh_generation``).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import random
import socket
import time
from typing import TYPE_CHECKING, Any

from ..core import serialization as _ser
from ..core.asyncs import ExponentialBackoff, retry
from ..core.errors import SiloUnavailableError
from ..core.ids import SiloAddress
from ..core.message import Category, Direction, Message, recycle_messages
from ..observability.stats import EGRESS_STATS
from .references import GrainFactory
from .runtime_client import RuntimeClient
from .wire import (
    FrameError,
    WireDecodeError,
    _BodyDecodeError,
    decode_frames,
    decode_handshake,
    decode_message,
    encode_handshake,
    encode_message,
    encode_message_batch,
    frame_stream,
    leads_hostile_frame,
    read_frame,
    writev_leftover,
)

if TYPE_CHECKING:
    from .silo import Silo

log = logging.getLogger("orleans.socket")

# _relay_endpoint's "not a relay case" marker (None means "consumed")
_NO_RELAY = object()

__all__ = ["SocketFabric", "GatewayClient"]

_CONNECT_RETRIES = 3
_CONNECT_BACKOFF = 0.2
# greedy sender batching: everything queued when the writer wakes rides
# one socket write (bounded so one slow peer cannot hold a huge buffer)
_SEND_BATCH_MAX = 256

# native vectored egress (hotwire.sock_writev) for the StreamWriter-
# backed sender drains — mirrors the multiloop pump's capability probe
_HW = _ser._hotwire
_HW_WRITEV = _HW is not None and hasattr(_HW, "sock_writev")

_EG_ENCODE = EGRESS_STATS["encode"]
_EG_RING_DROPS = EGRESS_STATS["ring_drops"]

# wire-charge stamp for the sharded egress stat rings (cost
# attribution): the shard may not touch the loop-confined CostLedger,
# so byte counts ride the ring and replay in EgressShardPool._apply_stats
from ..observability.ledger import WIRE_STAMP as _LEDGER_WIRE  # noqa: E402


def _writev_stream(writer: asyncio.StreamWriter, chunks: list) -> None:
    """Vectored drain for a StreamWriter-backed sender (the silo-peer
    path previously joined + wrote through the transport; only the
    ShardWriter and gateway client-route paths were vectored). When the
    transport's buffer is empty — the steady state for a sender that
    awaits ``drain()`` per batch — the chunk list rides ONE ``writev``
    syscall on the raw socket, no ``b"".join`` copy; the unsent
    remainder (kernel buffer full), transport-buffered states, and
    non-native builds fall back to the buffered write. Ordering is
    safe: the transport has nothing queued and this sender task is the
    connection's only writer."""
    if _HW_WRITEV:
        transport = writer.transport
        sock = writer.get_extra_info("socket")
        if sock is not None and transport.get_write_buffer_size() == 0:
            try:
                sent = _HW.sock_writev(sock.fileno(), chunks)
            except (BlockingIOError, InterruptedError):
                sent = 0
            except OSError:
                # surface the failure through the transport so the
                # sender's close/reconnect semantics stay identical
                writer.write(b"".join(chunks))
                return
            rest = writev_leftover(chunks, sent)
            if rest:
                writer.write(rest)
            return
    writer.write(b"".join(chunks))


def _drain_batch(queue: "asyncio.Queue[Message]", first: Message) -> list:
    """Greedy drain: everything already queued rides one write + one
    drain (the reference's sender batches the same way — SiloMessageSender
    drains its queue per send turn)."""
    batch = [first]
    while len(batch) < _SEND_BATCH_MAX:
        try:
            batch.append(queue.get_nowait())
        except asyncio.QueueEmpty:
            break
    return batch


async def _read_frame_batches(reader: asyncio.StreamReader, ist=None,
                              ledger=None, route="", *,
                              strict_tail: bool, chunk_size: int = 1 << 16):
    """Shared chunked-receive state machine for the batched pumps (silo
    and gateway sides): one ``decode_frames`` pass per socket read,
    yielding ``(msgs, bounces)``; the partial tail of a frame stays
    buffered for the next read. Raises :class:`FrameError` when a hostile
    (oversized) announcement leads the remaining buffer — frames decoded
    ahead of it were already yielded, matching the per-frame path's
    deliver-then-drop behavior, and the link drops without waiting for
    bytes the peer may never send. EOF mid-frame raises
    ``IncompleteReadError`` under ``strict_tail`` (silo links surface the
    torn tail) or just ends the pump (gateway: a torn tail is a clean
    close)."""
    buf = bytearray()
    while True:
        chunk = await reader.read(chunk_size)
        if not chunk:
            if buf and strict_tail:
                raise asyncio.IncompleteReadError(bytes(buf), None)
            return
        buf += chunk
        consumed, msgs, bounces = decode_frames(buf, ist)
        if consumed:
            del buf[:consumed]
            if ledger is not None:
                # cost attribution: inbound bytes charged where the
                # frame sizes are already known (loop-side callers only
                # pass a ledger — the sharded pumps stamp instead)
                ledger.charge_wire(route, rx=consumed)
        if msgs or bounces:
            yield msgs, bounces
        if leads_hostile_frame(buf):
            raise FrameError("oversized frame announced")



# a peer that accepts TCP but never sends its handshake reply is wedged:
# bound the negotiation read so the dial fails into the retry/backoff path
_NEGOTIATE_TIMEOUT = 5.0


async def _read_peer_codec(reader: asyncio.StreamReader) -> bool:
    """Read the acceptor's handshake reply; True iff the peer advertises
    hotwire decode support. A well-framed but undecodable reply falls back
    to the universally-decodable pickle form; a GARBLED or truncated frame
    raises ConnectionError — the stream is misaligned and every later frame
    on it would misparse, so the dial must fail into the retry path (fresh
    connection), never keep reading. An unresponsive peer raises
    TimeoutError — an OSError — into the same path."""
    try:
        headers, _ = await asyncio.wait_for(
            read_frame(reader), _NEGOTIATE_TIMEOUT)
    except (FrameError, asyncio.IncompleteReadError) as e:
        raise ConnectionError(f"handshake reply unreadable: {e}") from e
    try:
        return bool(decode_handshake(headers).get("hotwire", False))
    except Exception:  # noqa: BLE001 — well-framed junk reply → pickle
        return False


# the low 12 bits of this process's generations: a sequence from a random
# start, restarted in a forked child (as ``random`` reseeds there)
_gen_seq = itertools.count(random.getrandbits(12))


def _restart_gen_seq() -> None:
    global _gen_seq
    _gen_seq = itertools.count(random.getrandbits(12))


os.register_at_fork(after_in_child=_restart_gen_seq)


def _fresh_generation() -> int:
    """Epoch stamp distinguishing restarts at the same endpoint
    (SiloAddress.cs generation): full millisecond timestamp in the high bits
    so a later restart ALWAYS gets a higher generation (the membership join
    protocol requires strict monotonicity to declare prior incarnations
    dead). The low bits count on from a random start, so 4,096 addresses
    made in one millisecond by one process are distinct: a gateway client's
    address differs from another's only by its generation, and random low
    bits let two clients made in one millisecond collide."""
    return (int(time.time() * 1000) << 12) | (next(_gen_seq) & 0xFFF)


class _Sender:
    """Per-endpoint outbound queue + writer task (the SiloMessageSender
    analog — per-target FIFO, lazy dial, bounded reconnect). Runs on
    whichever loop constructed it: the main loop (classic path), or an
    egress shard's loop (``shard`` set — ``EgressShard._sender``
    constructs it there; encode then uses the per-shard template cache,
    stage timings are STAMPED and replayed loop-side, and outbound
    response envelopes recycle shard-side after their bytes exist)."""

    def __init__(self, fabric: "SocketFabric", endpoint: str, shard=None):
        self.fabric = fabric
        self.endpoint = endpoint
        self.shard = shard      # multiloop.EgressShard | None
        self.queue: asyncio.Queue[Message] = asyncio.Queue()
        self.task = asyncio.get_running_loop().create_task(self._run())
        self.writer: asyncio.StreamWriter | None = None
        # negotiated per-link codec: True only once the acceptor's
        # handshake reply advertises hotwire support
        self.peer_native = False
        self._busy = False      # mid-batch flag (drain_idle)

    # -- main-loop feed surface (classic senders; a shard-owned sender
    # -- is fed by its shard instead) ------------------------------------
    def feed(self, msg: Message) -> None:
        self.queue.put_nowait(msg)

    def feed_group(self, msgs: list) -> None:
        q = self.queue
        for m in msgs:
            q.put_nowait(m)

    async def _connect(self) -> asyncio.StreamWriter:
        host, port = self.endpoint.rsplit(":", 1)

        async def dial() -> asyncio.StreamWriter:
            reader, writer = await asyncio.open_connection(host, int(port))
            writer.write(encode_handshake(
                "silo", self.fabric.local_address()))
            await writer.drain()
            # codec negotiation: the acceptor replies with its own
            # handshake; encode at the peer's level from here on
            try:
                self.peer_native = await _read_peer_codec(reader)
            except OSError:
                writer.close()  # failed negotiation: redial, don't leak
                raise
            return writer

        try:
            # jittered backoff so N senders dialing a restarted silo don't
            # retry in lockstep
            return await retry(
                dial, max_attempts=_CONNECT_RETRIES, retry_on=OSError,
                backoff=ExponentialBackoff(min_delay=_CONNECT_BACKOFF,
                                           max_delay=2.0))
        except OSError as e:
            raise SiloUnavailableError(
                f"cannot connect to {self.endpoint}: {e}") from e

    async def _run(self) -> None:
        # loop attribution: everything this task does — wire encode and
        # the transport write — is outbound work; "egress" is the slice
        # the sharded-egress A/B moves off the main loop (a shard-owned
        # sender books it on the shard loop's own profiler instead)
        from ..observability.profiling import mark_loop_category
        mark_loop_category("egress")
        shard = self.shard
        while True:
            msg = await self.queue.get()
            batch = _drain_batch(self.queue, msg)
            if shard is not None:
                # backpressure accounting (EgressShard.pending, keyed
                # by endpoint): these leave the sender queue NOW — at
                # most one in-flight batch (<= _SEND_BATCH_MAX) goes
                # uncounted while a wedged peer blocks the write below;
                # the queue refilling behind it is what the feed bound
                # reads. Missing key = _close_endpoint already
                # reconciled this sender: no-op, a re-dialed sender's
                # fresh entry must not go negative.
                if self.endpoint in shard.pending:
                    shard.pending[self.endpoint] -= sum(
                        1 for m in batch
                        if m.category is Category.APPLICATION)
            if self.fabric.is_endpoint_dead(self.endpoint):
                # dead-silo drop (MessageCenter SiloDeadOracle): the
                # shard-owned batch's dead RESPONSE shells still go
                # back to the pool — every drop path recycles (the
                # ring-full path does via _egress_dropped)
                if shard is not None:
                    shard._recycle_responses(batch)
                continue
            self._busy = True
            bounced: list = []
            try:
                if self.writer is None or self.writer.is_closing():
                    self.writer = await self._connect()
                # encode AFTER the (re)connect: peer_native is per-link.
                if shard is None:
                    await self._send_batch_loopside(batch)
                else:
                    await self._send_batch_sharded(shard, batch, bounced)
            except (SiloUnavailableError, OSError, FrameError) as e:
                log.warning("send to %s failed: %s", self.endpoint, e)
                if self.writer is not None:
                    self.writer.close()
                    self.writer = None
                # dropped: senders learn via response timeout /
                # membership — the now-dead outbound responses of a
                # shard-owned batch still recycle (finally below)
            finally:
                if shard is not None:
                    # encode-then-recycle, every path: success, encode
                    # bounce, and send failure all end these envelopes'
                    # lifecycles (requests stay out — correlation owns
                    # them sender-side). BOUNCED envelopes stay out
                    # too: their bounce is marshalled to the main loop
                    # and still in flight — recycling here would let
                    # the pool re-issue the shell before the callback
                    # reads it (identity filter: Message.__eq__ is
                    # field-comparing).
                    if bounced:
                        skip = set(map(id, bounced))
                        shard._recycle_responses(
                            [m for m in batch if id(m) not in skip])
                    else:
                        shard._recycle_responses(batch)
                self._busy = False

    async def _send_batch_loopside(self, batch: list) -> None:
        """The classic main-loop drain: encode against the shared
        template cache, stats straight into the registry (we ARE the
        loop), one vectored write."""
        # egress.encode is the RESPONSE-path stage: only batches
        # carrying responses observe it (a pure request drain booking
        # into it would inflate the response-path share the attribution
        # harness reports; responses co-batched with requests share one
        # write, so the whole encode is honestly theirs-or-shared)
        est = self.fabric.egress_stats
        if est is not None and not any(
                m.direction == Direction.RESPONSE for m in batch):
            est = None
        chunks = encode_message_batch(
            batch, self.fabric.bounce_unencodable,
            native=self.peer_native, stats=est,
            templates=self.fabric.response_templates)
        if not chunks:
            return
        led = self.fabric.ledger
        if led is not None:
            # main-loop sender: the ledger is loop-confined here, charge
            # directly (the sharded path stamps instead)
            led.charge_wire(f"peer:{self.endpoint}",
                            tx=sum(len(c) for c in chunks))
        _writev_stream(self.writer, chunks)
        await self.writer.drain()

    async def _send_batch_sharded(self, shard, batch: list,
                                  bounced: list) -> None:
        """The shard-loop drain: per-shard template cache, encode bounce
        MARSHALLED to the main loop (``bounce_unencodable`` routes
        through main-loop state; the bounced envelope joins ``bounced``
        so the caller's recycle sweep leaves it for the in-flight
        callback to own), dwell/encode STAMPED here and replayed
        loop-side over the shard's stat ring — the registries are
        loop-confined, so no live registry ever crosses into this
        context (the OTPU007 contract)."""
        fab = self.fabric
        main = shard.main_loop

        def _bounce(m, e):
            bounced.append(m)
            try:
                main.call_soon_threadsafe(fab.bounce_unencodable, m, e)
            except RuntimeError:
                # main loop gone (process teardown): the bounce is
                # moot, but raising here would escape _run's except
                # tuple and kill the sender task
                pass

        stamps = shard._dwell_stamps(batch)
        t0 = time.monotonic()
        chunks = encode_message_batch(
            batch, _bounce,
            native=self.peer_native, stats=None,
            templates=fab.response_templates,
            tmpl_cache=shard.tmpl_cache)
        if chunks and stamps is not None and any(
                m.direction == Direction.RESPONSE for m in batch):
            stamps.append((_EG_ENCODE, time.monotonic() - t0))
        if chunks and stamps is not None and fab.ledger is not None:
            # wire-byte charge stamped for loop-side replay (the shard
            # may not touch the loop-confined ledger)
            stamps.append((_LEDGER_WIRE,
                           (f"peer:{self.endpoint}",
                            sum(len(c) for c in chunks))))
        if stamps:
            shard.stat_ring.push((0, stamps), 0)
        if not chunks:
            return
        shard.encoded += 1
        _writev_stream(self.writer, chunks)
        await self.writer.drain()

    async def drain_idle(self, timeout: float) -> None:
        """Best-effort queue flush (clean-shutdown drain): wait until
        the queue is empty and the writer task is parked back on
        ``queue.get`` — bounded, a dead peer's reconnect backoff must
        not hold shutdown hostage."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while (self.queue.qsize() or self._busy) and \
                loop.time() < deadline:
            await asyncio.sleep(0.01)

    def close(self) -> None:
        self.task.cancel()
        if self.writer is not None:
            self.writer.close()
            self.writer = None


class _ShardSenderHandle:
    """Main-loop face of a shard-owned silo-peer sender (sharded
    egress): application traffic — flush groups and per-message sends
    alike — crosses the shard's SPSC egress ring (ring FIFO keeps
    per-message sends ordered behind the groups ``flush_dest`` drained
    first), while PING/SYSTEM bypasses the ring per-message so a probe
    response can never sit behind ring backpressure (the QoS split).
    The actual :class:`_Sender` (queue + dial + encode + writev) lives
    on the shard loop — ``EgressShard._sender`` constructs it there."""

    __slots__ = ("fabric", "shard", "endpoint")

    def __init__(self, fabric: "SocketFabric", shard, endpoint: str):
        self.fabric = fabric
        self.shard = shard
        self.endpoint = endpoint

    def feed(self, msg: Message) -> None:
        shard = self.shard
        if shard.pool.closed:
            self.fabric._classic_sender(self.endpoint).feed(msg)
            return
        # clear the local arrival stamp before the hand-off: on a
        # relayed envelope it is INGRESS time — shard-side dwell must
        # only ever see the egress accumulator's send-side stamps
        # (feed_group), and the slot is wire-excluded dead weight here
        msg.received_at = None
        if msg.category is not Category.APPLICATION:
            shard.peer_direct(self.endpoint, msg)
        elif not shard.feed_peer(self.endpoint, msg, 1):
            self.fabric._egress_dropped(shard, [msg])

    def feed_group(self, msgs: list) -> None:
        shard = self.shard
        if shard.pool.closed:
            self.fabric._classic_sender(self.endpoint).feed_group(msgs)
            return
        if not shard.feed_peer(self.endpoint, msgs, len(msgs)):
            self.fabric._egress_dropped(shard, msgs)

    def close(self) -> None:
        try:
            self.shard.loop.call_soon_threadsafe(
                self.shard._close_endpoint, self.endpoint)
        except RuntimeError:
            pass  # shard loop gone: its senders died with it


class _PoolAcceptor:
    """Server-shaped handle for a multi-loop silo's acceptor (what
    ``unregister_silo`` closes in place of the asyncio server)."""

    __slots__ = ("pool",)

    def __init__(self, pool):
        self.pool = pool

    def close(self) -> None:
        self.pool.close_acceptor()


class SocketFabric:
    """Drop-in fabric (same surface the Silo/clients use as InProcFabric)
    whose wire is real TCP. One instance per process; it may host several
    silos (each with its own listening socket) for tests."""

    def __init__(self, host: str = "127.0.0.1"):
        self.host = host
        self.silos: dict[SiloAddress, Any] = {}      # local silos only
        self.dead: set[SiloAddress] = set()
        self._dead_endpoints: set[str] = set()
        self._listen_socks: dict[str, socket.socket] = {}  # name -> bound sock
        self._servers: dict[SiloAddress, asyncio.base_events.Server] = {}
        self._senders: dict[str, _Sender] = {}
        # client pseudo-address -> writer for clients connected to our gateway
        self.client_routes: dict[SiloAddress, asyncio.StreamWriter] = {}
        # negotiated codec per client route (handshake-advertised)
        self._client_native: dict[SiloAddress, bool] = {}
        # which local silo's gateway each client route belongs to
        self._route_owner: dict[SiloAddress, SiloAddress] = {}
        self._conn_tasks: set[asyncio.Task] = set()
        self.partitions: set[tuple[str, str]] = set()
        self._names = itertools.count(1)
        # egress stage metrics (EGRESS_STATS): the registry of the first
        # metrics-enabled local silo, else None — the sender/client-route
        # encode paths pay one attribute load (senders are shared per
        # endpoint, so per-silo attribution is not available here)
        self.egress_stats = None
        # cost-attribution ledger of the first ledger-enabled local silo
        # (same sharing rule as egress_stats): senders/client routes
        # charge wire bytes per route through it
        self.ledger = None
        # header-prefix wire templates for response batches
        # (wire.encode_message_batch templates= switch): cleared when any
        # local silo runs batched_egress=False so the A/B lever also
        # restores the per-frame header encode (bytes are identical
        # either way — this only flips WHICH encoder produced them)
        self.response_templates = True
        # sharded egress (runtime.multiloop.EgressShardPool): constructed
        # by register_silo when a local silo has egress_shards >= 1;
        # None = every sender/encode/write stays on the main loop
        self.egress_pool = None
        # peer endpoint -> ingress shard index owning the INBOUND half of
        # that peering (recorded at the shard handshake, marshalled here:
        # main-loop state) — the egress pool's link-affinity source
        self._peer_shard: dict[str, int] = {}
        # main-loop occupancy profiler (set by the silo when profiling is
        # on): the inline client-route encode+write paths book their
        # slice under "egress" so the sharded-egress A/B is measurable
        self.loop_prof = None
        # multi-process silo (runtime.multiproc) relay state. All three
        # stay empty/None under worker_procs=1 — the delivery hot path
        # pays one falsy check on its MISS branches only.
        #   route_relays: owner-side, client pseudo-address -> internal
        #     endpoint of the worker holding that connection (announced
        #     over the staging rings); consulted after a client_routes
        #     miss because the pseudo-address carries the ADVERTISED
        #     endpoint — dialing it would let the kernel hand the
        #     connection to an arbitrary reuseport worker
        self.route_relays: dict[SiloAddress, str] = {}
        #   endpoint_aliases: worker-side, advertised endpoint -> the
        #     owner's internal endpoint; a message for a client another
        #     process holds routes to the owner, which relays
        self.endpoint_aliases: dict[str, str] = {}
        #   route_notify: worker-side callback (addr, up) fired when a
        #     client route registers/drops, so the owner's relay table
        #     tracks this process's connections
        self.route_notify = None
        #   gateway_drop_endpoint: owner-side, the advertised endpoint —
        #     a client target there with NO relay is dropped, never
        #     dialed (the kernel would hand the new connection to an
        #     arbitrary reuseport worker, not the client)
        self.gateway_drop_endpoint: str | None = None

    # -- address allocation ---------------------------------------------
    def allocate_address(self, name: str,
                         reuseport: bool = False) -> SiloAddress:
        """Bind + listen immediately so peers can connect (backlog) even
        before the asyncio server attaches in register_silo — no startup
        race between silos dialing each other. ``reuseport=True``
        reserves a multi-process ADVERTISED endpoint: the socket opens
        an SO_REUSEPORT accept group that forked worker processes join
        with their own listeners (the owner's copy never accepts and
        closes once the workers are serving)."""
        if reuseport:
            from .multiproc import _reuseport_listener
            sock = _reuseport_listener(self.host, 0)
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self.host, 0))
            sock.listen(128)
            sock.setblocking(False)
        port = sock.getsockname()[1]
        addr = SiloAddress(self.host, port, _fresh_generation())
        self._listen_socks[addr.endpoint] = sock
        return addr

    def local_address(self) -> SiloAddress:
        if not self.silos:
            raise SiloUnavailableError("no local silo registered")
        return next(iter(self.silos))

    # -- silo lifecycle ----------------------------------------------------
    def register_silo(self, silo: "Silo") -> None:
        addr = silo.silo_address
        self.silos[addr] = silo
        self.dead.discard(addr)
        if self.egress_stats is None and silo.ingest_stats is not None:
            self.egress_stats = silo.stats
        if self.ledger is None and silo.ledger is not None:
            self.ledger = silo.ledger
        if not silo.config.batched_egress:
            self.response_templates = False
        sock = self._listen_socks.get(addr.endpoint)
        if sock is None:
            raise SiloUnavailableError(
                f"silo address {addr} was not allocated by this fabric")
        if silo.config.ingress_loops > 1 and silo.ingress_pool is None:
            # multi-loop silo (runtime.multiloop): N ingress pump
            # threads, each with its own event loop + vectored socket
            # pump, fed by the round-robin acceptor below over SPSC
            # hand-off rings. ingress_loops=1 (default) constructs none
            # of this — the start_server path below is today's bit for
            # bit.
            from .multiloop import IngressLoopPool
            silo.ingress_pool = IngressLoopPool(
                silo, silo.config.ingress_loops)
            silo.ingress_pool.start()
        if silo.config.egress_shards > 0 and self.egress_pool is None:
            # sharded egress (runtime.multiloop): silo-peer senders and
            # shard-owned client-route writes move onto shard loops, fed
            # over SPSC egress rings from this loop. Borrows the ingress
            # shards when the silo runs multi-loop (link-ownership
            # affinity), else spawns dedicated egress loop threads.
            # egress_shards=0 (default) constructs none of this.
            from .multiloop import EgressShardPool
            self.egress_pool = EgressShardPool(
                self, silo, silo.config.egress_shards,
                ingress_pool=silo.ingress_pool)
        loop = asyncio.get_running_loop()
        t = loop.create_task(self._serve(silo, sock))
        self._conn_tasks.add(t)
        t.add_done_callback(self._conn_tasks.discard)
        if silo.membership is not None:
            silo.membership.subscribe(self._on_membership_change)

    async def _serve(self, silo: "Silo", sock: socket.socket) -> None:
        pool = silo.ingress_pool
        if pool is None:
            server = await asyncio.start_server(
                lambda r, w: self._handle_conn(silo, r, w), sock=sock)
            self._servers[silo.silo_address] = server
            return
        # multi-loop acceptor: the listener runs on the main loop and
        # hands each accepted socket round-robin to an ingress shard
        # (the listener-thread form of the reference's acceptor; one
        # process needs no SO_REUSEPORT for this). The shard owns the
        # connection — handshake, pump, and client-route writes all run
        # on its loop.
        #
        # Closing stops the accept task and the task closes the listener
        # on its way out. The loop removes the listener's reader in a
        # callback it schedules when the pending accept is cancelled,
        # and that callback runs before the task resumes. Closing the
        # socket before it runs freed the fd number while the loop still
        # held a registration for it: a listener opened on this loop
        # before the callback ran (the next silo's, started right after
        # this one stopped) took the number, met the stale entry, and
        # never accepted.
        accept_task = asyncio.current_task()
        pool.accept_handle = accept_task.cancel
        self._servers[silo.silo_address] = _PoolAcceptor(pool)
        loop = asyncio.get_running_loop()
        try:
            while not pool.closed:
                conn, _peer = await loop.sock_accept(sock)
                conn.setblocking(False)
                pool.assign().submit_conn(self, silo, conn)
        except asyncio.CancelledError:
            pass
        except OSError:
            pass  # listener failed under us
        finally:
            sock.close()

    def unregister_silo(self, silo: "Silo", dead: bool = False) -> None:
        addr = silo.silo_address
        self.silos.pop(addr, None)
        if dead:
            self.dead.add(addr)
        server = self._servers.pop(addr, None)
        if server is not None:
            server.close()
        self._listen_socks.pop(addr.endpoint, None)
        # close only the routes of clients attached to THIS silo's gateway
        for caddr, owner in list(self._route_owner.items()):
            if owner == addr:
                self._route_owner.pop(caddr, None)
                self._client_native.pop(caddr, None)
                w = self.client_routes.pop(caddr, None)
                if w is not None:
                    w.close()
        # shared outbound senders survive while other local silos need them
        if not self.silos:
            for s in list(self._senders.values()):
                s.close()
            self._senders.clear()
            for w in self.client_routes.values():
                w.close()
            self.client_routes.clear()
            self._route_owner.clear()
            for t in list(self._conn_tasks):
                t.cancel()

    # -- membership-driven liveness ---------------------------------------
    def _on_membership_change(self, alive: list[SiloAddress],
                              dead: list[SiloAddress]) -> None:
        for d in dead:
            self.dead.add(d)
            self._dead_endpoints.add(d.endpoint)
            sender = self._senders.pop(d.endpoint, None)
            if sender is not None:
                sender.close()
        # a restarted silo reuses an endpoint with a new generation
        for a in alive:
            self._dead_endpoints.discard(a.endpoint)

    def is_dead(self, addr: SiloAddress) -> bool:
        return addr in self.dead

    def is_endpoint_dead(self, endpoint: str) -> bool:
        return endpoint in self._dead_endpoints

    def alive_silos(self) -> list[SiloAddress]:
        """Cluster view: from the membership oracle when running, else the
        local silos (bootstrap)."""
        for silo in self.silos.values():
            if silo.membership is not None:
                return silo.membership.active_silos()
        return [a for a, s in self.silos.items()
                if s.status in ("Running", "Joining")]

    # -- fault injection (parity with InProcFabric) ------------------------
    def partition(self, a: SiloAddress, b: SiloAddress) -> None:
        self.partitions.add((a.endpoint, b.endpoint))
        self.partitions.add((b.endpoint, a.endpoint))

    def heal_partition(self, a: SiloAddress, b: SiloAddress) -> None:
        self.partitions.discard((a.endpoint, b.endpoint))
        self.partitions.discard((b.endpoint, a.endpoint))

    # -- the wire ----------------------------------------------------------
    def deliver(self, msg: Message) -> None:
        target = msg.target_silo
        if target is None:
            log.warning("dropping unaddressed message %s", msg.method_name)
            return
        if msg.sending_silo is not None and \
                (msg.sending_silo.endpoint, target.endpoint) in self.partitions:
            return
        local = self.silos.get(target)
        if local is not None:
            local.message_center.deliver(msg)
            return
        client_writer = self.client_routes.get(target)
        if client_writer is not None:
            self._write_to_client(target, client_writer, msg)
            return
        if self.route_relays or self.endpoint_aliases or \
                self.gateway_drop_endpoint is not None:
            ep = self._relay_endpoint(target, msg)
            if ep is not _NO_RELAY:
                if ep is not None:
                    self._sender_for(ep).feed(msg)
                return
        if target in self.dead:
            return
        self._sender_for(target.endpoint).feed(msg)

    def _relay_endpoint(self, target: SiloAddress, msg: Message):
        """Multi-process relay resolution for a client pseudo-address
        another process holds (runtime.multiproc). Returns the internal
        endpoint to relay through, None when the message was consumed
        (dropped: unroutable or over the hop bound), or ``_NO_RELAY``
        when this target is not a relay case at all. The forward count
        bounds the worker->owner->worker path exactly like dispatcher
        forwards — a stale relay can bounce at most that many times."""
        ep = self.route_relays.get(target) if self.route_relays else None
        if ep is None and self.endpoint_aliases:
            ep = self.endpoint_aliases.get(target.endpoint)
        if ep is None:
            if target.endpoint == self.gateway_drop_endpoint:
                log.info("dropping message for client %s with no relay "
                         "route (disconnected)", target)
                return None
            return _NO_RELAY
        from .dispatcher import MAX_FORWARD_COUNT
        if msg.forward_count >= MAX_FORWARD_COUNT:
            log.info("dropping message for unroutable client %s "
                     "(relay hop bound)", target)
            return None
        msg.forward_count += 1
        return ep

    # -- outbound sender placement (sharded egress) -----------------------
    def _sender_for(self, endpoint: str):
        """The outbound sender (or shard handle) for one endpoint. With
        an egress pool, new links go to the shard that owns the inbound
        half of the peering (round-robin when connect-side only) and the
        main loop keeps only the ring feed; without one, the classic
        main-loop ``_Sender``."""
        sender = self._senders.get(endpoint)
        if sender is None:
            pool = self.egress_pool
            if pool is not None and not pool.closed:
                sender = _ShardSenderHandle(
                    self, pool.shard_for(endpoint), endpoint)
            else:
                sender = _Sender(self, endpoint)
            self._senders[endpoint] = sender
        return sender

    def _classic_sender(self, endpoint: str) -> _Sender:
        """Force a main-loop ``_Sender`` for one endpoint (egress-pool
        teardown: shard handles detach and late sends fall back here)."""
        s = self._senders.get(endpoint)
        if not isinstance(s, _Sender):
            s = self._senders[endpoint] = _Sender(self, endpoint)
        return s

    def _detach_shard_senders(self) -> None:
        """Egress-pool close: drop the shard handles so later sends
        build classic senders (the shards flush what they already
        hold — the clean-shutdown drain)."""
        for ep, s in list(self._senders.items()):
            if isinstance(s, _ShardSenderHandle):
                del self._senders[ep]

    def _record_peer_shard(self, endpoint: str, index: int) -> None:
        self._peer_shard[endpoint] = index

    def _forget_peer_shard(self, endpoint: str, index: int) -> None:
        if self._peer_shard.get(endpoint) == index:
            self._peer_shard.pop(endpoint, None)

    def _egress_dropped(self, shard, msgs: list) -> None:
        """Bounded backpressure hit: an egress ring past capacity
        dropped application traffic toward a slow/wedged consumer.
        Count it, say so once per shard, and recycle the now-dead
        response envelopes (senders learn via response timeout — the
        dead-peer drop semantics)."""
        est = self.egress_stats
        if est is not None:
            est.increment(_EG_RING_DROPS, len(msgs))
        if shard.drops == len(msgs):  # first drop on this shard
            log.warning("egress ring full (shard %d): dropping "
                        "application messages toward a slow consumer",
                        shard.index)
        dead = [m for m in msgs if m.direction == Direction.RESPONSE]
        if dead:
            recycle_messages(dead)

    def sharded_dest(self, dest) -> bool:
        """True when responses to ``dest`` will encode shard-side (the
        egress batcher then leaves its dwell stamps for the shard to
        observe — dwell spans accumulator + ring + sender queue).
        Derived from the sender/route actually INSTALLED, not from
        topology: a classic main-loop sender cached from before the
        pool existed keeps observing dwell loop-side."""
        pool = self.egress_pool
        if pool is None or pool.closed or dest is None:
            return False
        if dest in self.silos:
            return False  # in-proc loopback: never leaves the loop
        w = self.client_routes.get(dest)
        if w is not None:
            return getattr(w, "egress_shard", None) is not None
        if dest in self.dead:
            return False  # send_batch drops these before any sender
        s = self._senders.get(dest.endpoint)
        if s is not None:
            return isinstance(s, _ShardSenderHandle)
        return True  # no sender yet: _sender_for builds a shard handle

    def _client_encode_error(self, addr: SiloAddress,
                             writer: asyncio.StreamWriter, msg: Message,
                             e: Exception, native: bool) -> None:
        """A message to a gateway client failed to *encode*: the route is
        healthy, only this payload is bad. Fail the call promptly with a
        portable error response instead of letting the client time out.
        Shared by the per-message and batched client write paths."""
        log.warning("unencodable message to client %s: %s", addr, e)
        if msg.direction == Direction.RESPONSE:
            from ..core.message import ResponseKind
            fallback = Message.__new__(Message)
            for s in Message.__slots__:
                setattr(fallback, s, getattr(msg, s))
            fallback.response_kind = ResponseKind.ERROR
            fallback.body = SiloUnavailableError(
                f"response to {msg.interface_name}.{msg.method_name} "
                f"could not cross the wire: {e}")
            try:
                writer.write(encode_message(fallback, native=native))
            except Exception:  # noqa: BLE001
                log.exception("error-response fallback failed")

    def _drop_client_route(self, addr: SiloAddress) -> None:
        self.client_routes.pop(addr, None)
        self._route_owner.pop(addr, None)
        self._client_native.pop(addr, None)
        if self.route_notify is not None:
            self.route_notify(addr, False)

    def _stream_write_client(self, addr: SiloAddress, writer,
                             data: bytes) -> None:
        """Main-loop tail of a shard-encoded client write (standalone
        egress over a plain StreamWriter): the shard already paid the
        encode; only the fd write lands here."""
        try:
            writer.write(data)
        except Exception:  # noqa: BLE001 — client gone mid-write
            log.info("dropping message to disconnected client %s", addr)
            if self.client_routes.get(addr) is writer:
                self._drop_client_route(addr)

    @staticmethod
    def _marshal_client_write(writer, data: bytes) -> None:
        """Egress-pool-teardown fallback for a shard-bound route: the
        writer's ops are loop-bound, so bytes encoded here marshal to
        its loop (a dead shard loop means the route is dying anyway)."""
        try:
            writer._loop.call_soon_threadsafe(writer.write, data)
        except RuntimeError:
            pass

    def _write_to_client(self, addr: SiloAddress,
                         writer: asyncio.StreamWriter, msg: Message) -> None:
        es = getattr(writer, "egress_shard", None)
        native = self._client_native.get(addr, False)
        if es is not None:
            # shard-owned route: encode + write happen on the shard.
            # Clear the local arrival stamp first — on a forwarded
            # envelope it is INGRESS time, not egress dwell (see
            # _ShardSenderHandle.feed)
            msg.received_at = None
            if not es.pool.closed:
                if msg.category is not Category.APPLICATION:
                    es.client_direct(addr, writer, native, msg)
                else:
                    es.feed_client(addr, writer, native, [msg])
                return
            try:  # pool torn down, route still shard-bound: marshal
                data = encode_message(msg, native=native)
            except Exception as e:  # noqa: BLE001
                log.warning("unencodable message to client %s during "
                            "egress teardown: %s", addr, e)
                return
            self._marshal_client_write(writer, data)
            return
        lp = self.loop_prof
        tok = lp.enter("egress") if lp is not None else None
        try:
            try:
                data = encode_message(msg, native=native)
            except Exception as e:  # noqa: BLE001 — per-payload, not the route
                self._client_encode_error(addr, writer, msg, e, native)
                return
            if self.ledger is not None:
                # main-loop gateway write (per-message path): charge the
                # client route directly (we ARE the loop)
                self.ledger.charge_wire(f"client:{addr}", tx=len(data))
            try:
                writer.write(data)
            except Exception:  # noqa: BLE001 — client gone mid-write
                log.info("dropping message to disconnected client %s", addr)
                self._drop_client_route(addr)
        finally:
            if tok is not None:
                lp.exit(tok)

    def _write_client_batch(self, addr: SiloAddress,
                            writer: asyncio.StreamWriter,
                            msgs: list) -> None:
        """Batched gateway→client write: ONE ``encode_message_batch``
        (header-prefix template on the native path) + one transport write
        for a whole response group — the per-message path encoded and
        wrote each response alone, the exact N-hops-per-inbound-batch
        residue batched egress removes. Encode failures scope to one
        message via the shared error-response fallback. Sharded egress:
        a shard-owned route takes the whole Message list across the
        shard's egress ring instead — encode (per-shard template
        cache) + writev + the response recycle sweep all run on the
        shard loop, and only the ring push stays here."""
        native = self._client_native.get(addr, False)
        es = getattr(writer, "egress_shard", None)
        if es is not None:
            if not es.pool.closed:
                es.feed_client(addr, writer, native, msgs)
                return
            chunks = encode_message_batch(  # teardown fallback: marshal
                msgs, lambda m, e: log.warning(
                    "unencodable message to client %s during egress "
                    "teardown: %s", addr, e),
                native=native, templates=self.response_templates)
            if chunks:
                self._marshal_client_write(writer, b"".join(chunks))
            return
        lp = self.loop_prof
        tok = lp.enter("egress") if lp is not None else None
        try:
            chunks = encode_message_batch(
                msgs,
                lambda m, e: self._client_encode_error(addr, writer, m, e,
                                                       native),
                native=native, stats=self.egress_stats,
                templates=self.response_templates)
            if not chunks:
                return
            if self.ledger is not None:
                # main-loop gateway write: charge the client route
                # directly (we ARE the loop)
                self.ledger.charge_wire(f"client:{addr}",
                                        tx=sum(len(c) for c in chunks))
            try:
                # shard-owned routes (multiloop.ShardWriter) take the
                # chunk list whole — it rides one writev, no join copy
                write_many = getattr(writer, "write_many", None)
                if write_many is not None:
                    write_many(chunks)
                else:
                    writer.write(b"".join(chunks))
            except Exception:  # noqa: BLE001 — client gone mid-write
                log.info("dropping batch to disconnected client %s", addr)
                self._drop_client_route(addr)
        finally:
            if tok is not None:
                lp.exit(tok)

    def deliver_group(self, target: SiloAddress, msgs: list) -> None:
        """Batched outbound hand-off for ONE destination
        (``MessageCenter.send_batch``): a local silo gets one
        ``deliver_batch``, a gateway client route one batched encode +
        write, and a remote silo one sender-queue fill (the writer task
        wakes once and drains the whole group as a single wire batch —
        deliberate fill, not greedy-drain luck)."""
        if target is None:
            log.warning("dropping %d unaddressed batched messages",
                        len(msgs))
            return
        first = msgs[0]
        if first.sending_silo is not None and \
                (first.sending_silo.endpoint,
                 target.endpoint) in self.partitions:
            return  # one sender, one target: the whole group is cut
        local = self.silos.get(target)
        if local is not None:
            local.message_center.deliver_batch(msgs)
            return
        client_writer = self.client_routes.get(target)
        if client_writer is not None:
            self._write_client_batch(target, client_writer, msgs)
            return
        if self.route_relays or self.endpoint_aliases or \
                self.gateway_drop_endpoint is not None:
            ep = self._relay_endpoint(target, first)
            if ep is not _NO_RELAY:
                if ep is not None:
                    for m in msgs[1:]:
                        m.forward_count += 1
                    self._sender_for(ep).feed_group(msgs)
                return
        if target in self.dead:
            return
        self._sender_for(target.endpoint).feed_group(msgs)

    # -- inbound connections ----------------------------------------------
    async def _handle_conn(self, silo: "Silo", reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        peer_addr: SiloAddress | None = None
        is_client = False
        try:
            headers, _ = await read_frame(reader)
            hs = decode_handshake(headers)
            peer_addr = hs["address"]
            is_client = hs["kind"] == "client"
            # codec negotiation: reply with OUR handshake so the dialer
            # learns whether this process can decode hotwire frames; from
            # here on each side encodes at the peer's advertised level
            writer.write(encode_handshake("silo", silo.silo_address))
            await writer.drain()
            if is_client:
                # Gateway: record the client route (ClientObserverRegistrar
                # records gateway routes; here route == live connection)
                self.client_routes[peer_addr] = writer
                self._route_owner[peer_addr] = silo.silo_address
                self._client_native[peer_addr] = bool(
                    hs.get("hotwire", False))
                pool = self.egress_pool
                if pool is not None and not pool.closed and \
                        silo.ingress_pool is None:
                    # standalone-egress residue fix: pin this client
                    # route to an egress shard so its response encodes
                    # leave the main loop like silo-peer links already
                    # do (multi-loop ingress pins routes shard-side)
                    writer.egress_shard = pool.shard_for_client(peer_addr)
                if self.route_notify is not None:
                    # multi-process worker: announce the route so the
                    # owner can relay responses produced elsewhere
                    self.route_notify(peer_addr, True)
            # ingest stage metrics (observability.stats.INGEST_STATS):
            # decode is timed inside decode_frames/decode_message (which
            # also stamp the envelope's received_at) and frames-per-read
            # lands in the batch histogram. The later stages (enqueue/
            # queue_wait) are observed downstream where the envelope is
            # provably still live — routing can consume a message
            # synchronously (inline turns, response correlation +
            # recycle), so NOTHING here may touch msg after routing.
            ist = silo.ingest_stats
            if silo.loop_prof is not None:
                # loop-occupancy attribution: this handler task's steps —
                # socket reads, wire decode, batched routing (including
                # inline turns' first synchronous stretch until the turn
                # re-labels itself) — are pump work on the loop
                from ..observability.profiling import mark_loop_category
                mark_loop_category("pump")
            if silo.config.batched_ingress:
                await self._pump_batched(silo, reader, ist,
                                         route=f"in:{peer_addr}")
            else:
                # per-frame hand-off (the batched-ingress A/B lever):
                # decode + route one message per frame
                on_batch = None
                if ist is not None:
                    from ..observability.stats import (COUNT_BOUNDS,
                                                       INGEST_STATS)
                    on_batch = ist.histogram_with(
                        INGEST_STATS["frame_batch"], COUNT_BOUNDS).observe
                async for headers, body in frame_stream(reader,
                                                        on_batch=on_batch):
                    try:
                        msg = decode_message(headers, body, ist)
                    except _BodyDecodeError as e:
                        self._bounce_undecodable(e.message, str(e))
                        continue
                    except WireDecodeError as e:
                        # headers undecodable: scoped to this message —
                        # the frame was fully consumed, the link is fine
                        log.warning("dropping message with undecodable "
                                    "headers: %s", e)
                        continue
                    self._route_inbound(silo, msg)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass  # clean EOF / peer died
        except FrameError as e:
            log.warning("dropping connection from %s: %s", peer_addr, e)
        except Exception:  # noqa: BLE001
            log.exception("connection handler failed (peer=%s)", peer_addr)
        finally:
            # a reconnected client may have re-handshaked on a NEW connection
            # that overwrote this route — only remove the route if it is
            # still ours
            if is_client and peer_addr is not None and \
                    self.client_routes.get(peer_addr) is writer:
                self.client_routes.pop(peer_addr, None)
                self._route_owner.pop(peer_addr, None)
                self._client_native.pop(peer_addr, None)
                if self.route_notify is not None:
                    self.route_notify(peer_addr, False)
            writer.close()

    async def _pump_batched(self, silo: "Silo",
                            reader: asyncio.StreamReader, ist,
                            route: str = "") -> None:
        """Batched receive pump: every complete frame buffered after one
        socket read decodes in ONE ``decode_frames`` pass (a single
        ``unpack_batch`` C call on the native build) and the decoded list
        rides one batched hand-off into the message center — the
        receive-side symmetric of the sender's greedy ``_drain_batch``.
        This pump runs ON the silo's loop, so the cost ledger (when
        enabled) is passed live into the reader for per-route rx
        charges."""
        async for msgs, bounces in _read_frame_batches(reader, ist,
                                                       silo.ledger, route,
                                                       strict_tail=True):
            for e in bounces:
                self._bounce_undecodable(e.message, str(e))
            if msgs:
                self._route_inbound_batch(silo, msgs)

    def _route_inbound_batch(self, silo: "Silo", msgs: list) -> None:
        """Batched ``_route_inbound``: messages for a local silo ride ONE
        ``MessageCenter.deliver_batch`` hand-off per destination (the
        queue-wait killer); gateway-forwarded client deliveries and
        relays peel off to the per-message path. Grouping preserves
        arrival order per destination, which is all the wire ever
        guaranteed (per-sender FIFO per target)."""
        groups: dict[Any, list] = {}
        for msg in msgs:
            target = msg.target_silo
            if target is None:
                local = silo
            else:
                local = self.silos.get(target)
            if local is not None:
                g = groups.get(local.message_center)
                if g is None:
                    g = groups[local.message_center] = []
                g.append(msg)
            else:
                # client route / stale target / relay: per-message path
                self._route_inbound(silo, msg)
        for center, batch in groups.items():
            center.deliver_batch(batch)

    def _route_inbound(self, silo: "Silo", msg: Message) -> None:
        target = msg.target_silo
        if target is not None:
            local = self.silos.get(target)
            if local is not None:
                local.message_center.deliver(msg)
                return
            client_writer = self.client_routes.get(target)
            if client_writer is not None:
                # gateway forwarding to a connected client
                # (Gateway.TryDeliverToProxy:229)
                self._write_to_client(target, client_writer, msg)
                return
            if target.same_endpoint(silo.silo_address):
                # addressed to a client of ours that disconnected, or to an
                # older generation of this silo: drop (sender times out /
                # re-addresses via directory)
                log.info("dropping message for unknown local target %s",
                         target)
                return
            # misrouted: relay toward the addressed silo
            self.deliver(msg)
            return
        # unaddressed (client gateway ingress): this silo addresses it
        silo.message_center.deliver(msg)

    def bounce_unencodable(self, msg: Message, exc: Exception) -> None:
        """A message failed to *encode* (unpicklable payload). Requests get
        an error response back to the caller; anything else is dropped."""
        if msg.direction == Direction.RESPONSE or msg.sending_silo is None:
            log.warning("dropping unencodable %s: %s", msg.method_name, exc)
            return
        from ..core.message import make_error_response
        self.deliver(make_error_response(msg, SiloUnavailableError(
            f"wire encode failed for {msg.interface_name}.{msg.method_name}: "
            f"{exc}")))

    def _bounce_undecodable(self, msg: Message, info: str) -> None:
        """Body failed to decode; headers survived, so reject back to the
        sender instead of letting the call time out."""
        if msg.direction == Direction.RESPONSE or msg.sending_silo is None:
            log.warning("dropping undecodable %s: %s", msg.method_name, info)
            return
        from ..core.message import RejectionType, make_rejection
        rej = make_rejection(msg, RejectionType.UNRECOVERABLE,
                             f"wire decode failed: {info}")
        self.deliver(rej)

    # -- in-proc client compatibility --------------------------------------
    def register_client(self, client) -> None:  # pragma: no cover
        raise NotImplementedError(
            "SocketFabric clients connect via GatewayClient, not in-proc")

    def deliver_via_gateway(self, gateway: SiloAddress,
                            msg: Message) -> None:  # pragma: no cover
        raise NotImplementedError(
            "SocketFabric clients connect via GatewayClient, not in-proc")


# ---------------------------------------------------------------------------
# Out-of-process client
# ---------------------------------------------------------------------------

class _GatewayConnection:
    """One TCP connection to one gateway silo (GatewayConnection.cs)."""

    def __init__(self, client: "GatewayClient", endpoint: str):
        self.client = client
        self.endpoint = endpoint
        host, port = endpoint.rsplit(":", 1)
        self.pseudo_address = SiloAddress(host, int(port), client.generation)
        self.writer: asyncio.StreamWriter | None = None
        self.reader_task: asyncio.Task | None = None
        self.queue: asyncio.Queue[Message] = asyncio.Queue()
        self.sender_task: asyncio.Task | None = None
        self.live = False
        self.peer_native = False  # negotiated from the gateway's reply

    async def connect(self) -> None:
        host, port = self.endpoint.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(encode_handshake("client", self.pseudo_address))
        await writer.drain()
        # codec negotiation: the gateway replies with its own handshake
        try:
            self.peer_native = await _read_peer_codec(reader)
        except OSError:
            writer.close()  # misaligned reply stream must not feed _pump
            raise
        self.writer = writer
        self.live = True
        loop = asyncio.get_running_loop()
        self.reader_task = loop.create_task(self._pump(reader))
        self.sender_task = loop.create_task(self._send_loop())

    async def _pump(self, reader: asyncio.StreamReader) -> None:
        """Client message pump (OutsideRuntimeClient.RunClientMessagePump:235).
        Batched like the silo side: one ``decode_frames`` pass per socket
        read (header-undecodable frames are dropped with a log inside)."""
        # loop-occupancy attribution: this task's steps — response decode
        # + receive_response correlation — are CLIENT gateway machinery,
        # a first-class category so co-hosted harness cost never hides in
        # "other" (one contextvar set; free without a profiler installed)
        from ..observability.profiling import mark_loop_category
        mark_loop_category("client")
        try:
            async for msgs, bounces in _read_frame_batches(
                    reader, strict_tail=False):
                for e in bounces:
                    # a response we cannot decode still completes the call
                    msg = e.message
                    from ..core.message import ResponseKind
                    if msg.direction == Direction.RESPONSE:
                        msg.response_kind = ResponseKind.ERROR
                        msg.body = SiloUnavailableError(
                            f"undecodable response: {e}")
                        self.client.deliver(msg)
                if msgs:
                    # batched correlation: contiguous response runs out of
                    # one socket read resolve in a single
                    # receive_response_batch pass (one freelist sweep)
                    self.client.deliver_batch(msgs)
        except (ConnectionResetError, OSError):
            pass
        except FrameError as e:
            log.warning("gateway %s stream misaligned: %s", self.endpoint, e)
        finally:
            self.live = False
            if self.writer is not None:
                self.writer.close()

    def _bounce_unencodable(self, m: Message, e: Exception) -> None:
        if m.direction != Direction.RESPONSE:
            from ..core.message import make_error_response
            self.client.deliver(make_error_response(
                m, SiloUnavailableError(
                    f"wire encode failed for "
                    f"{m.interface_name}.{m.method_name}: {e}")))

    async def _send_loop(self) -> None:
        from ..observability.profiling import mark_loop_category
        mark_loop_category("client")  # see _pump: client-side machinery
        while True:
            msg = await self.queue.get()
            batch = _drain_batch(self.queue, msg)
            chunks = encode_message_batch(batch, self._bounce_unencodable,
                                          native=self.peer_native)
            if not chunks:
                continue
            try:
                assert self.writer is not None
                self.writer.write(b"".join(chunks))
                await self.writer.drain()
            except (OSError, AssertionError) as e:
                self.live = False
                log.warning("gateway %s send failed: %s", self.endpoint, e)
                # the connection is known-dead: fail EVERY batched call
                # promptly instead of letting any wait out the response
                # timeout
                from ..core.message import make_error_response
                for m in batch:
                    if m.direction != Direction.RESPONSE:
                        self.client.deliver(make_error_response(
                            m, SiloUnavailableError(
                                f"gateway {self.endpoint} connection lost")))

    def close(self) -> None:
        self.live = False
        for t in (self.reader_task, self.sender_task):
            if t is not None:
                t.cancel()
        if self.writer is not None:
            self.writer.close()


class GatewayClient(RuntimeClient):
    """Out-of-process cluster client over TCP gateways
    (OutsideRuntimeClient.cs:22 + GatewayManager.cs): N gateway connections,
    per-grain affinity routing with round-robin fallback, response pump,
    reconnect-on-demand."""

    def __init__(self, gateways: list[str], response_timeout: float = 30.0):
        super().__init__(response_timeout=response_timeout)
        if not gateways:
            raise ValueError("at least one gateway endpoint required")
        self.generation = _fresh_generation()
        self.conns = [_GatewayConnection(self, ep) for ep in gateways]
        self.grain_factory = GrainFactory(self)
        self._rr = 0
        self.connected = False
        self._reconnect_period = 0.5
        self._reconnector: asyncio.Task | None = None
        from .observers import ObserverHost
        self._observer_host = ObserverHost(lambda: self.silo_address)

    # -- RuntimeClient surface --------------------------------------------
    @property
    def silo_address(self) -> SiloAddress | None:
        live = self._live()
        return live[0].pseudo_address if live else None

    def _live(self) -> list[_GatewayConnection]:
        return [c for c in self.conns if c.live]

    def _pick_conn(self, msg: Message, live: list) -> _GatewayConnection:
        """The ONE affinity rule for both transmit paths: per-grain hash
        keeps one grain's requests ordered through one connection,
        round-robin for untargeted traffic."""
        if msg.target_grain is not None:
            return live[msg.target_grain.uniform_hash % len(live)]
        self._rr = (self._rr + 1) % len(live)
        return live[self._rr]

    def transmit(self, msg: Message) -> None:
        self._mark_remote_trace(msg)  # client sends always leave the client
        live = self._live()
        if not live:
            raise SiloUnavailableError("no live gateway connections")
        conn = self._pick_conn(msg, live)
        msg.sending_silo = conn.pseudo_address
        conn.queue.put_nowait(msg)

    def transmit_batch(self, msgs: list) -> None:
        """Batched transmit (RuntimeClient.call_batch): the group is
        split per live connection by the same affinity rule as
        ``transmit`` (shared ``_pick_conn``) and each slice is queued in
        one synchronous pass — the sender task wakes once and the whole
        slice rides a single ``encode_message_batch`` write (deliberate
        wire-batch fill, not greedy-drain luck)."""
        live = self._live()
        if not live:
            raise SiloUnavailableError("no live gateway connections")
        for msg in msgs:
            self._mark_remote_trace(msg)
            conn = self._pick_conn(msg, live)
            msg.sending_silo = conn.pseudo_address
            conn.queue.put_nowait(msg)

    def deliver(self, msg: Message) -> None:
        if msg.direction == Direction.RESPONSE:
            self.receive_response(msg)
        elif self._observer_host.dispatch(msg):
            pass  # grain→client observer notification
        else:
            log.debug("gateway client dropping unexpected message %s",
                      msg.method_name)

    # -- observers (CreateObjectReference / DeleteObjectReference) ---------
    def create_observer(self, obj):
        """Observer routes pin to the pseudo address of the connection the
        ref was minted on; if that gateway drops, re-create the observer
        (the reference refreshes observer routes the same way —
        ClientObserverRegistrar re-registration)."""
        return self._observer_host.create_observer(obj)

    def delete_observer(self, ref) -> bool:
        return self._observer_host.delete_observer(ref)

    # -- lifecycle ---------------------------------------------------------
    async def connect(self) -> "GatewayClient":
        results = await asyncio.gather(
            *(c.connect() for c in self.conns), return_exceptions=True)
        if not self._live():
            raise SiloUnavailableError(
                f"could not reach any gateway: {results}")
        self.connected = True
        self._reconnector = asyncio.get_running_loop().create_task(
            self._reconnect_loop())
        return self

    async def _reconnect_loop(self) -> None:
        """Revive dropped gateway connections (GatewayManager keeps retrying
        dead gateways and returns them to rotation when reachable)."""
        from ..observability.profiling import mark_loop_category
        mark_loop_category("client")  # see _pump: client-side machinery
        while True:
            await asyncio.sleep(self._reconnect_period)
            for c in self.conns:
                if not c.live:
                    c.close()  # reap stale pump/sender tasks
                    try:
                        await c.connect()
                        log.info("gateway %s reconnected", c.endpoint)
                    except OSError:
                        pass  # still down; retry next period

    async def close_async(self) -> None:
        if self._reconnector is not None:
            self._reconnector.cancel()
            self._reconnector = None
        for c in self.conns:
            c.close()
        self.connected = False
        self.close()

    def get_grain(self, grain_class: type, key, key_ext: str | None = None):
        return self.grain_factory.get_grain(grain_class, key, key_ext)
