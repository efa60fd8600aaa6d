"""Multi-loop silo ingress: sharded pump threads + SPSC hand-off rings.

Batching squeezed per-message cost at every boundary, and the JAX
package's measurements still showed ``queue_wait`` at ~0.9 of
per-message stage time at c=32 saturation with the socket pump at
0.33-0.57 of loop wall: **one Python event loop per silo multiplexing
pump + turns + client machinery is the wall**. The reference runtime
never funnels a silo's messaging through one thread — SocketManager
runs dedicated send/receive threads and MessageCenter fans work across
them (SocketManager.cs:1-261, IncomingMessageAcceptor.cs:12).

This module is the asyncio re-design of that split:

* ``IngressLoopPool`` — N ``IngressShard`` threads, each running its
  OWN event loop with its own socket pump. The silo's listener accepts
  on the main loop and hands each accepted socket round-robin to a
  shard (the listener-thread hand-off form of the reference's
  SO_REUSEPORT/acceptor-thread pattern; one process needs no
  SO_REUSEPORT since a single listener can feed every loop).
* Each shard's pump is **vectored**: one ``hotwire.sock_recv_batch`` C
  call per socket-ready event does the recv syscall (GIL released)
  AND the frame-batch decode straight into Message shells — replacing
  the Python recv → buffer-append → decode chain. Without the native
  build (``ORLEANS_TPU_NATIVE=0``) a byte-identical Python fallback
  (``sock_recv`` + ``decode_frames``) pumps the same frames.
* Decoded batches ride a lock-free **SPSC hand-off ring** (single
  producer: the shard thread; single consumer: the silo's main loop)
  with a coalesced ``call_soon_threadsafe`` wakeup, landing in ONE
  ``deliver_batch`` per ring drain entry — so the main loop's share of
  a message shrinks to routing + the turn itself.
* **QoS**: PING/SYSTEM messages (membership probes, control RPCs)
  NEVER enter the ring — each is handed to the main loop immediately
  and individually, so a probe can never sit behind ring backpressure
  or a drain of thousands of application frames (the same split that
  keeps them out of the egress flush accumulator; a probe response
  delayed past the probe timeout gets healthy silos voted dead).
* **Ordering**: a connection's frames stay on ONE shard for the
  connection's lifetime and the ring is FIFO, so per-sender-per-target
  FIFO — the only ordering the wire ever guaranteed — is preserved
  end to end; a grain's traffic from one caller rides one connection
  (senders and gateway clients hash grains to connections), so
  per-grain FIFO holds across any number of ingress loops.
* **Egress for shard-owned connections** (gateway client routes): the
  route's writer is a :class:`ShardWriter` bound to the MAIN loop over
  a dup'd fd — the shard owns only the READ half, so responses encode
  AND write where the fabric already runs with ZERO cross-thread
  hand-offs (this alone was worth ~1.7x on the closed-loop A/B vs
  marshalling writes to the shard), vectored through
  ``hotwire.sock_writev`` (one writev per flush group, no ``b"".join``
  copy) with a buffered Python fallback.

**Sharded egress** (``SiloConfig.egress_shards = N``) is the
structural twin of the ingress split for the OUTBOUND half — the
residue of the ingress split was that every ``encode_message_batch`` call and every
per-endpoint sender write still ran on the main loop:

* :class:`EgressShard` — the egress half of one shard loop: an SPSC
  ring fed FROM the main loop (reverse direction of the ingress rings,
  same coalesced-wakeup/single-writer-counter discipline), draining
  into per-endpoint silo-peer senders and shard-bound client-route
  writers that live ON the shard loop. Encode runs shard-side against
  a per-shard bounded header-template cache (same key/cap as the
  main-loop cache in ``wire.py``), writes ride ``sock_writev``, and
  outbound RESPONSE envelopes are recycled shard-side in one sweep the
  moment their bytes are produced (the freelist release is
  thread-safe — see ``core.message``).
* **Placement** mirrors link ownership (the Mapple mapping philosophy:
  where work runs is a policy over ownership, not an accident of which
  loop created the socket): a silo-peer sender colocates with the
  ingress shard that owns the INBOUND half of the same peering (the
  handshake records ``peer endpoint -> shard``); connect-side links
  with no inbound half round-robin onto shards. With an ingress pool
  the egress shards BORROW the first N ingress loops; without one
  (``ingress_loops=1``) the pool spawns N dedicated egress loop
  threads (client routes then keep the main-loop path — only
  shard-owned routes move).
* **QoS by construction**: PING/SYSTEM messages never enter an egress
  ring (nor the flush accumulator — the batched-egress invariant): they hand
  off per-message via ``call_soon_threadsafe`` straight to the shard's
  sender, so a probe response can never sit behind ring backpressure
  or be dropped by it — the exact mirror of the ingress bypass. Past
  the hand-off it shares the sender's wire FIFO with application
  traffic exactly like the classic path does, but the application
  backlog ahead of it is bounded by the per-endpoint backpressure cap
  below (the classic queue is unbounded — sharding makes the worst
  case strictly tighter, not looser).
* **Backpressure** is bounded in the only direction possible for a
  producer that cannot pause response generation: when ring backlog
  PLUS the destination endpoint's OWN sender-queue occupancy pass
  capacity (a wedged peer blocks its sender mid-write and the queue
  grows behind it), new application messages toward that endpoint DROP
  (counted, ``egress.ring_drops``) — the same
  learn-via-response-timeout semantics as a dead-peer send drop; the
  bound is per-endpoint, so a wedged peer never drops traffic toward
  healthy peers sharing its shard. QoS bypass traffic is never
  dropped; client routes buffer in the shard-bound writer exactly like
  the main-loop transport path does today.
* **Stats discipline**: dwell/encode are STAMPED shard-side into plain
  lists and REPLAYED loop-side over a per-shard stat ring (the
  loop-confinement rule; the registries are loop-confined,
  so OTPU007 stays clean with zero suppressions).
* **Clean shutdown** mirrors the ingress rings: the pool closes (new
  sends fall back to the classic main-loop path), each shard drains
  its ring inline on its own loop, senders flush their queues
  best-effort, then standalone threads join — pushed == drained.

``egress_shards = 0`` (the default) constructs NONE of this: senders,
encode, and client-route writes stay on the main loop bit for bit (the
A/B lever, symmetric with ``batched_egress``/``ingress_loops``).

``SiloConfig.ingress_loops = 1`` (the default) constructs NONE of this:
the silo keeps today's in-loop ``asyncio.start_server`` pump bit for
bit. ``ingress_loops = N >= 2`` spawns N shard threads. In-process
fabrics (InProcFabric) have no sockets and ignore the knob.

GIL note (honest scaling bounds): the recv/writev syscalls and the
select waits release the GIL; header decode and body deserialize hold
it. 1→2 loops therefore overlaps socket IO and scheduling with turn
execution rather than doubling decode throughput — the A/B ratio in
the JAX package's ``benchmarks/loop_attribution.run_multiloop_ab`` is
the measurement, and on free-threaded builds the same structure scales
further.

The port's copy of ``orleans_tpu.runtime.multiloop``, on the port's own
``hotwire`` build (``sock_recv_batch``, ``sock_writev``; the Python
fallback under ``ORLEANS_TPU_NATIVE=0``), with the multi-loop acceptor's
stop repaired (see ``SocketFabric._serve``).
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Any

from ..core import serialization as _ser
from ..core.message import Category, Direction, Message, recycle_messages
from ..observability.stats import (COUNT_BOUNDS, EGRESS_STATS, INGEST_STATS,
                                   SIZE_BOUNDS)
from .wire import (
    _LEN,
    MAX_FRAME_SEGMENT,
    FrameError,
    decode_frames,
    decode_handshake,
    encode_handshake,
    encode_message_batch,
    finish_batch_entries,
    leads_hostile_frame,
    writev_leftover,
)

if TYPE_CHECKING:
    from .silo import Silo
    from .socket_fabric import SocketFabric

log = logging.getLogger("orleans.multiloop")

__all__ = ["IngressLoopPool", "IngressShard", "SpscRing", "ShardWriter",
           "EgressShard", "EgressShardPool", "EgressLoopThread"]

# ring capacity in MESSAGES before the shard pauses its socket reads
# (kernel buffers then backpressure the peer); drained in one consumer
# callback, so this bounds main-loop burst size too
_RING_CAPACITY = 16384
# egress ring capacity in MESSAGES before the main loop starts dropping
# application traffic toward that shard (bounded backpressure — the
# producer is response generation, which cannot pause; see module
# docstring). QoS bypass traffic never counts against (or waits on) it.
_EGRESS_RING_CAPACITY = 16384
_READ_SIZE = 1 << 16
# native vectored entry points (Linux/macOS builds; absent on Windows
# or under ORLEANS_TPU_NATIVE=0 — the Python pump is the fallback)
_HW = _ser._hotwire
_HW_SOCK = _HW is not None and hasattr(_HW, "sock_recv_batch")


class SpscRing:
    """Bounded single-producer/single-consumer hand-off ring with a
    coalesced wakeup: ONE shard thread pushes, the silo's main loop
    drains. ``deque`` append/popleft are GIL-atomic; the armed flag
    coalesces ``call_soon_threadsafe`` wakeups to one per burst (the
    drain clears the flag BEFORE popping, so a push racing the drain
    either lands in the current sweep or re-arms — never lost)."""

    __slots__ = ("_items", "_consumer_loop", "_drain_cb", "_armed",
                 "_context", "pushed_msgs", "drained_msgs",
                 "drained_batches")

    def __init__(self, consumer_loop, drain_cb, context=None):
        self._items: deque = deque()
        self._consumer_loop = consumer_loop
        self._drain_cb = drain_cb
        self._armed = False
        # optional contextvars.Context for the drain callback: asyncio
        # copies the PUSHING thread's context into the Handle, so a
        # ring whose producer runs under an unrelated LOOP_CATEGORY
        # (the egress rings: main loop pushes, shard drains) passes a
        # pre-built context here to keep the consumer-side profiler
        # attribution honest (the profiling pump_ctx idiom). The
        # ingress rings pass none — their shard-thread producer already
        # runs marked "pump", which is exactly the right label.
        self._context = context
        # backlog = pushed - drained: each counter has exactly ONE
        # writer (producer / consumer), so no read-modify-write ever
        # races; the other side only reads (torn-free under the GIL)
        self.pushed_msgs = 0
        self.drained_msgs = 0
        self.drained_batches = 0

    def push(self, item, n_msgs: int) -> None:
        """Producer side (shard thread only)."""
        self._items.append(item)
        self.pushed_msgs += n_msgs
        if not self._armed:
            self._armed = True
            if self._context is not None:
                self._consumer_loop.call_soon_threadsafe(
                    self._drain, context=self._context)
            else:
                self._consumer_loop.call_soon_threadsafe(self._drain)

    def _drain(self) -> None:
        """Consumer side (main loop only)."""
        self._armed = False
        items = self._items
        while True:
            try:
                item = items.popleft()
            except IndexError:
                return
            self.drained_msgs += item[0]
            self.drained_batches += 1
            try:
                self._drain_cb(item)
            except Exception:  # noqa: BLE001 — same contract as the pump
                log.exception("ring drain failed")

    def drain_now(self) -> None:
        """Final consumer-side sweep at shutdown (producers stopped):
        whatever the armed callback never got to runs inline so no
        decoded message is dropped — the clean-shutdown drain."""
        self._drain()

    def discard(self, on_item) -> None:
        """Teardown sweep for a DEAD consumer loop: pop every item
        under the normal counter discipline (pushed == drained still
        holds) but hand it to ``on_item`` instead of the drain
        callback, which must not run in the caller's context."""
        items = self._items
        while True:
            try:
                item = items.popleft()
            except IndexError:
                return
            self.drained_msgs += item[0]
            self.drained_batches += 1
            try:
                on_item(item)
            except Exception:  # noqa: BLE001 — teardown best-effort
                log.exception("ring discard failed")

    def backlog(self) -> int:
        return self.pushed_msgs - self.drained_msgs


async def _read_handshake_frame(loop, sock) -> tuple[bytes, bytes]:
    """Read ONE length-prefixed frame from a raw non-blocking socket
    (the connection-opening handshake); returns (headers, leftover) —
    any bytes the peer pipelined behind the handshake seed the pump's
    tail. Raises FrameError on a hostile announcement, ConnectionError
    on EOF mid-frame."""
    buf = bytearray()
    while True:
        if len(buf) >= 8:
            hlen, blen = _LEN.unpack_from(buf, 0)
            if hlen > MAX_FRAME_SEGMENT or blen > MAX_FRAME_SEGMENT:
                raise FrameError(f"oversized frame announced: {hlen}+{blen}")
            total = 8 + hlen + blen
            if len(buf) >= total:
                return bytes(buf[8:8 + hlen]), bytes(buf[total:])
        chunk = await loop.sock_recv(sock, _READ_SIZE)
        if not chunk:
            raise ConnectionError("EOF during handshake")
        buf += chunk


class ShardWriter:
    """Writer for the client route of a shard-owned connection, bound
    to ONE loop over a dup'd fd: the silo's MAIN loop by default (the
    shard thread owns the READ half; responses encode AND write where
    the fabric's client-route paths already run, so the response path
    pays ZERO cross-thread hand-offs), or — under sharded egress — the
    connection's OWN shard loop (``egress_shard`` set; the fabric then
    hands whole Message flush groups across the egress ring and the
    shard encodes + writes them here). The dup keeps
    the write fd safe against kernel fd-number reuse after the shard
    closes its half; writes to a peer-closed socket surface as EPIPE
    and drop the route exactly like the StreamWriter path. Egress is
    vectored: one ``sock_writev`` per flush group on the native build
    (no ``b"".join`` copy), buffered ``sock_sendall`` otherwise.
    Mirrors the StreamWriter surface the fabric uses
    (``write``/``close``/``is_closing``)."""

    __slots__ = ("_loop", "_sock", "_chunks", "_sending", "_task",
                 "_closed", "on_error", "egress_shard")

    def __init__(self, main_loop, sock):
        self._loop = main_loop
        # set by the shard handler when sharded egress owns this route:
        # the fabric then feeds Message lists to that shard's ring (and
        # the writer binds to the SHARD loop instead of the main loop)
        self.egress_shard = None
        # portable duplicate of the WRITE half: socket.dup() (not
        # os.dup on the raw fd — fds aren't WinSock handles on Windows)
        self._sock = sock.dup()
        self._sock.setblocking(False)
        self._chunks: list = []
        self._sending = False
        self._task = None         # in-flight _send_loop task
        self._closed = False
        self.on_error = None      # main-loop thunk: route cleanup

    # -- main-loop surface ----------------------------------------------
    def write(self, data: bytes) -> None:
        if self._closed:
            raise ConnectionResetError("shard connection closed")
        self._chunks.append(data)
        if not self._sending:
            self._sending = True
            self._task = self._loop.create_task(self._send_loop())

    def write_many(self, chunks: list) -> None:
        """Batched write (``_write_client_batch``): the chunk list rides
        to ``sock_writev`` as-is — no ``b"".join`` copy anywhere on the
        native egress path."""
        if self._closed:
            raise ConnectionResetError("shard connection closed")
        self._chunks.extend(chunks)
        if not self._sending:
            self._sending = True
            self._task = self._loop.create_task(self._send_loop())

    def close(self) -> None:
        """Thread-safe: callable from the main loop (route teardown) or
        the shard's connection handler (peer EOF)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._loop.call_soon_threadsafe(self._do_close)
        except RuntimeError:
            self._do_close()  # main loop gone (process teardown)

    def is_closing(self) -> bool:
        return self._closed

    def _do_close(self) -> None:
        # cancel a send parked in sock_sendall FIRST: closing the fd
        # silently removes it from the selector, so the writability
        # event that future waits on would never fire and the task (plus
        # its buffered responses) would leak for the silo's lifetime
        t = self._task
        if t is not None and not t.done():
            t.cancel()
        self._chunks.clear()
        try:
            self._sock.close()
        except OSError:
            pass

    async def _send_loop(self) -> None:
        loop = self._loop
        try:
            while self._chunks and not self._closed:
                chunks, self._chunks = self._chunks, []
                if _HW_SOCK:
                    # vectored egress: one writev per flush group; a
                    # partial write falls back to buffered sendall for
                    # the remainder (rare: kernel buffer full)
                    try:
                        sent = _HW.sock_writev(self._sock.fileno(), chunks)
                    except BlockingIOError:
                        sent = 0
                    rest = writev_leftover(chunks, sent)
                    if rest:
                        await loop.sock_sendall(self._sock, rest)
                else:
                    await loop.sock_sendall(self._sock, b"".join(chunks))
        except (OSError, ValueError) as e:
            self._closed = True
            log.info("shard client route write failed: %s", e)
            hook = self.on_error
            if hook is not None:
                hook()
        finally:
            self._sending = False


class IngressShard(threading.Thread):
    """ONE ingress loop: a daemon thread running its own event loop,
    pumping the sockets assigned to it and handing decoded batches to
    the silo's main loop over its SPSC ring. The MessageCenter ingress
    shard of the tentpole design: routing stays sharded because a
    connection pins here for life and grain→connection affinity is
    hash-based at every sender."""

    def __init__(self, pool: "IngressLoopPool", index: int):
        super().__init__(name=f"{pool.silo.config.name}-ingress-{index}",
                         daemon=True)
        self.pool = pool
        self.index = index
        # wire-charge route label (cost attribution): per-shard, not
        # per-peer — a shard owns its connections for life, so the label
        # is stable and costs one tuple slot per ring entry
        self._route = f"in:shard{index}"
        self.main_loop = pool.main_loop
        self.loop = asyncio.new_event_loop()
        self.ring = SpscRing(self.main_loop, pool._drain_entry)
        self.profiler = None
        self._conn_tasks: set = set()
        self._ready = threading.Event()
        # counters read by tests/benchmarks (single-writer: this thread)
        self.qos_direct = 0       # PING/SYSTEM handed off ring-free
        self.batches = 0          # ring entries pushed
        self.frames = 0           # messages decoded on this loop

    # -- thread body -----------------------------------------------------
    def run(self) -> None:
        asyncio.set_event_loop(self.loop)
        cfg = self.pool.silo.config
        if cfg.profiling_enabled:
            # per-loop attribution: each ingress loop gets its OWN
            # profiler (occupancy is a loop property); ctl_loop_profile
            # aggregates them beside the main loop's. Best-effort: a
            # failed install must not kill the shard (submit_conn drops
            # connections of a never-ready shard on the floor)
            try:
                from ..observability.profiling import (
                    install_loop_profiler, mark_loop_category)
                self.profiler = install_loop_profiler(
                    self.loop, window=cfg.profiling_window,
                    ring=cfg.profiling_ring, top_k=cfg.profiling_top_k,
                    trigger_interval=cfg.profiling_trigger_interval)
                mark_loop_category("pump")
            except Exception:  # noqa: BLE001
                log.exception("ingress-loop profiler install failed; "
                              "shard runs unprofiled")
        self._ready.set()
        try:
            self.loop.run_forever()
        finally:
            # reap connection tasks (their finallys close the sockets
            # and unregister client routes), then close the loop
            pending = [t for t in self._conn_tasks if not t.done()]
            for t in pending:
                t.cancel()
            if pending:
                try:
                    self.loop.run_until_complete(asyncio.gather(
                        *pending, return_exceptions=True))
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
            self.loop.close()

    def submit_conn(self, fabric: "SocketFabric", silo: "Silo",
                    sock) -> None:
        """Main-loop side: hand one accepted socket to this shard. Never
        blocks: the pool's start() already waited for readiness — a
        shard whose thread died before becoming ready just closes the
        socket (the client redials another connection), it must not
        stall the acceptor (a frozen main loop delays PING responses
        past the probe timeout — the failure the QoS split prevents)."""
        if self.pool.closed or not (self._ready.is_set() and
                                    self.is_alive()):
            sock.close()
            if not self.pool.closed:
                log.warning("ingress shard %s not serving; connection "
                            "dropped", self.name)
            return

        def _start() -> None:
            t = self.loop.create_task(self._serve_conn(fabric, silo, sock))
            self._conn_tasks.add(t)
            t.add_done_callback(self._conn_tasks.discard)

        try:
            self.loop.call_soon_threadsafe(_start)
        except RuntimeError:
            sock.close()  # shard stopped between check and submit

    def stop(self) -> None:
        try:
            self.loop.call_soon_threadsafe(self.loop.stop)
        except RuntimeError:
            pass

    # -- shard-loop connection handling ---------------------------------
    async def _serve_conn(self, fabric: "SocketFabric", silo: "Silo",
                          sock) -> None:
        """Shard-side twin of ``SocketFabric._handle_conn``: handshake,
        route registration, then the vectored pump."""
        from ..observability.profiling import mark_loop_category
        mark_loop_category("pump")
        loop = self.loop
        peer_addr = None
        is_client = False
        writer: ShardWriter | None = None
        try:
            headers, tail = await _read_handshake_frame(loop, sock)
            hs = decode_handshake(headers)
            peer_addr = hs["address"]
            is_client = hs["kind"] == "client"
            await loop.sock_sendall(
                sock, encode_handshake("silo", silo.silo_address))
            if is_client:
                # gateway route for a shard-owned connection: the WRITE
                # half binds to the main loop over a dup'd fd (zero
                # cross-thread hops on the response path; one writev
                # per flush group). Route dict mutation is MARSHALLED
                # to the main loop — the fabric's route tables are
                # main-loop state (unregister_silo iterates them) — and
                # the pump does not START until the registration has
                # RUN there: call_soon_threadsafe FIFO alone is not
                # enough, because a ring already armed by another
                # connection on this shard has its drain queued AHEAD
                # of the registration callback and would route a
                # pipelined first request (whose response then finds no
                # route) before it. One confirmation round trip per
                # connection setup buys the ordering for every delivery
                # path — ring, QoS-direct, and bounce alike.
                #
                # Sharded egress: when the egress pool rides the ingress
                # shards and covers this one, the write half binds to
                # THIS shard's loop instead — the fabric then hands
                # whole Message flush groups across the shard's egress
                # ring (one coalesced hop per group) and encode + writev
                # run here, off the main loop.
                eshard = None
                epool = getattr(fabric, "egress_pool", None)
                if epool is not None and epool.on_ingress and \
                        not epool.closed and \
                        self.index < len(epool.shards) and \
                        epool.shards[self.index].loop is self.loop:
                    # loop identity, not index alone: the fabric-wide
                    # pool borrows the FIRST registered silo's ingress
                    # loops — a co-hosted silo's shard at the same index
                    # runs on a different thread, and binding its writer
                    # there would make write_many a cross-thread call
                    eshard = epool.shards[self.index]
                writer = ShardWriter(
                    self.loop if eshard is not None else self.main_loop,
                    sock)
                writer.egress_shard = eshard

                def _on_err(w=writer, f=fabric, a=peer_addr,
                            ml=self.main_loop):
                    # route-dict mutation MARSHALS to the main loop with
                    # the is-ours identity check (same rule as _cleanup
                    # below): under sharded egress this hook fires on
                    # the SHARD loop, and a reconnected client may have
                    # registered a NEW route meanwhile
                    def _drop():
                        if f.client_routes.get(a) is w:
                            f._drop_client_route(a)
                    try:
                        ml.call_soon_threadsafe(_drop)
                    except RuntimeError:
                        pass  # main loop gone: process teardown
                    w._do_close()

                writer.on_error = _on_err
                native = bool(hs.get("hotwire", False))
                registered: asyncio.Future = loop.create_future()

                def _register(f=fabric, a=peer_addr, w=writer,
                              owner=silo.silo_address, n=native):
                    f.client_routes[a] = w
                    f._route_owner[a] = owner
                    f._client_native[a] = n
                    try:
                        self.loop.call_soon_threadsafe(
                            lambda: registered.done()
                            or registered.set_result(None))
                    except RuntimeError:
                        pass  # shard stopping: the await below is dying

                self.main_loop.call_soon_threadsafe(_register)
                await registered
            else:
                # silo peer: record which shard owns the inbound half of
                # this peering so the egress pool colocates the OUTBOUND
                # sender with it (link-ownership affinity; marshalled —
                # the map is main-loop state like the route tables)
                try:
                    self.main_loop.call_soon_threadsafe(
                        fabric._record_peer_shard, peer_addr.endpoint,
                        self.index)
                except RuntimeError:
                    pass  # main loop gone: process teardown
            await self._pump(fabric, silo, sock, bytearray(tail))
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # clean EOF / peer died
        except FrameError as e:
            log.warning("dropping shard connection from %s: %s",
                        peer_addr, e)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            log.exception("shard connection handler failed (peer=%s)",
                          peer_addr)
        finally:
            if is_client and peer_addr is not None and writer is not None:
                # route cleanup on the main loop (same marshalling rule
                # as registration; the is-ours identity check must run
                # where the dict is owned — a reconnected client may
                # have re-registered a NEW route meanwhile)
                def _cleanup(f=fabric, a=peer_addr, w=writer):
                    if f.client_routes.get(a) is w:
                        f.client_routes.pop(a, None)
                        f._route_owner.pop(a, None)
                        f._client_native.pop(a, None)

                try:
                    self.main_loop.call_soon_threadsafe(_cleanup)
                except RuntimeError:
                    pass  # main loop gone: process teardown
            elif not is_client and peer_addr is not None:
                try:
                    self.main_loop.call_soon_threadsafe(
                        fabric._forget_peer_shard, peer_addr.endpoint,
                        self.index)
                except RuntimeError:
                    pass  # main loop gone: process teardown
            if writer is not None:
                writer.close()  # releases the dup'd write fd
            try:
                sock.close()
            except OSError:
                pass

    async def _pump(self, fabric, silo, sock, tail: bytearray) -> None:
        """The sharded socket pump. Native build: a PERSISTENT reader
        callback — one ``add_reader`` for the connection's lifetime, and
        each socket-ready event costs exactly one vectored C call
        (recv + frame-batch decode) plus the ring push, with no
        coroutine resumption or per-read selector churn (the same
        persistent ``_read_ready`` shape the transport layer uses).
        Fallback: byte-identical ``sock_recv`` + ``decode_frames``.
        Backpressure: when the ring backs up past capacity the pump
        unregisters the reader (kernel buffers then slow the peer)
        instead of growing the hand-off unboundedly."""
        loop = self.loop
        if tail:
            # frames the peer pipelined behind its handshake: decode the
            # seeded tail NOW — both pump shapes below only parse after
            # a fresh recv, so without this a conformant peer that sent
            # handshake+request in one burst and then waited for the
            # response would hang until its timeout
            consumed, msgs0, bounces0 = decode_frames(tail)
            if consumed:
                del tail[:consumed]
            if msgs0 or bounces0:
                self._deliver(fabric, silo, msgs0, bounces0, 0.0, consumed)
            if leads_hostile_frame(tail):
                raise FrameError("oversized frame announced")
        if not _HW_SOCK:
            buf = bytearray(tail)
            while True:
                while self.ring.backlog() > _RING_CAPACITY:
                    await asyncio.sleep(0.002)
                chunk = await loop.sock_recv(sock, _READ_SIZE)
                if not chunk:
                    if buf:
                        raise asyncio.IncompleteReadError(bytes(buf), None)
                    return
                buf += chunk
                # decode stage timed AROUND the parse only — the recv
                # await above is socket idle, not decode cost (the
                # replayed observation must match the single-loop
                # path's decode_frames-internal timing)
                t0 = time.monotonic()
                consumed, msgs, bounces = decode_frames(buf)
                decode_s = time.monotonic() - t0
                if consumed:
                    del buf[:consumed]
                if msgs or bounces:
                    self._deliver(fabric, silo, msgs, bounces,
                                  decode_s, consumed)
                if leads_hostile_frame(buf):
                    raise FrameError("oversized frame announced")

        fd = sock.fileno()
        done: asyncio.Future = loop.create_future()
        tail_b = bytes(tail)

        def _finish(exc: BaseException | None) -> None:
            try:
                loop.remove_reader(fd)
            except Exception:  # noqa: BLE001 — already removed/closed
                pass
            if not done.done():
                if exc is None:
                    done.set_result(None)
                else:
                    done.set_exception(exc)

        def on_ready() -> None:
            nonlocal tail_b
            # decode-stage timing covers the whole fused C call: the
            # NONBLOCKING recv syscall is indivisible from the parse
            # here (that fusion is the vectored pump's point), so the
            # replayed decode observation includes ~1-2us of syscall
            # the decode_frames-timed paths don't — noted, accepted
            t0 = time.monotonic()
            # adaptive read size: sock_recv_batch round-trips the
            # partial tail through a fresh buffer each call, so a huge
            # mid-flight frame read in fixed 64K steps would cost
            # O(frame^2/64K) memcpy — scaling the read toward the tail
            # size keeps the total near-linear (cap 4MB per event)
            bufsize = _READ_SIZE
            tl = len(tail_b)
            if tl > bufsize:
                bufsize = tl if tl < (1 << 22) else (1 << 22)
            try:
                r = _HW.sock_recv_batch(fd, tail_b, Message, bufsize)
            except ValueError as e:
                _finish(FrameError(str(e)))
                return
            except OSError as e:
                _finish(e)
                return
            if r is None:
                return  # spurious readiness
            entries, tail2, eof, nrecv = r
            msgs: list = []
            bounces: list = []
            finish_batch_entries(entries, msgs, bounces)
            nbytes = len(tail_b) + nrecv - len(tail2)  # consumed bytes
            tail_b = tail2
            if msgs or bounces:
                self._deliver(fabric, silo, msgs, bounces,
                              time.monotonic() - t0, nbytes)
            if leads_hostile_frame(tail_b):
                _finish(FrameError("oversized frame announced"))
                return
            if eof:
                _finish(asyncio.IncompleteReadError(tail_b, None)
                        if tail_b else None)
                return
            if self.ring.backlog() > _RING_CAPACITY:
                # backpressure: stop reading; the kernel buffer fills
                # and slows the peer. Resume once the consumer drains.
                try:
                    loop.remove_reader(fd)
                except Exception:  # noqa: BLE001
                    pass
                loop.call_later(0.002, _resume)

        def _resume() -> None:
            if done.done():
                return
            if self.ring.backlog() > _RING_CAPACITY:
                loop.call_later(0.002, _resume)
                return
            loop.add_reader(fd, on_ready)
            on_ready()  # bytes may have buffered while paused

        loop.add_reader(fd, on_ready)
        try:
            await done
        finally:
            if not done.done():
                # the TASK was cancelled (shard stopping) with `done`
                # still pending: resolve it so a backpressure `_resume`
                # scheduled via call_later no-ops instead of re-arming
                # add_reader on the closed fd
                done.cancel()
            try:
                loop.remove_reader(fd)
            except Exception:  # noqa: BLE001 — loop/socket tearing down
                pass

    def _deliver(self, fabric, silo, msgs: list, bounces: list,
                 decode_s: float, nbytes: int) -> None:
        """Hand one decoded read to the main loop: PING/SYSTEM peel off
        ring-free (the QoS split), everything else rides ONE ring entry;
        decode-stage metrics replay loop-side at drain (StatsRegistry is
        not thread-safe — the stamp-off-loop/replay-loop-side
        rule)."""
        now = time.monotonic()
        n = len(msgs) + len(bounces)
        self.frames += n
        app: list | None = None
        main = self.main_loop
        for m in msgs:
            m.received_at = now
            if m.category is not Category.APPLICATION:
                # QoS: probes/control RPCs must never wait behind ring
                # backpressure or an application drain — immediate
                # per-message hand-off (still FIFO with prior ring
                # entries only via the ready queue, which is exactly
                # the cross-category looseness the category-partitioned
                # inbound queues already allow)
                self.qos_direct += 1
                main.call_soon_threadsafe(fabric._route_inbound, silo, m)
            else:
                if app is None:
                    app = []
                app.append(m)
        for e in bounces:
            e.message.received_at = now
            main.call_soon_threadsafe(fabric._bounce_undecodable,
                                      e.message, str(e))
        if app is not None or (n and (self.pool._ist is not None or
                                      self.pool._led is not None)):
            # an entry rides even for QoS/bounce-only reads when metrics
            # (or the cost ledger) are on: the decode seconds/bytes, the
            # ALL-category frame counts, and the wire-byte charge must
            # replay loop-side exactly like the single-loop decode_frames
            # observations (only the stats ride the ring then — the QoS
            # messages themselves were already handed off above, ring-free)
            self.batches += 1
            n_app = len(app) if app is not None else 0
            self.ring.push((n_app, silo, app or [], decode_s, nbytes, n,
                            self._route), n_app)


class IngressLoopPool:
    """N ingress shards for one silo + the round-robin assigner the
    listener uses. Constructed by ``SocketFabric.register_silo`` when
    ``SiloConfig.ingress_loops >= 2``; ``Silo.stop`` closes it (pump
    threads joined, rings drained) BEFORE the message center stops so
    every decoded message still delivers — the clean-shutdown drain."""

    def __init__(self, silo: "Silo", n: int):
        self.silo = silo
        self.main_loop = asyncio.get_running_loop()
        self.closed = False
        self.accept_handle: Any = None   # set by the fabric's acceptor
        self._rr = 0
        # ingest stage metrics replayed at drain (loop-side)
        self._ist = silo.ingest_stats
        # cost ledger, same replay rule: shards stamp nbytes into the
        # ring entry, the drain charges the route loop-side
        self._led = silo.ledger
        self.shards = [IngressShard(self, i) for i in range(n)]

    def start(self) -> None:
        for s in self.shards:
            s.start()
        for s in self.shards:
            s._ready.wait(5.0)

    def assign(self) -> IngressShard:
        self._rr = (self._rr + 1) % len(self.shards)
        return self.shards[self._rr]

    # -- consumer side (main loop) --------------------------------------
    def _drain_entry(self, item) -> None:
        """One ring entry → one ``deliver_batch`` routing hop, with the
        decode-stage metrics the shard stamped replayed here (loop-side,
        the only thread the registry tolerates). ``n_total`` counts
        EVERY frame of the read — QoS-bypassed and bounced included —
        matching the single-loop ``decode_frames`` observations."""
        _n, silo, msgs, decode_s, nbytes, n_total, route = item
        ist = self._ist
        if ist is not None and n_total:
            ist.observe(INGEST_STATS["decode"], decode_s)
            ist.histogram_with(INGEST_STATS["decode_bytes"],
                               SIZE_BOUNDS).observe(nbytes)
            ist.increment(INGEST_STATS["frames"], n_total)
            ist.histogram_with(INGEST_STATS["frame_batch"],
                               COUNT_BOUNDS).observe(n_total)
        led = self._led
        if led is not None and nbytes:
            led.charge_wire(route, rx=nbytes)
        if msgs:
            silo.fabric._route_inbound_batch(silo, msgs)

    # -- lifecycle -------------------------------------------------------
    def close_acceptor(self) -> None:
        h = self.accept_handle
        if h is not None:
            self.accept_handle = None
            h()

    def close(self) -> None:
        """Synchronous teardown half (fabric unregister): stop accepting
        and stop the shard loops."""
        self.closed = True
        self.close_acceptor()
        for s in self.shards:
            s.stop()

    async def aclose(self) -> None:
        """Full teardown (silo stop): stop accepts + pump loops, join
        the threads, then drain every ring on the main loop so decoded
        messages still reach the (still-running) message center."""
        self.close()
        loop = asyncio.get_running_loop()
        for s in self.shards:
            if s.is_alive():
                await loop.run_in_executor(None, s.join, 5.0)
            if s.is_alive():
                # a wedged shard (e.g. a callback deserializing a huge
                # body) outlived the join budget: its ring drain below
                # is best-effort only — say so instead of silently
                # racing the producer
                log.warning("ingress shard %s did not stop within 5s; "
                            "draining its ring best-effort", s.name)
        for s in self.shards:
            s.ring.drain_now()

    # -- observability ---------------------------------------------------
    async def loop_profiles(self, windows: int = 8) -> list[dict]:
        """Per-ingress-loop occupancy profiles (the per-loop attribution
        the profiler's per-loop install buys; aggregated beside the main
        loop's profile by ``SiloControl.ctl_loop_profile``). Each
        profile is read ON its own loop — the profiler's dicts are
        loop-confined, exactly like the main loop's — with a direct read
        only once the shard thread is provably dead."""
        out = []
        for s in self.shards:
            p = s.profiler
            if p is None:
                continue
            if s.is_alive():
                async def _read(prof=p, w=windows):
                    return prof.profile(w, snapshots=False)
                try:
                    prof = await asyncio.wait_for(asyncio.wrap_future(
                        asyncio.run_coroutine_threadsafe(_read(), s.loop)),
                        timeout=2.0)
                except Exception:  # noqa: BLE001 — shard stopping mid-read
                    continue
            else:
                prof = p.profile(windows, snapshots=False)
            prof["ingress_loop"] = s.index
            prof["frames"] = s.frames
            prof["qos_direct"] = s.qos_direct
            prof["ring_batches"] = s.batches
            out.append(prof)
        return out


# ---------------------------------------------------------------------------
# Sharded egress: the outbound twin of the ingress shards
# ---------------------------------------------------------------------------

class EgressLoopThread(threading.Thread):
    """A dedicated egress shard loop for silos WITHOUT an ingress pool
    (``egress_shards > 0`` with ``ingress_loops = 1``): thread + event
    loop + optional per-loop profiler, nothing else — the pump half of
    :class:`IngressShard` never exists here. With an ingress pool the
    egress shards borrow its loops instead (link-ownership affinity)."""

    def __init__(self, name: str, profiling_cfg=None):
        super().__init__(name=name, daemon=True)
        self.loop = asyncio.new_event_loop()
        self.profiler = None
        self._profiling_cfg = profiling_cfg
        self._ready = threading.Event()

    def run(self) -> None:
        asyncio.set_event_loop(self.loop)
        cfg = self._profiling_cfg
        if cfg is not None:
            try:  # best-effort, like the ingress shards
                from ..observability.profiling import (
                    install_loop_profiler, mark_loop_category)
                self.profiler = install_loop_profiler(
                    self.loop, window=cfg.profiling_window,
                    ring=cfg.profiling_ring, top_k=cfg.profiling_top_k,
                    trigger_interval=cfg.profiling_trigger_interval)
                mark_loop_category("egress")
            except Exception:  # noqa: BLE001
                log.exception("egress-loop profiler install failed; "
                              "shard runs unprofiled")
        self._ready.set()
        try:
            self.loop.run_forever()
        finally:
            self.loop.close()

    def stop(self) -> None:
        try:
            self.loop.call_soon_threadsafe(self.loop.stop)
        except RuntimeError:
            pass


# egress ring entry kinds (item[0] is the message count the SpscRing
# counters track; QoS bypass traffic never rides the ring)
_EG_PEER = 0     # (n, _EG_PEER, endpoint, Message | [Message])
_EG_CLIENT = 1   # (n, _EG_CLIENT, (addr, writer, native), [Message])

_EGRESS_ENCODE_STAT = EGRESS_STATS["encode"]
_EGRESS_DWELL_STAT = EGRESS_STATS["dwell"]

# wire-charge stamp riding the egress stat rings (cost attribution):
# replayed into the loop-confined CostLedger by _apply_stats
from ..observability.ledger import WIRE_STAMP as _LEDGER_WIRE  # noqa: E402


class EgressShard:
    """The egress half of ONE shard loop: an SPSC ring fed from the main
    loop draining into per-endpoint silo-peer senders and shard-bound
    client-route writers that live on this loop; shard-side
    ``encode_message_batch`` against a per-shard template cache;
    encode-then-recycle for outbound responses; dwell/encode stamped
    here and replayed loop-side over ``stat_ring`` (the loop-confinement
    rule). Feed methods (``feed_*``/``*_direct``) run on the MAIN loop
    only (single producer); ``_drain``/``_*_now`` run on the shard loop
    only (single consumer)."""

    def __init__(self, pool: "EgressShardPool", index: int, loop):
        self.pool = pool
        self.fabric = pool.fabric
        self.index = index
        self.loop = loop
        self.main_loop = pool.main_loop
        # drain in a pre-built "egress" context: the PRODUCER is the
        # main loop (running under "turns"/whatever category scheduled
        # the flush) and call_soon_threadsafe would copy that context
        # into the shard-side drain — mislabeling the moved encode +
        # write work on the shard's own profiler (the ingress rings
        # don't need this: their shard-thread producer is marked
        # "pump", the right label for main-loop routing)
        from ..observability.profiling import LOOP_CATEGORY
        ctx = contextvars.Context()
        ctx.run(LOOP_CATEGORY.set, "egress")
        self._egress_ctx = ctx
        self.ring = SpscRing(loop, self._drain, context=ctx)
        # shard -> main-loop stat replay (consumer = MAIN loop): entries
        # are (0, [(series_name, value), ...]) observe stamps — replayed
        # under "observability", the registry-work label, not whatever
        # category the shard thread happened to be in at push time
        obs_ctx = contextvars.Context()
        obs_ctx.run(LOOP_CATEGORY.set, "observability")
        self.stat_ring = SpscRing(pool.main_loop, pool._apply_stats,
                                  context=obs_ctx)
        # per-shard bounded header-template cache (same key/cap rules as
        # wire.py's main-loop cache — wire._frame_template enforces them)
        self.tmpl_cache: dict = {}
        self._senders: dict = {}   # endpoint -> _Sender (shard-confined)
        # counters: single-writer discipline like the ingress shards —
        # qos_direct/encoded/recycled written by the shard thread only,
        # drops by the main loop only
        self.qos_direct = 0
        self.encoded = 0      # wire batches encoded shard-side
        self.recycled = 0     # response envelopes recycled shard-side
        self.drops = 0        # ring-full drops (main-loop writer)
        # application messages sitting in shard SENDER queues, PER
        # endpoint (shard thread is the only writer: _drain increments,
        # the sender's batch pop decrements, _close_endpoint drops the
        # key). feed_peer bounds on ring backlog + the ENDPOINT's own
        # entry — without it the ring drains instantly into the
        # unbounded sender queue and the advertised wedged-peer
        # backpressure would never engage (only a stalled shard loop
        # would); per-endpoint, not shard-wide, so one wedged peer's
        # backlog never drops traffic toward healthy peers sharing the
        # shard (the classic path isolates per-endpoint too)
        self.pending: dict = {}

    # -- main-loop (producer) side ---------------------------------------
    def feed_peer(self, endpoint: str, payload, n: int) -> bool:
        """One application message or one flush group toward a silo
        peer. False = backlog over capacity, payload dropped (bounded
        backpressure; the caller counts/recycles). The bound covers the
        ring AND this ENDPOINT's shard sender queue (``pending``): a
        wedged peer blocks its sender in ``drain()`` while the queue
        behind it grows — that queue, not the instantly-drained ring,
        is where a peer stall accumulates, and it is per-endpoint so a
        wedged peer never drops traffic toward its shard-mates."""
        if self.ring.backlog() + self.pending.get(endpoint, 0) > \
                _EGRESS_RING_CAPACITY:
            self.drops += n
            return False
        self.ring.push((n, _EG_PEER, endpoint, payload), n)
        return True

    def feed_client(self, addr, writer, native: bool, msgs: list) -> None:
        """One response flush group toward a shard-owned client route
        (the Message list crosses the ring; encode happens shard-side).
        Never drops: client responses buffer — in the ring, then the
        shard-bound writer — exactly like the classic path buffers them
        in the transport (the module contract); the peer-side drop
        policy exists for senders whose backlog a wedged PEER grows,
        which a client route, drained by its own shard loop, cannot."""
        n = len(msgs)
        self.ring.push((n, _EG_CLIENT, (addr, writer, native), msgs), n)

    def peer_direct(self, endpoint: str, msg) -> None:
        """QoS bypass (PING/SYSTEM): per-message hand-off straight to
        the shard sender's queue — never through the ring, so a probe
        response cannot sit behind ring backpressure or be dropped by
        the bounded-backpressure check (the egress mirror of the
        ingress QoS split). It shares the sender's wire FIFO from
        there, like the classic path — with the application backlog
        ahead of it capped by the per-endpoint ``feed_peer`` bound."""
        self.loop.call_soon_threadsafe(self._peer_now, endpoint, msg,
                                       context=self._egress_ctx)

    def client_direct(self, addr, writer, native: bool, msg) -> None:
        """QoS bypass for a shard-owned client route: per-message
        encode + write marshalled to the shard, ring-free."""
        self.loop.call_soon_threadsafe(self._client_now, addr, writer,
                                       native, msg,
                                       context=self._egress_ctx)

    # -- shard-loop (consumer) side --------------------------------------
    def _sender(self, endpoint: str):
        s = self._senders.get(endpoint)
        if s is None:
            from .socket_fabric import _Sender
            s = self._senders[endpoint] = _Sender(self.fabric, endpoint,
                                                  shard=self)
        return s

    def _peer_now(self, endpoint: str, msg) -> None:
        self.qos_direct += 1
        self._sender(endpoint).queue.put_nowait(msg)

    def _drain(self, item) -> None:
        kind = item[1]
        if kind == _EG_PEER:
            ep = item[2]
            q = self._sender(ep).queue
            payload = item[3]
            self.pending[ep] = self.pending.get(ep, 0) + item[0]
            if type(payload) is list:
                for m in payload:
                    q.put_nowait(m)
            else:
                q.put_nowait(payload)
        else:
            addr, writer, native = item[2]
            self._write_client(addr, writer, native, item[3])

    def _client_now(self, addr, writer, native: bool, msg) -> None:
        self._write_client(addr, writer, native, [msg])

    def _write_client(self, addr, writer, native: bool,
                      msgs: list) -> None:
        """Shard-side client-route flush: dwell stamp → one
        ``encode_message_batch`` against the per-shard template cache →
        one ``write_many`` (→ ``sock_writev``) → one recycle sweep for
        the now-dead outbound response envelopes. Registry writes are
        forbidden here — stamps replay loop-side."""
        stamps = self._dwell_stamps(msgs)
        fabric = self.fabric
        t0 = time.monotonic()
        chunks = encode_message_batch(
            msgs,
            lambda m, e: fabric._client_encode_error(addr, writer, m, e,
                                                     native),
            native=native, stats=None, templates=fabric.response_templates,
            tmpl_cache=self.tmpl_cache)
        if chunks:
            if stamps is not None:
                stamps.append((_EGRESS_ENCODE_STAT,
                               time.monotonic() - t0))
                if fabric.ledger is not None:
                    stamps.append((_LEDGER_WIRE,
                                   (f"client:{addr}",
                                    sum(len(c) for c in chunks))))
            self.encoded += 1
            write_many = getattr(writer, "write_many", None)
            if write_many is None:
                # main-loop StreamWriter under standalone egress
                # (ingress_loops=1): the encode above already ran HERE,
                # off the main loop — the multi-loop residue fix. Only
                # the final fd write marshals back; the fabric tail
                # handles the disconnected-client drop on its own loop.
                try:
                    self.main_loop.call_soon_threadsafe(
                        fabric._stream_write_client, addr, writer,
                        b"".join(chunks))
                except RuntimeError:
                    pass  # main loop closed: route dying anyway
            else:
                try:
                    write_many(chunks)
                except Exception:  # noqa: BLE001 — client gone mid-write
                    log.info("dropping shard batch to disconnected "
                             "client %s", addr)

                    def _drop(f=fabric, a=addr, w=writer):
                        # is-ours identity check (same rule as _on_err):
                        # by the time this runs on the main loop a
                        # reconnected client may have registered a NEW
                        # route under addr
                        if f.client_routes.get(a) is w:
                            f._drop_client_route(a)
                    try:
                        self.main_loop.call_soon_threadsafe(_drop)
                    except RuntimeError:
                        pass
        self._recycle_responses(msgs)
        if stamps:
            self.stat_ring.push((0, stamps), 0)

    def _dwell_stamps(self, msgs: list):
        """Dwell = accumulator add → shard encode (covers accumulator +
        egress ring transit — strictly MORE truthful than the main-loop
        flush-time observation it replaces for sharded destinations).
        Returns a stamp list when metrics are on, else None; clears the
        send-side ``received_at`` either way."""
        if self.fabric.egress_stats is None:
            for m in msgs:
                m.received_at = None
            # ledger-only mode: the wire charge still needs a stamp list
            # to ride the stat ring when metrics are off
            return [] if self.fabric.ledger is not None else None
        stamps: list = []
        now = time.monotonic()
        for m in msgs:
            if m.received_at is not None:
                stamps.append((_EGRESS_DWELL_STAT, now - m.received_at))
                m.received_at = None
        return stamps

    def _recycle_responses(self, msgs: list) -> None:
        """Encode-then-recycle: an outbound RESPONSE envelope is dead
        the moment its bytes exist — nothing silo-side holds it past
        the wire (requests stay out: the sender's callback machinery
        owns them until correlation). One sweep per batch, shard-side
        (the freelist release is thread-safe; see core.message)."""
        dead = [m for m in msgs if m.direction is Direction.RESPONSE]
        if dead:
            recycle_messages(dead)
            self.recycled += len(dead)

    def _close_endpoint(self, endpoint: str) -> None:
        s = self._senders.pop(endpoint, None)
        if s is not None:
            # the backpressure entry dies with the sender: whatever it
            # never drained must not count against a re-dialed sender
            # to the same endpoint (the in-flight batch's decrement
            # no-ops on the missing key — see _Sender._run)
            self.pending.pop(endpoint, None)
            s.close()

    def _discard_ring(self) -> None:
        """Teardown fallback for a DEAD shard loop (callable from the
        main loop): sweep the ring WITHOUT running ``_drain`` — peer
        items would lazily build senders on the calling loop (dialing
        peers mid-shutdown, their tasks registered nowhere) and client
        items would ``create_task`` on the dead loop. Recycle the dead
        response envelopes instead; pushed == drained still holds."""
        def _recycle(item):
            payload = item[3]
            self._recycle_responses(
                payload if type(payload) is list else [payload])
        self.ring.discard(_recycle)

    async def flush_and_close(self) -> None:
        """Clean-shutdown drain, ON the shard loop: sweep the ring
        (consumer side — pushed == drained afterwards, the producers
        already stopped), let each sender flush its queue best-effort,
        then close the links."""
        self.ring.drain_now()
        for s in list(self._senders.values()):
            try:
                await s.drain_idle(2.0)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            s.close()
        self._senders.clear()


class EgressShardPool:
    """N egress shards for one fabric + the link-affinity assigner.
    Constructed by ``SocketFabric.register_silo`` when a local silo has
    ``egress_shards >= 1``: borrows the first N ingress shard loops when
    the silo runs multi-loop ingress (so a peer's outbound sender lives
    with the shard that owns the inbound half of the peering), else
    spawns N dedicated :class:`EgressLoopThread`\\ s. ``Silo.stop``
    closes it BEFORE the ingress pool and the message center so every
    accepted response still flushes — the clean-shutdown drain."""

    def __init__(self, fabric, silo: "Silo", n: int, ingress_pool=None):
        self.fabric = fabric
        self.owner = silo
        self.main_loop = asyncio.get_running_loop()
        self.closed = False
        self._rr = 0
        self._assigned: dict = {}   # endpoint -> shard index (stable)
        self._threads: list[EgressLoopThread] = []
        if ingress_pool is not None:
            self.on_ingress = True
            loops = [s.loop for s in
                     ingress_pool.shards[:max(1, min(n, len(
                         ingress_pool.shards)))]]
            if len(loops) < n:
                log.warning(
                    "egress_shards=%d capped at %d: egress shards "
                    "borrow the ingress loops (ingress_loops=%d) — "
                    "raise ingress_loops to get more egress shards",
                    n, len(loops), len(ingress_pool.shards))
        else:
            self.on_ingress = False
            cfg = silo.config
            pcfg = cfg if cfg.profiling_enabled else None
            self._threads = [
                EgressLoopThread(f"{cfg.name}-egress-{i}", pcfg)
                for i in range(n)]
            for t in self._threads:
                t.start()
            for t in self._threads:
                t._ready.wait(5.0)
            loops = [t.loop for t in self._threads]
        self.shards = [EgressShard(self, i, lp)
                       for i, lp in enumerate(loops)]

    # -- main-loop surface ----------------------------------------------
    def shard_for(self, endpoint: str) -> EgressShard:
        """Stable shard assignment for one peer endpoint: the ingress
        shard owning the inbound half of the peering when known (the
        handshake records it), else round-robin — and sticky either
        way, so one endpoint's traffic keeps per-target FIFO."""
        idx = self._assigned.get(endpoint)
        if idx is None:
            idx = None if not self.on_ingress else \
                self.fabric._peer_shard.get(endpoint)
            if idx is None or idx >= len(self.shards):
                idx = self._rr
                self._rr = (self._rr + 1) % len(self.shards)
            self._assigned[endpoint] = idx
        return self.shards[idx]

    def shard_for_client(self, addr) -> EgressShard:
        """Sticky shard for one CLIENT route (the multi-loop residue
        fix): under ``ingress_loops=1`` client connections are accepted
        on the main loop, so without this their response encodes ran
        there too while silo-peer links already encoded on the shards.
        Round-robin at registration, sticky for the connection's life —
        per-client FIFO holds exactly like per-peer FIFO does."""
        idx = self._assigned.get(addr)
        if idx is None:
            idx = self._rr
            self._rr = (self._rr + 1) % len(self.shards)
            self._assigned[addr] = idx
        return self.shards[idx]

    def _apply_stats(self, item) -> None:
        """Stat-ring drain (MAIN loop — the only thread the registry
        tolerates): replay the shard-stamped dwell/encode observations
        and the wire-byte ledger charges. The ledger entries are NOT
        metrics-gated — ledger-only silos stamp too."""
        est = self.fabric.egress_stats
        led = self.fabric.ledger
        for name, value in item[1]:
            if name is _LEDGER_WIRE:
                if led is not None:
                    route, nbytes = value
                    led.charge_wire(route, tx=nbytes)
            elif est is not None:
                est.observe(name, value)

    # -- lifecycle -------------------------------------------------------
    async def aclose(self) -> None:
        """Close + drain: new sends fall back to the classic main-loop
        path the moment ``closed`` flips (checked by every feed), the
        fabric detaches its shard sender handles, then each shard
        flushes on its own loop (ring swept, sender queues drained
        best-effort) and standalone threads join.

        Teardown ordering caveat (deliberate): a send issued DURING the
        bounded (5s) shard flush builds a fresh classic sender whose
        write can overtake messages the shard sender still holds —
        per-target FIFO is relaxed for that stop window only. The
        alternative (route feeds through each shard sender until it
        quiesces) cannot terminate under sustained load, which is
        exactly when ``Silo.stop`` runs this drain; responses are
        correlation-matched so the RPC layer is order-insensitive, and
        the window is bounded by the flush timeout."""
        if self.closed:
            return
        self.closed = True
        self.fabric._detach_shard_senders()
        loop = asyncio.get_running_loop()

        async def _flush(shard) -> None:
            alive = (self.on_ingress or
                     self._threads[shard.index].is_alive())
            if not alive:
                # loop dead: recycle the ring's envelopes — running the
                # drain here would build senders on THIS loop and write
                # on the dead one (see _discard_ring)
                shard._discard_ring()
                return
            try:
                await asyncio.wait_for(
                    asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                        shard.flush_and_close(), shard.loop)), 5.0)
            except Exception:  # noqa: BLE001 — wedged shard: say so
                log.warning("egress shard %d did not flush within 5s",
                            shard.index)

        # concurrent: the flushes are independent (each on its own
        # loop), so the whole drain is bounded by ONE flush timeout,
        # not shards x timeout
        await asyncio.gather(*(_flush(s) for s in self.shards))
        for t in self._threads:
            t.stop()
        for t in self._threads:
            if t.is_alive():
                await loop.run_in_executor(None, t.join, 5.0)
