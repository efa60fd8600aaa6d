"""Multi-process silos: SO_REUSEPORT worker processes +
shared-memory device staging rings.

``SiloConfig.worker_procs = N`` (N >= 2) forks N single-GIL worker
processes at ``Silo.start()``. The topology:

- **One advertised endpoint, N accepting processes.** The owner binds
  the advertised gateway port with ``SO_REUSEPORT`` at construction
  time (so the port is reserved and printable before start); each
  forked worker binds its OWN fresh ``SO_REUSEPORT`` listener to the
  same port and the kernel balances accepted connections across them.
  A connection pins to its accepting worker for life, so the multiloop
  FIFO argument carries over verbatim: senders hash grains to
  connections, per-grain FIFO is preserved with zero cross-process
  hops on the host-tier hot path, and host activations live in the
  accepting worker. The owner closes its own (never-accepting) copy of
  the listener once every worker reports ready — from then on the
  owner process serves NO client ingress at all (main-process pump +
  encode share -> ~0: no client route on the owner, every worker's
  client routes relayed).

- **Workers are full cluster members.** Each worker builds a real
  ``Silo`` on its own internal endpoint and joins the cluster through
  the shared file/sqlite membership table, so death detection
  (SIGKILL -> probes -> declared dead), directory convergence, and the
  per-silo ``ctl_*`` management surface all reuse the existing
  machinery unchanged — a worker is just a silo that happens to share
  the advertised gateway port.

- **One device engine.** Only the owner process owns CUDA and the
  ``VectorRuntime``; forked children never touch the device. Workers
  feed vector calls through cross-process SPSC staging rings built on
  ``multiprocessing.shared_memory`` (:class:`ShmRing` — the
  ``runtime/multiloop.py`` ring discipline one address space wider:
  single-writer cumulative counters on separate cache lines, pipe-byte
  wakeups coalesced exactly like the armed flag, message-bounded
  backpressure). The worker-side fill packs each ingress batch's calls
  column-major straight into the shared segment; the owner drains into
  ``VectorRuntime.call_packed`` (one method/table resolution per
  group, the ``call_group`` discipline) and the existing off-loop tick
  worker + tick fence claim/tick/resolve. Completions ride per-worker
  response rings back and resolve the worker-side futures on the
  worker's loop.

  Deliberate non-goal: the worker does NOT scatter into the engine's
  ``[n_shards, B, ...]`` staging buffers directly — lane allocation is
  owner state under the tick fence (slot lookup, conflict deferral,
  double-buffer rotation), and exporting the fence across processes
  would serialize exactly the work the rings decouple. The shared
  segment carries the columnar batch; the owner's staging fill stays
  where the fence lives.

- **Client-route relays.** Client pseudo-addresses share the
  advertised endpoint, so a response produced in a process that does
  NOT hold the client's connection cannot just dial the endpoint (the
  kernel would hand the connection to an arbitrary worker). Each
  worker announces its client routes to the owner over the request
  ring (``route+``/``route-``); the owner keeps
  ``fabric.route_relays`` (pseudo-address -> owning worker's internal
  endpoint) and relays; workers alias the advertised endpoint to the
  owner's internal endpoint (``fabric.endpoint_aliases``). Relay hops
  are bounded by the message forward count; an unroutable
  advertised-endpoint target is dropped with a log, never dialed.

``worker_procs = 1`` (the default) constructs none of this — today's
single-process path bit for bit (the A/B lever).

The port's copy of ``orleans_tpu.runtime.multiproc``. The owner forks
after ``add_vector_grains`` built its tables on the card, so it already
holds a CUDA context, and torch cannot start CUDA again in a forked child.
So a worker:

- marks itself first (``parallel.mesh.mark_worker_process``): the
  device entry points raise ``WorkerProcessError`` there, and the
  profiler captures the CPU only, with no ``torch.cuda`` call;
- freezes the objects it inherited out of its garbage collector, so no
  inherited tensor (CUDA or CPU) is ever freed in the child;
- runs no torch op (the parent's intra-op thread pool did not survive
  the fork);
- reports ``torch.cuda.is_initialized()`` in its ready and exit records
  (``WorkerSupervisor.describe``).

Ring records are pickled with the wire's tensor refusal
(``core.serialization.WireTypeError`` naming the type, at push): a
tensor's pickle would rebuild it in the other process, a CUDA tensor in
a child where CUDA must not start. The engine resolves vector futures
with numpy, which crosses as it is.
"""

from __future__ import annotations

import asyncio
import copyreg
import gc
import io
import logging
import os
import pickle
import signal
import socket
import struct
import time
from collections import ChainMap
from typing import TYPE_CHECKING, Any

import torch

from ..core import serialization as _ser
from ..core.errors import ConfigurationError, SiloUnavailableError
from ..core.ids import SiloAddress
from ..observability.stats import COUNT_BOUNDS, RING_STATS
from ..parallel.mesh import mark_worker_process

if TYPE_CHECKING:
    from .silo import Silo

log = logging.getLogger("orleans.multiproc")

# ring-stage metric names resolved once (observability.stats.RING_STATS —
# the cross-process leg of the ingest decomposition). Dwell stages are
# stamped push-side INTO the ring record (plain bytes cross the process
# boundary, the stamp-and-replay discipline one address space wider) and
# observed pop-side on the consumer's own loop; CLOCK_MONOTONIC is
# system-wide on Linux, so a producer stamp compares against a consumer
# read directly.
_RS_STAGING = RING_STATS["staging_dwell"]
_RS_RESPONSE = RING_STATS["response_dwell"]
_RS_DRAIN = RING_STATS["drain_batch"]
_RS_GROUP = RING_STATS["group"]
_RS_HOPS = RING_STATS["hops"]
_RS_RECORDS = RING_STATS["records"]

__all__ = ["ShmRing", "WorkerSupervisor", "VectorShmClient"]

# native ring primitives (hotwire.c shm_push/shm_pop operate on the
# identical layout, so a native producer and a pure-Python consumer
# interoperate — the ORLEANS_TPU_NATIVE=0 contract)
_HW = _ser._hotwire
_HW_SHM = _HW is not None and hasattr(_HW, "shm_push")

# ---------------------------------------------------------------------------
# ShmRing: the multiloop SpscRing discipline, one address space wider
# ---------------------------------------------------------------------------
# Header layout (all u64 little-endian):
#   [0:8]    write_cum    cumulative bytes written   (producer-only writer)
#   [8:16]   pushed_msgs  cumulative messages pushed (producer-only writer)
#   [64:72]  read_cum     cumulative bytes consumed  (consumer-only writer)
#   [72:80]  drained_msgs cumulative messages drained(consumer-only writer)
#   [128:]   data region (capacity bytes, 8-aligned)
# Each counter has exactly ONE writer on its own cache line, so no
# read-modify-write ever races (the SpscRing pushed/drained rule); the
# other side only reads. Records are `u32 len | u32 n_msgs | payload`,
# padded to 8 bytes; a record never wraps — when the contiguous tail is
# too short the producer writes a u32 0xFFFFFFFF wrap marker and both
# sides skip to the region start. backlog = pushed - drained, exactly
# the multiloop message-bounded backpressure signal.
_HDR = 128
_OFF_WRITE = 0
_OFF_PUSHED = 8
_OFF_READ = 64
_OFF_DRAINED = 72
_WRAP = 0xFFFFFFFF
_U64 = struct.Struct("<Q")
_REC = struct.Struct("<II")
# ring capacity in MESSAGES before the producer refuses (the multiloop
# _RING_CAPACITY twin); byte capacity bounds independently
_RING_MSG_CAPACITY = 16384

# ring-record pickling: the copyreg table with the wire's exact-type
# tensor refusals in front (core.serialization._REFUSED)
_RING_DISPATCH = ChainMap(_ser._REFUSED, copyreg.dispatch_table)


def _ring_dumps(record) -> bytes:
    """One ring record's bytes; a torch tensor anywhere in it raises
    ``WireTypeError`` naming its type (see the module docstring)."""
    buf = io.BytesIO()
    p = pickle.Pickler(buf, protocol=5)
    p.dispatch_table = _RING_DISPATCH
    p.dump(record)
    return buf.getvalue()


class ShmRing:
    """Bounded cross-process SPSC byte ring over one shared-memory
    segment + a pipe-byte wakeup. ``push`` runs in the producer process
    only, ``pop``/``drain pipe`` in the consumer process only (the
    SpscRing single-producer/single-consumer contract across a process
    boundary). Payloads are opaque bytes; both sides of a silo are the
    same trust domain (forked from one process), so records carry plain
    pickle."""

    __slots__ = ("shm", "buf", "capacity", "wake_rfd", "wake_wfd")

    def __init__(self, shm, wake_rfd: int, wake_wfd: int):
        self.shm = shm
        self.buf = shm.buf
        self.capacity = (shm.size - _HDR) & ~7
        if self.capacity <= 64:
            raise ValueError(f"shm segment too small: {shm.size}")
        self.wake_rfd = wake_rfd
        self.wake_wfd = wake_wfd

    # -- counters (cross-process readable; single writer each) -----------
    def _load(self, off: int) -> int:
        return _U64.unpack_from(self.buf, off)[0]

    def _store(self, off: int, v: int) -> None:
        # an aligned 8-byte store (single memcpy under CPython); the
        # native path uses release/acquire atomics for the same slot
        _U64.pack_into(self.buf, off, v)

    @property
    def pushed_msgs(self) -> int:
        return self._load(_OFF_PUSHED)

    @property
    def drained_msgs(self) -> int:
        return self._load(_OFF_DRAINED)

    def backlog(self) -> int:
        return self.pushed_msgs - self.drained_msgs

    # -- producer side ----------------------------------------------------
    def push(self, payload: bytes, n_msgs: int = 1) -> bool:
        """Append one record and wake the consumer. False = over
        capacity (bytes or messages) — bounded backpressure, the caller
        decides (drop / fail futures / retry later). Never blocks."""
        if self.backlog() >= _RING_MSG_CAPACITY:
            return False
        if _HW_SHM:
            try:
                if not _HW.shm_push(self.buf, self.capacity, payload,
                                    n_msgs):
                    return False
            except ValueError:
                return False
        elif not self._push_py(payload, n_msgs):
            return False
        try:
            os.write(self.wake_wfd, b"\x01")
        except (BlockingIOError, InterruptedError):
            pass  # wakeup already pending — self-coalescing
        except OSError:
            pass  # consumer side gone; the reaper handles it
        return True

    def _push_py(self, payload: bytes, n_msgs: int) -> bool:
        cap = self.capacity
        wc = self._load(_OFF_WRITE)
        rc = self._load(_OFF_READ)
        ln = len(payload)
        rec = 8 + ((ln + 7) & ~7)
        if rec > cap - 8:
            raise ValueError(f"record of {ln} bytes exceeds ring "
                             f"capacity {cap}")
        pos = wc % cap
        contig = cap - pos
        need = rec + (contig if contig < rec else 0)
        if cap - (wc - rc) < need:
            return False
        if contig < rec:
            # wrap marker, then restart at the region head (positions
            # stay 8-aligned, so the 4-byte marker always fits)
            _REC.pack_into(self.buf, _HDR + pos, _WRAP, 0)
            wc += contig
            pos = 0
        _REC.pack_into(self.buf, _HDR + pos, ln, n_msgs)
        self.buf[_HDR + pos + 8:_HDR + pos + 8 + ln] = payload
        # publish AFTER the payload bytes land (the release half; the
        # consumer's counter read is the acquire half)
        self._store(_OFF_WRITE, wc + rec)
        self._store(_OFF_PUSHED, self._load(_OFF_PUSHED) + n_msgs)
        return True

    # -- consumer side ----------------------------------------------------
    def drain_wakeups(self) -> None:
        """Clear pending wakeup bytes BEFORE popping (a push racing the
        drain either lands in this sweep or leaves a byte for the next
        wakeup — the armed-flag rule)."""
        try:
            while os.read(self.wake_rfd, 4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            pass

    def pop(self):
        """One record, or None when empty: ``(payload, n_msgs)``."""
        if _HW_SHM:
            return _HW.shm_pop(self.buf, self.capacity)
        return self._pop_py()

    def _pop_py(self):
        cap = self.capacity
        while True:
            rc = self._load(_OFF_READ)
            if self._load(_OFF_WRITE) == rc:
                return None
            pos = rc % cap
            ln, n_msgs = _REC.unpack_from(self.buf, _HDR + pos)
            if ln == _WRAP:
                self._store(_OFF_READ, rc + (cap - pos))
                continue
            payload = bytes(self.buf[_HDR + pos + 8:_HDR + pos + 8 + ln])
            self._store(_OFF_READ, rc + 8 + ((ln + 7) & ~7))
            self._store(_OFF_DRAINED, self._load(_OFF_DRAINED) + n_msgs)
            return payload, n_msgs

    def close(self) -> None:
        self.buf = None  # release the exported memoryview before shm close
        for fd in (self.wake_rfd, self.wake_wfd):
            try:
                os.close(fd)
            except OSError:
                pass
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass


def _make_ring(size: int) -> ShmRing:
    from multiprocessing import shared_memory
    shm = shared_memory.SharedMemory(create=True, size=_HDR + size)
    shm.buf[:_HDR] = b"\x00" * _HDR
    r, w = os.pipe()
    os.set_blocking(r, False)
    os.set_blocking(w, False)
    return ShmRing(shm, r, w)


def _reuseport_listener(host: str, port: int = 0) -> socket.socket:
    """A fresh listening socket in the advertised endpoint's
    SO_REUSEPORT group (every member sets the option BEFORE bind — the
    kernel's admission rule). Native ``bind_reuseport`` when available
    (one syscall sequence, the hotwire ring's C twin), else the
    portable setsockopt path."""
    if _HW is not None and hasattr(_HW, "bind_reuseport"):
        fd = _HW.bind_reuseport(host, port)
        sock = socket.socket(fileno=fd)
    else:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind((host, port))
        sock.listen(128)
    sock.setblocking(False)
    return sock


# ---------------------------------------------------------------------------
# Worker-side vector proxy: silo.vector in a worker process
# ---------------------------------------------------------------------------

class _ProxyTable:
    """Route-recording stand-in for ``ShardedActorTable`` at a worker:
    ``note_route`` collects (key_hash, uniform_hash) pairs that ride
    the next packed record to the owner's real table
    (``note_route_many``) — the ownership-sweep bookkeeping crosses the
    ring with the calls it belongs to."""

    __slots__ = ("routes",)

    def __init__(self) -> None:
        self.routes: list = []

    def note_route(self, key_hash: int, uniform_hash: int) -> None:
        if key_hash != uniform_hash:
            self.routes.append((key_hash, uniform_hash))

    def drain_routes(self) -> list:
        r, self.routes = self.routes, []
        return r


class VectorShmClient:
    """The worker process's ``silo.vector``: same call surface the
    dispatcher drives (``key_hash_for`` / ``table`` / ``call`` /
    ``call_group``), implemented as a packed push onto the
    cross-process staging ring. The dispatcher bypasses ring-ownership
    forwarding when this proxy is installed (``is_shm_proxy``): the
    ring IS the route — every vector call from this process funnels
    into the single owner-process engine, so all processes resolve a
    key to the same device row (the single-activation constraint,
    enforced by topology instead of per-message forwards)."""

    is_shm_proxy = True

    def __init__(self, ring_out: ShmRing, owner_address: SiloAddress):
        self.ring = ring_out
        self.owner_address = owner_address
        self._tables: dict[type, _ProxyTable] = {}
        self._futures: dict[int, asyncio.Future] = {}
        self._corr = 0
        # counters mirrored from the engine surface (samplers/ctl read
        # them through getattr guards)
        self.ticks = 0
        self.messages_processed = 0
        self.conflicts_deferred = 0
        self.exchange_lanes = 0
        self.tables: dict = {}
        self.pending: dict = {}
        # the staging buffers live in the owner's engine: a worker stages
        # nothing (the metrics sampler's vector.staging_* sources read
        # these instead of failing on every sample)
        self.staging_fill = 0
        # observability taps, set by _worker_async after the worker silo
        # builds them (None = off; every site guards on the None):
        # tracer closes the response-ring leg span per traced call,
        # stats is the silo's metrics-gated registry (ingest_stats
        # idiom) for the ring-stage histograms
        self.tracer = None
        self.stats = None
        # corr -> (trace_id, parent_span_id) for in-flight traced calls:
        # the response pop closes the return-leg span into the right
        # trace (bounded by the futures table it parallels)
        self._trace_of: dict[int, tuple] = {}

    # the one key->hash rule, mirrored from VectorRuntime.key_hash_for
    # (a worker process must not construct the engine)
    @staticmethod
    def key_hash_for(key, uniform_hash: int) -> int:
        if isinstance(key, int) and 0 <= key < 2**62:
            return key
        return uniform_hash

    def table(self, cls: type) -> _ProxyTable:
        t = self._tables.get(cls)
        if t is None:
            t = self._tables[cls] = _ProxyTable()
        return t

    def queue_depth(self) -> int:
        return len(self._futures)

    def staging_lanes(self) -> int:
        return 0

    def shutdown_worker(self) -> None:  # Silo.stop symmetry
        pass

    # -- the packed push --------------------------------------------------
    def call(self, grain_class: type, key_hash: int, method: str,
             **args) -> asyncio.Future:
        return self.call_group(grain_class, method,
                               [(key_hash, args, True)])[0]

    def call_group(self, grain_class: type, method: str,
                   items: list, traces: list | None = None,
                   origin: str | None = None) -> list:
        """Grouped enqueue, ring edition: the batch packs column-major
        (one names tuple + per-argument value columns — the staging
        layout the owner's ``call_packed`` consumes) and lands in the
        shared segment in ONE push. Returns one entry per item in item
        order: a future where ``want_future`` was set, else None (the
        ``call_group`` contract).

        ``traces`` (optional, parallel to ``items``) carries per-item
        ``(trace_id, parent_span_id)`` contexts: they ride the record
        across the ring so the owner opens correctly-parented ring-leg
        and device-tick child spans, and the response pop here closes
        the return leg. The record header carries the push stamps
        (monotonic for dwell, wall for span starts) and a relay hop
        count — stamped push-side, observed pop-side. ``origin`` is
        accepted for engine-signature parity; the owner labels batches
        by link, so it is unused here."""
        loop = asyncio.get_running_loop()
        tracer = self.tracer
        futs: list = []
        # sub-batches keyed by the kwargs name tuple: schema-bound
        # callers all share one; a mixed group still packs correctly
        subs: dict[tuple, list] = {}
        idx = -1
        for key_hash, args, want_future in items:
            idx += 1
            fut = loop.create_future() if want_future else None
            futs.append(fut)
            corr = -1
            if fut is not None:
                self._corr += 1
                corr = self._corr
                self._futures[corr] = fut
            tr = traces[idx] if traces is not None else None
            if tr is not None and tracer is not None:
                if corr >= 0:
                    self._trace_of[corr] = tr
                # this trace's legs are about to leave the process over
                # the ring — retention must fan the pull out (the
                # send-side hook rule, ring edition)
                tracer.mark_remote(tr[0])
            names = tuple(args)
            sub = subs.get(names)
            if sub is None:
                sub = subs[names] = [[], [], [list() for _ in names], []]
            sub[0].append(key_hash)
            sub[1].append(corr)
            for col, name in zip(sub[2], names):
                col.append(args[name])
            sub[3].append(tr)
        routes = self.table(grain_class).drain_routes()
        record = ("vec", grain_class.__name__, method, routes,
                  [(names, khs, corrs, cols, trs)
                   for names, (khs, corrs, cols, trs) in subs.items()],
                  time.monotonic(), time.time(), 1)
        if not self.ring.push(_ring_dumps(record), n_msgs=len(items)):
            # bounded backpressure: the staging ring (or the engine
            # behind it) is saturated — fail promptly, like the egress
            # ring drop policy, instead of buffering without bound
            err = SiloUnavailableError(
                "device staging ring full (owner engine saturated)")
            for fut in futs:
                if fut is not None and not fut.done():
                    fut.set_exception(err)
            self._futures = {c: f for c, f in self._futures.items()
                             if not f.done()}
            self._trace_of = {c: t for c, t in self._trace_of.items()
                              if c in self._futures}
        return futs

    # -- response-ring drain (worker loop) --------------------------------
    def resolve(self, results: list, t_push_mono: float = 0.0,
                t_push_wall: float = 0.0) -> None:
        """Apply one response batch: ``(corr, ok, payload)`` triples.
        ``t_push_mono``/``t_push_wall`` are the owner's response-ring
        push stamps: the pop here (this worker's loop) closes the
        return-leg dwell — the response_dwell histogram plus one "ring"
        span per traced call, parented into the request's trace."""
        dwell = 0.0
        if t_push_mono:
            dwell = max(0.0, time.monotonic() - t_push_mono)
            st = self.stats
            if st is not None:
                st.observe(_RS_RESPONSE, dwell)
        tracer = self.tracer
        trace_of = self._trace_of
        futures = self._futures
        for corr, ok, payload in results:
            tr = trace_of.pop(corr, None)
            if tr is not None and tracer is not None and t_push_mono:
                tracer.record(tr[0], tr[1], "shm.response_ring", "ring",
                              t_push_wall, dwell, pid=os.getpid())
            fut = futures.pop(corr, None)
            if fut is None or fut.done():
                continue
            if ok:
                fut.set_result(payload)
            else:
                fut.set_exception(payload)

    def fail_all(self, exc: Exception) -> None:
        futs, self._futures = self._futures, {}
        self._trace_of.clear()
        for fut in futs.values():
            if not fut.done():
                fut.set_exception(exc)


# ---------------------------------------------------------------------------
# Boot plumbing (fork context: arguments pass by reference, unpickled)
# ---------------------------------------------------------------------------

class _WorkerBoot:
    """Everything one forked worker needs, captured before fork. Plain
    references — the fork start method never pickles, so test-local
    grain classes and closures cross intact."""

    __slots__ = ("index", "name", "host", "advertised_port",
                 "advertised_ep", "owner_internal_ep", "owner_address",
                 "config", "registry", "storage_providers",
                 "vector_interfaces", "membership_factory",
                 "req_ring", "resp_ring", "close_fds", "close_socks",
                 "management")

    def __init__(self, **kw) -> None:
        for k, v in kw.items():
            setattr(self, k, v)


class _WorkerLink:
    """Owner-side handle for one worker: process + both rings + the
    response batcher (single armed flush, the SpscRing wakeup rule on
    the outbound side too)."""

    __slots__ = ("index", "proc", "req_ring", "resp_ring", "silo_address",
                 "internal_ep", "ready", "dead", "out", "_flush_armed",
                 "origin", "cuda_initialized")

    def __init__(self, index: int, proc, req_ring: ShmRing,
                 resp_ring: ShmRing, ready: asyncio.Future):
        self.index = index
        self.proc = proc
        self.req_ring = req_ring    # worker -> owner (consumer here)
        self.resp_ring = resp_ring  # owner -> worker (producer here)
        self.silo_address: SiloAddress | None = None
        self.internal_ep: str | None = None
        self.ready = ready
        self.dead = False
        self.out: list = []          # pending (corr, ok, payload)
        self._flush_armed = False
        # ledger attribution label for work this worker originates
        # (device row-seconds via _Pending.origin, wire bytes via
        # charge_wire) — the cross-process burner key
        self.origin = f"worker-{index}"
        # torch.cuda.is_initialized() in the worker, from its ready and
        # exit records (None until the first); must stay False
        self.cuda_initialized: bool | None = None


class WorkerSupervisor:
    """Owner-side lifecycle + shm engine server for the worker fleet:
    forks the workers, waits for their ready handshakes, closes the
    owner's never-accepting advertised listener, drains each request
    ring into the device engine, batches completions onto the response
    rings, maintains the client-route relay table, and reaps dead
    workers (SIGKILL mid-traffic: the ring goes quiet, membership
    probes declare the worker's silo dead, and the relays toward it
    drop here)."""

    # staging ring: sized for bursts of packed columnar batches;
    # response ring smaller (results are compact)
    REQ_RING_BYTES = 4 << 20
    RESP_RING_BYTES = 2 << 20

    def __init__(self, silo: "Silo"):
        self.silo = silo
        self.fabric = silo.fabric
        self.n = silo.config.worker_procs
        self.links: list[_WorkerLink] = []
        self.loop: asyncio.AbstractEventLoop | None = None
        self._reaper: asyncio.Task | None = None
        self._closed = False
        self._advertised_sock: socket.socket | None = None
        self._mbr_tmp: str | None = None

    # -- fork (owner, pre-services) ---------------------------------------
    def fork_workers(self) -> None:
        """Fork the fleet. Runs FIRST in ``Silo.start()`` — before the
        owner starts loops/threads/services — so each child begins from
        a quiet interpreter (only the forking thread survives a fork;
        a child must never touch inherited CUDA/loop state, and the less
        of it exists, the less there is to avoid)."""
        import multiprocessing
        silo = self.silo
        adv = silo.advertised_address
        assert adv is not None
        self._advertised_sock = self.fabric._listen_socks.get(adv.endpoint)
        membership_factory = self._membership_factory()
        ctx = multiprocessing.get_context("fork")
        storage_providers = dict(silo.storage_manager.providers)
        close_socks: list = [self._advertised_sock,
                             self.fabric._listen_socks.get(
                                 silo.silo_address.endpoint)]
        close_fds: list[int] = []
        for i in range(self.n):
            req = _make_ring(self.REQ_RING_BYTES)
            resp = _make_ring(self.RESP_RING_BYTES)
            boot = _WorkerBoot(
                index=i, name=f"{silo.config.name}-w{i}",
                host=adv.host, advertised_port=adv.port,
                advertised_ep=adv.endpoint,
                owner_internal_ep=silo.silo_address.endpoint,
                owner_address=silo.silo_address,
                config=silo.config, registry=silo.registry,
                storage_providers=storage_providers,
                vector_interfaces=dict(silo.vector_interfaces),
                membership_factory=membership_factory,
                # workers of a managed silo install their own SiloControl
                # so cluster fan-outs (ctl_metrics / ctl_loop_profile /
                # ctl_critical_path) reach every process by silo address
                management=getattr(silo, "silo_control", None) is not None,
                req_ring=req, resp_ring=resp,
                # earlier workers' wakeup pipes: close in this child so
                # a dead sibling's pipe EOF semantics stay crisp
                close_fds=list(close_fds),
                close_socks=list(close_socks))
            proc = ctx.Process(target=_worker_main, args=(boot,),
                               name=boot.name, daemon=True)
            proc.start()
            close_fds.extend((req.wake_rfd, req.wake_wfd,
                              resp.wake_rfd, resp.wake_wfd))
            self.links.append(_WorkerLink(i, proc, req, resp,
                                          asyncio.get_running_loop()
                                          .create_future()))

    def _membership_factory(self):
        """A per-process constructor for the SHARED membership table.
        Workers must see the same rows the owner does; only a
        path-backed table can cross the fork (each process re-opens by
        path). No membership at all -> a private file table in a
        tempdir, created here and auto-joined by the owner too."""
        mbr = self.silo.membership
        if mbr is None:
            import tempfile
            from ..membership import FileMembershipTable, join_cluster
            self._mbr_tmp = tempfile.mkdtemp(prefix="orleans-mbr-")
            path = os.path.join(self._mbr_tmp, "membership.json")
            join_cluster(self.silo, FileMembershipTable(path))
            return lambda: FileMembershipTable(path)
        table = mbr.table
        cls = type(table)
        path = getattr(table, "path", None)
        if path is None or cls.__name__ == "InMemoryMembershipTable" or \
                path == ":memory:":
            raise ConfigurationError(
                f"worker_procs > 1 needs a path-backed membership table "
                f"shared across processes (File/SqliteMembershipTable); "
                f"got {cls.__name__}")
        return lambda: cls(path)

    # -- owner-loop attach / ready barrier --------------------------------
    def attach(self, loop: asyncio.AbstractEventLoop) -> None:
        self.loop = loop
        for link in self.links:
            loop.add_reader(link.req_ring.wake_rfd, self._drain_link, link)
        self._reaper = loop.create_task(self._reap_loop())

    async def wait_ready(self, timeout: float = 30.0) -> None:
        """Block until every worker's silo is serving on its reuseport
        listener, then retire the owner's advertised-listener copy:
        while any fd to the owner's listening socket stays open the
        socket keeps its SO_REUSEPORT share and black-holes the
        connections hashed to it (nobody accepts there). Children close
        their inherited copies at boot; this close is the last."""
        try:
            await asyncio.wait_for(
                asyncio.gather(*(lk.ready for lk in self.links)), timeout)
        except asyncio.TimeoutError:
            dead = [lk.index for lk in self.links if not lk.ready.done()]
            raise SiloUnavailableError(
                f"worker processes {dead} did not come up within "
                f"{timeout}s") from None
        adv_ep = self.silo.advertised_address.endpoint
        if self._advertised_sock is not None:
            self.fabric._listen_socks.pop(adv_ep, None)
            self._advertised_sock.close()
            self._advertised_sock = None
        log.info("silo %s: %d reuseport workers serving %s",
                 self.silo.config.name, self.n, adv_ep)

    # -- request-ring drain (owner loop) -----------------------------------
    def _drain_link(self, link: _WorkerLink) -> None:
        ring = link.req_ring
        ring.drain_wakeups()
        st = self.silo.ingest_stats
        led = self.silo.ledger
        n_recs = rx_bytes = 0
        while True:
            rec = ring.pop()
            if rec is None:
                break
            n_recs += 1
            rx_bytes += len(rec[0])
            try:
                payload = pickle.loads(rec[0])
                kind = payload[0]
                if kind == "vec":
                    self._handle_vec(link, payload)
                elif kind == "route+":
                    self.fabric.route_relays[payload[1]] = payload[2]
                elif kind == "route-":
                    if self.fabric.route_relays.get(payload[1]) == \
                            payload[2]:
                        self.fabric.route_relays.pop(payload[1], None)
                elif kind == "ready":
                    _, addr, internal_ep, link.cuda_initialized = payload
                    link.silo_address = SiloAddress(*addr)
                    link.internal_ep = internal_ep
                    if not link.ready.done():
                        link.ready.set_result(None)
                elif kind == "exit":
                    link.cuda_initialized = payload[1]
                else:
                    log.warning("unknown shm record kind %r from "
                                "worker %d", kind, link.index)
            except Exception:  # noqa: BLE001 — one record, not the link
                log.exception("shm request record failed (worker %d)",
                              link.index)
        if n_recs:
            if st is not None:
                # drain-batch size + record counter: one observe per
                # wakeup sweep, on the owner's own loop (loop-confined)
                st.histogram_with(_RS_DRAIN, COUNT_BOUNDS).observe(n_recs)
                st.increment(_RS_RECORDS, n_recs)
            if led is not None:
                # inbound wire bytes land on the originating worker's
                # route row — the cross-process get_cluster_ledger key
                led.charge_wire(link.origin, rx_bytes, 0)

    def _handle_vec(self, link: _WorkerLink, payload) -> None:
        """One packed vector batch -> the engine. The columnar
        sub-batches join via ``call_packed`` (one method/table
        resolution + one tick schedule per group — the call_group
        discipline), route notes land in the real table, and each
        wanted future's completion batches onto the response ring.

        The record tail carries the worker's push stamps and per-sub
        trace-context columns: the pop here closes the staging-ring
        dwell (histogram + one "ring" span per distinct traced request,
        parented into the request's trace), and the contexts thread
        into ``call_packed`` so the tick records correctly-parented
        device-tick child spans. ``link.origin`` labels every item for
        the ledger's per-worker device-time attribution."""
        _, iface, method, routes, subs, t_mono, t_wall, hops = payload
        silo = self.silo
        rt = silo.vector
        vcls = silo.vector_interfaces.get(iface)
        if rt is None or vcls is None:
            err = SiloUnavailableError(
                f"no device engine for {iface} in the owner process")
            for _names, _khs, corrs, _cols, _trs in subs:
                for corr in corrs:
                    if corr >= 0:
                        self._complete_value(link, corr, False, err)
            return
        st = silo.ingest_stats
        dwell = max(0.0, time.monotonic() - t_mono)
        if st is not None:
            st.observe(_RS_STAGING, dwell)
            st.histogram_with(_RS_HOPS, COUNT_BOUNDS).observe(hops)
        tracer = silo.tracer
        if tracer is not None:
            seen: set = set()
            for _names, _khs, _corrs, _cols, trs in subs:
                for tr in trs:
                    if tr is None or tr in seen:
                        continue
                    seen.add(tr)
                    tracer.record(tr[0], tr[1], "shm.staging_ring",
                                  "ring", t_wall, dwell,
                                  worker=link.index)
        if routes:
            rt.table(vcls).note_route_many(routes)
        origin = link.origin if silo.ledger is not None else None
        for names, khs, corrs, cols, trs in subs:
            if st is not None:
                st.histogram_with(_RS_GROUP, COUNT_BOUNDS).observe(
                    len(khs))
            try:
                futs = rt.call_packed(vcls, method, khs,
                                      dict(zip(names, cols)),
                                      [c >= 0 for c in corrs],
                                      traces=(trs if tracer is not None
                                              else None),
                                      origin=origin)
            except Exception as e:  # noqa: BLE001 — unknown method etc.
                for corr in corrs:
                    if corr >= 0:
                        self._complete_value(link, corr, False, e)
                continue
            for corr, fut in zip(corrs, futs):
                if fut is not None:
                    fut.add_done_callback(
                        lambda f, lk=link, c=corr: self._complete(lk, c, f))

    # -- response batching (owner loop) ------------------------------------
    def _complete(self, link: _WorkerLink, corr: int, fut) -> None:
        if fut.cancelled():
            self._complete_value(link, corr, False, SiloUnavailableError(
                "device tick cancelled at silo stop"))
            return
        exc = fut.exception()
        if exc is not None:
            self._complete_value(link, corr, False, exc)
        else:
            self._complete_value(link, corr, True, fut.result())

    def _complete_value(self, link: _WorkerLink, corr: int, ok: bool,
                        payload) -> None:
        link.out.append((corr, ok, payload))
        if not link._flush_armed:
            link._flush_armed = True
            self.loop.call_soon(self._flush_link, link)

    def _flush_link(self, link: _WorkerLink) -> None:
        link._flush_armed = False
        if not link.out or link.dead:
            link.out.clear()
            return
        batch, link.out = link.out, []
        # push stamps ride the record (monotonic for the response-dwell
        # observe, wall for the return-leg span start — both closed by
        # the worker's pop); a retry re-stamps at its own push, so dwell
        # never absorbs the backoff
        stamps = (time.monotonic(), time.time())
        try:
            data = _ring_dumps(("res", batch) + stamps)
        except Exception:  # noqa: BLE001 — unpicklable result: per-item
            data = _ring_dumps(
                ("res", [self._portable(item) for item in batch])
                + stamps)
        if not link.resp_ring.push(data, n_msgs=len(batch)):
            # response ring full (worker loop stalled): hold the batch
            # and retry — results must not drop while the worker lives
            link.out = batch + link.out
            if not link._flush_armed:
                link._flush_armed = True
                self.loop.call_later(0.002, self._flush_link, link)
            return
        led = self.silo.ledger
        if led is not None:
            # outbound wire bytes join the worker's route row (the rx
            # half charges at the request-ring drain)
            led.charge_wire(link.origin, 0, len(data))

    @staticmethod
    def _portable(item):
        corr, ok, payload = item
        try:
            _ring_dumps(payload)
            return item
        except _ser.WireTypeError as e:
            return (corr, False, e)  # a tensor: the refusal names it
        except Exception as e:  # noqa: BLE001
            if ok:
                return (corr, False, SiloUnavailableError(
                    f"vector result could not cross the worker ring: {e}"))
            return (corr, False, SiloUnavailableError(
                f"vector error could not cross the worker ring: "
                f"{payload!r}"))

    # -- death watch --------------------------------------------------------
    async def _reap_loop(self) -> None:
        """A SIGKILLed worker goes silent: membership probes declare its
        SILO dead (directory convergence — existing machinery); this
        loop reaps the PROCESS — joins it, detaches its rings, and drops
        the client-route relays that pointed into it (those connections
        died with the process; senders learn via response timeout)."""
        while not self._closed:
            await asyncio.sleep(0.5)
            for link in self.links:
                if link.dead or link.proc.is_alive():
                    continue
                link.dead = True
                log.warning("worker process %d (pid %s) died",
                            link.index, link.proc.pid)
                self.loop.remove_reader(link.req_ring.wake_rfd)
                link.out.clear()
                if link.internal_ep is not None:
                    stale = [a for a, ep in
                             self.fabric.route_relays.items()
                             if ep == link.internal_ep]
                    for a in stale:
                        self.fabric.route_relays.pop(a, None)
                if not link.ready.done():
                    link.ready.set_exception(SiloUnavailableError(
                        f"worker {link.index} died during startup"))

    def silo_addresses(self) -> set:
        """The silo addresses of the workers that reported ready: ring
        owners that are this silo's own processes (their vector calls
        run on this engine)."""
        return {lk.silo_address for lk in self.links
                if lk.silo_address is not None}

    def alive_workers(self) -> int:
        return sum(1 for lk in self.links
                   if not lk.dead and lk.proc.is_alive())

    def describe(self) -> dict:
        """The ``ctl_workers`` payload: topology + per-worker ring
        counters (single-writer cumulative, so this read is torn-free)
        + the relay spread (client connections per worker — the accept
        balance the floor asserts on)."""
        relays: dict[str, int] = {}
        for ep in self.fabric.route_relays.values():
            relays[ep] = relays.get(ep, 0) + 1
        return {
            "worker_procs": self.n,
            "advertised": self.silo.advertised_address.endpoint,
            "workers": [{
                "index": lk.index,
                "pid": lk.proc.pid,
                "alive": (not lk.dead) and lk.proc.is_alive(),
                "silo": lk.internal_ep,
                "client_routes": relays.get(lk.internal_ep or "", 0),
                "req_pushed": lk.req_ring.pushed_msgs,
                "req_drained": lk.req_ring.drained_msgs,
                "req_backlog": lk.req_ring.backlog(),
                "resp_pushed": lk.resp_ring.pushed_msgs,
                "resp_drained": lk.resp_ring.drained_msgs,
                "resp_backlog": lk.resp_ring.backlog(),
                "cuda_initialized": lk.cuda_initialized,
            } for lk in self.links],
        }

    # -- shutdown ----------------------------------------------------------
    async def stop(self, graceful: bool = True) -> None:
        """Clean-shutdown drain: tell every live worker to stop (its
        silo drains its own rings/turns on its own loop), join the
        processes, take a FINAL sweep of each request ring (so every
        decoded-and-pushed record is accounted — pushed == drained
        afterwards), then unlink the segments."""
        if self._closed:
            return
        self._closed = True
        if self._reaper is not None:
            self._reaper.cancel()
        for link in self.links:
            self.loop.remove_reader(link.req_ring.wake_rfd)
            if not link.dead and link.proc.is_alive() and graceful:
                link.resp_ring.push(_ring_dumps(("stop",)), n_msgs=0)
        if graceful:
            deadline = time.monotonic() + 10.0
            loop = asyncio.get_running_loop()
            for link in self.links:
                budget = max(0.1, deadline - time.monotonic())
                await loop.run_in_executor(None, link.proc.join, budget)
        for link in self.links:
            if link.proc.is_alive():
                link.proc.terminate()
                await asyncio.get_running_loop().run_in_executor(
                    None, link.proc.join, 2.0)
            if link.proc.is_alive():
                link.proc.kill()
        for link in self.links:
            # final sweep: whatever the workers pushed before exiting
            # still routes (route-/vec records from their own drains)
            self._drain_link(link)
            # completions that land after this point have nowhere to go
            # (the worker is gone): _flush_link drops them on the flag
            link.dead = True
            link.req_ring.close()
            link.resp_ring.close()
            try:
                link.req_ring.shm.unlink()
                link.resp_ring.shm.unlink()
            except (OSError, FileNotFoundError):
                pass
        if self._advertised_sock is not None:
            self._advertised_sock.close()
            self._advertised_sock = None

    def cleanup_membership_dir(self) -> None:
        """Remove the auto-provisioned membership tempdir. Called by the
        silo AFTER its own membership oracle has shut down — the OWNER's
        iam-alive/refresh timers keep writing the table file past
        ``stop()`` (workers stop first by design), so removing it there
        would turn every later timer tick into a FileNotFoundError."""
        if self._mbr_tmp is not None:
            import shutil
            shutil.rmtree(self._mbr_tmp, ignore_errors=True)
            self._mbr_tmp = None


# ---------------------------------------------------------------------------
# Worker process body
# ---------------------------------------------------------------------------

def _worker_main(boot: _WorkerBoot) -> None:
    """Forked child entry: shed inherited resources, build THIS
    process's silo, serve. Exits via ``os._exit`` so the parent's
    atexit/pytest machinery never runs twice."""
    # before anything else: no device entry point from here on, and no
    # inherited object (a CUDA tensor among them) is ever collected here
    mark_worker_process()
    gc.freeze()
    code = 0
    try:
        # inherited listener fds FIRST: while this child holds a copy
        # of the owner's advertised reuseport listener, that socket
        # keeps its accept share after the owner closes its own fd —
        # and nobody accepts there (the black-hole)
        for s in boot.close_socks:
            try:
                if s is not None:
                    s.close()
            except OSError:
                pass
        for fd in boot.close_fds:
            try:
                os.close(fd)
            except OSError:
                pass
        asyncio.run(_worker_async(boot))
    except Exception:  # noqa: BLE001 — the parent reads our stderr
        log.exception("worker %s crashed", boot.name)
        code = 1
    finally:
        os._exit(code)


async def _worker_async(boot: _WorkerBoot) -> None:
    from dataclasses import replace

    from ..membership import join_cluster
    from ..storage.core import StorageManager
    from .silo import Silo
    from .socket_fabric import SocketFabric

    loop = asyncio.get_running_loop()
    stop_ev = asyncio.Event()
    try:
        loop.add_signal_handler(signal.SIGTERM, stop_ev.set)
        loop.add_signal_handler(signal.SIGINT, stop_ev.set)
    except (NotImplementedError, RuntimeError):
        pass

    # worker_procs=1: a worker never forks its own fleet. The owner's
    # Prometheus endpoint is a TCP port WITHOUT SO_REUSEPORT — N workers
    # inheriting its number would collide at bind (or worse, silently
    # shadow each other) — so workers rebind ephemeral (port 0) when the
    # owner serves metrics at all, else stay serverless; per-process
    # metrics stay reachable over ctl (ctl_metrics / ctl_critical_path
    # fan out by silo address). Everything else — tracing, profiling
    # (flight-recorder triggers), ledger, SLO — inherits, so anomaly
    # triggers fire IN the worker that breached.
    cfg = replace(boot.config, name=boot.name, worker_procs=1,
                  metrics_port=(0 if boot.config.metrics_port is not None
                                else None))
    fabric = SocketFabric(boot.host)
    storage = StorageManager()
    storage.providers.update(boot.storage_providers)
    silo = Silo(cfg, fabric, boot.registry, storage)
    join_cluster(silo, boot.membership_factory())
    await silo.start()

    if getattr(boot, "management", False):
        # the owner runs add_management: mirror the SiloControl system
        # target here so ManagementGrain fan-outs (cluster metrics, loop
        # profiles, the critical-path waterfall) reach THIS process by
        # its silo address — workers are full cluster members
        from ..management.control import SILO_CONTROL, SiloControl
        control = SiloControl(silo)
        silo.register_system_target(control, SILO_CONTROL)
        silo.silo_control = control

    # the device proxy: every vector call from this process crosses the
    # staging ring into the owner's engine (installed before the
    # reuseport listener opens, so no client ever races it)
    proxy = None
    if boot.vector_interfaces:
        proxy = VectorShmClient(boot.req_ring, boot.owner_address)
        # observability taps: the proxy stamps trace contexts into ring
        # records and closes response-ring legs on THIS silo's collector
        # / metrics-gated registry (both None when the plane is off)
        proxy.tracer = silo.tracer
        proxy.stats = silo.ingest_stats
        silo.vector = proxy
        silo.vector_interfaces.update(boot.vector_interfaces)
    # responses to clients held by OTHER processes route via the owner
    fabric.endpoint_aliases[boot.advertised_ep] = boot.owner_internal_ep

    # client-route announcements -> the owner's relay table
    def _route_notify(addr, up: bool) -> None:
        kind = "route+" if up else "route-"
        boot.req_ring.push(
            _ring_dumps((kind, addr, silo.silo_address.endpoint)),
            n_msgs=0)
    fabric.route_notify = _route_notify

    # response-ring drain: resolve proxy futures on this loop
    def _drain_responses() -> None:
        ring = boot.resp_ring
        ring.drain_wakeups()
        while True:
            rec = ring.pop()
            if rec is None:
                return
            try:
                payload = pickle.loads(rec[0])
            except Exception:  # noqa: BLE001
                log.exception("bad response record")
                continue
            if payload[0] == "res":
                if proxy is not None:
                    proxy.resolve(payload[1], payload[2], payload[3])
            elif payload[0] == "stop":
                stop_ev.set()
    loop.add_reader(boot.resp_ring.wake_rfd, _drain_responses)

    # THIS process's membership of the advertised endpoint's reuseport
    # group: a fresh listener (never the inherited fd), accepted
    # connections pin here for life
    lsock = _reuseport_listener(boot.host, boot.advertised_port)
    server = await asyncio.start_server(
        lambda r, w: fabric._handle_conn(silo, r, w), sock=lsock)

    boot.req_ring.push(
        _ring_dumps(("ready",
                     (silo.silo_address.host, silo.silo_address.port,
                      silo.silo_address.generation),
                     silo.silo_address.endpoint,
                     torch.cuda.is_initialized())), n_msgs=0)
    log.info("worker %s serving %s (silo %s)", boot.name,
             boot.advertised_ep, silo.silo_address.endpoint)

    await stop_ev.wait()

    server.close()
    await server.wait_closed()
    loop.remove_reader(boot.resp_ring.wake_rfd)
    if proxy is not None:
        proxy.fail_all(SiloUnavailableError("worker stopping"))
    await silo.stop()
    # the last record: CUDA stayed untouched for the worker's whole life
    # (the owner's final sweep in WorkerSupervisor.stop reads it)
    boot.req_ring.push(_ring_dumps(("exit", torch.cuda.is_initialized())),
                       n_msgs=0)
