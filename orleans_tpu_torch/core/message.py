"""Message model (L1/L2 boundary).

Re-design of the reference's single unit-of-work type
(Orleans' src/Orleans.Core/Messaging/Message.cs:12 — enums :74-101,
HeadersContainer :725) plus the response envelope (``Response.cs``).

Departures:

* In-process and intra-slice delivery never serializes: messages are plain
  Python objects handed between silo event loops (the reference deep-copies
  instead for isolation — see ``immutable`` flag).
* Batched device payloads: when a message targets a vectorized grain, ``body``
  is a (method, args-pytree) pair whose leaves are numpy scalars so the
  tick engine can stack thousands of messages into one kernel launch.

The port's copy of ``orleans_tpu.core.message``.
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any

from .ids import ActivationId, GrainId, SiloAddress

__all__ = [
    "Category", "Direction", "ResponseKind", "RejectionType",
    "Message", "make_request", "make_response", "make_error_response",
    "make_rejection", "recycle_message", "recycle_messages",
    "PoolDisciplineError", "set_debug_pool", "debug_pool_enabled",
    "pool_generation", "assert_live", "assert_generation",
]


class Category(IntEnum):
    """QoS classes with separate queues/draining in the reference
    (``Message.cs:74-78``, ``InboundMessageQueue.cs``, ``Silo.cs:215-217``)."""

    PING = 0
    SYSTEM = 1
    APPLICATION = 2


class Direction(IntEnum):
    """``Message.cs:80-85``."""

    REQUEST = 0
    RESPONSE = 1
    ONE_WAY = 2


class ResponseKind(IntEnum):
    """Result discriminator (``Message.ResponseTypes``, ``Message.cs:95-101``)."""

    SUCCESS = 0
    ERROR = 1
    REJECTION = 2


class RejectionType(IntEnum):
    """``Message.RejectionTypes`` (``Message.cs:87-93``)."""

    TRANSIENT = 0
    OVERLOADED = 1
    DUPLICATE_REQUEST = 2
    UNRECOVERABLE = 3
    GATEWAY_TOO_BUSY = 4
    CACHE_INVALIDATION = 5


_correlation = itertools.count(1)


@dataclass
class Message:
    """One grain message. Headers follow ``Message.HeadersContainer``
    (``Message.cs:725``) trimmed to the fields the TPU runtime consumes.

    ``__slots__`` keeps per-message overhead low on the host control plane; the
    real hot path never materializes one object per logical invocation — the
    tick engine (orleans_tpu.dispatch.tick) carries batches as arrays.
    """

    __slots__ = (
        "category", "direction", "id", "sending_silo", "sending_grain",
        "sending_activation", "target_silo", "target_grain", "target_activation",
        "interface_name", "method_name", "body", "response_kind",
        "rejection_type", "rejection_info", "forward_count", "resend_count",
        "expires_at", "call_chain", "is_read_only", "is_always_interleave",
        "is_unordered", "immutable", "cache_invalidation", "request_context",
        "is_new_placement", "transaction_info", "interface_version",
        "received_at",
        # freelist bookkeeping only — NOT dataclass fields (no annotation),
        # never cross the wire (excluded from runtime.wire._HEADER_SLOTS).
        # _pool_gen is the debug-poisoning generation counter: bumped on
        # every recycle under ORLEANS_TPU_DEBUG_POOL=1 so wire/dispatch
        # paths can assert a shell they hold was not recycled (and maybe
        # re-acquired) under them — the runtime double-check of what the
        # OTPU001 static rule proves.
        "_pool_free", "_pool_gen",
    )

    category: Category
    direction: Direction
    id: int
    sending_silo: SiloAddress | None
    sending_grain: GrainId | None
    sending_activation: ActivationId | None
    target_silo: SiloAddress | None
    target_grain: GrainId | None
    target_activation: ActivationId | None
    interface_name: str
    method_name: str
    body: Any
    response_kind: ResponseKind
    rejection_type: RejectionType | None
    rejection_info: str | None
    forward_count: int
    resend_count: int
    expires_at: float | None
    call_chain: tuple[GrainId, ...]
    is_read_only: bool
    is_always_interleave: bool
    is_unordered: bool
    immutable: bool
    cache_invalidation: list | None
    request_context: dict | None
    is_new_placement: bool
    transaction_info: Any
    # caller's compiled-against interface version (Runtime/Versions/
    # enforcement at addressing, Dispatcher.cs:725-732)
    interface_version: int
    # local monotonic arrival stamp (queue-wait attribution for tracing;
    # stamped on delivery only when a tracer is installed, never crosses
    # the wire — see runtime.wire._HEADER_SLOTS)
    received_at: float | None

    # ------------------------------------------------------------------
    @property
    def is_expired(self) -> bool:
        return self.expires_at is not None and time.monotonic() > self.expires_at

    def created_response(self, kind: ResponseKind, body: Any) -> "Message":
        """Build the response for this request, swapping sender/target
        (``MessageFactory.CreateResponseMessage``). Positional args in
        field order — this runs once per request on the hot path and the
        kwarg-matching cost of 28 fields is measurable."""
        return _fresh_message(
            self.category, Direction.RESPONSE, self.id,
            self.target_silo, self.target_grain, self.target_activation,
            self.sending_silo, self.sending_grain, self.sending_activation,
            self.interface_name, self.method_name, body,
            kind, None, None,              # response_kind, rejection x2
            0, 0, self.expires_at,         # forward, resend, expiry
            (), self.is_read_only, False,  # call_chain, read_only, interleave
            False, True, None,             # unordered, immutable, cache_inval
            None, False, self.transaction_info,  # ctx, new_placement, txn
            self.interface_version,
            None,                          # received_at (stamped on arrival)
        )


# ---------------------------------------------------------------------------
# Message freelist (the BufferPool.cs discipline applied to envelopes):
# request/response shells on the host control plane churn at call rate, and
# allocator/GC pressure was measurable in a ping attribution profile. A released
# envelope re-enters service through ``_fresh_message`` (dataclass __init__
# re-run on the recycled shell — every field overwritten, so no state leaks
# between uses). ``recycle_message`` is called ONLY where the envelope's
# lifecycle provably ends (RuntimeClient.receive_response, after the caller's
# future resolves; egress shards, after an outbound response's bytes are
# produced): callers guarantee no live reference remains.
#
# Thread-safety contract (sharded egress releases from shard threads):
# RELEASE is safe from any thread — ``list.append``/``list.pop`` are
# GIL-atomic, the releasing thread is by contract the shell's LAST
# holder (so the per-shell field clears race nothing), and the capacity
# check is per-append (``len < cap`` then append can interleave across
# threads, overfilling by at most one shell per concurrent releaser —
# bounded and benign, the cap is a memory bound not an invariant).
# ACQUIRE (``_fresh_message``) stays effectively loop-side today but is
# pop-defensive so a concurrent release/acquire interleaving can never
# raise.
# ---------------------------------------------------------------------------

_MSG_POOL: list["Message"] = []
_MSG_POOL_CAP = 1024

# Debug pool-poisoning (ORLEANS_TPU_DEBUG_POOL=1): recycle_message stamps a
# per-shell generation counter and the wire/dispatch paths assert that a
# shell they hold is neither sitting in the freelist (_pool_free) nor a
# different incarnation than the one they captured (_pool_gen changed) —
# the runtime double-check of what the OTPU001 static rule proves. Off by
# default: the stamp/asserts cost nothing on the hot path when disabled
# (call sites gate on the module flag before calling in).
_DEBUG_POOL = os.environ.get("ORLEANS_TPU_DEBUG_POOL", "") not in ("", "0")


class PoolDisciplineError(AssertionError):
    """A pooled shell was used after recycle (or across a re-acquire)."""


def set_debug_pool(enabled: bool) -> bool:
    """Flip poisoning at runtime (tests); returns the previous setting."""
    global _DEBUG_POOL
    prev, _DEBUG_POOL = _DEBUG_POOL, bool(enabled)
    return prev


def debug_pool_enabled() -> bool:
    return _DEBUG_POOL


def pool_generation(m: Message) -> int:
    """Current incarnation of a shell (0 until its first debug recycle)."""
    return getattr(m, "_pool_gen", 0)


def assert_live(m: Message, where: str) -> None:
    """Poisoning check: the shell must not be in the freelist."""
    if _DEBUG_POOL and getattr(m, "_pool_free", False):
        raise PoolDisciplineError(
            f"pooled Message used after recycle at {where} "
            f"(id={getattr(m, 'id', '?')}, gen={pool_generation(m)})")


def assert_generation(m: Message, gen: int, where: str) -> None:
    """Poisoning check: the shell is live AND still the incarnation the
    caller captured — catches recycle-and-reacquire under a holder."""
    if not _DEBUG_POOL:
        return
    assert_live(m, where)
    if pool_generation(m) != gen:
        raise PoolDisciplineError(
            f"pooled Message recycled under its holder at {where} "
            f"(captured gen {gen}, now {pool_generation(m)})")


def _fresh_message(*fields) -> Message:
    pool = _MSG_POOL
    if pool:
        try:
            m = pool.pop()
        except IndexError:  # raced a concurrent acquirer: allocate
            m = None
        if m is not None:
            m._pool_free = False
            m.__init__(*fields)
            return m
    m = Message(*fields)
    m._pool_free = False
    m._pool_gen = 0
    return m


def recycle_message(m: Message) -> None:
    """Return a dead envelope to the freelist. Idempotent (double release
    is a no-op via ``_pool_free`` — the STATIC double-release check is
    OTPU001's job); drops the shell when the pool is full. Reference-
    carrying fields are cleared so a pooled shell cannot pin user payloads
    or context dicts alive. Callable from any thread (see the freelist
    thread-safety contract above): the capacity check is per-append, so
    concurrent releasers can overfill the pool by at most one shell
    each — a memory bound, not an invariant."""
    if getattr(m, "_pool_free", False):
        return
    pool_full = len(_MSG_POOL) >= _MSG_POOL_CAP
    if pool_full and not _DEBUG_POOL:
        return
    if _DEBUG_POOL:
        # stamp even when the shell is DROPPED (pool at cap): poisoning
        # must keep detecting use-after-recycle on the busiest paths,
        # which are exactly the ones that fill the pool. A dropped shell
        # never re-enters service, so leaving it marked free is correct —
        # any later touch is the bug the mode exists to catch.
        m._pool_gen = pool_generation(m) + 1
    m._pool_free = True
    m.body = None
    m.request_context = None
    m.transaction_info = None
    m.cache_invalidation = None
    m.call_chain = ()
    if not pool_full:
        _MSG_POOL.append(m)


def recycle_messages(msgs) -> None:
    """Batch twin of :func:`recycle_message` — ONE release sweep for the
    envelopes a batched response correlation retires together
    (``RuntimeClient.receive_response_batch``: two envelopes per RPC at
    batch rate, where the per-call function overhead was the point of
    batching), and for the egress shards' encode-then-recycle sweep
    (shard-thread callers — the capacity check below is per-append, not
    a precomputed room count, so concurrent sweeps stay bounded; see
    the freelist thread-safety contract above). Semantics are identical
    per envelope: idempotent via ``_pool_free``, reference-carrying
    fields cleared, debug-pool generation stamped even when the full
    pool drops the shell."""
    pool = _MSG_POOL
    debug = _DEBUG_POOL
    cap = _MSG_POOL_CAP
    for m in msgs:
        if getattr(m, "_pool_free", False):
            continue
        room = len(pool) < cap
        if not room and not debug:
            continue
        if debug:
            m._pool_gen = pool_generation(m) + 1
        m._pool_free = True
        m.body = None
        m.request_context = None
        m.transaction_info = None
        m.cache_invalidation = None
        m.call_chain = ()
        if room:
            pool.append(m)


def make_request(
    *,
    target_grain: GrainId,
    interface_name: str,
    method_name: str,
    body: Any,
    category: Category = Category.APPLICATION,
    direction: Direction = Direction.REQUEST,
    sending_silo: SiloAddress | None = None,
    sending_grain: GrainId | None = None,
    sending_activation: ActivationId | None = None,
    target_silo: SiloAddress | None = None,
    timeout: float | None = 30.0,
    call_chain: tuple[GrainId, ...] = (),
    is_read_only: bool = False,
    is_always_interleave: bool = False,
    immutable: bool = False,
    request_context: dict | None = None,
    interface_version: int = 0,
) -> Message:
    """Request factory (``MessageFactory.CreateMessage``). Default 30 s expiry
    mirrors ``MessagingOptions.ResponseTimeout``. Positional construction in
    field order (see created_response)."""
    return _fresh_message(
        category, direction, next(_correlation),
        sending_silo, sending_grain, sending_activation,
        target_silo, target_grain, None,
        interface_name, method_name, body,
        ResponseKind.SUCCESS, None, None,
        0, 0,
        (time.monotonic() + timeout) if timeout is not None else None,
        call_chain, is_read_only, is_always_interleave,
        False, immutable, None,
        request_context, False, None,
        interface_version,
        None,
    )


def make_request_fast(
    category, direction, sending_silo, sending_grain, sending_activation,
    target_silo, target_grain, interface_name, method_name, body,
    expires_at, call_chain, is_read_only, is_always_interleave,
    request_context, interface_version,
) -> Message:
    """Positional hot-path twin of :func:`make_request` (the RPC engine
    builds one Message per call; 28 kwargs are measurable there). The
    field list lives here, beside the dataclass, so reordering Message
    fields has exactly one positional construction site per shape to
    update (this, make_request, created_response)."""
    return _fresh_message(
        category, direction, next(_correlation),
        sending_silo, sending_grain, sending_activation,
        target_silo, target_grain, None,
        interface_name, method_name, body,
        ResponseKind.SUCCESS, None, None,
        0, 0, expires_at,
        call_chain, is_read_only, is_always_interleave,
        False, False, None,
        request_context, False, None,
        interface_version,
        None,
    )


def make_response(request: Message, result: Any) -> Message:
    return request.created_response(ResponseKind.SUCCESS, result)


def make_error_response(request: Message, exc: BaseException) -> Message:
    return request.created_response(ResponseKind.ERROR, exc)


def make_rejection(request: Message, rtype: RejectionType, info: str) -> Message:
    msg = request.created_response(ResponseKind.REJECTION, None)
    msg.rejection_type = rtype
    msg.rejection_info = info
    return msg
