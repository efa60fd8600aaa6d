"""Wire framing for cross-process messaging (L2 wire tier).

Re-design of the reference's framing layer: length-prefixed
``[4B headers-len][4B body-len][headers][body]`` frames
(Orleans' src/Orleans.Core/Messaging/IncomingMessageBuffer.cs:125-163,
``Message.LENGTH_HEADER_SIZE`` Message.cs:14-15, ``Message.Serialize:481``).

Departures from the reference:

* Headers and body are encoded with the wire tier of
  :mod:`orleans_tpu_torch.core.serialization` (restricted-unpickler codec
  with a type allowlist) instead of the token-stream binary format — the
  hot data path on the device never touches this codec (vectorized
  payloads ride device collectives; see parallel.transport), so the
  control plane optimizes for fidelity over bytes.
* ``expires_at`` is a ``time.monotonic`` stamp, meaningless across process
  boundaries — it is rebased through a relative TTL carried on the wire.
* A connection opens with a handshake frame identifying the peer
  (``kind`` silo/client + its SiloAddress) — the analog of the gateway
  handshake-carried client id (GatewayAcceptor.cs:63,
  ClientMessageCenter.cs:453).

The port's copy of ``orleans_tpu.runtime.wire``. Its frames are the same
bytes as the JAX package's for the same message (the header slots come
from the same ``Message.__slots__`` order and the same enums), so a port
process and a JAX-package process can share a link.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from typing import Any

log = logging.getLogger("orleans.wire")

from ..core import message as _msg_mod
from ..core.ids import SiloAddress
from ..core.message import Message
from ..core.serialization import deserialize, serialize, serialize_portable
from ..observability.stats import COUNT_BOUNDS as _COUNT_BOUNDS
from ..observability.stats import EGRESS_STATS as _EGRESS
from ..observability.stats import INGEST_STATS as _INGEST
from ..observability.stats import SIZE_BOUNDS as _SIZE_BOUNDS

_EGRESS_ENCODE = _EGRESS["encode"]
_DECODE_SECONDS = _INGEST["decode"]
_DECODE_BYTES = _INGEST["decode_bytes"]
_FRAMES = _INGEST["frames"]
_FRAME_BATCH = _INGEST["frame_batch"]

__all__ = [
    "MAX_FRAME_SEGMENT", "FrameError", "WireDecodeError",
    "encode_frame", "read_frame", "frame_stream",
    "encode_message", "decode_message",
    "encode_message_batch", "decode_frames", "finish_batch_entries",
    "writev_leftover",
    "encode_handshake", "decode_handshake",
]

_LEN = struct.Struct("<II")  # headers-len, body-len (LENGTH_HEADER_SIZE = 8)

# Refuse absurd frames before allocating (the reference caps via
# MaxMessageBodySize / buffer-pool discipline).
MAX_FRAME_SEGMENT = 128 * 1024 * 1024


class FrameError(Exception):
    """Malformed or oversized frame — the connection must be dropped."""


class WireDecodeError(Exception):
    """Frame arrived intact but its payload failed to decode (unregistered
    type, version skew). Scoped to one message, not the connection."""


def encode_frame(headers: bytes, body: bytes) -> bytes:
    if len(headers) > MAX_FRAME_SEGMENT or len(body) > MAX_FRAME_SEGMENT:
        raise FrameError(
            f"frame segment exceeds {MAX_FRAME_SEGMENT} bytes "
            f"(headers={len(headers)}, body={len(body)})")
    return _LEN.pack(len(headers), len(body)) + headers + body


async def read_frame(reader: asyncio.StreamReader) -> tuple[bytes, bytes]:
    """Read one complete frame; raises IncompleteReadError at clean EOF."""
    prefix = await reader.readexactly(_LEN.size)
    hlen, blen = _LEN.unpack(prefix)
    if hlen > MAX_FRAME_SEGMENT or blen > MAX_FRAME_SEGMENT:
        raise FrameError(f"oversized frame announced: {hlen}+{blen}")
    headers = await reader.readexactly(hlen) if hlen else b""
    body = await reader.readexactly(blen) if blen else b""
    return headers, body


async def frame_stream(reader: asyncio.StreamReader, chunk_size: int = 1 << 16,
                       on_batch=None):
    """Yield (headers, body) frames from a buffered chunk reader.

    The per-frame path (`read_frame`) costs three readexactly awaits per
    message; under load this reads a socket chunk once and parses every
    complete frame out of it (the IncomingMessageBuffer batching,
    IncomingMessageBuffer.cs:125). Ends cleanly at EOF on a frame
    boundary; raises IncompleteReadError for a mid-frame EOF and
    FrameError for an oversized announcement (connection must drop).

    ``on_batch`` (metrics): called with the number of complete frames
    parsed out of each socket read — the receive-side batching-degree
    signal (frames-per-wakeup ≈ how hard the sender/backlog is driving
    this link)."""
    buf = bytearray()
    pos = 0
    while True:
        end = len(buf)
        n_frames = 0
        while end - pos >= 8:
            hlen, blen = _LEN.unpack_from(buf, pos)
            if hlen > MAX_FRAME_SEGMENT or blen > MAX_FRAME_SEGMENT:
                raise FrameError(f"oversized frame announced: {hlen}+{blen}")
            total = 8 + hlen + blen
            if end - pos < total:
                break
            h0 = pos + 8
            yield bytes(buf[h0:h0 + hlen]), bytes(buf[h0 + hlen:pos + total])
            pos += total
            n_frames += 1
        if on_batch is not None and n_frames:
            on_batch(n_frames)
        if pos:
            del buf[:pos]
            pos = 0
        chunk = await reader.read(chunk_size)
        if not chunk:
            if buf:
                raise asyncio.IncompleteReadError(bytes(buf), None)
            return
        buf += chunk


# ---------------------------------------------------------------------------
# Message <-> frame
# ---------------------------------------------------------------------------

# Every Message slot except the lazily-decoded body (the headers/body split
# of Message.HeadersContainer, Message.cs:725), expires_at (rebased),
# received_at (a local monotonic arrival stamp, meaningless cross-process —
# the receiver re-stamps on delivery), and _pool_free/_pool_gen (freelist
# bookkeeping, core.message.recycle_message).
_HEADER_SLOTS = tuple(s for s in Message.__slots__
                      if s not in ("body", "expires_at", "received_at",
                                   "_pool_free", "_pool_gen"))

# Enum-typed header fields ride the wire as plain ints (the native codec's
# scalar fast path; pickling an IntEnum writes a by-reference class lookup).
from ..core import serialization as _ser  # noqa: E402
from ..core.message import Category, Direction, RejectionType, ResponseKind  # noqa: E402

_I_CATEGORY = _HEADER_SLOTS.index("category")
_I_DIRECTION = _HEADER_SLOTS.index("direction")
_I_RESPONSE_KIND = _HEADER_SLOTS.index("response_kind")
_I_REJECTION_TYPE = _HEADER_SLOTS.index("rejection_type")


# (field index, members-indexed-by-value) pairs: the single source of truth
# for enum-typed header fields, consumed by the native decoder directly and
# by the pickle-fallback paths below.
_ENUM_SPEC = (
    (_I_CATEGORY, _ser.members_by_value(Category)),
    (_I_DIRECTION, _ser.members_by_value(Direction)),
    (_I_RESPONSE_KIND, _ser.members_by_value(ResponseKind)),
    (_I_REJECTION_TYPE, _ser.members_by_value(RejectionType)),
)

# Native header-struct codec (hotwire.c configure_headers/pack_frame/
# unpack_header): the field-name tuple and enum spec are cached inside the
# C module once, so the per-message socket path is a single C call each
# way — no struct.pack, no bytes concat, no spec tuples crossing the
# C boundary per frame. Frame BYTES are identical to the pack_attrs form,
# so mixed builds (one side without the new entry points) interoperate.
_HW_FRAMES = _ser._hotwire is not None and \
    hasattr(_ser._hotwire, "pack_frame")
if _HW_FRAMES:
    _ser._hotwire.configure_headers(_HEADER_SLOTS, _ENUM_SPEC)
# Vectorized frame-batch entry points (hotwire.c pack_batch/unpack_batch):
# one C call per send batch / per socket read instead of one per frame.
# Batch BYTES are identical to the per-frame form (pack_batch output ==
# concatenated pack_frame frames; unpack_batch parses either), so every
# mix of batched/per-frame/pickle peers interoperates.
_HW_BATCH = _HW_FRAMES and hasattr(_ser._hotwire, "pack_batch")
# Header-prefix template mode (hotwire.c make_header_template/
# pack_batch_tmpl): responses within one egress group share an invariant
# header prefix per (sending-silo, target-silo, kind); the template
# memcpys the pre-encoded invariant runs and patches only the varying
# fields — byte-identical to pack_frame (property-tested).
_HW_TMPL = _HW_BATCH and hasattr(_ser._hotwire, "pack_batch_tmpl")

# The per-message (varying) header fields of a templated frame:
# correlation id, the grain/activation endpoints, the per-class method
# identity, the result discriminator, and the per-message stamps
# (trace-context wall stamp from _stamp_response / call_batch req_ctx,
# txn joins from _attach_txn_joins) — everything else is invariant
# across one template key and rides the memcpy'd chunks. ONE index set
# serves responses AND requests (the call_batch sender half): a field
# that is invariant within a request batch but varies across batches
# (method identity, sender grain) simply encodes per message, which is
# always byte-correct. Sampled frames batch IDENTICALLY (their
# request_context is a varying field); only headers the template cannot
# carry — rejections, forwarded/resent envelopes — peel to the
# per-frame encoder below.
_TMPL_VAR_SLOTS = frozenset((
    "id", "sending_grain", "sending_activation", "target_grain",
    "target_activation", "interface_name", "method_name", "response_kind",
    "is_read_only", "request_context", "transaction_info",
    "interface_version"))
_TMPL_VAR_IDX = tuple(i for i, s in enumerate(_HEADER_SLOTS)
                      if s in _TMPL_VAR_SLOTS)

# template key -> pre-encoded chunk tuple. Response keys are
# (sending_silo, target_silo, category); request keys additionally pin
# direction and the invariant flags (see _frame_template; chain-carrying
# envelopes peel, so chains never enter the key space). Bounded: a
# cluster only ever sees O(silos + clients) keys, but a pathological key
# churn (client generations) must not grow it forever. This dict is the
# MAIN-loop cache; egress shards (runtime.multiloop.EgressShard) pass
# their own per-shard dict through ``encode_message_batch(tmpl_cache=)``
# so shard-side encode never touches (or contends on) this one — the
# key space and cap are identical either way.
_TMPL_CACHE: dict = {}
_TMPL_CACHE_CAP = 512


def _frame_template(m: Message, cache: dict | None = None):
    """The cached header-prefix template for ``m``, or None when the
    message must take the per-frame encoder (carrying headers the
    template's invariant runs can't represent).

    Responses key on (sending_silo, target_silo, category). Requests/
    one-ways — the ``call_batch`` native sender's half — key
    additionally on direction and the flag fields that are constant per
    (class, method) batch (is_always_interleave, immutable), which
    subsumes the per-(sender, target-class, method) keying: one
    template serves every method a sender batches over one link, since
    method identity is a varying field. Chain-CARRYING envelopes peel
    (requests and responses alike): a chain would have to be part of
    the key, and chain cardinality scales with active calling grains —
    keying on it would thrash the bounded cache and evict the hot
    response templates; client senders (the call_batch target) carry
    empty chains and template fully.

    ``cache`` (default: the module-level main-loop cache): the bounded
    template dict to consult — egress shards pass their own so two
    loops never share one dict (the pre-encoded chunk tuples themselves
    are immutable and the C entry points hold the GIL throughout, so
    the only shared state to confine was the cache)."""
    if cache is None:
        cache = _TMPL_CACHE
    d = m.direction
    if (m.rejection_type is not None or m.rejection_info is not None
            or m.forward_count or m.resend_count or m.is_unordered
            or m.call_chain
            or m.cache_invalidation is not None or m.is_new_placement):
        return None  # peel: headers outside the invariant constants
    if d == Direction.RESPONSE:
        if m.is_always_interleave or not m.immutable:
            return None  # peel: flags outside the response template
        key = (m.sending_silo, m.target_silo, m.category)
    else:
        # REQUEST / ONE_WAY: flags are invariant within one call_batch
        # group, so they ride the template keyed, not peeled
        key = (m.sending_silo, m.target_silo, m.category, d,
               m.is_always_interleave, m.immutable)
    t = cache.get(key)
    if t is None:
        if len(cache) >= _TMPL_CACHE_CAP:
            cache.clear()
        try:
            t = cache[key] = _ser._hotwire.make_header_template(
                m, _TMPL_VAR_IDX)
        except Exception:  # noqa: BLE001 — unencodable invariant field:
            return None    # the per-frame path owns the error semantics
    return t


_NO_RUN = object()  # run-splitting sentinel (a template is never this)


def encode_message(msg: Message, native: bool = True) -> bytes:
    """Encode one message frame. ``native=False`` forces the pickle wire
    form — used per-connection when the peer's handshake did not advertise
    hotwire support (mixed-build cluster: a silo whose native build failed
    must still receive decodable frames; SerializationManager.cs:173-201
    negotiates serializers per registered type, we negotiate per link)."""
    if _msg_mod._DEBUG_POOL:
        # pool poisoning: serializing a recycled shell would put another
        # call's (or zeroed) headers on the wire — fail loudly instead
        _msg_mod.assert_live(msg, "wire.encode_message")
    ttl = None
    if msg.expires_at is not None:
        ttl = max(0.0, msg.expires_at - time.monotonic())
    body = serialize(msg.body) if native else serialize_portable(msg.body)
    hw = _ser._hotwire if native else None
    if hw is not None and _HW_FRAMES:
        try:
            # single C call for the whole frame: getattr walk + enum
            # coercion + header encode + length prefix + body splice
            return hw.pack_frame(msg, ttl, body)
        except ValueError:
            pass  # cyclic/over-deep header payload (or absurd size):
            #       the pickle/encode_frame fallback below handles/raises
    headers = None
    if hw is not None:
        try:
            # single C call: getattr walk + enum coercion + encode
            headers = hw.pack_attrs(msg, _HEADER_SLOTS, ttl)
        except ValueError:
            pass  # cyclic/over-deep header payload: pickle's memo handles it
    if headers is None:
        fields = [getattr(msg, s) for s in _HEADER_SLOTS]
        for i, _members in _ENUM_SPEC:
            if fields[i] is not None:
                fields[i] = int(fields[i])
        headers = serialize((tuple(fields), ttl)) if native \
            else serialize_portable((tuple(fields), ttl))
    return encode_frame(headers, body)


def decode_message(headers: bytes, body: bytes, stats=None) -> Message:
    """Decode one frame into a Message. ``stats`` (a StatsRegistry, passed
    by metrics-enabled receive paths) times the whole decode — native
    hotwire or pickle fallback alike — into the ingest stage histograms
    and stamps the envelope's ``received_at`` with the post-decode
    monotonic clock, the single stamp every later ingest stage measures
    against (and re-stamps at its own boundary)."""
    t0 = time.monotonic() if stats is not None else 0.0
    msg = Message.__new__(Message)
    try:
        if headers[:1] == b"\xa7" and _HW_FRAMES and \
                _ser._hotwire is not None:
            # single C call against the cached header spec
            ttl = _ser._hotwire.unpack_header(headers, msg)
        elif headers[:1] == b"\xa7" and _ser._hotwire is not None:
            # single C call: decode + enum restore + setattr walk
            ttl = _ser._hotwire.unpack_attrs(
                headers, msg, _HEADER_SLOTS, _ENUM_SPEC)
        else:
            fields, ttl = deserialize(headers)
            fields = list(fields)
            for i, members in _ENUM_SPEC:
                v = fields[i]
                if v is not None:
                    # range-check before indexing: a negative value must be
                    # rejected, not wrap to the last member, and bool is
                    # not an enum value (matches the C decoder's ev < 0
                    # guard and its exact-int check)
                    m = members[v] if type(v) is int and \
                        0 <= v < len(members) else None
                    if m is None:
                        raise ValueError(
                            f"bad enum value {v!r} for header {_HEADER_SLOTS[i]}")
                    fields[i] = m
            for k, v in zip(_HEADER_SLOTS, fields, strict=True):
                setattr(msg, k, v)
    except Exception as e:  # noqa: BLE001 — headers must decode or the msg is lost
        raise WireDecodeError(f"undecodable message headers: {e}") from e
    msg.expires_at = None if ttl is None else time.monotonic() + ttl
    msg.received_at = None  # local arrival stamp; tracing re-stamps
    msg._pool_free = False  # full slot set: consumers may walk __slots__
    msg._pool_gen = 0       # fresh incarnation on this process
    try:
        msg.body = deserialize(body)
    except Exception as e:  # noqa: BLE001 — body failure is per-message
        msg.body = None
        raise _BodyDecodeError(msg, e) from e
    if stats is not None:
        now = time.monotonic()
        stats.observe(_DECODE_SECONDS, now - t0)
        stats.histogram_with(_DECODE_BYTES, _SIZE_BOUNDS).observe(
            len(headers) + len(body))
        stats.increment(_FRAMES)
        msg.received_at = now  # ingest stage stamp (enqueue measures next)
    return msg


class _BodyDecodeError(WireDecodeError):
    """Body failed to decode but headers did: carries the headers-only
    message so the receiver can still route an error response."""

    def __init__(self, msg: Message, cause: Exception):
        super().__init__(f"undecodable message body: {cause}")
        self.message = msg


# ---------------------------------------------------------------------------
# Frame batches (the batched-ingress wire unit)
# ---------------------------------------------------------------------------

def encode_message_batch(msgs: list, bounce, native: bool = True,
                         stats=None, templates: bool = True,
                         tmpl_cache: dict | None = None) -> list:
    """Encode a send batch into wire chunks: contiguous frame-batch
    buffers (``pack_batch`` C calls) on the native path, else one chunk
    per message. Per-message encode failures route to ``bounce`` (scoped
    to the message, never the connection), matching
    :func:`encode_message`; a batch-level native failure falls back to the
    per-message path so the failing message is identified and bounced
    alone. Output bytes are identical either way.

    ``templates`` (native path only): contiguous runs of messages whose
    headers a cached prefix template can carry encode via
    ``pack_batch_tmpl`` — the invariant header runs are memcpy'd and only
    correlation id / endpoints / stamps / body splice encode per message
    (the SocketManager pooled-buffer carry-over). Responses AND
    requests ride it: the request-side template is the ``call_batch``
    native-sender half (keyed per sender link, method
    identity varying — see :func:`_frame_template`). ``stats``
    (metrics-enabled egress writers): the whole batch encode is timed as
    one ``egress.encode.seconds`` observation — MAIN-loop callers only;
    shard-side egress writers pass ``stats=None`` and stamp the encode
    themselves for loop-side replay (the registries are loop-confined).
    ``tmpl_cache``: the per-loop template dict (see
    :func:`_frame_template`; None = the main-loop cache).
    """
    hw = _ser._hotwire if native else None
    if hw is not None and _HW_BATCH:
        now = time.monotonic()
        use_tmpl = templates and _HW_TMPL
        # ordered (template | None, items) runs: FIFO on the wire is
        # preserved because runs flush in arrival order
        runs: list = []
        cur_t = _NO_RUN
        cur_items: list = []
        for m in msgs:
            try:
                if _msg_mod._DEBUG_POOL:
                    # inside the try: a poisoned envelope bounces like any
                    # other per-message failure (the per-frame path's
                    # behavior) instead of killing the sender task
                    _msg_mod.assert_live(m, "wire.encode_message_batch")
                ttl = None
                if m.expires_at is not None:
                    ttl = max(0.0, m.expires_at - now)
                body = serialize(m.body)
                tmpl = _frame_template(m, tmpl_cache) if use_tmpl else None
            except Exception as e:  # noqa: BLE001 — per-message body failure
                bounce(m, e)
                continue
            if tmpl is not cur_t:
                cur_items = []
                runs.append((tmpl, cur_items))
                cur_t = tmpl
            cur_items.append((m, ttl, body))
        chunks = []
        for tmpl, items in runs:
            try:
                if tmpl is None:
                    chunks.append(hw.pack_batch(items))
                else:
                    chunks.append(hw.pack_batch_tmpl(
                        tmpl, _TMPL_VAR_IDX, items))
            except Exception:  # noqa: BLE001 — a header refused batch
                # encode: retry per-message so the failure scopes to one
                # frame (bodies re-serialize; this path is rare)
                for m, _ttl, _body in items:
                    try:
                        chunks.append(encode_message(m, native=native))
                    except Exception as e:  # noqa: BLE001
                        bounce(m, e)
        if stats is not None and chunks:
            stats.observe(_EGRESS_ENCODE, time.monotonic() - now)
        return chunks
    chunks = []
    for m in msgs:
        try:
            chunks.append(encode_message(m, native=native))
        except Exception as e:  # noqa: BLE001 — per-message, not the link
            bounce(m, e)
    return chunks


def finish_batch_entries(entries, msgs: list, bounces: list) -> None:
    """Shared tail of the native batch decode (``unpack_batch`` and the
    vectored pump's ``sock_recv_batch``): per entry, rebase the TTL,
    initialise the wire-excluded pool slots, and deserialize the body —
    pickle-peer (or corrupt-native) frames carry raw header/body
    segments and fall through the ordinary per-frame
    :func:`decode_message`, which reproduces the exact per-message error
    semantics. Appends to ``msgs``/``bounces`` in wire order; callers
    own the ``received_at`` stamping."""
    for msg, ttl, body in entries:
        if msg is None:
            # pickle-peer (or corrupt-native) frame: ttl/body carry the
            # raw header/body segments — ordinary per-frame decode
            try:
                msgs.append(decode_message(ttl, body))
            except _BodyDecodeError as e:
                bounces.append(e)
            except WireDecodeError as e:
                log.warning("dropping message with undecodable "
                            "headers: %s", e)
            continue
        msg.expires_at = None if ttl is None else time.monotonic() + ttl
        msg.received_at = None  # callers stamp once per batch
        msg._pool_free = False  # full slot set (see decode_message)
        msg._pool_gen = 0
        try:
            msg.body = deserialize(body)
        except Exception as e:  # noqa: BLE001 — body failure per-message
            msg.body = None
            bounces.append(_BodyDecodeError(msg, e))
            continue
        msgs.append(msg)


def decode_frames(buf, stats=None) -> tuple[int, list, list]:
    """Parse every COMPLETE frame out of one receive buffer in a single
    pass: returns ``(consumed, msgs, bounces)``. ``consumed`` is how many
    bytes were fully parsed (the caller keeps the partial tail for the
    next socket read); ``bounces`` are :class:`_BodyDecodeError`\\ s whose
    headers survived (route an error back); header-undecodable frames are
    dropped with a log, exactly like the per-frame path.

    Native path: ONE ``unpack_batch`` C call decodes every hotwire frame
    straight into blank Message shells; pickle-peer frames in the same
    buffer fall through to :func:`decode_message`. Fallback path
    (``ORLEANS_TPU_NATIVE=0`` or no toolchain): Python length-prefix walk
    + per-frame :func:`decode_message` — the wire bytes are identical, so
    mixed-build peers interoperate frame for frame.

    ``stats`` (metrics-enabled receive paths): the whole batch decode is
    timed as one ``decode`` observation (stage *sums* stay truthful — the
    share math divides summed seconds), ``decode_bytes`` observes the
    consumed byte count, ``frames`` counts messages, and the per-read
    batching degree lands in ``frame_batch``. Every decoded envelope is
    stamped with the same post-decode ``received_at``."""
    t0 = time.monotonic() if stats is not None else 0.0
    msgs: list[Message] = []
    bounces: list[_BodyDecodeError] = []
    consumed = 0
    if _HW_BATCH and _ser._hotwire is not None:
        try:
            consumed, entries = _ser._hotwire.unpack_batch(buf, Message)
        except ValueError as e:
            # oversized/hostile frame announcement: connection must drop
            raise FrameError(str(e)) from e
        finish_batch_entries(entries, msgs, bounces)
    else:
        end = len(buf)
        pos = 0
        while end - pos >= 8:
            hlen, blen = _LEN.unpack_from(buf, pos)
            if hlen > MAX_FRAME_SEGMENT or blen > MAX_FRAME_SEGMENT:
                if pos > 0:
                    # deliver the frames parsed ahead of the hostile
                    # announcement (per-frame parity); the next call sees
                    # it at position 0 and raises then
                    break
                raise FrameError(f"oversized frame announced: {hlen}+{blen}")
            total = 8 + hlen + blen
            if end - pos < total:
                break
            h0 = pos + 8
            headers = bytes(buf[h0:h0 + hlen])
            body = bytes(buf[h0 + hlen:pos + total])
            pos += total
            try:
                msgs.append(decode_message(headers, body))
            except _BodyDecodeError as e:
                bounces.append(e)
            except WireDecodeError as e:
                log.warning("dropping message with undecodable headers: %s",
                            e)
        consumed = pos
    if stats is not None and (msgs or bounces):
        now = time.monotonic()
        n = len(msgs) + len(bounces)
        stats.observe(_DECODE_SECONDS, now - t0)
        stats.histogram_with(_DECODE_BYTES, _SIZE_BOUNDS).observe(consumed)
        stats.increment(_FRAMES, n)
        stats.histogram_with(_FRAME_BATCH, _COUNT_BOUNDS).observe(n)
        for m in msgs:
            m.received_at = now
        for e in bounces:
            e.message.received_at = now
    return consumed, msgs, bounces


# ---------------------------------------------------------------------------
# Handshake
# ---------------------------------------------------------------------------

def writev_leftover(chunks: list, sent: int) -> bytes:
    """The unsent suffix of a chunk list after a (possibly partial)
    vectored ``sock_writev`` — shared by every vectored egress drain
    (ShardWriter, the silo-peer sender)."""
    total = 0
    for i, c in enumerate(chunks):
        nxt = total + len(c)
        if sent < nxt:
            rest = [c[sent - total:]]
            rest.extend(chunks[i + 1:])
            return b"".join(rest)
        total = nxt
    return b""


def leads_hostile_frame(buf) -> bool:
    """True when the buffer's leading length prefix announces an
    oversized frame. :func:`decode_frames` stops BEFORE such a prefix
    when valid frames precede it (so they are still delivered) — the
    receive pump calls this afterwards to drop the link immediately
    instead of waiting for the hostile peer's next (never-coming)
    bytes."""
    if len(buf) < 8:
        return False
    hlen, blen = _LEN.unpack_from(buf, 0)
    return hlen > MAX_FRAME_SEGMENT or blen > MAX_FRAME_SEGMENT


def encode_handshake(kind: str, address: SiloAddress,
                     extra: dict[str, Any] | None = None) -> bytes:
    """Handshake frames are ALWAYS pickle-encoded: the handshake is where
    codec support is negotiated, so it must be decodable by every build —
    a hotwire-encoded handshake would be unreadable to exactly the peers
    the negotiation exists for. Advertises this process's codec support
    (``hotwire``); each side then encodes per-connection at the peer's
    level (the connection-preamble negotiation the reference does for
    serializer registration, SerializationManager.cs:173-201)."""
    payload = {"kind": kind, "address": address,
               "hotwire": _ser._hotwire is not None, **(extra or {})}
    return encode_frame(serialize_portable(payload), b"")


def decode_handshake(headers: bytes) -> dict[str, Any]:
    hs = deserialize(headers)
    if not isinstance(hs, dict) or "kind" not in hs or "address" not in hs:
        raise FrameError(f"malformed handshake: {hs!r}")
    return hs
