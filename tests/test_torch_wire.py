"""The port's wire tier (orleans_tpu_torch.native's hotwire and hotloop,
core.serialization, runtime.wire) on the CPU, and its byte parity with
the JAX package's.

* The port's copies of tests/test_native_codec.py, tests/test_native_fuzz.py
  (its hypothesis settings kept), tests/test_wire_codecs.py, the wire tests
  of tests/test_message.py, the frame and codec tests of
  tests/test_batched_ingress.py and the native loop-runner tests of
  tests/test_loop_profiler.py, run through the port.
* Cross-package parity: for the same messages (same ids, correlation ids,
  headers, bodies of builtins and numpy scalars) the port's
  ``encode_message``, ``encode_message_batch`` (with and without header
  templates) and ``pack_batch_tmpl`` give the JAX package's bytes; each
  package decodes the other's frames into its own types; a ``GrainId``
  encoded by either package decodes in the other as the other's
  ``GrainId`` with the same key, category and hash; configuring one
  package's codec never changes what the other decodes. Tolerance: exact
  (bytes and values).

The two packages' hotwire libraries are distinct files at distinct paths
(``orleans_tpu/native/``, ``orleans_tpu_torch/_build/``), so each keeps
its own configured id types. Async bodies run under
``asyncio.wait_for(..., 30)``.
"""

import asyncio
import functools
import pickle
import random
import struct

import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover — hypothesis is baked into this env
    pytest.skip("hypothesis unavailable", allow_module_level=True)

import orleans_tpu.core.ids as jids
import orleans_tpu.core.message as jmsg
import orleans_tpu.core.serialization as jser
import orleans_tpu.runtime.wire as jwire
import orleans_tpu_torch.core.ids as tids
import orleans_tpu_torch.core.message as tmsg
import orleans_tpu_torch.core.serialization as ser
import orleans_tpu_torch.runtime.wire as twire
from orleans_tpu_torch.core.ids import (ActivationAddress, ActivationId,
                                        GrainCategory, GrainId, GrainType,
                                        SiloAddress)
from orleans_tpu_torch.core.message import (Category, Direction, Message,
                                            make_request, set_debug_pool)
from orleans_tpu_torch.core.serialization import (
    deserialize,
    register_wire_codec,
    serialize,
    serialize_portable,
    unregister_wire_codec,
)
from orleans_tpu_torch.observability.profiling import (
    LoopProfiler,
    install_loop_profiler,
    uninstall_loop_profiler,
)
from orleans_tpu_torch.runtime import ClusterClient, Grain, SiloBuilder
from orleans_tpu_torch.runtime.wire import (FrameError, _BodyDecodeError,
                                            decode_frames, decode_message,
                                            encode_message,
                                            encode_message_batch)

hw = ser._hotwire
jhw = jser._hotwire
pytestmark = pytest.mark.skipif(
    hw is None or jhw is None,
    reason="native toolchain unavailable in this environment")

TIMEOUT = 30


def bounded(fn):
    """Run the test coroutine under ``asyncio.wait_for(..., TIMEOUT)``."""
    @functools.wraps(fn)
    async def run(*args, **kwargs):
        await asyncio.wait_for(fn(*args, **kwargs), TIMEOUT)
    return run


def test_the_port_loads_its_own_codec_builds():
    """The port's codec and loop runner are its own builds, loaded under
    its own names from the port's build directory."""
    from orleans_tpu_torch.native import BUILD_DIR
    from orleans_tpu_torch.observability import profiling
    for mod in (hw, profiling._hotloop):
        assert mod.__name__.startswith("orleans_tpu_torch.native._hot")
        assert str(BUILD_DIR) in mod.__file__
    assert hw.__file__ != jhw.__file__


# ---------------------------------------------------------------------------
# tests/test_native_codec.py
# ---------------------------------------------------------------------------

GT = GrainType.of("native.Echo")
GID = GrainId.for_grain(GT, 42)
SILO = SiloAddress("10.0.0.7", 11111, 1703, 3)
# fixed ids, so that the parametrized test ids are the same every run
AID = ActivationId(0x1234_5678_9ABC)


CORPUS = [
    None, True, False,
    0, 1, -1, 255, -256, 2**31, -(2**31), 2**62, -(2**62),
    2**100, -(2**100),          # bignum -> pickle escape
    0.0, -1.5, 3.141592653589793, float("inf"),
    "", "ascii", "héllo wörld", "日本語", "x" * 5000,
    b"", b"raw\x00bytes", b"\xff" * 1000,
    (), (1,), (1, "a", None, (2, (3,))),
    [], [1, [2, [3, [4]]]],
    {}, {"k": 1, 2: "v", (1, 2): [3]},
    set(), {1, 2, 3}, frozenset({("a", 1)}),
    GID, GrainId.for_grain(GT, "string-key", "with-ext"),
    GrainId.for_guid(GT, __import__("uuid").UUID(int=0xC0FFEE)),
    GrainId.client("client-7"), GrainId.system_target(99, SILO),
    SILO, SiloAddress("::1", 0, 0), AID,
    ActivationAddress(SILO, GID, AID),
    {"addr": ActivationAddress(SILO, GID, AID), "chain": (GID, GID)},
]


@pytest.mark.parametrize("value", CORPUS, ids=lambda v: repr(v)[:40])
def test_roundtrip(value):
    out = hw.loads(hw.dumps(value))
    assert out == value
    assert type(out) is type(value)


def test_id_hashes_survive_without_rehash():
    for gid in [GID, GrainId.for_grain(GT, "k", "e"), GrainId.client("c")]:
        out = hw.loads(hw.dumps(gid))
        assert out.uniform_hash == gid.uniform_hash
        assert hash(out) == hash(gid)
        assert out.category is gid.category  # enum member, not int
    s2 = hw.loads(hw.dumps(SILO))
    assert s2.uniform_hash == SILO.uniform_hash
    assert s2.endpoint == SILO.endpoint and s2.mesh_index == SILO.mesh_index


def test_frames_are_smaller_than_pickle():
    header_ish = (GID, SILO, AID, "method", 123, None, (), True)
    assert len(hw.dumps(header_ish)) < len(pickle.dumps(header_ish))


def test_serialize_dispatch_and_pickle_interop():
    # serialize() rides hotwire; deserialize() dispatches on the magic byte
    blob = ser.serialize({"x": (GID, 1.5)})
    assert blob[:1] == b"\xa7"
    assert ser.deserialize(blob) == {"x": (GID, 1.5)}
    # frames from a non-native peer (plain pickle) still decode
    legacy = pickle.dumps({"x": (GID, 1.5)}, protocol=pickle.HIGHEST_PROTOCOL)
    assert ser.deserialize(legacy) == {"x": (GID, 1.5)}


class _Foreign:
    """Module-level so pickle can serialize it; 'tests' is not on the wire
    allowlist, so decode must reject it."""

    def __eq__(self, other):
        return isinstance(other, _Foreign)


def test_escape_hatch_keeps_allowlist():
    # values outside the codec's native set escape through the RESTRICTED
    # pickler on decode: non-allowlisted types must still be rejected
    blob = hw.dumps((1, _Foreign()))
    with pytest.raises(Exception, match="allowlist"):
        hw.loads(blob)


def test_enum_values_escape_as_pickled_enums():
    # enums in *bodies* (not header positions) keep their type via escape
    out = hw.loads(hw.dumps((Category.SYSTEM, Direction.ONE_WAY)))
    assert out[0] is Category.SYSTEM and out[1] is Direction.ONE_WAY


@pytest.mark.parametrize("bad", [
    b"",
    b"\xa7",
    b"\xa7\x01",                    # magic only, no value
    b"\xa7\x02\x00",                # wrong version
    b"\x00\x01\x00",                # wrong magic
    b"\xa7\x01\x99",                # unknown tag
    b"\xa7\x01\x06\xff\xff\xff\xff\x0f",  # str length >> buffer
    b"\xa7\x01\x08\xff\xff\xff\xff\x0f",  # tuple count >> buffer
    b"\xa7\x01\x03\x80\x80\x80\x80\x80\x80\x80\x80\x80\x80\x01",  # varint >64bit
    b"\xa7\x01\x05\x00\x00",        # truncated float
    b"\xa7\x01\x06" + b"\x80" * 9 + b"\x01",  # str length = 2^63 (Py_ssize_t overflow)
    b"\xa7\x01\x08" + b"\x80" * 9 + b"\x01",  # tuple count = 2^63
    b"\xa7\x01\x03" + b"\x80" * 9 + b"\x02",  # varint payload bits past bit 63
    b"\xa7\x01\x0d\x02",            # truncated GrainId
    b"\xa7\x01\x00\x00",            # trailing garbage
], ids=lambda b: b.hex()[:24] or "empty")
def test_malformed_input_raises(bad):
    with pytest.raises(ValueError):
        hw.loads(bad)


def test_truncations_of_real_frames_raise_not_crash():
    blob = hw.dumps({"k": (GID, SILO, [1.5, "x", b"y"], AID)})
    for cut in range(2, len(blob)):
        try:
            hw.loads(blob[:cut])
        except ValueError:
            pass
        except Exception:
            pass  # escape-pickle truncation raises pickle errors: fine


def test_cyclic_payloads_fall_back_to_pickle():
    d: dict = {}
    d["self"] = d
    blob = ser.serialize(d)
    assert blob[:1] != b"\xa7"  # rode the pickle fallback
    out = ser.deserialize(blob)
    assert out["self"] is out


def test_nesting_depth_capped():
    deep = None
    for _ in range(500):
        deep = (deep,)
    with pytest.raises((ValueError, RecursionError)):
        hw.dumps(deep)
    # hostile hand-built deep buffer on the decode side
    bad = b"\xa7\x01" + b"\x08\x01" * 500 + b"\x00"
    with pytest.raises(ValueError, match="deep"):
        hw.loads(bad)


def test_unpack_attrs_rejects_non_int_enum_values():
    """A hostile/corrupt peer placing a non-int, non-None object into an
    enum-typed header slot must be rejected (the Python fallback raises
    ValueError for the same frame shape)."""
    from orleans_tpu_torch.runtime.wire import _ENUM_SPEC, _HEADER_SLOTS
    msg = Message.__new__(Message)
    for s in Message.__slots__:
        setattr(msg, s, None)
    msg.category = "EVIL"  # str where Category is expected
    data = hw.pack_attrs(msg, _HEADER_SLOTS, None)
    out = Message.__new__(Message)
    with pytest.raises(ValueError, match="non-int enum"):
        hw.unpack_attrs(data, out, _HEADER_SLOTS, _ENUM_SPEC)


def test_handshake_is_always_pickle_and_advertises_codec():
    """The handshake is the negotiation vehicle, so it must be decodable
    by every build regardless of the local codec — and it must carry the
    hotwire capability flag."""
    from orleans_tpu_torch.runtime.wire import (decode_handshake,
                                                encode_handshake)
    frame = encode_handshake("silo", SILO)
    hlen = int.from_bytes(frame[:4], "little")
    headers = frame[8:8 + hlen]
    assert headers[:1] != b"\xa7"  # never hotwire-encoded
    hs = decode_handshake(headers)
    assert hs["address"] == SILO
    assert hs["hotwire"] == (ser._hotwire is not None)


def test_encode_message_native_false_emits_pickle_frames():
    """Per-connection fallback: native=False must produce frames a
    pickle-only peer can decode, even when this build has hotwire."""
    msg = make_request(
        target_grain=GID, interface_name="n.I", method_name="m",
        body={"k": 1}, sending_silo=SILO, target_silo=SILO)
    frame = encode_message(msg, native=False)
    hlen = int.from_bytes(frame[:4], "little")
    headers, body = frame[8:8 + hlen], frame[8 + hlen:]
    assert headers[:1] != b"\xa7" and body[:1] != b"\xa7"
    out = decode_message(headers, body)
    assert out.method_name == "m" and out.body == {"k": 1}


def test_wire_message_roundtrip_native_and_fallback(monkeypatch):
    msg = make_request(
        target_grain=GID, interface_name="native.IEcho", method_name="echo",
        body=("payload", 1, {"a": b"b"}), sending_silo=SILO, target_silo=SILO,
        call_chain=(GID,), request_context={"trace": "t-1"})

    def roundtrip():
        frame = encode_message(msg)
        hlen = int.from_bytes(frame[:4], "little")
        return decode_message(frame[8:8 + hlen], frame[8 + hlen:])

    for use_native in (True, False):
        monkeypatch.setattr(ser, "_hotwire", hw if use_native else None)
        out = roundtrip()
        assert out.category is Category.APPLICATION
        assert out.direction is Direction.REQUEST
        assert out.rejection_type is None
        assert out.target_grain == GID and out.sending_silo == SILO
        assert out.call_chain == (GID,)
        assert out.request_context == {"trace": "t-1"}
        assert out.body == ("payload", 1, {"a": b"b"})

    # native-encoded headers decodable by the fallback too? No — that needs
    # the extension; but fallback-encoded headers MUST decode when native is
    # active (mixed-build cluster, old silo -> new silo):
    monkeypatch.setattr(ser, "_hotwire", None)
    frame = encode_message(msg)
    hlen = int.from_bytes(frame[:4], "little")
    monkeypatch.setattr(ser, "_hotwire", hw)
    out = decode_message(frame[8:8 + hlen], frame[8 + hlen:])
    assert out.method_name == "echo" and out.category is Category.APPLICATION



# ---------------------------------------------------------------------------
# tests/test_native_fuzz.py
# ---------------------------------------------------------------------------

_GT = GrainType.of("fuzz.Grain")

_scalars = st.one_of(
    st.none(),
    st.booleans(),
    st.integers(min_value=-(2**63), max_value=2**63 - 1),
    st.integers(min_value=-(2**200), max_value=2**200),  # bignum escape
    st.floats(allow_nan=False),  # NaN != NaN breaks equality, not codec
    st.text(max_size=60),
    st.binary(max_size=60),
    st.builds(lambda k: GrainId.for_grain(_GT, k),
              st.integers(min_value=0, max_value=2**40)),
    st.builds(SiloAddress,
              st.text(min_size=1, max_size=20), st.integers(0, 65535),
              st.integers(0, 2**40)),
)

_values = st.recursive(
    _scalars,
    lambda children: st.one_of(
        st.lists(children, max_size=5),
        st.lists(children, max_size=5).map(tuple),
        st.dictionaries(st.text(max_size=8), children, max_size=4),
        st.dictionaries(st.integers(), children, max_size=4),
    ),
    max_leaves=25,
)


def _assert_same(a, b):
    """Recursive equality + type fidelity: Python's == treats True == 1
    and 1.0 == 1, so a nested tag-confusion regression (bool decoded as
    int) would pass a plain equality check."""
    assert type(a) is type(b), (a, b)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert a == b, (a, b)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_roundtrip_equality_and_type_fidelity(value):
    blob = ser.serialize(value)
    out = ser.deserialize(blob)
    _assert_same(out, value)


@pytest.mark.parametrize("edge", [
    -(2**63), 2**63 - 1, -(2**63) - 1, 2**63,  # int64 boundaries + just past
])
def test_int64_boundaries(edge):
    assert ser.deserialize(ser.serialize(edge)) == edge


@settings(max_examples=300, deadline=None)
@given(st.binary(min_size=0, max_size=200))
def test_random_bytes_never_crash_the_decoder(data):
    """Any buffer must either decode or raise a Python exception — never
    crash the process (the codec's bounds-check contract)."""
    try:
        ser.deserialize(b"\xa7\x01" + data)
    except Exception:  # noqa: BLE001 — any clean Python error is fine
        pass


@settings(max_examples=150, deadline=None)
@given(_values, st.integers(min_value=2, max_value=40))
def test_truncations_never_crash(value, cut):
    blob = ser.serialize(value)
    try:
        ser.deserialize(blob[:max(2, len(blob) - cut)])
    except Exception:  # noqa: BLE001
        pass


@settings(max_examples=300, deadline=None)
@given(st.binary(min_size=0, max_size=300))
def test_unpack_batch_random_bytes_never_crash(data):
    """Hostile receive buffers through the batched frame parser:
    any input must either parse (consumed <= len, entries well-formed
    triples) or raise a clean Python exception — never crash or over-read
    (the wire.decode_frames contract for untrusted peers)."""
    try:
        consumed, entries = ser._hotwire.unpack_batch(data, Message)
    except Exception:  # noqa: BLE001 — oversized/hostile announcement
        return
    assert 0 <= consumed <= len(data)
    for e in entries:
        assert isinstance(e, tuple) and len(e) == 3


@settings(max_examples=150, deadline=None)
@given(st.integers(min_value=1, max_value=120))
def test_unpack_batch_truncated_real_frames_never_crash(cut):
    """A real frame batch cut mid-stream: the parser must stop cleanly at
    the last complete frame and report the partial tail unconsumed."""
    msgs = [make_request(target_grain=GrainId.for_grain(_GT, i),
                         interface_name="fuzz.I", method_name="m",
                         body=(i, "x" * i)) for i in range(4)]
    whole = b"".join(encode_message(m) for m in msgs)
    data = whole[:max(0, len(whole) - cut)]
    consumed, entries = ser._hotwire.unpack_batch(data, Message)
    assert 0 <= consumed <= len(data)
    assert len(entries) <= len(msgs)



# ---------------------------------------------------------------------------
# tests/test_wire_codecs.py
# ---------------------------------------------------------------------------

class Vec2:
    """A user type with a compact custom encoding (8 bytes, no pickle)."""

    def __init__(self, x: float, y: float):
        self.x, self.y = x, y

    def __eq__(self, other):
        return isinstance(other, Vec2) and (self.x, self.y) == \
            (other.x, other.y)

    def __repr__(self):
        return f"Vec2({self.x}, {self.y})"


def _enc(v: Vec2) -> bytes:
    return struct.pack("<ff", v.x, v.y)


def _dec(b: bytes) -> Vec2:
    return Vec2(*struct.unpack("<ff", b))


@pytest.fixture
def vec2_codec():
    register_wire_codec("vec2", Vec2, _enc, _dec)
    try:
        yield
    finally:
        unregister_wire_codec("vec2")


def test_roundtrip_through_custom_codec(vec2_codec, monkeypatch):
    payload = {"pos": Vec2(1.5, -2.0), "tag": "ok",
               "nested": [Vec2(0.25, 0.5)]}
    for native in (True, False):
        if not native:
            monkeypatch.setattr(ser, "_hotwire", None)
        out = deserialize(serialize(payload))
        assert out == payload
    # durable blobs take the seam too
    assert deserialize(serialize_portable(Vec2(3.0, 4.0))) == Vec2(3.0, 4.0)


def test_custom_bytes_actually_used(vec2_codec):
    blob = serialize_portable(Vec2(9.0, 8.0))
    assert struct.pack("<ff", 9.0, 8.0) in blob   # the codec's bytes
    assert b"Vec2" not in blob                    # not pickled by class


def test_unregistered_decoder_fails_loudly(vec2_codec):
    blob = serialize(Vec2(1.0, 2.0))
    unregister_wire_codec("vec2")
    try:
        with pytest.raises(Exception, match="vec2.*not.*registered"):
            deserialize(blob)
    finally:
        register_wire_codec("vec2", Vec2, _enc, _dec)


def test_registration_invariants(vec2_codec):
    class Other:
        pass
    with pytest.raises(ValueError, match="already registered"):
        register_wire_codec("vec2", Other, _enc, _dec)
    # one codec per type: a second NAME for Vec2 is rejected, so an
    # unregister of either name can never silently disable the other
    with pytest.raises(ValueError, match="one codec per type"):
        register_wire_codec("vec2-alt", Vec2, _enc, _dec)
    # re-registering the SAME pair is fine (idempotent deploy scripts)
    register_wire_codec("vec2", Vec2, _enc, _dec)
    # builtin fast-path types can never route through a codec — loud error
    # instead of a silently-ignored registration
    with pytest.raises(ValueError, match="builtin"):
        register_wire_codec("mylist", list, _enc, _dec)


class SubVec(Vec2):
    """Module-level so pickle can reference it by name."""


def test_exact_type_match_only(vec2_codec):
    blob = serialize_portable(SubVec(1.0, 1.0))
    # subclass did NOT route through the codec (falls to pickle), so the
    # restricted unpickler rejects the unregistered module instead of
    # silently truncating the subclass to a Vec2
    with pytest.raises(Exception, match="allowlist|not in"):
        deserialize(blob)


class Holder(Grain):
    async def stash(self, v):
        self._v = v
        return v

    async def nudge(self):
        return Vec2(self._v.x + 1, self._v.y + 1)


@bounded
async def test_grain_call_carries_custom_coded_type(vec2_codec):
    """The seam holds on the full RPC path: args and results carrying a
    registered type cross the wire through the custom codec."""
    silo = SiloBuilder().add_grains(Holder).build()
    await silo.start()
    client = await ClusterClient(silo.fabric).connect()
    try:
        g = client.get_grain(Holder, 1)
        assert await g.stash(Vec2(2.0, 3.0)) == Vec2(2.0, 3.0)
        assert await g.nudge() == Vec2(3.0, 4.0)
    finally:
        await client.close_async()
        await silo.stop()


# ---------------------------------------------------------------------------
# tests/test_message.py: the wire round trip and frame_stream
# ---------------------------------------------------------------------------

def test_wire_roundtrip():
    m = make_request(target_grain=GrainId.for_grain(GrainType.of("Echo"), 1),
                     interface_name="IEcho", method_name="echo",
                     body=("hi",))
    m2 = deserialize(serialize({"x": 1, "body": m.body}))
    assert m2["x"] == 1 and m2["body"] == ("hi",)


class _ChunkReader:
    """StreamReader stand-in feeding preset chunks."""

    def __init__(self, chunks):
        self.chunks = list(chunks)

    async def read(self, n):
        return self.chunks.pop(0) if self.chunks else b""


def _collect_frames(chunks):
    from orleans_tpu_torch.runtime.wire import frame_stream

    async def collect():
        out = []
        async for h, b in frame_stream(_ChunkReader(chunks)):
            out.append((h, b))
        return out
    return asyncio.run(asyncio.wait_for(collect(), TIMEOUT))


def test_frame_stream_parses_frames_across_chunk_boundaries():
    from orleans_tpu_torch.runtime.wire import encode_frame
    frames = [(f"h{i}".encode(), f"body-{i}".encode() * i) for i in range(5)]
    blob = b"".join(encode_frame(h, b) for h, b in frames)
    # all at once, byte-by-byte, and ragged 7-byte chunks
    for chunking in ([blob],
                     [blob[i:i + 1] for i in range(len(blob))],
                     [blob[i:i + 7] for i in range(0, len(blob), 7)]):
        assert _collect_frames(chunking) == frames, chunking


def test_frame_stream_mid_frame_eof_raises():
    from orleans_tpu_torch.runtime.wire import encode_frame
    blob = encode_frame(b"hh", b"bb")[:-1]
    with pytest.raises(asyncio.IncompleteReadError):
        _collect_frames([blob])


def test_frame_stream_oversized_announcement_raises():
    from orleans_tpu_torch.runtime.wire import MAX_FRAME_SEGMENT
    bad = struct.pack("<II", MAX_FRAME_SEGMENT + 1, 0) + b"x" * 16
    with pytest.raises(FrameError):
        _collect_frames([bad])


# ---------------------------------------------------------------------------
# tests/test_batched_ingress.py: the frame-batch codec
# ---------------------------------------------------------------------------

BI_GT = GrainType.of("bi.Echo")
BI_SILO = SiloAddress("10.1.2.3", 7777, 42)


def _corpus_messages(n: int = 40, timeout=None) -> list:
    """Messages with varied headers/bodies (``timeout=None`` keeps the
    TTL out of the frames so two encodes of one message are
    byte-identical)."""
    rng = random.Random(1234)
    bodies = [None, 0, -1, 3.5, "text", b"bytes", (1, "a"), [1, [2]],
              {"k": (BI_GT,)}, ((), {"x": 7}), ((1, 2), {"deep": {"d": [9]}})]
    out = []
    for i in range(n):
        msg = make_request(
            target_grain=GrainId.for_grain(BI_GT, i),
            interface_name="bi.IEcho", method_name=f"m{i % 5}",
            body=rng.choice(bodies),
            direction=rng.choice([Direction.REQUEST, Direction.ONE_WAY]),
            sending_silo=BI_SILO, target_silo=BI_SILO,
            call_chain=(GrainId.for_grain(BI_GT, i - 1),) if i % 3 else (),
            request_context={"trace": f"t-{i}"} if i % 4 == 0 else None,
            timeout=timeout,
        )
        out.append(msg)
    return out


def _split_frames(buf: bytes) -> list:
    frames = []
    pos = 0
    while pos < len(buf):
        hlen, blen = struct.unpack_from("<II", buf, pos)
        h0 = pos + 8
        frames.append((buf[h0:h0 + hlen], buf[h0 + hlen:h0 + hlen + blen]))
        pos = h0 + hlen + blen
    return frames


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


def test_pack_batch_bytes_identical_to_per_frame():
    msgs = _corpus_messages()
    items = [(m, None, ser.serialize(m.body)) for m in msgs]
    batch = hw.pack_batch(items)
    per_frame = b"".join(hw.pack_frame(*it) for it in items)
    assert batch == per_frame
    # and identical to the public encode path (encode_message emits the
    # same frames; encode_message_batch emits ONE chunk holding them all)
    assert per_frame == b"".join(encode_message(m) for m in msgs)
    chunks = encode_message_batch(msgs, bounce=lambda m, e: None)
    assert b"".join(chunks) == batch


def test_decode_frames_matches_per_frame_decode():
    msgs = _corpus_messages(timeout=30.0)
    buf = bytearray(b"".join(encode_message(m) for m in msgs))
    consumed, decoded, bounces = decode_frames(buf)
    assert consumed == len(buf) and not bounces
    assert len(decoded) == len(msgs)
    for headers_body, batch_msg, orig in zip(
            _split_frames(bytes(buf)), decoded, msgs):
        single = decode_message(*headers_body)
        assert _slots_equal(single, batch_msg)
        assert _slots_equal(batch_msg, orig)
        # TTL rebased into a live expiry on both paths
        assert batch_msg.expires_at is not None
        assert abs(batch_msg.expires_at - single.expires_at) < 1.0


def test_decode_frames_python_fallback_equivalent(monkeypatch):
    """ORLEANS_TPU_NATIVE=0 path: same wire bytes, per-frame fallback
    codec, identical decoded messages."""
    msgs = _corpus_messages()
    native_frames = b"".join(encode_message(m) for m in msgs)
    monkeypatch.setattr(ser, "_hotwire", None)
    pickle_frames = b"".join(encode_message(m) for m in msgs)
    # native frames are NOT decodable without the extension, but the
    # fallback-encoded frames decode through the same decode_frames entry
    consumed, decoded, bounces = decode_frames(bytearray(pickle_frames))
    assert consumed == len(pickle_frames) and not bounces
    assert len(decoded) == len(msgs)
    for m, orig in zip(decoded, msgs):
        assert _slots_equal(m, orig)
    monkeypatch.setattr(ser, "_hotwire", hw)
    if hw is not None:
        # mixed-build peers: the NATIVE receiver decodes the pickle
        # peer's frames out of one batch buffer
        consumed, decoded, _ = decode_frames(bytearray(pickle_frames))
        assert consumed == len(pickle_frames)
        assert all(_slots_equal(m, o) for m, o in zip(decoded, msgs))
        # and a buffer interleaving both forms decodes in order
        mix = bytearray()
        expect = []
        for i, m in enumerate(msgs[:10]):
            mix += encode_message(m, native=bool(i % 2))
            expect.append(m)
        consumed, decoded, _ = decode_frames(mix)
        assert consumed == len(mix)
        assert all(_slots_equal(m, o) for m, o in zip(decoded, expect))


def test_decode_frames_partial_tail_and_resume():
    msgs = _corpus_messages(8)
    whole = b"".join(encode_message(m) for m in msgs)
    cut = len(whole) - 11  # mid-frame
    buf = bytearray(whole[:cut])
    consumed, decoded, _ = decode_frames(buf)
    assert consumed < len(buf)  # stopped on the frame boundary
    assert len(decoded) == len(msgs) - 1
    del buf[:consumed]
    buf += whole[cut:]  # the rest of the socket stream arrives
    consumed2, decoded2, _ = decode_frames(buf)
    assert consumed2 == len(buf) and len(decoded2) == 1
    assert _slots_equal(decoded2[0], msgs[-1])


def test_decode_frames_bounces_undecodable_body_mid_batch():
    """A frame whose BODY fails to decode, sitting between good frames:
    the good ones decode, the bad one surfaces as a bounce (headers
    intact so the receiver can reject back to the sender)."""
    good1, bad, good2 = _corpus_messages(3)
    bad_frame_headers = _split_frames(encode_message(bad))[0][0]
    from orleans_tpu_torch.runtime.wire import encode_frame
    frames = (encode_message(good1)
              + encode_frame(bad_frame_headers, b"\xa7\x01\x99")  # bad tag
              + encode_message(good2))
    consumed, decoded, bounces = decode_frames(bytearray(frames))
    assert consumed == len(frames)
    assert [m.method_name for m in decoded] == [good1.method_name,
                                                good2.method_name]
    assert len(bounces) == 1 and isinstance(bounces[0], _BodyDecodeError)
    assert bounces[0].message.method_name == bad.method_name
    assert bounces[0].message.body is None


def test_decode_frames_oversized_announcement_drops_connection():
    evil = struct.pack("<II", 1 << 30, 8) + b"x" * 32
    with pytest.raises(FrameError):
        decode_frames(bytearray(evil))


def test_corrupt_native_headers_scoped_to_frame():
    """Magic-prefixed but garbled headers: that frame drops (logged), the
    rest of the batch decodes — connection survives."""
    good1, good2 = _corpus_messages(2)
    from orleans_tpu_torch.runtime.wire import encode_frame
    frames = (encode_message(good1)
              + encode_frame(b"\xa7\x01\x99", b"")   # unknown tag header
              + encode_message(good2))
    consumed, decoded, bounces = decode_frames(bytearray(frames))
    assert consumed == len(frames) and not bounces
    assert [m.method_name for m in decoded] == [good1.method_name,
                                                good2.method_name]


def test_encode_message_batch_bounces_per_message():
    msgs = _corpus_messages(4)
    msgs[2].body = lambda: None  # unpicklable: encode must bounce it
    bounced = []
    chunks = encode_message_batch(msgs, lambda m, e: bounced.append(m))
    assert bounced == [msgs[2]]
    consumed, decoded, _ = decode_frames(bytearray(b"".join(chunks)))
    assert [m.method_name for m in decoded] == \
        [m.method_name for i, m in enumerate(msgs) if i != 2]


def test_decode_frames_delivers_frames_ahead_of_hostile_prefix():
    """Good frames followed by an oversized announcement: the good frames
    still come back (per-frame parity — they were routable before the
    link must drop); the NEXT call, seeing the hostile prefix lead the
    buffer, raises."""
    msgs = _corpus_messages(3)
    evil = struct.pack("<II", 1 << 30, 8) + b"x" * 16
    buf = bytearray(b"".join(encode_message(m) for m in msgs) + evil)
    consumed, decoded, bounces = decode_frames(buf)
    assert len(decoded) == 3 and not bounces
    assert consumed == len(buf) - len(evil)
    del buf[:consumed]
    with pytest.raises(FrameError):
        decode_frames(buf)


def test_encode_batch_bounces_poisoned_envelope_under_debug_pool():
    """ORLEANS_TPU_DEBUG_POOL=1: a recycled envelope reaching the batch
    encoder bounces like any per-message failure — the sender task (and
    the rest of the batch) survives."""
    from orleans_tpu_torch.core.message import recycle_message
    prev = set_debug_pool(True)
    try:
        good1, poisoned, good2 = _corpus_messages(3)
        recycle_message(poisoned)
        bounced = []
        chunks = encode_message_batch([good1, poisoned, good2],
                                      lambda m, e: bounced.append((m, e)))
        assert [m for m, _ in bounced] == [poisoned]
        consumed, decoded, _ = decode_frames(bytearray(b"".join(chunks)))
        assert [m.method_name for m in decoded] == [good1.method_name,
                                                    good2.method_name]
    finally:
        set_debug_pool(prev)


def test_leads_hostile_frame_peek():
    from orleans_tpu_torch.runtime.wire import leads_hostile_frame
    good = encode_message(_corpus_messages(1)[0])
    evil = struct.pack("<II", 1 << 30, 8) + b"xxxx"
    assert not leads_hostile_frame(b"")
    assert not leads_hostile_frame(good[:7])   # short prefix: keep reading
    assert not leads_hostile_frame(good)
    assert leads_hostile_frame(evil)
    # decode_frames + peek compose: the valid frame decodes, the peek
    # then flags the hostile remainder for an immediate connection drop
    buf = bytearray(good + evil)
    consumed, msgs, _ = decode_frames(buf)
    del buf[:consumed]
    assert len(msgs) == 1 and leads_hostile_frame(buf)


# ---------------------------------------------------------------------------
# tests/test_loop_profiler.py: the native loop runner (hotloop)
# ---------------------------------------------------------------------------

def test_native_runner_stamps_offsets():
    """The C hot path (hotloop.c) stamps the same offsets as the Python
    reference; skipped where the toolchain is unavailable."""
    import time as _t

    from orleans_tpu_torch.observability import profiling
    if profiling._hotloop is None:
        import pytest
        pytest.skip("native hotloop unavailable")
    loop = asyncio.new_event_loop()
    try:
        prof = install_loop_profiler(loop, window=60.0)
        assert type(prof) is not LoopProfiler

        def spin():
            end = _t.perf_counter() + 0.002
            while _t.perf_counter() < end:
                pass

        def done():
            loop.stop()

        loop.call_soon(spin)
        loop.call_later(0.02, spin)
        loop.call_later(0.04, done)
        loop.run_forever()
        prof._finalize_window(_t.perf_counter())
        top = [r for r in prof.ring[-1]["top"] if r["seconds"] >= 0.002]
        assert len(top) >= 2
        offs = sorted(r["offset"] for r in top)
        assert all(o is not None and o >= 0.0 for o in offs)
        assert offs[1] - offs[0] >= 0.015  # the call_later gap is real
    finally:
        uninstall_loop_profiler(loop)
        loop.close()


def test_pure_python_fallback_matches_native_semantics(monkeypatch):
    """Without the native runner (no toolchain / ORLEANS_TPU_NATIVE=0)
    install falls back to the pure-Python hot path with identical
    semantics — attribution, idle accounting, nesting, uninstall
    passthrough."""
    from orleans_tpu_torch.observability import profiling

    monkeypatch.setattr(profiling, "_hotloop", None)
    loop = asyncio.new_event_loop()
    try:
        prof = install_loop_profiler(loop, window=0.0)
        assert type(prof) is LoopProfiler  # not the native subclass

        def work():
            prof.set_category("turns")
            t = __import__("time").perf_counter() + 0.002
            while __import__("time").perf_counter() < t:
                pass
            loop.stop()

        loop.call_soon(work)
        loop.run_forever()
        assert prof.totals.get("turns", 0.0) > 0.0
        occ = prof.occupancy()
        assert abs(sum(occ.values()) - 1.0) < 1e-6
        uninstall_loop_profiler(loop)
        assert prof.closed and "call_soon" not in loop.__dict__
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# Cross-package parity: the same messages give the same bytes, and each
# package decodes the other's frames
# ---------------------------------------------------------------------------

JAX = (jids, jmsg, jwire, jser)
PORT = (tids, tmsg, twire, ser)


def _parity_corpus(pkg, n: int = 48) -> list:
    """Requests, one-ways, responses, errors and rejections with the same
    ids, correlation ids, headers and bodies (builtins, numpy scalars and
    arrays, the package's own id types) in either package."""
    ids, msg, _, _ = pkg
    gt = ids.GrainType.of("par.Echo")
    s1 = ids.SiloAddress("10.7.0.1", 1111, 3)
    s2 = ids.SiloAddress("10.7.0.2", 2222, 5, 1)
    out = []
    for i in range(n):
        gid = ids.GrainId.for_grain(gt, i) if i % 3 else \
            ids.GrainId.for_grain(gt, f"k{i}", "ext")
        body = [
            None, i, -7 * i, i / 3, f"s{i}", b"b" * (i % 5),
            (i, "a", (None, True)), [i, [i + 1, 2.5]], {"k": i, 2: "v"},
            np.int32(i), np.float32(i) / 3, np.int64(-i), np.bool_(i % 2),
            np.arange(i % 5, dtype=np.int32),
            ((i,), {"x": np.float16(i)}), gid, s1,
            ids.ActivationAddress(s2, gid, ids.ActivationId(i + 1)),
        ][i % 18]
        req = msg.make_request(
            target_grain=gid, interface_name="par.IEcho",
            method_name=f"m{i % 4}", body=body,
            direction=msg.Direction.ONE_WAY if i % 7 == 0
            else msg.Direction.REQUEST,
            sending_silo=s2, target_silo=s1, timeout=None,
            call_chain=(ids.GrainId.for_grain(gt, 1000 + i),)
            if i % 5 == 0 else (),
            is_read_only=i % 2 == 0,
            request_context={"trace": f"t-{i}"} if i % 4 == 0 else None,
            interface_version=i % 3)
        req.id = 10_000 + i
        req.sending_activation = ids.ActivationId(50 + i)
        out.append(req)
        if i % 2:
            if i % 9 == 0:
                resp = msg.make_rejection(req, msg.RejectionType.TRANSIENT,
                                          f"stale-{i}")
            elif i % 5 == 0:
                resp = msg.make_error_response(req, ValueError(f"boom-{i}"))
            else:
                resp = msg.make_response(req, body)
            if i % 3 == 0:
                resp.transaction_info = (i, {i: "participant"})
            out.append(resp)
    return out


def test_frames_byte_equal_to_the_reference_singly_batched_templated():
    mine, theirs = _parity_corpus(PORT), _parity_corpus(JAX)
    for m, j in zip(mine, theirs):
        assert encode_message(m) == jwire.encode_message(j)
    for templates in (True, False):
        ours = encode_message_batch(mine, lambda m, e: None,
                                    templates=templates)
        ref = jwire.encode_message_batch(theirs, lambda m, e: None,
                                         templates=templates)
        assert ours == ref  # chunk for chunk: the same runs and bytes
        assert b"".join(ours) == b"".join(
            jwire.encode_message(j) for j in theirs)
    # the template entry point itself, on a run of plain responses
    run = [(m, j) for m, j in zip(mine, theirs)
           if m.direction == Direction.RESPONSE
           and twire._frame_template(m) is not None]
    assert len(run) >= 8
    tm = twire._frame_template(run[0][0])
    tj = jwire._frame_template(run[0][1])
    assert tm == tj
    keyed = [(m, j) for m, j in run if twire._frame_template(m) is tm]
    assert hw.pack_batch_tmpl(tm, twire._TMPL_VAR_IDX, [
        (m, None, serialize(m.body)) for m, _ in keyed]) == \
        jhw.pack_batch_tmpl(tj, jwire._TMPL_VAR_IDX, [
            (j, None, jser.serialize(j.body)) for _, j in keyed])


def _same_message(a, b) -> None:
    """Slot by slot across packages: ids compare by their fields, enums by
    value, exceptions by type name and args, numpy values exactly."""
    for s in tmsg.Message.__slots__:
        if s in ("received_at", "_pool_free", "_pool_gen", "expires_at"):
            continue
        va, vb = getattr(a, s), getattr(b, s)
        assert _plain(va) == _plain(vb), s


def _plain(v):
    """A package-free form of a decoded value."""
    if isinstance(v, BaseException):
        return ("exc", type(v).__name__, v.args)
    if isinstance(v, np.ndarray):
        return ("nd", str(v.dtype), v.tolist())
    if isinstance(v, np.generic):
        return ("np", str(v.dtype), v.item())
    if isinstance(v, (tuple, list)):
        return (type(v).__name__, tuple(_plain(x) for x in v))
    if isinstance(v, dict):
        return ("dict", tuple((_plain(k), _plain(x)) for k, x in v.items()))
    if type(v).__module__.startswith(("orleans_tpu.", "orleans_tpu_torch.")):
        if hasattr(v, "__dataclass_fields__"):
            return (type(v).__name__, tuple(
                _plain(getattr(v, f)) for f in v.__dataclass_fields__))
        return (type(v).__name__, int(v))  # an IntEnum member
    return v


def test_each_package_decodes_the_others_frames():
    mine, theirs = _parity_corpus(PORT), _parity_corpus(JAX)
    buf = b"".join(jwire.encode_message_batch(theirs, lambda m, e: None))
    consumed, got, bounces = decode_frames(bytearray(buf))
    assert consumed == len(buf) and not bounces and len(got) == len(mine)
    for g, m in zip(got, mine):
        assert type(g.sending_silo) is SiloAddress  # the port's own types
        assert type(g.category) is Category
        _same_message(g, m)
    buf = b"".join(encode_message_batch(mine, lambda m, e: None))
    consumed, got, bounces = jwire.decode_frames(bytearray(buf))
    assert consumed == len(buf) and not bounces and len(got) == len(theirs)
    for g, j in zip(got, theirs):
        assert type(g.sending_silo) is jids.SiloAddress
        assert type(g.category) is jmsg.Category
        _same_message(g, j)


def _ids_of(ids):
    gt = ids.GrainType.of("par.Id")
    silo = ids.SiloAddress("10.7.0.9", 30000, 77, 2)
    return [ids.GrainId.for_grain(gt, 5), ids.GrainId.for_grain(gt, -3),
            ids.GrainId.for_grain(gt, "key", "ext"),
            ids.GrainId.for_guid(gt, __import__("uuid").UUID(int=12345)),
            ids.GrainId.client("client-7"),
            ids.GrainId.system_target(99, silo), silo,
            ids.ActivationId(4242),
            ids.ActivationAddress(silo, ids.GrainId.for_grain(gt, 9),
                                  ids.ActivationId(7))]


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_ids_cross_between_packages(direction):
    src, dst = (PORT, JAX) if direction == "port-to-jax" else (JAX, PORT)
    for a, b in zip(_ids_of(src[0]), _ids_of(dst[0])):
        blob = src[3].serialize(a)
        assert blob[:1] == b"\xa7" and blob == dst[3].serialize(b)
        out = dst[3].deserialize(blob)
        assert type(out) is type(b) and out == b
        if isinstance(b, dst[0].GrainId):
            assert (out.key, out.key_ext, out.type_code) == \
                (a.key, a.key_ext, a.type_code)
            assert out.category is b.category and \
                int(out.category) == int(a.category)
            assert out.uniform_hash == a.uniform_hash
        if isinstance(b, dst[0].SiloAddress):
            assert out.uniform_hash == a.uniform_hash


def test_configuring_one_codec_leaves_the_other_alone():
    class MarkedGrainId(GrainId):
        pass

    gid = jids.GrainId.for_grain(jids.GrainType.of("par.Cfg"), 11)
    frame = jser.serialize(gid)
    assert type(hw.loads(frame)) is GrainId
    try:
        hw.configure(MarkedGrainId, ser.members_by_value(GrainCategory),
                     SiloAddress, ActivationId, ActivationAddress,
                     ser._pickle_dumps, ser._restricted_pickle_loads)
        assert type(hw.loads(frame)) is MarkedGrainId
        assert type(jhw.loads(frame)) is jids.GrainId  # untouched
        assert jser.serialize(gid) == frame
    finally:
        hw.configure(GrainId, ser.members_by_value(GrainCategory),
                     SiloAddress, ActivationId, ActivationAddress,
                     ser._pickle_dumps, ser._restricted_pickle_loads)
    assert type(hw.loads(frame)) is GrainId
    assert hw.loads(frame).uniform_hash == gid.uniform_hash


def test_a_tensor_in_a_body_is_refused_at_encode_naming_its_type():
    """The port's choice for a torch tensor on the wire: refused when the
    frame is encoded (a per-message bounce), never decoded onto a
    receiver's device."""
    import torch
    msgs = _corpus_messages(3)
    msgs[1].body = ((), {"x": torch.arange(3)})
    bounced = []
    chunks = encode_message_batch(msgs, lambda m, e: bounced.append((m, e)))
    assert [m for m, _ in bounced] == [msgs[1]]
    assert isinstance(bounced[0][1], ser.WireTypeError)
    assert "torch.Tensor" in str(bounced[0][1])
    consumed, decoded, _ = decode_frames(bytearray(b"".join(chunks)))
    assert [m.method_name for m in decoded] == \
        [msgs[0].method_name, msgs[2].method_name]
    with pytest.raises(ser.WireTypeError, match="Parameter"):
        encode_message(make_request(
            target_grain=GrainId.for_grain(BI_GT, 1), interface_name="i",
            method_name="m", body=torch.nn.Parameter(torch.ones(2))))
