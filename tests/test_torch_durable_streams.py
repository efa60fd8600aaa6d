"""Parity of the port's durable stream queues (orleans_tpu_torch.streams
.durable: the file and SQLite queue adapters and the group committer)
with the JAX package's, on the CPU: the scenarios of
tests/test_durable_streams.py run through each package one after the
other, each on files of its own, and what each observed must be equal
exactly.

A package reads back only its own files: a blob the JAX package writes
names ``orleans_tpu.streams.core.StreamId``, which the port's unpickler
refuses (it admits no ``orleans_tpu`` module), naming the type. The plain
rows (sequence numbers, ack flags, watermarks, the ack log) are equal
across the two packages' files.

Host grains of a pair are built by one factory per package; every async
body runs under ``asyncio.wait_for(..., 30)``.
"""

import asyncio
import json
import pickle
import sqlite3
import time
from types import SimpleNamespace

import pytest

import orleans_tpu.membership as jm
import orleans_tpu.runtime as jr
import orleans_tpu.storage as js
import orleans_tpu.streams as jst
import orleans_tpu_torch.membership as tm
import orleans_tpu_torch.runtime as tr
import orleans_tpu_torch.storage as ts
import orleans_tpu_torch.streams as tst

TIMEOUT = 30


def _grains(rt, received):
    class ConsumerGrain(rt.Grain):
        async def join(self, ns, key, from_token=None):
            stream = self.get_stream_provider("dq").get_stream(ns, key)
            await stream.subscribe(self.on_event, from_token=from_token)

        async def on_event(self, item, token):
            received.setdefault(self.primary_key, []).append((token, item))

    class ProducerGrain(rt.Grain):
        async def publish(self, ns, key, items):
            stream = self.get_stream_provider("dq").get_stream(ns, key)
            await stream.on_next_batch(items)

    return ConsumerGrain, ProducerGrain


def _pkg(name, rt, st, mb, storage):
    received: dict = {}
    consumer, producer = _grains(rt, received)
    return SimpleNamespace(name=name, rt=rt, st=st, mb=mb, storage=storage,
                           received=received, Consumer=consumer,
                           Producer=producer)


J = _pkg("jax", jr, jst, jm, js)
T = _pkg("torch", tr, tst, tm, ts)


async def _parity(scenario, tmp_path, *args):
    got = []
    for pkg in (J, T):
        pkg.received.clear()
        d = tmp_path / pkg.name
        d.mkdir()
        got.append(await asyncio.wait_for(scenario(pkg, d, *args), TIMEOUT))
    assert got[0] == got[1], (scenario.__name__, got[0], got[1])
    return got[1]


def _adapter(pkg, kind, d, **kw):
    if kind == "file":
        return pkg.st.FileQueueAdapter(str(d / "queues"), **kw)
    return pkg.st.SqliteQueueAdapter(str(d / "queues.db"), **kw)


def _seqs(batches):
    return [(b.seq, b.items) for b in batches]


# ---------------------------------------------------------------------------
# Adapter-level semantics
# ---------------------------------------------------------------------------

async def _ack_cursor_and_replay(pkg, d, kind):
    ad = _adapter(pkg, kind, d, n_queues=2)
    sid = pkg.st.StreamId("p", "ns", "k")
    q = ad.queue_of(sid)
    await ad.queue_message_batch(q, sid, ["a", "b"])
    await ad.queue_message_batch(q, sid, ["c"])
    await ad.queue_message_batch(q, sid, ["d", "e", "f"])
    r1 = ad.create_receiver(q)
    got = await r1.get_messages(10)
    out = {"first": _seqs(got), "repeat": _seqs(await r1.get_messages(10))}
    await r1.ack(got[0])
    r2 = ad.create_receiver(q)
    redelivered = await r2.get_messages(10)
    out["redelivered"] = _seqs(redelivered)
    for b in redelivered:
        await r2.ack(b)
    out["replay0"] = _seqs(await ad.replay(sid, 0))
    out["replay3"] = [b.seq for b in await ad.replay(sid, 3)]
    out["queue"] = q
    return out


@pytest.mark.parametrize("kind", ["file", "sqlite"])
async def test_durable_adapter_ack_cursor_and_replay(kind, tmp_path):
    got = await _parity(_ack_cursor_and_replay, tmp_path, kind)
    assert got["first"] == [(0, ["a", "b"]), (2, ["c"]),
                            (3, ["d", "e", "f"])]
    assert got["repeat"] == []
    assert got["redelivered"] == [(2, ["c"]), (3, ["d", "e", "f"])]
    assert got["replay0"] == got["first"] and got["replay3"] == [3]


async def _survives_reopen(pkg, d, kind):
    ad = _adapter(pkg, kind, d)
    sid = pkg.st.StreamId("p", "ns", "k2")
    q = ad.queue_of(sid)
    await ad.queue_message_batch(q, sid, [1, 2, 3])
    r = ad.create_receiver(q)
    got = await r.get_messages(10)
    await r.ack(got[0])
    await ad.queue_message_batch(q, sid, [4])
    if kind == "sqlite":
        ad.close()
    ad2 = _adapter(pkg, kind, d)
    got2 = await ad2.create_receiver(q).get_messages(10)
    return ([b.items for b in got2],
            [b.items for b in await ad2.replay(sid, 0)])


@pytest.mark.parametrize("kind", ["file", "sqlite"])
async def test_durable_adapter_survives_reopen(kind, tmp_path):
    got = await _parity(_survives_reopen, tmp_path, kind)
    assert got == ([[4]], [[1, 2, 3]])


async def _torn_tail(pkg, d):
    ad = pkg.st.FileQueueAdapter(str(d / "queues"), n_queues=1)
    sid = pkg.st.StreamId("p", "ns", "k")
    await ad.queue_message_batch(0, sid, ["a", "b"])
    with open(ad._log(0), "a", encoding="utf-8") as f:
        f.write('{"sid": "AAAA", "b": "BB')
    await ad.queue_message_batch(0, sid, ["c"])
    return _seqs(await ad.create_receiver(0).get_messages(10))


async def test_file_adapter_recovers_from_torn_tail(tmp_path):
    got = await _parity(_torn_tail, tmp_path)
    assert got == [(0, ["a", "b"]), (2, ["c"])]


async def _compaction(pkg, d):
    ad = pkg.st.FileQueueAdapter(str(d / "queues"), n_queues=1, retention=3)
    sid = pkg.st.StreamId("p", "ns", "k")
    for i in range(70):
        await ad.queue_message_batch(0, sid, [i])
    r = ad.create_receiver(0)
    for b in await r.get_messages(100):
        await r.ack(b)
    out = {"rows_after_trigger": len(ad._read_log(0))}
    with ad._lock:
        ad._compact_locked(0)
    out["rows"] = len(ad._read_log(0))
    out["history"] = [b.items for b in await ad.replay(sid, 0)]
    await ad.queue_message_batch(0, sid, ["new"])
    out["next"] = _seqs(await ad.create_receiver(0).get_messages(10))
    ad2 = pkg.st.FileQueueAdapter(str(d / "queues"), n_queues=1,
                                  retention=3)
    out["reopened"] = _seqs(await ad2.create_receiver(0).get_messages(10))
    with open(ad._log(0), encoding="utf-8") as f:
        out["watermarks"] = [r["s"] for r in map(json.loads, f) if r.get("w")]
    return out


async def test_file_adapter_compaction_bounds_log(tmp_path):
    got = await _parity(_compaction, tmp_path)
    assert got["rows_after_trigger"] < 70
    assert got["rows_after_trigger"] <= 3 + 64
    assert got["rows"] == 3
    assert got["history"] == [[67], [68], [69]]
    assert got["next"] == got["reopened"] == [(70, ["new"])]


async def _retention_zero(pkg, d):
    ad = pkg.st.FileQueueAdapter(str(d / "queues"), n_queues=1, retention=0)
    sid = pkg.st.StreamId("p", "ns", "k")
    for i in range(5):
        await ad.queue_message_batch(0, sid, [i])
    r = ad.create_receiver(0)
    for b in await r.get_messages(10):
        await r.ack(b)
    with ad._lock:
        ad._compact_locked(0)
    out = (ad._read_log(0), await ad.replay(sid, 0))
    await ad.queue_message_batch(0, sid, ["next"])
    return out + (_seqs(await ad.create_receiver(0).get_messages(10)),)


async def test_file_adapter_retention_zero_keeps_no_history(tmp_path):
    got = await _parity(_retention_zero, tmp_path)
    assert got == ([], [], [(5, ["next"])])


async def _sqlite_retention(pkg, d):
    ad = pkg.st.SqliteQueueAdapter(str(d / "q.db"), n_queues=1, retention=3)
    sid = pkg.st.StreamId("p", "n", "k")
    for i in range(6):
        await ad.queue_message_batch(0, sid, [i])
    r = ad.create_receiver(0)
    for b in await r.get_messages(10):
        await r.ack(b)
    hist = [b.items for b in await ad.replay(sid, 0)]
    ad.close()
    db = sqlite3.connect(str(d / "q.db"))
    try:
        rows = db.execute("SELECT queue_id, seq, n, acked FROM stream_batches"
                          " ORDER BY seq").fetchall()
        marks = db.execute("SELECT * FROM stream_watermarks").fetchall()
    finally:
        db.close()
    return hist, rows, marks


async def test_sqlite_retention_bounds_acked_history(tmp_path):
    hist, rows, marks = await _parity(_sqlite_retention, tmp_path)
    assert hist == [[3], [4], [5]]
    assert rows == [(0, 3, 1, 1), (0, 4, 1, 1), (0, 5, 1, 1)]
    assert marks == [(0, 6)]


async def _token_continuity(pkg, d):
    path = str(d / "wm.db")
    a = pkg.st.SqliteQueueAdapter(path, n_queues=1, retention=0)
    sid = pkg.st.StreamId("dq", "ns", "k")
    for i in range(3):
        await a.queue_message_batch(0, sid, [f"a{i}", f"b{i}"])
    recv = a.create_receiver(0)
    batches = await recv.get_messages(10)
    for b in batches:
        await recv.ack(b)
    a.close()
    b2 = pkg.st.SqliteQueueAdapter(path, n_queues=1, retention=0)
    await b2.queue_message_batch(0, sid, ["post-drain"])
    got = await b2.create_receiver(0).get_messages(10)
    b2.close()
    return [b.seq for b in batches], [x.seq for x in got]


async def test_sqlite_token_continuity_after_full_drain(tmp_path):
    got = await _parity(_token_continuity, tmp_path)
    assert got == ([0, 2, 4], [6])


async def _flush_failure(pkg, d):
    a = pkg.st.SqliteQueueAdapter(str(d / "gc.db"), n_queues=1)
    sid = pkg.st.StreamId("dq", "ns", "k")
    a._db.close()
    results = await asyncio.gather(
        *(a.queue_message_batch(0, sid, [i]) for i in range(8)),
        return_exceptions=True)
    return [type(r).__name__ for r in results]


async def test_group_commit_flush_failure_fails_every_waiter(tmp_path):
    got = await _parity(_flush_failure, tmp_path)
    assert got == ["ProgrammingError"] * 8


async def _plain_rows(pkg, d, kind):
    """The plain rows a scenario leaves in the queue files: sequence
    numbers, item counts, ack flags and watermarks (SQLite), or the ack
    log and the batch records' plain fields (file)."""
    ad = _adapter(pkg, kind, d, n_queues=1)
    sid = pkg.st.StreamId("p", "ns", "k")
    for items in (["a"], ["b", "c"], ["d"]):
        await ad.queue_message_batch(0, sid, items)
    r = ad.create_receiver(0)
    got = await r.get_messages(10)
    await r.ack(got[0])
    await r.ack(got[2])
    if kind == "sqlite":
        ad.close()
        db = sqlite3.connect(str(d / "queues.db"))
        try:
            return (db.execute("SELECT queue_id, seq, n, acked FROM "
                               "stream_batches ORDER BY seq").fetchall(),
                    db.execute("SELECT * FROM stream_watermarks").fetchall())
        finally:
            db.close()
    with open(ad._log(0), encoding="utf-8") as f:
        log = [(r["s"], r["n"]) for r in map(json.loads, f)]
    with open(ad._ackf(0), encoding="utf-8") as f:
        return log, f.read().split()


@pytest.mark.parametrize("kind", ["file", "sqlite"])
async def test_plain_rows_of_the_queue_files_are_equal(kind, tmp_path):
    got = await _parity(_plain_rows, tmp_path, kind)
    if kind == "sqlite":
        assert got == ([(0, 0, 1, 1), (0, 1, 2, 0), (0, 3, 1, 1)], [(0, 4)])
    else:
        assert got == ([(0, 1), (1, 2), (3, 1)], ["0", "3"])


@pytest.mark.parametrize("kind", ["file", "sqlite"])
async def test_port_refuses_a_queue_file_the_jax_package_wrote(kind,
                                                               tmp_path):
    """A deliberate divergence: the port's unpickler admits no
    ``orleans_tpu`` module, so a batch the JAX package wrote is refused
    with an error naming the type; the JAX package reads it."""
    async def run():
        ad = _adapter(J, kind, tmp_path, n_queues=1)
        await ad.queue_message_batch(0, jst.StreamId("p", "ns", "k"), [7])
        if kind == "sqlite":
            ad.close()
        port = _adapter(T, kind, tmp_path, n_queues=1)
        with pytest.raises(pickle.UnpicklingError,
                           match=r"orleans_tpu\.streams\.core\.StreamId"):
            await port.create_receiver(0).get_messages(10)
        again = _adapter(J, kind, tmp_path, n_queues=1)
        return [b.items for b in await again.create_receiver(0)
                .get_messages(10)]

    assert await asyncio.wait_for(run(), TIMEOUT) == [[7]]


def test_port_streams_export_the_durable_adapters():
    assert set(tst.__all__) == set(jst.__all__)
    for name in ("DurableQueueAdapter", "FileQueueAdapter",
                 "SqliteQueueAdapter"):
        assert getattr(tst, name).__module__ == \
            "orleans_tpu_torch.streams.durable"


# ---------------------------------------------------------------------------
# End-to-end through the pulling machinery
# ---------------------------------------------------------------------------

async def _cluster(pkg, n, adapter, with_membership=False,
                   cache_capacity=256):
    fabric = pkg.rt.InProcFabric()
    storage = pkg.storage.MemoryStorage()
    mbr = pkg.mb.InMemoryMembershipTable()
    silos = []
    for i in range(n):
        b = (pkg.rt.SiloBuilder().with_name(f"dq{i}").with_fabric(fabric)
             .add_grains(pkg.Consumer, pkg.Producer)
             .with_storage("Default", storage)
             .with_config(membership_probe_period=0.1,
                          membership_probe_timeout=0.15,
                          membership_missed_probes_limit=2,
                          membership_refresh_period=0.3,
                          response_timeout=2.0))
        pkg.st.add_persistent_streams(b, "dq", adapter, pull_period=0.05,
                                      cache_capacity=cache_capacity,
                                      rebalance_period=0.5)
        silo = b.build()
        if with_membership:
            pkg.mb.join_cluster(silo, mbr)
        await silo.start()
        silos.append(silo)
    client = await pkg.rt.ClusterClient(fabric).connect()
    return silos, client


async def _stop(silos, client):
    await client.close_async()
    for s in silos:
        if s.status not in ("Stopped", "Dead"):
            await s.stop()


async def _wait_count(pkg, key, count, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(pkg.received.get(key, [])) >= count:
            return pkg.received[key]
        await asyncio.sleep(0.03)
    raise AssertionError(
        f"{key}: got {len(pkg.received.get(key, []))}, wanted {count}")


async def _end_to_end(pkg, d, kind):
    silos, client = await _cluster(pkg, 1, _adapter(pkg, kind, d))
    try:
        await client.get_grain(pkg.Consumer, 1).join("gps", "car")
        await client.get_grain(pkg.Producer, 1).publish(
            "gps", "car", list(range(5)))
        return list(await _wait_count(pkg, 1, 5))
    finally:
        await _stop(silos, client)


@pytest.mark.parametrize("kind", ["file", "sqlite"])
async def test_durable_stream_end_to_end(kind, tmp_path):
    got = await _parity(_end_to_end, tmp_path, kind)
    assert [i for _, i in got] == [0, 1, 2, 3, 4]


async def _silo_kill(pkg, d):
    adapter = pkg.st.SqliteQueueAdapter(str(d / "q.db"), n_queues=2)
    silos, client = await _cluster(pkg, 3, adapter, with_membership=True)
    try:
        await client.get_grain(pkg.Consumer, 9).join("gps", "bus")
        prod = client.get_grain(pkg.Producer, 1)
        await prod.publish("gps", "bus", list(range(10)))
        await _wait_count(pkg, 9, 10)
        sid = pkg.st.StreamId("dq", "gps", "bus")
        q = adapter.queue_of(sid)
        owner = next(s for s in silos
                     if q in s.stream_providers["dq"].manager.agents)
        await prod.publish("gps", "bus", list(range(10, 30)))
        await owner.stop(graceful=False)
        got = await _wait_count(pkg, 9, 30, timeout=20.0)
        uniq: dict = {}
        for t, i in got:
            uniq.setdefault(t, i)
        # redelivery (duplicates) is allowed: what is compared is the set
        # of items and the dedup by token
        return sorted({i for _, i in got}), sorted(uniq.values())
    finally:
        await _stop(silos, client)


async def test_silo_kill_mid_stream_loses_nothing(tmp_path):
    items, deduped = await _parity(_silo_kill, tmp_path)
    assert items == deduped == list(range(30))


async def _rewind(pkg, d):
    adapter = pkg.st.SqliteQueueAdapter(str(d / "q.db"), n_queues=1)
    silos, client = await _cluster(pkg, 1, adapter, cache_capacity=4)
    try:
        await client.get_grain(pkg.Consumer, 1).join("gps", "t")
        prod = client.get_grain(pkg.Producer, 1)
        for i in range(40):
            await prod.publish("gps", "t", [i])
        await _wait_count(pkg, 1, 40)
        await asyncio.sleep(0.5)
        agent = silos[0].stream_providers["dq"].manager.agents[0]
        moved_on = agent.cache.count < 40
        await client.get_grain(pkg.Consumer, 2).join("gps", "t",
                                                     from_token=0)
        got = await _wait_count(pkg, 2, 40, timeout=15.0)
        uniq: dict = {}
        for t, i in got:
            uniq.setdefault(t, i)
        return moved_on, sorted(uniq.items())
    finally:
        await _stop(silos, client)


async def test_rewind_beyond_cache_replays_durable_history(tmp_path):
    moved_on, replay = await _parity(_rewind, tmp_path)
    assert moved_on
    assert [i for _, i in replay] == list(range(40))
