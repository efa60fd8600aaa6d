"""Durable queue adapters: persistent-stream events that survive the process.

Re-design of the reference's externally-durable stream queues —
Orleans' src/Azure/Orleans.Streaming.AzureStorage/Providers/Streams/
AzureQueue/AzureQueueAdapterReceiver.cs (+ ``AzureQueueAdapterFactory.cs``),
consumed by ``PersistentStreamPullingAgent.cs:350-368`` — with this repo's
standard durable-backend split (file / sqlite, the same split membership,
reminders, storage, the transaction log, and gossip channels use; cloud
queue services map onto these backends).

Durability contract:

* ``produce`` appends the batch durably BEFORE returning: an event accepted
  by ``on_next`` survives process death from that moment.
* Receivers deliver unacked batches. Acks are committed durably, so a
  restarted silo's pulling agent resumes from the durable cursor, and
  unacked batches redeliver (at-least-once; consumers dedup by token).
* Acked batches are RETAINED (bounded by ``retention`` per queue), so a
  rewound subscription (``subscribe(from_token=...)``) replays history
  beyond the in-memory cache window via :meth:`DurableQueueAdapter.replay`
  — the queue-retention replay the reference gets from EventHub offsets.

Blocking I/O (fsync, sqlite) runs in the default executor so produces and
acks never stall the silo's event loop.

The port's copy of ``orleans_tpu.streams.durable``.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import os
import sqlite3
import threading

from ..core.serialization import serialize_portable
from ..core.serialization import _restricted_pickle_loads as _loads
from .core import StreamId
from .persistent import QueueAdapter, QueueBatch, QueueReceiver

try:
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX fallback
    fcntl = None

__all__ = ["DurableQueueAdapter", "FileQueueAdapter", "SqliteQueueAdapter"]


class _GroupCommitter:
    """Group commit: coalesce produces that are concurrently in flight
    into ONE durable commit (the batched-write analog of the reference's
    ``QueueMessageBatchAsync`` path consumed by
    PersistentStreamPullingAgent.cs:350-368). Entries arriving while a
    flush runs in the executor join the NEXT flush, so N concurrent
    producers share ~1 fsync per flush instead of paying one each; a solo
    producer flushes immediately — no batching-window latency is ever
    added. Each submitter's await completes only after the commit that
    contains its entry is durable (or fails, with the flush error)."""

    def __init__(self, flush):
        self._flush = flush  # flush(entries) — blocking, runs in executor
        self._pending: list = []
        self._task: asyncio.Task | None = None

    async def submit(self, entry) -> None:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._pending.append((entry, fut))
        if self._task is None or self._task.done():
            self._task = loop.create_task(self._drain())
        await fut

    async def _drain(self) -> None:
        loop = asyncio.get_running_loop()
        while self._pending:
            batch, self._pending = self._pending, []
            entries = [e for e, _ in batch]
            try:
                await loop.run_in_executor(None, self._flush, entries)
            except asyncio.CancelledError:
                # loop teardown: the in-flight commit may still land in
                # the executor thread, but its waiters cannot learn that —
                # cancel them (at-least-once: a retry re-produces) and
                # STOP draining; swallowing the cancel would re-enter
                # run_in_executor on a closing loop
                for _, fut in batch:
                    if not fut.done():
                        fut.cancel()
                raise
            except BaseException as exc:  # noqa: BLE001 — to every waiter
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)
            else:
                for _, fut in batch:
                    if not fut.done():
                        fut.set_result(None)


class DurableQueueAdapter(QueueAdapter):
    """Shared contract of the durable backends; adds :meth:`replay` (the
    rewind-beyond-cache source consumed by the pulling agent's pumps) and
    the group-commit produce path."""

    def _flush_entries(self, entries: list) -> None:
        """Blocking: durably commit a produce flush group (subclass hook)."""
        raise NotImplementedError

    def _flush_acks(self, entries: list) -> None:
        """Blocking: durably commit an ack flush group (subclass hook)."""
        raise NotImplementedError

    def _committer(self, kind: str, flush) -> _GroupCommitter:
        """One committer per (event loop, kind): adapters are shared
        objects (the 'external queue service'), and tests drive them from
        several sequential loops — futures must never cross loops.
        Committers of closed loops are pruned so sequential loops (and
        their retained tasks/futures) do not accumulate."""
        by_key = getattr(self, "_committers", None)
        if by_key is None:
            by_key = self._committers = {}
        for stale in [k for k in by_key if k[0].is_closed()]:
            del by_key[stale]
        key = (asyncio.get_running_loop(), kind)
        c = by_key.get(key)
        if c is None:
            c = by_key[key] = _GroupCommitter(flush)
        return c

    async def replay(self, stream: StreamId,
                     from_seq: int) -> list[QueueBatch]:
        """Acked batches of ``stream`` whose token range reaches
        ``from_seq`` or later, in order. Only ACKED batches: unacked ones
        redeliver through the normal pull path, so replaying them here
        would double-deliver the live window."""
        raise NotImplementedError

    def queue_of(self, stream: StreamId) -> int:
        return stream.uniform_hash % self.n_queues


class _DurableReceiver(QueueReceiver):
    """Receiver over a durable backend: the backend knows acked state; this
    object only tracks what THIS incarnation already handed out, so a fresh
    receiver (silo restart / queue-ownership handoff) redelivers every
    unacked batch — the durable-cursor resume."""

    def __init__(self, adapter, queue_id: int):
        self._adapter = adapter
        self._queue_id = queue_id
        self._delivered: set[int] = set()

    async def get_messages(self, max_count: int) -> list[QueueBatch]:
        batches = await self._adapter._unacked(
            self._queue_id, self._delivered, max_count)
        self._delivered.update(b.seq for b in batches)
        return batches

    async def ack(self, batch: QueueBatch) -> None:
        await self._adapter._ack(self._queue_id, batch.seq)
        self._delivered.discard(batch.seq)

    def shutdown(self) -> None:
        # acks are durable; dropping the delivered set is all a handoff
        # needs — the next owner's receiver re-reads unacked rows
        self._delivered.clear()


class SqliteQueueAdapter(DurableQueueAdapter):
    """Sqlite-backed queue bank (the AdoNet/AzureQueue analog): one
    database file is the cluster-shared queue service. WAL mode; one
    connection guarded by a lock, used from the executor."""

    def __init__(self, path: str, n_queues: int = 8, name: str = "sqlite",
                 retention: int = 4096):
        self.name = name
        self.n_queues = n_queues
        self.retention = retention
        self.path = path
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS stream_batches ("
                " queue_id INTEGER, seq INTEGER, stream BLOB, items BLOB,"
                " n INTEGER, acked INTEGER DEFAULT 0,"
                " PRIMARY KEY (queue_id, seq))")
            # per-queue high-water mark (the sqlite analog of the file
            # adapter's watermark record): retention can DELETE every row
            # of a drained queue, and deriving next-seq from surviving rows
            # alone would then restart at 0 and collide with
            # already-delivered tokens
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS stream_watermarks ("
                " queue_id INTEGER PRIMARY KEY, next_seq INTEGER)")
            self._db.commit()

    def close(self) -> None:
        with self._lock:
            self._db.close()

    async def queue_message_batch(self, queue_id, stream, items) -> None:
        blob = serialize_portable(list(items))
        sblob = serialize_portable(stream)
        await self._committer("produce", self._flush_entries).submit(
            (queue_id, sblob, blob, len(items)))

    def _flush_entries(self, entries: list) -> None:
        """One transaction (one WAL fsync) commits every produce in the
        flush group."""
        with self._lock:
            # BEGIN IMMEDIATE takes the write lock BEFORE the seq
            # read: two producer PROCESSES sharing this .db must not
            # both read the same max seq (deferred transactions would
            # let them, and one INSERT would die on the PK)
            self._db.execute("BEGIN IMMEDIATE")
            try:
                next_seq: dict[int, int] = {}
                for queue_id, sblob, blob, n in entries:
                    if queue_id not in next_seq:
                        # item-cumulative per-queue seq
                        # (EventSequenceToken contract): next = previous
                        # seq + previous item count. max() with the
                        # watermark: rows alone under-count after
                        # retention drained the queue; the watermark
                        # alone under-counts on a pre-watermark db
                        row = self._db.execute(
                            "SELECT seq + n FROM stream_batches"
                            " WHERE queue_id=?"
                            " ORDER BY seq DESC LIMIT 1",
                            (queue_id,)).fetchone()
                        wm = self._db.execute(
                            "SELECT next_seq FROM stream_watermarks"
                            " WHERE queue_id=?", (queue_id,)).fetchone()
                        next_seq[queue_id] = max(row[0] if row else 0,
                                                 wm[0] if wm else 0)
                    seq = next_seq[queue_id]
                    self._db.execute(
                        "INSERT INTO stream_batches"
                        " (queue_id, seq, stream, items, n)"
                        " VALUES (?,?,?,?,?)",
                        (queue_id, seq, sblob, blob, n))
                    next_seq[queue_id] = seq + n
                for queue_id, ns in next_seq.items():
                    self._db.execute(
                        "INSERT OR REPLACE INTO stream_watermarks"
                        " (queue_id, next_seq) VALUES (?,?)",
                        (queue_id, ns))
                self._db.commit()
            except BaseException:
                self._db.rollback()
                raise

    def create_receiver(self, queue_id: int) -> QueueReceiver:
        return _DurableReceiver(self, queue_id)

    async def _unacked(self, queue_id: int, exclude: set[int],
                       max_count: int) -> list[QueueBatch]:
        # bound the fetch: at most max_count new rows can be returned, so
        # max_count + |delivered-but-unacked| rows suffice — a large
        # backlog under consumer backpressure must not make every poll
        # scan the whole queue
        limit = max_count + len(exclude)

        def read():
            with self._lock:
                return self._db.execute(
                    "SELECT seq, stream, items FROM stream_batches"
                    " WHERE queue_id=? AND acked=0 ORDER BY seq LIMIT ?",
                    (queue_id, limit)).fetchall()

        rows = await asyncio.get_running_loop().run_in_executor(None, read)
        out = []
        for seq, sblob, blob in rows:
            if seq in exclude:
                continue
            out.append(QueueBatch(_loads(sblob), _loads(blob), seq))
            if len(out) >= max_count:
                break
        return out

    async def _ack(self, queue_id: int, seq: int) -> None:
        await self._committer("ack", self._flush_acks).submit(
            (queue_id, seq))

    def _flush_acks(self, entries: list) -> None:
        """One transaction acks the whole flush group; the retention
        sweep runs once per touched queue, not once per ack."""
        with self._lock:
            self._db.execute("BEGIN IMMEDIATE")
            try:
                self._db.executemany(
                    "UPDATE stream_batches SET acked=1"
                    " WHERE queue_id=? AND seq=?", entries)
                for queue_id in {q for q, _ in entries}:
                    # bounded retention: keep the newest `retention` acked
                    # batches per queue for rewind replay, drop older
                    self._db.execute(
                        "DELETE FROM stream_batches WHERE queue_id=?"
                        " AND acked=1"
                        " AND seq NOT IN (SELECT seq FROM stream_batches"
                        "  WHERE queue_id=? AND acked=1"
                        "  ORDER BY seq DESC LIMIT ?)",
                        (queue_id, queue_id, self.retention))
                self._db.commit()
            except BaseException:
                self._db.rollback()
                raise

    async def replay(self, stream: StreamId,
                     from_seq: int) -> list[QueueBatch]:
        queue_id = self.queue_of(stream)

        def read():
            with self._lock:
                return self._db.execute(
                    "SELECT seq, stream, items FROM stream_batches"
                    " WHERE queue_id=? AND acked=1 AND seq + n > ?"
                    " ORDER BY seq", (queue_id, from_seq)).fetchall()

        rows = await asyncio.get_running_loop().run_in_executor(None, read)
        return [QueueBatch(s, _loads(blob), seq)
                for seq, sblob, blob in rows
                if (s := _loads(sblob)) == stream]


class FileQueueAdapter(DurableQueueAdapter):
    """Append-only file-backed queue bank: one directory is the queue
    service. Per queue: ``q<i>.log`` (one JSON line per batch, payload
    pickled+base64) and ``q<i>.ack`` (one acked seq per line). fsync per
    produce — the durability point. A torn trailing line (crash mid-write)
    is detected on parse and ignored; the producer that crashed never had
    its produce() return, so nothing acknowledged is lost."""

    def __init__(self, directory: str, n_queues: int = 8,
                 name: str = "file", retention: int = 4096):
        self.name = name
        self.n_queues = n_queues
        # newest acked batches kept per queue for rewind replay; older
        # acked batches are dropped by compaction (a log rewrite with a
        # seq-watermark record so token continuity survives), triggered
        # once enough acks accumulate — the log is bounded, not
        # append-forever
        self.retention = retention
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._next_seq: dict[int, int] = {}
        self._scanned: dict[int, int] = {}  # queue -> file size at scan
        self._acks_since_compact: dict[int, int] = {}

    def _log(self, q: int) -> str:
        return os.path.join(self.directory, f"q{q}.log")

    def _ackf(self, q: int) -> str:
        return os.path.join(self.directory, f"q{q}.ack")

    @contextlib.contextmanager
    def _os_lock(self, q: int):
        """Cross-process exclusive lock per queue (flock on a sidecar):
        seq assignment must be atomic between producer PROCESSES."""
        if fcntl is None:  # pragma: no cover
            yield
            return
        with open(self._log(q) + ".lock", "a+") as lk:
            fcntl.flock(lk.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lk.fileno(), fcntl.LOCK_UN)

    def _read_log_raw(self, q: int) -> tuple[
            list[tuple[int, bytes, bytes, int]], int, int]:
        """Parse q<i>.log into ``(rows, valid_end, next_seq)``:
        ``rows`` are (seq, stream_blob, items_blob, n_items) batch
        records; ``valid_end`` is the byte length of the VALID prefix;
        ``next_seq`` is the next token to assign — the max over every
        record (including compaction watermarks ``{"s":…, "w":1}``,
        which carry the sequence over dropped history) of seq + n.

        A torn trailing line (crash mid-append: unterminated or
        unparseable) ends the valid prefix — that writer's produce()
        never returned, so the torn record was never acknowledged to
        anyone. The producer truncates the torn tail before appending:
        appending after it would leave the new record unreachable behind
        the parse stop."""
        path = self._log(q)
        if not os.path.exists(path):
            return [], 0, 0
        rows: list = []
        valid_end = 0
        next_seq = 0
        with open(path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break  # torn tail from a crashed writer
                stripped = line.strip()
                if stripped:
                    try:
                        r = json.loads(stripped)
                        if r.get("w"):
                            # compaction watermark: preserves the token
                            # sequence across dropped history
                            next_seq = max(next_seq, r["s"])
                        else:
                            rows.append((r["s"],
                                         base64.b64decode(r["sid"]),
                                         base64.b64decode(r["b"]), r["n"]))
                            next_seq = max(next_seq, r["s"] + r["n"])
                    except (ValueError, KeyError):
                        break
                valid_end += len(line)
        return rows, valid_end, next_seq

    def _read_log(self, q: int) -> list[tuple[int, bytes, bytes, int]]:
        return self._read_log_raw(q)[0]

    def _read_acks(self, q: int) -> set[int]:
        path = self._ackf(q)
        if not os.path.exists(path):
            return set()
        acked = set()
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        acked.add(int(line))
                    except ValueError:
                        break
        return acked

    async def queue_message_batch(self, queue_id, stream, items) -> None:
        rec = {"sid": base64.b64encode(
                   serialize_portable(stream)).decode(),
               "b": base64.b64encode(
                   serialize_portable(list(items))).decode(),
               "n": len(items)}
        await self._committer("produce", self._flush_entries).submit(
            (queue_id, rec))

    def _flush_entries(self, entries: list) -> None:
        """One append + one fsync per QUEUE per flush group commits every
        produce in the group."""
        by_q: dict[int, list[dict]] = {}
        for queue_id, rec in entries:
            by_q.setdefault(queue_id, []).append(rec)
        with self._lock:
            for queue_id, recs in by_q.items():
                with self._os_lock(queue_id):
                    # cached next-seq, revalidated by file size under the
                    # flock: steady-state single-process produce is O(1);
                    # a cross-process writer (or a torn tail) shows up as
                    # a size mismatch and forces one rescan (the
                    # FileTransactionLog index pattern)
                    path = self._log(queue_id)
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        size = 0
                    if self._scanned.get(queue_id) != size:
                        _rows, valid_end, next_seq = \
                            self._read_log_raw(queue_id)
                        if valid_end < size:
                            # truncate a crashed writer's torn tail so
                            # the records appended below stay parseable
                            with open(path, "r+b") as tf:
                                tf.truncate(valid_end)
                        self._next_seq[queue_id] = next_seq
                    seq = self._next_seq.get(queue_id, 0)
                    with open(path, "a", encoding="utf-8") as f:
                        for rec in recs:
                            rec["s"] = seq
                            seq += rec["n"]
                            f.write(json.dumps(rec, separators=(",", ":"))
                                    + "\n")
                        f.flush()
                        os.fsync(f.fileno())
                        self._scanned[queue_id] = f.tell()
                    self._next_seq[queue_id] = seq

    def create_receiver(self, queue_id: int) -> QueueReceiver:
        return _DurableReceiver(self, queue_id)

    async def _unacked(self, queue_id: int, exclude: set[int],
                       max_count: int) -> list[QueueBatch]:
        def read():
            with self._lock:
                rows = self._read_log(queue_id)
                acked = self._read_acks(queue_id)
            out = []
            for seq, sblob, blob, _n in rows:
                if seq in acked or seq in exclude:
                    continue
                out.append(QueueBatch(_loads(sblob), _loads(blob), seq))
                if len(out) >= max_count:
                    break
            return out

        return await asyncio.get_running_loop().run_in_executor(None, read)

    async def _ack(self, queue_id: int, seq: int) -> None:
        await self._committer("ack", self._flush_acks).submit(
            (queue_id, seq))

    def _flush_acks(self, entries: list) -> None:
        """One append + one fsync per queue acks the whole flush group;
        the compaction check runs once per touched queue."""
        by_q: dict[int, list[int]] = {}
        for queue_id, seq in entries:
            by_q.setdefault(queue_id, []).append(seq)
        with self._lock:
            for queue_id, seqs in by_q.items():
                # the flock serializes against a concurrent compaction in
                # ANOTHER process: its ack-file rewrite must never discard
                # an ack appended between its read and its replace
                with self._os_lock(queue_id):
                    with open(self._ackf(queue_id), "a",
                              encoding="utf-8") as f:
                        f.writelines(f"{seq}\n" for seq in seqs)
                        f.flush()
                        os.fsync(f.fileno())
                    n = self._acks_since_compact.get(queue_id, 0) \
                        + len(seqs)
                    if n >= max(self.retention, 64):
                        self._compact_under_flock(queue_id)
                        n = 0
                    self._acks_since_compact[queue_id] = n

    def _compact_locked(self, q: int) -> None:
        """Compact with only ``_lock`` held (takes the flock itself).
        Never call while already holding the flock — flock on a second
        fd of the same lock file blocks even within one process."""
        with self._os_lock(q):
            self._compact_under_flock(q)

    def _compact_under_flock(self, q: int) -> None:
        """Bound the log: keep unacked batches plus the newest
        ``retention`` acked ones; a leading watermark record carries the
        token sequence over the dropped history. Caller holds ``_lock``
        AND the queue flock (which serializes against cross-process
        producers and ackers). Replace order is log-then-ack: a crash
        between the two leaves stale seqs in the ack file (harmless —
        acks for absent batches are ignored) but never un-acks a kept
        batch."""
        rows, _, next_seq = self._read_log_raw(q)
        acked = self._read_acks(q)
        acked_seqs = sorted(r[0] for r in rows if r[0] in acked)
        # [-0:] would keep EVERYTHING; retention=0 means no history
        keep_acked = set(acked_seqs[-self.retention:]) \
            if self.retention > 0 else set()
        kept = [r for r in rows
                if r[0] not in acked or r[0] in keep_acked]
        path = self._log(q)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps({"s": next_seq, "w": 1},
                               separators=(",", ":")) + "\n")
            for seq, sblob, blob, n in kept:
                f.write(json.dumps(
                    {"s": seq,
                     "sid": base64.b64encode(sblob).decode(),
                     "b": base64.b64encode(blob).decode(),
                     "n": n}, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        ackf = self._ackf(q)
        atmp = ackf + ".tmp"
        with open(atmp, "w", encoding="utf-8") as f:
            for seq in sorted(keep_acked):
                f.write(f"{seq}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(atmp, ackf)
        self._scanned[q] = os.path.getsize(path)
        self._next_seq[q] = next_seq

    async def replay(self, stream: StreamId,
                     from_seq: int) -> list[QueueBatch]:
        queue_id = self.queue_of(stream)

        def read():
            with self._lock:
                rows = self._read_log(queue_id)
                acked = self._read_acks(queue_id)
            out = []
            for seq, sblob, blob, n in rows:
                if seq not in acked or seq + n <= from_seq:
                    continue
                sid = _loads(sblob)
                if sid == stream:
                    out.append(QueueBatch(sid, _loads(blob), seq))
            return out

        return await asyncio.get_running_loop().run_in_executor(None, read)
