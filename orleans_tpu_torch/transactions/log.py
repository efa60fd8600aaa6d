"""Durable transaction commit log.

Re-design of Orleans' src/Orleans.Transactions/TransactionLog.cs
(storage-backed commit log the TM appends decisions to before announcing
them) behind a pluggable provider interface, with in-memory / append-only
file / sqlite backends — the same provider split the membership table and
reminder table use (cloud log storage such as
Orleans.Transactions.AzureStorage maps to the File/Sqlite backends here;
no cloud egress in scope).

The log is the TM's durable truth: a decision is COMMITTED the moment its
record is appended, before any participant hears the outcome. A TM
activation replays the log on activate (seq + decision map), which is what
makes TM failover safe: in-doubt participants query ``decision_of`` against
the recovered map.

Growth is bounded the way the reference truncates below the stable mark
(TransactionLog.cs): once every participant has acknowledged a decision
and a retention window has passed, the TM calls ``rewrite`` with the
records still live; a ``seq`` watermark record preserves the shard's
version sequence across compactions.

Blocking I/O (fsync, sqlite) runs via ``loop.run_in_executor`` so a
commit decision never stalls the silo's event loop.

The port's copy of ``orleans_tpu.transactions.log``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import sqlite3
import threading
from typing import Iterable

try:
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX fallback (tests/dev)
    fcntl = None

__all__ = ["TransactionLog", "InMemoryTransactionLog", "FileTransactionLog",
           "SqliteTransactionLog"]

# decision value reserved for the compaction watermark record
_SEQ_MARK = "__seq__"


class TransactionLog:
    """Provider contract. One log instance may be shared by several TM
    shards; records carry the shard id so each shard replays its own."""

    async def append(self, shard: int, txn: str, decision: str,
                     version: int) -> None:
        raise NotImplementedError

    async def decide(self, shard: int, txn: str, decision: str,
                     version: int) -> tuple[str, int]:
        """Atomic first-decision-wins append: if the log already holds a
        decision for ``txn`` (e.g. logged by a concurrent duplicate TM
        incarnation during a membership transition), return THAT record
        without writing; otherwise append and return the proposal. This
        is what makes presumed abort safe against a racing commit — the
        log, not any single activation's memory, is the serialization
        point (TransactionLog.cs as the TM's durable truth)."""
        raise NotImplementedError

    async def replay(self, shard: int) -> tuple[int, dict[str, tuple[str, int]]]:
        """Return (max_version_seen, {txn: (decision, version)}) for one
        shard."""
        raise NotImplementedError

    async def rewrite(self, shard: int,
                      live: dict[str, tuple[str, int]], seq: int) -> None:
        """Compact: replace the shard's records with ``live`` plus a seq
        watermark. Other shards' records are preserved."""
        raise NotImplementedError


class InMemoryTransactionLog(TransactionLog):
    """Test/dev backend; survives silo restarts when the instance is shared
    (the InMemoryTransactionLog analog of InMemoryMembershipTable)."""

    def __init__(self) -> None:
        self.records: list[tuple[int, str, str, int]] = []
        self._index: dict[tuple[int, str], tuple[str, int]] = {}

    async def append(self, shard: int, txn: str, decision: str,
                     version: int) -> None:
        self.records.append((shard, txn, decision, version))
        self._index.setdefault((shard, txn), (decision, version))

    async def decide(self, shard: int, txn: str, decision: str,
                     version: int) -> tuple[str, int]:
        prior = self._index.get((shard, txn))
        if prior is not None:
            return prior
        await self.append(shard, txn, decision, version)
        return (decision, version)

    async def replay(self, shard: int) -> tuple[int, dict[str, tuple[str, int]]]:
        return _fold(r for r in self.records if r[0] == shard)

    async def rewrite(self, shard: int,
                      live: dict[str, tuple[str, int]], seq: int) -> None:
        self.records = [r for r in self.records if r[0] != shard]
        self.records.append((shard, "", _SEQ_MARK, seq))
        self.records.extend((shard, t, d, v) for t, (d, v) in live.items())
        self._index = {k: v for k, v in self._index.items()
                       if k[0] != shard}
        self._index.update({(shard, t): d for t, d in live.items()})


class FileTransactionLog(TransactionLog):
    """Append-only JSONL file, fsync'd per decision — the durability
    point of the 2PC (TransactionLog.cs's storage append). The fsync runs
    in the default executor; a lock serializes writers so compaction's
    replace-rename cannot race an append."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._io_lock = threading.Lock()
        # decide() index: (shard, txn) → FIRST record. Built from the
        # file and kept current for this process's writes; cross-process
        # writers are detected by file growth and serialized by an OS
        # file lock (the threading lock only covers this process).
        self._index: dict[tuple[int, str], tuple[str, int]] | None = None
        self._scanned_size = -1

    @contextlib.contextmanager
    def _os_lock(self):
        """Cross-process exclusive lock (fcntl.flock on a sidecar): the
        first-decision-wins guarantee must hold between silo PROCESSES
        sharing the file, not just between tasks of one process."""
        if fcntl is None:
            yield
            return
        with open(self.path + ".lock", "a+") as lk:
            fcntl.flock(lk.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lk.fileno(), fcntl.LOCK_UN)

    def _write_locked(self, shard: int, txn: str, decision: str,
                      version: int) -> None:
        line = json.dumps({"s": shard, "t": txn, "d": decision,
                           "v": version}, separators=(",", ":"))
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
            size = f.tell()
        if self._index is not None:
            self._index.setdefault((shard, txn), (decision, version))
            self._scanned_size = size

    def _refresh_index_locked(self) -> dict:
        """(Re)build the index iff the file changed since the last scan —
        the common decide() for a fresh txn costs one getsize(), not a
        full-file parse."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = 0
        if self._index is None or size != self._scanned_size:
            idx: dict = {}
            for s, t, d, v in self._read_all():
                if d != _SEQ_MARK:
                    idx.setdefault((s, t), (d, v))  # first decision wins
            self._index = idx
            self._scanned_size = size
        return self._index

    async def append(self, shard: int, txn: str, decision: str,
                     version: int) -> None:
        def write() -> None:
            with self._io_lock, self._os_lock():
                self._write_locked(shard, txn, decision, version)

        await asyncio.get_running_loop().run_in_executor(None, write)

    async def decide(self, shard: int, txn: str, decision: str,
                     version: int) -> tuple[str, int]:
        def decide_locked() -> tuple[str, int]:
            with self._io_lock, self._os_lock():
                prior = self._refresh_index_locked().get((shard, txn))
                if prior is not None:
                    return prior
                self._write_locked(shard, txn, decision, version)
                return (decision, version)

        return await asyncio.get_running_loop().run_in_executor(
            None, decide_locked)

    def _read_all(self) -> list[tuple[int, str, str, int]]:
        """Callers must hold ``_io_lock`` — an unlocked read can observe
        a torn half-flushed line from a concurrent append/rewrite."""
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                r = json.loads(line)
                out.append((r["s"], r["t"], r["d"], r["v"]))
        return out

    async def replay(self, shard: int) -> tuple[int, dict[str, tuple[str, int]]]:
        def read():
            with self._io_lock:
                return self._read_all()

        rows = await asyncio.get_running_loop().run_in_executor(None, read)
        return _fold(r for r in rows if r[0] == shard)

    async def rewrite(self, shard: int,
                      live: dict[str, tuple[str, int]], seq: int) -> None:
        def compact() -> None:
            with self._io_lock:  # _read_all is called under the lock here
                keep = [r for r in self._read_all() if r[0] != shard]
                keep.append((shard, "", _SEQ_MARK, seq))
                keep.extend((shard, t, d, v) for t, (d, v) in live.items())
                tmp = self.path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    for s, t, d, v in keep:
                        f.write(json.dumps(
                            {"s": s, "t": t, "d": d, "v": v},
                            separators=(",", ":")) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
                self._index = None  # rebuilt lazily from the new file
                self._scanned_size = -1

        await asyncio.get_running_loop().run_in_executor(None, compact)


class SqliteTransactionLog(TransactionLog):
    """Sqlite-backed log (the AdoNet analog). One connection, WAL mode,
    used from the executor; ``close()`` releases it."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db_lock = threading.Lock()
        with self._db_lock:
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS txn_log ("
                " shard INTEGER, txn TEXT, decision TEXT, version INTEGER)")
            # migration: pre-index databases may hold duplicate (shard,
            # txn) rows from the plain-INSERT era — keep the FIRST record
            # per key (first-decision-wins) or the index creation fails
            self._db.execute(
                "DELETE FROM txn_log WHERE rowid NOT IN"
                " (SELECT MIN(rowid) FROM txn_log GROUP BY shard, txn)")
            # first-decision-wins is enforced by the database itself
            # (decide() uses INSERT OR IGNORE against this index)
            self._db.execute(
                "CREATE UNIQUE INDEX IF NOT EXISTS txn_log_pk"
                " ON txn_log(shard, txn)")
            self._db.commit()

    def close(self) -> None:
        with self._db_lock:
            self._db.close()

    async def append(self, shard: int, txn: str, decision: str,
                     version: int) -> None:
        def write() -> None:
            with self._db_lock:
                self._db.execute(
                    "INSERT OR IGNORE INTO txn_log VALUES (?,?,?,?)",
                    (shard, txn, decision, version))
                self._db.commit()

        await asyncio.get_running_loop().run_in_executor(None, write)

    async def decide(self, shard: int, txn: str, decision: str,
                     version: int) -> tuple[str, int]:
        def decide_tx() -> tuple[str, int]:
            with self._db_lock:
                self._db.execute(
                    "INSERT OR IGNORE INTO txn_log VALUES (?,?,?,?)",
                    (shard, txn, decision, version))
                self._db.commit()
                row = self._db.execute(
                    "SELECT decision, version FROM txn_log"
                    " WHERE shard=? AND txn=?", (shard, txn)).fetchone()
            return (row[0], row[1])

        return await asyncio.get_running_loop().run_in_executor(
            None, decide_tx)

    async def replay(self, shard: int) -> tuple[int, dict[str, tuple[str, int]]]:
        def read():
            with self._db_lock:
                return self._db.execute(
                    "SELECT shard, txn, decision, version FROM txn_log"
                    " WHERE shard=?", (shard,)).fetchall()

        return _fold(await asyncio.get_running_loop().run_in_executor(
            None, read))

    async def rewrite(self, shard: int,
                      live: dict[str, tuple[str, int]], seq: int) -> None:
        def compact() -> None:
            with self._db_lock:
                self._db.execute("DELETE FROM txn_log WHERE shard=?",
                                 (shard,))
                self._db.execute(
                    "INSERT OR IGNORE INTO txn_log VALUES (?,?,?,?)",
                    (shard, "", _SEQ_MARK, seq))
                self._db.executemany(
                    "INSERT OR IGNORE INTO txn_log VALUES (?,?,?,?)",
                    [(shard, t, d, v) for t, (d, v) in live.items()])
                self._db.commit()

        await asyncio.get_running_loop().run_in_executor(None, compact)


def _fold(rows: Iterable[tuple[int, str, str, int]]
          ) -> tuple[int, dict[str, tuple[str, int]]]:
    seq = 0
    decisions: dict[str, tuple[str, int]] = {}
    for _, txn, decision, version in rows:
        if decision == _SEQ_MARK:
            seq = max(seq, version)
            continue
        # FIRST decision wins: decide() guarantees one record per txn,
        # but a legacy log (or a lost cross-process race on a filesystem
        # without flock) may hold duplicates — replay must agree with
        # decide()'s winner, not invert it
        decisions.setdefault(txn, (decision, version))
        seq = max(seq, version)
    return seq, decisions
