"""Cluster membership table: shared CAS store of silo liveness rows.

Re-design of Orleans' src/Orleans.Core/SystemTargetInterfaces/
IMembershipTable.cs:14 (etag-CAS rows + monotonically versioned table) and its
backends: InMemoryMembershipTable (MembershipService/InMemoryMembershipTable.cs),
the AdoNet SQL table (src/AdoNet/Orleans.Clustering.AdoNet → sqlite here), and
a file-backed table standing in for the other external stores (Azure/ZooKeeper/
Consul — same contract, different durability substrate).

The contract (exercised uniformly by tests, mirroring
test/TesterInternal/MembershipTests/MembershipTableTestsBase.cs):
  - ``read_all`` returns every row with its etag plus the table version
  - ``insert_row``/``update_row`` are compare-and-swap on (row etag, table
    version); losers must re-read and retry
  - ``update_iam_alive`` is a non-CAS heartbeat-timestamp fast path
"""

from __future__ import annotations

import asyncio
import contextlib
import fcntl
import json
import os
import sqlite3
import time
from dataclasses import dataclass, field, replace

from ..core.ids import SiloAddress

__all__ = [
    "SiloStatus", "MembershipEntry", "TableVersion", "TableSnapshot",
    "MembershipTable", "InMemoryMembershipTable", "FileMembershipTable",
    "SqliteMembershipTable",
]


class SiloStatus:
    """Silo lifecycle states (SiloStatus enum in the reference)."""

    CREATED = "Created"
    JOINING = "Joining"
    ACTIVE = "Active"
    SHUTTING_DOWN = "ShuttingDown"
    DEAD = "Dead"


@dataclass
class MembershipEntry:
    """One silo's row (MembershipEntry in IMembershipTable.cs)."""

    address: SiloAddress
    status: str = SiloStatus.CREATED
    # suspicion votes: (voter endpoint string, unix timestamp)
    suspect_times: list[tuple[str, float]] = field(default_factory=list)
    start_time: float = 0.0
    iam_alive_time: float = 0.0

    def fresh_votes(self, expiry: float, now: float) -> list[tuple[str, float]]:
        return [(v, t) for v, t in self.suspect_times if now - t <= expiry]

    def copy(self) -> "MembershipEntry":
        return replace(self, suspect_times=list(self.suspect_times))

    # -- json round-trip (file/sqlite backends) -------------------------
    def to_json(self) -> dict:
        a = self.address
        return {
            "host": a.host, "port": a.port, "gen": a.generation,
            "mesh": a.mesh_index, "status": self.status,
            "suspects": self.suspect_times, "start": self.start_time,
            "alive": self.iam_alive_time,
        }

    @classmethod
    def from_json(cls, d: dict) -> "MembershipEntry":
        return cls(
            address=SiloAddress(d["host"], d["port"], d["gen"], d["mesh"]),
            status=d["status"],
            suspect_times=[(v, t) for v, t in d["suspects"]],
            start_time=d["start"], iam_alive_time=d["alive"],
        )


@dataclass(frozen=True)
class TableVersion:
    """Whole-table version + etag: CAS token for structural changes."""

    version: int = 0
    etag: str = "0"

    def next(self) -> "TableVersion":
        return TableVersion(self.version + 1, str(self.version + 1))


@dataclass
class TableSnapshot:
    """Result of read_all: rows with etags + the table version."""

    entries: list[tuple[MembershipEntry, str]]
    version: TableVersion

    def get(self, address: SiloAddress) -> tuple[MembershipEntry, str] | None:
        for e, tag in self.entries:
            if e.address == address:
                return e, tag
        return None


class MembershipTable:
    """Abstract CAS membership table (IMembershipTable.cs:14)."""

    async def read_all(self) -> TableSnapshot:
        raise NotImplementedError

    async def insert_row(self, entry: MembershipEntry,
                         version: TableVersion) -> bool:
        raise NotImplementedError

    async def update_row(self, entry: MembershipEntry, etag: str,
                         version: TableVersion) -> bool:
        raise NotImplementedError

    async def update_iam_alive(self, address: SiloAddress, ts: float) -> None:
        raise NotImplementedError

    async def delete_table(self) -> None:
        raise NotImplementedError


class InMemoryMembershipTable(MembershipTable):
    """Dev/test backend (InMemoryMembershipTable.cs:89): one shared object,
    atomic by virtue of the single event loop + a lock for safety."""

    def __init__(self) -> None:
        self._rows: dict[str, tuple[MembershipEntry, int]] = {}
        self._version = TableVersion()
        self._etag_counter = 0
        self._lock = asyncio.Lock()

    @staticmethod
    def _key(address: SiloAddress) -> str:
        return f"{address.endpoint}@{address.generation}"

    async def read_all(self) -> TableSnapshot:
        async with self._lock:
            return TableSnapshot(
                entries=[(e.copy(), str(tag))
                         for e, tag in self._rows.values()],
                version=self._version)

    async def insert_row(self, entry, version) -> bool:
        async with self._lock:
            if version.version != self._version.version + 1:
                return False
            key = self._key(entry.address)
            if key in self._rows:
                return False
            self._etag_counter += 1
            self._rows[key] = (entry.copy(), self._etag_counter)
            self._version = version
            return True

    async def update_row(self, entry, etag, version) -> bool:
        async with self._lock:
            if version.version != self._version.version + 1:
                return False
            key = self._key(entry.address)
            cur = self._rows.get(key)
            if cur is None or str(cur[1]) != etag:
                return False
            self._etag_counter += 1
            self._rows[key] = (entry.copy(), self._etag_counter)
            self._version = version
            return True

    async def update_iam_alive(self, address, ts) -> None:
        async with self._lock:
            cur = self._rows.get(self._key(address))
            if cur is not None:
                cur[0].iam_alive_time = ts

    async def delete_table(self) -> None:
        async with self._lock:
            self._rows.clear()
            self._version = TableVersion()


class FileMembershipTable(MembershipTable):
    """JSON-file backend: whole-file read-modify-write under an OS file lock.
    Stands in for the reference's external-store tables (Azure/ZooKeeper/
    Consul clustering packs) for single-host multi-process deployments.

    The port's copy holds an ``flock`` on ``<path>.lock`` around every
    read-modify-write, so the CAS holds across processes (the workers of a
    multi-process silo write the owner's table): the JAX package's copy
    locks only within one process and writes one ``<path>.tmp`` from every
    process, so writes from two processes interleaved in it and a CAS
    insert could be lost."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = asyncio.Lock()

    @contextlib.contextmanager
    def _os_lock(self):
        fd = os.open(self.path + ".lock", os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # releases the lock

    def _load(self) -> tuple[dict, TableVersion]:
        if not os.path.exists(self.path):
            return {}, TableVersion()
        with open(self.path) as f:
            raw = json.load(f)
        rows = {k: (MembershipEntry.from_json(v["entry"]), v["etag"])
                for k, v in raw["rows"].items()}
        return rows, TableVersion(raw["version"], raw["etag"])

    def _store(self, rows: dict, version: TableVersion) -> None:
        raw = {
            "rows": {k: {"entry": e.to_json(), "etag": tag}
                     for k, (e, tag) in rows.items()},
            "version": version.version, "etag": version.etag,
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(raw, f)
        os.replace(tmp, self.path)

    @staticmethod
    def _key(address: SiloAddress) -> str:
        return f"{address.endpoint}@{address.generation}"

    async def read_all(self) -> TableSnapshot:
        async with self._lock:
            with self._os_lock():
                rows, version = self._load()
            return TableSnapshot(
                entries=[(e, str(tag)) for e, tag in rows.values()],
                version=version)

    async def insert_row(self, entry, version) -> bool:
        async with self._lock:
            with self._os_lock():
                rows, cur = self._load()
                key = self._key(entry.address)
                if version.version != cur.version + 1 or key in rows:
                    return False
                rows[key] = (entry, int(time.time_ns()))
                self._store(rows, version)
                return True

    async def update_row(self, entry, etag, version) -> bool:
        async with self._lock:
            with self._os_lock():
                rows, cur = self._load()
                key = self._key(entry.address)
                existing = rows.get(key)
                if (version.version != cur.version + 1 or existing is None
                        or str(existing[1]) != etag):
                    return False
                rows[key] = (entry, int(time.time_ns()))
                self._store(rows, version)
                return True

    async def update_iam_alive(self, address, ts) -> None:
        async with self._lock:
            with self._os_lock():
                rows, version = self._load()
                cur = rows.get(self._key(address))
                if cur is not None:
                    cur[0].iam_alive_time = ts
                    self._store(rows, version)

    async def delete_table(self) -> None:
        async with self._lock:
            with self._os_lock():
                if os.path.exists(self.path):
                    os.remove(self.path)


class SqliteMembershipTable(MembershipTable):
    """SQL backend over sqlite3: real conditional-UPDATE CAS, the AdoNet
    clustering analog (src/AdoNet/Orleans.Clustering.AdoNet). Safe for
    multi-process single-host clusters; ``:memory:`` works for tests."""

    def __init__(self, path: str) -> None:
        self._db = sqlite3.connect(path)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS membership ("
            " key TEXT PRIMARY KEY, entry TEXT NOT NULL, etag INTEGER)")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS version (id INTEGER PRIMARY KEY"
            " CHECK (id = 0), version INTEGER)")
        self._db.execute(
            "INSERT OR IGNORE INTO version (id, version) VALUES (0, 0)")
        self._db.commit()
        self._lock = asyncio.Lock()

    @staticmethod
    def _key(address: SiloAddress) -> str:
        return f"{address.endpoint}@{address.generation}"

    def _table_version(self) -> int:
        return self._db.execute(
            "SELECT version FROM version WHERE id=0").fetchone()[0]

    def _bump_version(self, expected_next: int) -> bool:
        cur = self._db.execute(
            "UPDATE version SET version=? WHERE id=0 AND version=?",
            (expected_next, expected_next - 1))
        return cur.rowcount == 1

    async def read_all(self) -> TableSnapshot:
        async with self._lock:
            rows = self._db.execute(
                "SELECT entry, etag FROM membership").fetchall()
            v = self._table_version()
            return TableSnapshot(
                entries=[(MembershipEntry.from_json(json.loads(e)), str(tag))
                         for e, tag in rows],
                version=TableVersion(v, str(v)))

    async def insert_row(self, entry, version) -> bool:
        async with self._lock:
            if not self._bump_version(version.version):
                self._db.rollback()
                return False
            try:
                self._db.execute(
                    "INSERT INTO membership (key, entry, etag) VALUES (?,?,1)",
                    (self._key(entry.address), json.dumps(entry.to_json())))
            except sqlite3.IntegrityError:
                self._db.rollback()
                return False
            self._db.commit()
            return True

    async def update_row(self, entry, etag, version) -> bool:
        async with self._lock:
            if not self._bump_version(version.version):
                self._db.rollback()
                return False
            cur = self._db.execute(
                "UPDATE membership SET entry=?, etag=etag+1"
                " WHERE key=? AND etag=?",
                (json.dumps(entry.to_json()), self._key(entry.address),
                 int(etag)))
            if cur.rowcount != 1:
                self._db.rollback()
                return False
            self._db.commit()
            return True

    async def update_iam_alive(self, address, ts) -> None:
        async with self._lock:
            row = self._db.execute(
                "SELECT entry FROM membership WHERE key=?",
                (self._key(address),)).fetchone()
            if row is None:
                return
            entry = MembershipEntry.from_json(json.loads(row[0]))
            entry.iam_alive_time = ts
            self._db.execute(
                "UPDATE membership SET entry=? WHERE key=?",
                (json.dumps(entry.to_json()), self._key(address)))
            self._db.commit()

    async def delete_table(self) -> None:
        async with self._lock:
            self._db.execute("DELETE FROM membership")
            self._db.execute("UPDATE version SET version=0 WHERE id=0")
            self._db.commit()
