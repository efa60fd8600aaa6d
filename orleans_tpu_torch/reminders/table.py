"""Reminder table: durable schedule rows shared by the cluster.

Re-design of Orleans' src/Orleans.Core/SystemTargetInterfaces/
IReminderTable.cs (ReminderEntry/ReminderTableData) and its backends:
InMemoryRemindersTable / MockReminderTable (ReminderService/) for dev-test,
and the SQL pack (src/AdoNet/Orleans.Reminders.AdoNet) → sqlite here.

Rows are keyed (grain, reminder name) and carry an etag for CAS removal;
range reads key off the grain's 64-bit uniform hash (the virtual-bucket
ring partitioning input, VirtualBucketsRingProvider.cs:15).

The port's copy of ``orleans_tpu.reminders.table``.
"""

from __future__ import annotations

import asyncio
import json
import sqlite3
from dataclasses import dataclass, replace

from ..core.ids import GrainCategory, GrainId

__all__ = ["ReminderEntry", "ReminderTable", "InMemoryReminderTable",
           "SqliteReminderTable"]


@dataclass
class ReminderEntry:
    """One durable reminder registration."""

    grain_id: GrainId
    interface_name: str
    name: str
    start_at: float   # unix time of first tick
    period: float     # seconds between ticks
    etag: int = 0

    def copy(self) -> "ReminderEntry":
        return replace(self)

    def to_json(self) -> dict:
        g = self.grain_id
        key = g.key.hex() if isinstance(g.key, bytes) else g.key
        return {
            "cat": int(g.category), "tc": g.type_code, "key": key,
            "kb": isinstance(g.key, bytes), "ext": g.key_ext,
            "iface": self.interface_name, "name": self.name,
            "start": self.start_at, "period": self.period, "etag": self.etag,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ReminderEntry":
        key = bytes.fromhex(d["key"]) if d["kb"] else d["key"]
        gid = GrainId(GrainCategory(d["cat"]), d["tc"], key, d["ext"])
        return cls(gid, d["iface"], d["name"], d["start"], d["period"],
                   d["etag"])


class ReminderTable:
    """Abstract reminder store (IReminderTable)."""

    async def read_all(self) -> list[ReminderEntry]:
        raise NotImplementedError

    async def read_row(self, grain_id: GrainId,
                       name: str) -> ReminderEntry | None:
        raise NotImplementedError

    async def read_grain_rows(self, grain_id: GrainId) -> list[ReminderEntry]:
        raise NotImplementedError

    async def upsert_row(self, entry: ReminderEntry) -> int:
        """Write/overwrite; returns the new etag."""
        raise NotImplementedError

    async def remove_row(self, grain_id: GrainId, name: str,
                         etag: int | None = None) -> bool:
        raise NotImplementedError

    async def delete_table(self) -> None:
        raise NotImplementedError


class InMemoryReminderTable(ReminderTable):
    """Dev/test backend (InMemoryRemindersTable)."""

    def __init__(self) -> None:
        self._rows: dict[tuple[GrainId, str], ReminderEntry] = {}
        self._etag = 0
        self._lock = asyncio.Lock()

    async def read_all(self):
        async with self._lock:
            return [e.copy() for e in self._rows.values()]

    async def read_row(self, grain_id, name):
        async with self._lock:
            e = self._rows.get((grain_id, name))
            return e.copy() if e else None

    async def read_grain_rows(self, grain_id):
        async with self._lock:
            return [e.copy() for (g, _), e in self._rows.items()
                    if g == grain_id]

    async def upsert_row(self, entry):
        async with self._lock:
            self._etag += 1
            entry = entry.copy()
            entry.etag = self._etag
            self._rows[(entry.grain_id, entry.name)] = entry
            return entry.etag

    async def remove_row(self, grain_id, name, etag=None):
        async with self._lock:
            cur = self._rows.get((grain_id, name))
            if cur is None or (etag is not None and cur.etag != etag):
                return False
            del self._rows[(grain_id, name)]
            return True

    async def delete_table(self):
        async with self._lock:
            self._rows.clear()


class SqliteReminderTable(ReminderTable):
    """SQL backend (the AdoNet reminders analog); ``:memory:`` for tests."""

    def __init__(self, path: str) -> None:
        self._db = sqlite3.connect(path)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS reminders ("
            " gkey TEXT NOT NULL, name TEXT NOT NULL, entry TEXT NOT NULL,"
            " etag INTEGER NOT NULL, PRIMARY KEY (gkey, name))")
        self._db.commit()
        self._lock = asyncio.Lock()
        self._etag = 0

    @staticmethod
    def _gkey(grain_id: GrainId) -> str:
        return str(grain_id)

    async def read_all(self):
        async with self._lock:
            rows = self._db.execute("SELECT entry FROM reminders").fetchall()
            return [ReminderEntry.from_json(json.loads(r[0])) for r in rows]

    async def read_row(self, grain_id, name):
        async with self._lock:
            r = self._db.execute(
                "SELECT entry FROM reminders WHERE gkey=? AND name=?",
                (self._gkey(grain_id), name)).fetchone()
            return ReminderEntry.from_json(json.loads(r[0])) if r else None

    async def read_grain_rows(self, grain_id):
        async with self._lock:
            rows = self._db.execute(
                "SELECT entry FROM reminders WHERE gkey=?",
                (self._gkey(grain_id),)).fetchall()
            return [ReminderEntry.from_json(json.loads(r[0])) for r in rows]

    async def upsert_row(self, entry):
        async with self._lock:
            self._etag = self._etag + 1
            entry = entry.copy()
            entry.etag = self._etag
            self._db.execute(
                "INSERT INTO reminders (gkey, name, entry, etag)"
                " VALUES (?,?,?,?)"
                " ON CONFLICT (gkey, name) DO UPDATE SET entry=excluded.entry,"
                " etag=excluded.etag",
                (self._gkey(entry.grain_id), entry.name,
                 json.dumps(entry.to_json()), entry.etag))
            self._db.commit()
            return entry.etag

    async def remove_row(self, grain_id, name, etag=None):
        async with self._lock:
            if etag is None:
                cur = self._db.execute(
                    "DELETE FROM reminders WHERE gkey=? AND name=?",
                    (self._gkey(grain_id), name))
            else:
                cur = self._db.execute(
                    "DELETE FROM reminders WHERE gkey=? AND name=? AND etag=?",
                    (self._gkey(grain_id), name, etag))
            self._db.commit()
            return cur.rowcount == 1

    async def delete_table(self):
        async with self._lock:
            self._db.execute("DELETE FROM reminders")
            self._db.commit()
