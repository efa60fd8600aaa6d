"""Pooled queue cache: cursor-based batch cache with backpressure.

Re-design of Orleans' src/OrleansProviders/Streams/Common/PooledCache/
``PooledQueueCache.cs:386`` (cursor iteration over cached message blocks) and
``SimpleCache/SimpleQueueCache.cs:328`` (bounded cache + under-pressure
signal). Each pulling agent owns one cache: pulled batches are appended once
and consumed by any number of per-consumer cursors at independent speeds; a
batch is evicted (and acked upstream) only once every cursor has passed it;
the pull loop pauses while the cache is under pressure — slow consumers
throttle the pull instead of forcing redelivery.

The port's copy of ``orleans_tpu.streams.cache``.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Any

__all__ = ["CachedBatch", "QueueCacheCursor", "PooledQueueCache"]


@dataclass
class CachedBatch:
    """One cached queue batch + delivery bookkeeping."""

    batch: Any  # QueueBatch
    token: int  # monotonically increasing cache position


@dataclass
class QueueCacheCursor:
    """One consumer's read position (the IQueueCacheCursor analog)."""

    consumer_key: Any
    next_token: int
    invalidated: bool = field(default=False)


class PooledQueueCache:
    """Bounded FIFO of batches with multi-cursor consumption."""

    def __init__(self, capacity: int = 256,
                 pressure_threshold: float = 0.75):
        self.capacity = capacity
        self.pressure_threshold = pressure_threshold
        self._items: collections.deque[CachedBatch] = collections.deque()
        self._next_token = 0
        self.cursors: dict[Any, QueueCacheCursor] = {}
        # streams whose consumer view the agent has resolved (with or
        # without consumers). Batches of an UNRESOLVED stream pin the
        # eviction floor: their pump/cursor may simply not exist yet, and
        # evicting them would silently drop events (the bug class this
        # guards: pressure-branch purge racing the first consumer
        # refresh). Maintained by the pulling agent.
        self.resolved_streams: set = set()

    # -- write side --------------------------------------------------------
    def add(self, batch: Any) -> CachedBatch:
        cb = CachedBatch(batch=batch, token=self._next_token)
        self._next_token += 1
        self._items.append(cb)
        return cb

    @property
    def under_pressure(self) -> bool:
        """SimpleQueueCache's IsUnderPressure: the pull loop must pause when
        the slowest cursor lags this far behind."""
        return len(self._items) >= self.capacity * self.pressure_threshold

    @property
    def count(self) -> int:
        return len(self._items)

    @property
    def write_token(self) -> int:
        """The token the NEXT added batch will take — the write head a
        cursor-lag gauge measures against (tokens are contiguous, so
        ``write_token - cursor.next_token`` is the lag in batches)."""
        return self._next_token

    def cached_streams(self) -> set:
        """Distinct stream ids with batches still cached."""
        return {cb.batch.stream for cb in self._items}

    # -- cursor side -------------------------------------------------------
    def new_cursor(self, consumer_key: Any,
                   from_oldest: bool = True) -> QueueCacheCursor:
        """Create (or reset) a consumer cursor. ``from_oldest`` starts at the
        oldest cached batch; otherwise at the next batch to arrive."""
        if from_oldest and self._items:
            token = self._items[0].token
        else:
            token = self._next_token
        cur = QueueCacheCursor(consumer_key=consumer_key, next_token=token)
        self.cursors[consumer_key] = cur
        return cur

    def remove_cursor(self, consumer_key: Any) -> None:
        self.cursors.pop(consumer_key, None)

    def next(self, cursor: QueueCacheCursor) -> CachedBatch | None:
        """The batch at the cursor, advancing it; None when drained.
        Tokens are contiguous, so the deque position is head-relative
        arithmetic — O(1), not a scan."""
        if cursor.invalidated or not self._items:
            return None
        head = self._items[0].token
        idx = max(0, cursor.next_token - head)
        if idx >= len(self._items):
            return None
        cb = self._items[idx]
        cursor.next_token = cb.token + 1
        return cb

    # -- eviction ----------------------------------------------------------
    def purge(self) -> list[Any]:
        """Evict batches every live cursor has passed; returns the evicted
        batches (the agent acks them upstream). A stream the agent has not
        yet resolved consumers for pins the floor at its oldest batch —
        see ``resolved_streams``. With no cursors and everything resolved
        the cache drains fully — no consumers means nothing to wait for."""
        if self.cursors:
            low = min(c.next_token for c in self.cursors.values())
        else:
            low = self._next_token
        for cb in self._items:
            if cb.token >= low:
                break
            if cb.batch.stream not in self.resolved_streams:
                # tokens are ordered: the first unresolved batch is the floor
                low = cb.token
                break
        evicted = []
        while self._items and self._items[0].token < low:
            evicted.append(self._items.popleft().batch)
        return evicted
