"""Adaptive grain-directory cache: per-entry TTLs that adapt on
hit/invalidation, plus a maintainer that refreshes hot entries.

Re-design of Orleans' src/Orleans.Runtime/GrainDirectory/
``AdaptiveGrainDirectoryCache.cs:178`` (entries carry a TTL that DOUBLES
each time a lookup re-validates the same answer and resets when the entry
proves wrong) and ``AdaptiveDirectoryCacheMaintainer.cs:243`` (a periodic
sweep batches owner lookups for recently-accessed entries so hot routes
stay fresh instead of paying staleness in forward hops).

Departures: eviction is LRU-bounded like the rest of the repo's caches
(the reference's maintainer also drops untouched entries; LRU subsumes
that), and the maintainer refreshes entries that were ACCESSED since the
last sweep and are expired or expiring within one period — cold entries
cost nothing until traffic returns.

The port's copy of ``orleans_tpu.directory.adaptive_cache``.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable

__all__ = ["AdaptiveDirectoryCache"]


class _Entry:
    __slots__ = ("silo", "ttl", "expires")

    def __init__(self, silo, ttl: float, now: float):
        self.silo = silo
        self.ttl = ttl
        self.expires = now + ttl


class AdaptiveDirectoryCache:
    """Bounded LRU of grain → silo with adaptive per-entry TTLs.

    API shape matches how the locator used its plain OrderedDict
    (get/pop/items/len) so it drops in; ``put`` and ``sweep`` carry the
    adaptive behavior."""

    def __init__(self, size: int, initial_ttl: float = 5.0,
                 max_ttl: float = 120.0,
                 clock: Callable[[], float] = time.monotonic):
        self.size = size
        self.initial_ttl = initial_ttl
        self.max_ttl = max_ttl
        self.clock = clock
        self._d: collections.OrderedDict[Any, _Entry] = \
            collections.OrderedDict()
        # gids touched since the last sweep: the maintainer iterates THIS
        # (O(recent traffic)), never the full cache (O(cache_size) per
        # period would burn the single-core event loop while idle)
        self._accessed: set = set()
        self.hits = 0
        self.expired_hits = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, gid) -> bool:
        return gid in self._d

    def get(self, gid):
        """The cached silo, or None when absent OR past its TTL (an
        expired entry reads as a miss — the caller re-resolves and put()
        re-arms it — but stays resident so the maintainer sees it was
        wanted)."""
        e = self._d.get(gid)
        if e is None:
            return None
        # bounded even when no maintainer drains it (refresh period 0):
        # distinct-gid traffic must not grow the set past the cache
        # itself. Clear only when a NEW gid would exceed the bound — a
        # steady-state working set of exactly `size` hot gids must keep
        # its marks or the maintainer would never see them at sweep time
        if gid not in self._accessed and len(self._accessed) >= self.size:
            self._accessed.clear()
        self._accessed.add(gid)
        if self.clock() >= e.expires:
            self.expired_hits += 1
            return None
        self.hits += 1
        self._d.move_to_end(gid)
        return e.silo

    def put(self, gid, silo) -> None:
        """Adaptive arm: re-confirming the SAME answer doubles the TTL
        (up to max); a new/changed answer starts at the initial TTL —
        exactly the reference's AddOrUpdate semantics."""
        now = self.clock()
        e = self._d.get(gid)
        if e is not None and e.silo == silo:
            e.ttl = min(e.ttl * 2, self.max_ttl)
            e.expires = now + e.ttl
        else:
            self._d[gid] = _Entry(silo, self.initial_ttl, now)
        self._d.move_to_end(gid)
        while len(self._d) > self.size:
            self._d.popitem(last=False)

    def valid_silo(self, gid):
        """TTL-checked entry WITHOUT the hit/access/LRU bookkeeping — the
        dispatcher's catalog-first guard calls this per message, and the
        expired→miss contract is what bounds a usurped duplicate to one
        TTL (the fall-through slow path re-resolves and re-arms); the
        bookkeeping belongs to the resolution path, not the guard."""
        e = self._d.get(gid)
        if e is None or self.clock() >= e.expires:
            return None
        return e.silo

    def pop(self, gid, default=None):
        e = self._d.pop(gid, None)
        return default if e is None else e.silo

    def items(self):
        return [(gid, e.silo) for gid, e in self._d.items()]

    # -- maintainer support ------------------------------------------------
    def sweep_candidates(self, horizon: float) -> list:
        """Entries touched since the last sweep that are expired or will
        expire within ``horizon`` seconds — the refresh set. Consumes the
        accessed marks (each sweep sees only NEW traffic)."""
        now = self.clock()
        touched, self._accessed = self._accessed, set()
        out = []
        for gid in touched:
            e = self._d.get(gid)
            if e is not None and e.expires <= now + horizon:
                out.append(gid)
        return out

    def refresh_result(self, gid, silo) -> None:
        """Fold one owner answer from the maintainer: same silo → TTL
        doubles; different silo → replace at initial TTL; None (no
        registration — the grain deactivated) → drop."""
        if silo is None:
            self._d.pop(gid, None)
        else:
            self.put(gid, silo)
