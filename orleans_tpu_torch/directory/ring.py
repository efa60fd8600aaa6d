"""Consistent-hash rings (reference L5 support).

Re-design of Orleans' src/Orleans.Runtime/ConsistentRing/:
``ConsistentRingProvider.cs:17`` (one point per silo — directory ownership),
``VirtualBucketsRingProvider.cs:15,29`` (N virtual buckets per silo —
reminder ranges), plus ``RingRange`` (Core/Runtime/RingRange.cs).

Hash space is the 63-bit non-negative range of ``stable_hash64``.

The port's copy of ``orleans_tpu.directory.ring``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Iterable

from ..core.ids import SiloAddress, stable_hash64

__all__ = ["ConsistentRing", "VirtualBucketRing", "EquallyDividedRing",
           "RingRange"]

HASH_SPACE = 1 << 63


@dataclass(frozen=True)
class RingRange:
    """Half-open arc (begin, end] on the ring; wraps modulo HASH_SPACE."""

    begin: int
    end: int

    def contains(self, point: int) -> bool:
        if self.begin == self.end:
            return True  # full ring (single owner)
        if self.begin < self.end:
            return self.begin < point <= self.end
        return point > self.begin or point <= self.end

    @property
    def size(self) -> int:
        return (self.end - self.begin) % HASH_SPACE or HASH_SPACE


class ConsistentRing:
    """One point per silo (ConsistentRingProvider.cs): the owner of a key is
    the first silo clockwise from the key's hash."""

    def __init__(self, silos: Iterable[SiloAddress] = ()):
        self._points: list[tuple[int, SiloAddress]] = []
        for s in silos:
            self.add(s)

    def add(self, silo: SiloAddress) -> None:
        point = silo.uniform_hash
        entry = (point, silo)
        if entry not in self._points:
            bisect.insort(self._points, entry)

    def remove(self, silo: SiloAddress) -> None:
        self._points = [(p, s) for (p, s) in self._points if s != silo]

    def update(self, silos: Iterable[SiloAddress]) -> None:
        self._points = sorted((s.uniform_hash, s) for s in set(silos))

    @property
    def silos(self) -> list[SiloAddress]:
        return [s for _, s in self._points]

    def owner(self, key_hash: int) -> SiloAddress | None:
        """CalculateTargetSilo (LocalGrainDirectory.cs:477-546)."""
        if not self._points:
            return None
        i = bisect.bisect_left(self._points, (key_hash % HASH_SPACE,))
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def my_range(self, silo: SiloAddress) -> RingRange | None:
        """The arc this silo owns: (predecessor, me]."""
        if not self._points:
            return None
        idx = None
        for i, (_, s) in enumerate(self._points):
            if s == silo:
                idx = i
                break
        if idx is None:
            return None
        me = self._points[idx][0]
        pred = self._points[idx - 1][0]  # wraps via [-1]
        return RingRange(pred, me)

    def successors(self, silo: SiloAddress, k: int) -> list[SiloAddress]:
        """k distinct silos clockwise after ``silo`` (probe targets,
        MembershipOracle.cs:741-776)."""
        others = [s for _, s in self._points if s != silo]
        if not others:
            return []
        all_pts = [s for _, s in self._points]
        try:
            i = all_pts.index(silo)
        except ValueError:
            return others[:k]
        ordered = all_pts[i + 1:] + all_pts[:i]
        return [s for s in ordered if s != silo][:k]


class VirtualBucketRing:
    """N virtual points per silo (VirtualBucketsRingProvider.cs:15,29):
    smooths range sizes for reminder partitioning."""

    def __init__(self, buckets_per_silo: int = 30):
        self.buckets_per_silo = buckets_per_silo
        self._points: list[tuple[int, SiloAddress]] = []

    def update(self, silos: Iterable[SiloAddress]) -> None:
        pts = []
        for s in set(silos):
            for b in range(self.buckets_per_silo):
                pts.append((stable_hash64(f"vb|{s.endpoint}|{s.generation}|{b}"), s))
        self._points = sorted(pts)

    def owner(self, key_hash: int) -> SiloAddress | None:
        if not self._points:
            return None
        i = bisect.bisect_left(self._points, (key_hash % HASH_SPACE,))
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def ranges_of(self, silo: SiloAddress) -> list[RingRange]:
        """All arcs owned by ``silo`` (reminder load ranges)."""
        if not self._points:
            return []
        out = []
        for i, (pt, s) in enumerate(self._points):
            if s == silo:
                pred = self._points[i - 1][0]
                out.append(RingRange(pred, pt))
        return out

    def owns(self, silo: SiloAddress, key_hash: int) -> bool:
        return self.owner(key_hash) == silo


class EquallyDividedRing:
    """Exact 1/N split of the hash space over the sorted alive set
    (EquallyDividedRangeRingProvider.cs:10): deterministic equal ranges —
    used by grain services that want uniform load rather than
    hash-positioned arcs. Ranges are derived, not point-based: silo i of N
    (sorted by address) owns [i*SPACE/N, (i+1)*SPACE/N)."""

    def __init__(self, silos: Iterable[SiloAddress] = ()):
        self._silos: list[SiloAddress] = []
        self.update(silos)

    def update(self, silos: Iterable[SiloAddress]) -> None:
        self._silos = sorted(set(silos),
                             key=lambda s: (s.endpoint, s.generation))

    @property
    def silos(self) -> list[SiloAddress]:
        return list(self._silos)

    def _bounds(self, i: int) -> tuple[int, int]:
        n = len(self._silos)
        return (HASH_SPACE * i) // n, (HASH_SPACE * (i + 1)) // n

    def owner(self, key_hash: int) -> SiloAddress | None:
        n = len(self._silos)
        if not n:
            return None
        k = key_hash % HASH_SPACE
        # invert the exact integer split: candidate index then adjust
        i = min((k * n) // HASH_SPACE, n - 1)
        lo, hi = self._bounds(i)
        if k < lo:
            i -= 1
        elif k >= hi:
            i += 1
        return self._silos[i]

    def my_range(self, silo: SiloAddress) -> RingRange | None:
        try:
            i = self._silos.index(silo)
        except ValueError:
            return None
        lo, hi = self._bounds(i)
        # RingRange is (begin, end]: shift the half-open [lo, hi) by -1
        return RingRange((lo - 1) % HASH_SPACE, (hi - 1) % HASH_SPACE)
