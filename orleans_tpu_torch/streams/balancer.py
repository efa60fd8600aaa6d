"""Stream queue balancers: queue→silo assignment strategies.

Re-design of Orleans' src/Orleans.Runtime/Streams/QueueBalancer/:
``DeploymentBasedQueueBalancer.cs:40`` (membership-driven deterministic
assignment), ``BestFitBalancer.cs`` (even-count distribution),
``LeaseBasedQueueBalancer.cs:80`` (lease-table ownership with TTL renewal —
there backed by Azure blob leases; here a pluggable LeaseProvider with an
in-memory dev implementation, the MemoryQueueAdapter analog).

The port's copy of ``orleans_tpu.streams.balancer``.
"""

from __future__ import annotations

import time
from typing import Protocol

from ..core.ids import SiloAddress, stable_hash64

__all__ = [
    "QueueBalancer", "DeploymentBasedBalancer", "BestFitBalancer",
    "LeaseProvider", "MemoryLeaseProvider", "LeaseBasedBalancer",
]


class QueueBalancer(Protocol):
    """Strategy deciding which of ``n_queues`` this silo should pump.
    Deterministic balancers need no coordination (every silo computes the
    same mapping from the shared membership view); lease-based balancers
    coordinate through an external lease store."""

    async def owned_queues(self, n_queues: int, adapter_name: str,
                           me: SiloAddress,
                           alive: list[SiloAddress]) -> set[int]: ...

    def close(self, me: SiloAddress) -> None: ...


class DeploymentBasedBalancer:
    """Rendezvous (highest-random-weight) hashing over the alive set
    (DeploymentBasedQueueBalancer.cs:40): deterministic, membership-driven,
    minimal churn on join/leave."""

    async def owned_queues(self, n_queues, adapter_name, me, alive):
        if not alive:
            return set()
        return {
            q for q in range(n_queues)
            if min(alive, key=lambda s: stable_hash64(
                f"qb|{adapter_name}|{q}|{s.endpoint}|{s.generation}")) == me}

    def close(self, me: SiloAddress) -> None:  # noqa: B027
        pass


class BestFitBalancer:
    """Strictly even distribution (BestFitBalancer.cs): sort silos and
    queues deterministically and give each silo a contiguous ⌈n/k⌉/⌊n/k⌋
    block. Guarantees per-silo counts differ by at most one — tighter than
    rendezvous hashing — at the cost of more reassignment churn."""

    async def owned_queues(self, n_queues, adapter_name, me, alive):
        if not alive or me not in alive:
            return set()
        ranked = sorted(alive, key=lambda s: (s.endpoint, s.generation))
        k = len(ranked)
        idx = ranked.index(me)
        base, extra = divmod(n_queues, k)
        start = idx * base + min(idx, extra)
        count = base + (1 if idx < extra else 0)
        return set(range(start, start + count))

    def close(self, me: SiloAddress) -> None:  # noqa: B027
        pass


# ---------------------------------------------------------------------------
# Lease-based balancing
# ---------------------------------------------------------------------------

class LeaseProvider(Protocol):
    """External lease store (the ILeaseProvider analog). All silos of a
    cluster must share one store (like a blob container)."""

    def try_acquire(self, key: str, owner: str, ttl: float) -> bool: ...

    def renew(self, key: str, owner: str, ttl: float) -> bool: ...

    def release(self, key: str, owner: str) -> None: ...


class MemoryLeaseProvider:
    """In-proc shared lease table for dev/test clusters."""

    def __init__(self) -> None:
        self._leases: dict[str, tuple[str, float]] = {}  # key -> (owner, expiry)

    def try_acquire(self, key: str, owner: str, ttl: float) -> bool:
        now = time.monotonic()
        cur = self._leases.get(key)
        if cur is not None and cur[1] > now and cur[0] != owner:
            return False
        self._leases[key] = (owner, now + ttl)
        return True

    def renew(self, key: str, owner: str, ttl: float) -> bool:
        cur = self._leases.get(key)
        if cur is None or cur[0] != owner:
            return False
        self._leases[key] = (owner, time.monotonic() + ttl)
        return True

    def release(self, key: str, owner: str) -> None:
        cur = self._leases.get(key)
        if cur is not None and cur[0] == owner:
            self._leases.pop(key, None)


class LeaseBasedBalancer:
    """Lease-table ownership (LeaseBasedQueueBalancer.cs:80): each silo
    tries to hold leases on its fair share of queues; leases expire on silo
    death without any membership round-trip, so queues fail over even if the
    membership oracle lags. Called from the pulling manager's rebalance
    loop, which doubles as the renewal timer."""

    def __init__(self, provider: LeaseProvider, ttl: float = 10.0):
        self.provider = provider
        self.ttl = ttl
        self._held: set[str] = set()

    @staticmethod
    def _owner_id(me: SiloAddress) -> str:
        return f"{me.endpoint}@{me.generation}"

    async def owned_queues(self, n_queues, adapter_name, me, alive):
        owner = self._owner_id(me)
        target = -(-n_queues // max(1, len(alive)))  # fair share, rounded up
        owned: set[int] = set()
        # renew current leases first — losing a held lease mid-stream is the
        # expensive case (another silo starts pumping the same queue)
        for q in range(n_queues):
            key = f"{adapter_name}/{q}"
            if key in self._held:
                if self.provider.renew(key, owner, self.ttl):
                    owned.add(q)
                else:
                    self._held.discard(key)
        # then top up to the fair share from unleased queues
        for q in range(n_queues):
            if len(owned) >= target:
                break
            key = f"{adapter_name}/{q}"
            if q not in owned and self.provider.try_acquire(
                    key, owner, self.ttl):
                self._held.add(key)
                owned.add(q)
        # over-target shedding: give up excess leases so late joiners get
        # their share
        if len(owned) > target:
            for q in sorted(owned, reverse=True)[:len(owned) - target]:
                key = f"{adapter_name}/{q}"
                self.provider.release(key, owner)
                self._held.discard(key)
                owned.discard(q)
        return owned

    def close(self, me: SiloAddress) -> None:
        owner = self._owner_id(me)
        for key in list(self._held):
            self.provider.release(key, owner)
        self._held.clear()
