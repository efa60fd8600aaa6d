"""Rebalance planner: cluster load view → batched migration plan.

Each silo plans ONLY for itself as a source (the decentralized shape of
Orleans's activation repartitioning: every silo drains its own excess, no
global coordinator), across both tiers:

* **host tier** — when this silo's activation count exceeds the cluster
  mean by the configured hysteresis ratio, pick migration victims and a
  destination per victim through ``placement.strategies`` directors
  (``ActivationCountPlacement`` full scan, fed the planned loads so one
  round doesn't dogpile a single receiver).
* **device tier** — when one mesh shard's on-device hit counters run hot,
  drain its hottest hashed-regime rows toward cool shards. The candidate →
  destination assignment is packed with ``ops.route.pack_by_dest`` (the
  same prefix-count pack the tick exchange uses: K2 on a CUDA table):
  per-destination buckets, capacity = the round budget, overflow dropped
  and counted — budget enforcement IS the pack's overflow semantics.

This is the redistribution-planning half of "Memory-efficient array
redistribution through portable collective communication" (PAPERS.md)
applied to an actor table: plan on the host at planner rate, execute as
batched device copies.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..placement.strategies import ActivationCountPlacement
from .telemetry import hot_hashed_keys

__all__ = ["ActivationMove", "ShardMoves", "MigrationPlan",
           "RebalancePlanner"]


@dataclass
class ActivationMove:
    """One host-tier move: a local activation → a peer silo."""

    act: object           # runtime.activation.ActivationData
    dest: object          # SiloAddress


@dataclass
class ShardMoves:
    """Device-tier moves for one VectorGrain class (already packed and
    budget-bounded)."""

    cls: type
    keys: np.ndarray          # [M] int64 hashed key hashes
    dest_shards: np.ndarray   # [M] int32
    dropped: int = 0          # candidates beyond the per-round budget


@dataclass
class MigrationPlan:
    activation_moves: list[ActivationMove] = field(default_factory=list)
    shard_moves: list[ShardMoves] = field(default_factory=list)
    imbalance: float = 0.0    # observed hot/mean load ratio this round

    def __bool__(self) -> bool:
        return bool(self.activation_moves or self.shard_moves)

    @property
    def total(self) -> int:
        return len(self.activation_moves) + sum(
            len(m.keys) for m in self.shard_moves)


class RebalancePlanner:
    def __init__(self, silo, budget: int | None = None,
                 imbalance_ratio: float | None = None):
        self.silo = silo
        self.budget = budget if budget is not None \
            else silo.config.rebalance_budget
        self.imbalance_ratio = imbalance_ratio if imbalance_ratio is not None \
            else silo.config.rebalance_imbalance_ratio

    # ------------------------------------------------------------------
    def plan(self) -> MigrationPlan:
        plan = MigrationPlan()
        self._plan_activation_moves(plan)
        self._plan_ledger_moves(plan)
        self._plan_shard_moves(plan)
        return plan

    # -- host tier -------------------------------------------------------
    def _peer_loads(self) -> tuple[dict, dict]:
        """(activation counts, queue depths) per alive peer: the
        publisher's broadcast view when fresh, the in-proc fabric catalog
        read as fallback (the same two-source discipline as
        DistributedLocator._load_of). Queue depth is the secondary signal:
        the hysteresis and move count stay in activation-count units, but
        a backlogged peer is a worse destination than its count implies."""
        me = self.silo.silo_address
        publisher = getattr(self.silo, "load_publisher", None)
        loads, depths = {}, {}
        for s in self.silo.locator.alive_list:
            if s == me:
                continue
            report = publisher.report_of(s) if publisher is not None else None
            if report is not None:
                loads[s] = report["activation_count"]
                depths[s] = report.get("queue_depth", 0)
                continue
            peer = getattr(self.silo.fabric, "silos", {}).get(s)
            if peer is not None and peer.status == "Running":
                from .telemetry import queue_depth
                loads[s] = peer.catalog.activation_count()
                depths[s] = queue_depth(peer)
        return loads, depths

    def _victims(self, n: int) -> list:
        """Local activations cheapest to move, idle-first: VALID
        application grains with no timers (timer continuity across a move
        is a follow-on — a fence would silently kill them today) and no
        in-flight activation work."""
        from ..runtime.activation import ActivationState

        out = []
        for act in self.silo.catalog.by_activation.values():
            if act.grain_id.is_system_target():
                continue
            if act.state != ActivationState.VALID:
                continue
            if act.is_stateless_worker or act.timers:
                continue
            if act.activating_backlog:
                continue
            out.append(act)
        # idle activations first (nothing to drain), longest-idle first
        out.sort(key=lambda a: (not a.is_inactive, -a.idle_for()))
        return out[:n]

    def _plan_activation_moves(self, plan: MigrationPlan) -> None:
        peers, depths = self._peer_loads()
        if not peers:
            return
        my_load = self.silo.catalog.activation_count()
        mean = (my_load + sum(peers.values())) / (len(peers) + 1)
        if mean > 0:
            plan.imbalance = max(plan.imbalance, my_load / mean)
        if my_load <= self.imbalance_ratio * mean or \
                my_load - min(peers.values()) < 2:
            return
        n = min(self.budget, my_load - math.ceil(mean))
        if n <= 0:
            return
        # destination per victim through the placement director, fed the
        # PLANNED loads (each assignment bumps its target) so one round's
        # moves spread instead of dogpiling the single coldest peer; a
        # peer's queue depth rides along as a penalty so a count-cold but
        # backlogged silo is not the automatic winner
        planned = dict(peers)
        director = ActivationCountPlacement(
            lambda s: planned.get(s, 1 << 30) + depths.get(s, 0))
        candidates = list(planned)
        for act in self._victims(n):
            dest = director.place(act.grain_id, self.silo.silo_address,
                                  candidates)
            if planned[dest] + 1 >= my_load - len(plan.activation_moves):
                break  # moving further would just invert the imbalance
            planned[dest] += 1
            plan.activation_moves.append(ActivationMove(act, dest))

    def _plan_ledger_moves(self, plan: MigrationPlan) -> None:
        """Host-tier HOT-ACTOR moves from the cost ledger
        (``RebalanceOptions.use_ledger``): activation counts say WHERE
        activations live, the ledger says WHO is burning — a silo whose
        counts look balanced can still host the cluster's hottest keys,
        and the count-based pass above will never move them. Keys whose
        charged seconds exceed the imbalance ratio × the tracked mean
        become migration candidates toward the coolest peers, sharing
        the round's move budget with (and deduped against) the
        count-based pass. The label scheme is EXACTLY the dispatcher's
        charge key ("Class/key"), so resolution back to a local
        activation is a dict lookup, not a scan per label."""
        if not getattr(self.silo.config, "rebalance_use_ledger", False):
            return
        led = getattr(self.silo, "ledger", None)
        if led is None or not led.keys.counts:
            return
        budget = self.budget - len(plan.activation_moves)
        if budget <= 0:
            return
        peers, depths = self._peer_loads()
        if not peers:
            return
        ranked = led.keys.top()
        mean = sum(r[1] for r in ranked) / len(ranked)
        if mean <= 0:
            return
        hot_labels = [label for label, seconds, _err in ranked
                      if seconds > self.imbalance_ratio * mean]
        if not hot_labels:
            return
        from ..runtime.activation import ActivationState

        already = {id(m.act) for m in plan.activation_moves}
        by_label: dict[str, object] = {}
        for act in self.silo.catalog.by_activation.values():
            gid = act.grain_id
            if gid.is_system_target() or \
                    act.state != ActivationState.VALID:
                continue
            if act.is_stateless_worker or act.timers or \
                    act.activating_backlog or id(act) in already:
                continue
            by_label[f"{act.grain_class.__name__}/{gid.key}"] = act
        planned = dict(peers)
        for m in plan.activation_moves:
            planned[m.dest] = planned.get(m.dest, 0) + 1
        director = ActivationCountPlacement(
            lambda s: planned.get(s, 1 << 30) + depths.get(s, 0))
        candidates = list(planned)
        for label in hot_labels:
            if budget <= 0:
                break
            act = by_label.get(label)
            if act is None:
                continue  # remote, device-tier, or not movable here
            dest = director.place(act.grain_id, self.silo.silo_address,
                                  candidates)
            planned[dest] += 1
            plan.activation_moves.append(ActivationMove(act, dest))
            budget -= 1

    # -- device tier -----------------------------------------------------
    def _plan_shard_moves(self, plan: MigrationPlan) -> None:
        rt = getattr(self.silo, "vector", None)
        if rt is None or not rt.track_load:
            return
        for cls, tbl in rt.tables.items():
            if tbl.n_shards < 2 or not tbl.key_to_slot:
                continue
            hits = tbl.shard_hits().astype(np.float64)
            total = float(hits.sum())
            if total <= 0:
                continue
            mean = total / tbl.n_shards
            hot = int(np.argmax(hits))
            plan.imbalance = max(plan.imbalance, float(hits[hot]) / mean)
            if hits[hot] <= self.imbalance_ratio * mean:
                continue
            slot_hits = tbl.slot_hits()  # ONE counter readout per round
            keys = hot_hashed_keys(tbl, hot, self.budget,
                                   slot_hits=slot_hits)
            if not len(keys):
                continue
            moves = self._pack_shard_moves(tbl, hot, hits, keys,
                                           slot_hits[hot])
            if moves is not None:
                moves = ShardMoves(cls, *moves)
                if len(moves.keys):
                    plan.shard_moves.append(moves)

    def _pack_shard_moves(self, tbl, hot: int, hits: np.ndarray,
                          keys: np.ndarray, slot_hits: np.ndarray):
        """Assign each candidate a cool destination shard (greedy: always
        the currently-coolest, updating as the key's own heat lands), then
        pack the assignment with ``pack_by_dest``. ``slot_hits``: the hot
        shard's row of the round's single counter readout."""
        from ..ops.route import pack_by_dest

        planned = hits.copy()
        dests = np.empty(len(keys), dtype=np.int32)
        n_assigned = 0
        for kh in keys:
            dest = int(np.argmin(planned))
            if dest == hot:
                break  # hot shard became coolest: balance reached
            dests[n_assigned] = dest
            heat = float(slot_hits[tbl.key_to_slot[int(kh)][1]])
            planned[dest] += heat
            planned[hot] -= heat
            n_assigned += 1
        if n_assigned == 0:
            return None
        keys, dests = keys[:n_assigned], dests[:n_assigned]
        # pack candidate INDICES, not the keys: 63-bit key hashes do not
        # survive an int32 payload (bit 62 is set for half of all string
        # keys), and indices are what the pack actually needs — the keys
        # are recovered host-side from the candidate array
        # — made on the table's device, so a CUDA table packs with K2
        # (CPU tensors would take the plain version)
        device = tbl.mesh.device
        payload = {"idx": torch.arange(len(keys), dtype=torch.int32,
                                       device=device)}
        valid = torch.ones(len(keys), dtype=torch.bool, device=device)
        out, out_valid, drops = pack_by_dest(
            torch.from_numpy(dests).to(device), valid, payload,
            tbl.n_shards, self.budget)
        idx = out["idx"].cpu().numpy()
        ok = out_valid.cpu().numpy()
        dest_grid = np.broadcast_to(
            np.arange(tbl.n_shards, dtype=np.int32)[:, None], ok.shape)
        return keys[idx[ok]], dest_grid[ok].astype(np.int32), int(drops)
