"""Multi-cluster gossip: configuration + gateway exchange between clusters.

Re-design of Orleans' src/Orleans.Runtime/MultiClusterNetwork/
MultiClusterOracle.cs:12 + MultiClusterGossipChannelFactory.cs: each cluster
periodically merges its local view (its own gateways, stamped) with one or
more gossip channels — last-writer-wins per cluster key. Channels are
pluggable (the factory's job): in-memory for tests, JSON-file and sqlite
for real multi-process deployments (the Azure-table channel stand-ins,
mirroring the membership-table backend split).

The port's copy of ``orleans_tpu.multicluster.gossip``, with one repair:
two entries (or two configurations) with equal stamps are ordered by their
serialized form (:func:`_entry_rank`, :func:`_config_rank`), in the merge
and in the sqlite channel alike. The JAX package's strict ``>`` keeps
whichever it already holds, so two clusters holding different entries at
one stamp never converge.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from ..core.ids import SiloAddress

if TYPE_CHECKING:
    from ..runtime.silo import Silo

log = logging.getLogger("orleans.multicluster")

__all__ = ["MultiClusterData", "InMemoryGossipChannel", "FileGossipChannel",
           "SqliteGossipChannel", "MultiClusterOracle"]


@dataclass
class MultiClusterData:
    """Gossiped payload (MultiClusterData): per-cluster gateway lists +
    stamps, plus the admin-injected configuration; merge = per-key (and
    for the config) newest stamp wins, equal stamps broken by the
    serialized entry."""

    clusters: dict[str, dict] = field(default_factory=dict)
    # clusters[cluster_id] = {"gateways": [SiloAddress], "stamp": float}
    # admin-injected multi-cluster configuration
    # (MultiClusterConfiguration: timestamped cluster list + comment);
    # None until an operator injects one — gossip membership then governs
    config: dict | None = None
    # config = {"clusters": [str], "stamp": float, "comment": str}

    def merge(self, other: "MultiClusterData") -> bool:
        changed = False
        for cid, entry in other.clusters.items():
            mine = self.clusters.get(cid)
            if mine is None or _entry_rank(entry) > _entry_rank(mine):
                self.clusters[cid] = dict(entry)
                changed = True
        if other.config is not None and (
                self.config is None
                or _config_rank(other.config) > _config_rank(self.config)):
            self.config = dict(other.config)
            changed = True
        return changed

    def copy(self) -> "MultiClusterData":
        return MultiClusterData(
            {k: dict(v) for k, v in self.clusters.items()},
            dict(self.config) if self.config else None)


class GossipChannel:
    """Shared gossip substrate (IGossipChannel)."""

    async def publish(self, data: MultiClusterData) -> None:
        raise NotImplementedError

    async def read(self) -> MultiClusterData:
        raise NotImplementedError


class InMemoryGossipChannel(GossipChannel):
    """Dev/test channel: one shared object across clusters (the Azure-table
    stand-in)."""

    def __init__(self) -> None:
        self._data = MultiClusterData()

    async def publish(self, data: MultiClusterData) -> None:
        self._data.merge(data)

    async def read(self) -> MultiClusterData:
        return self._data.copy()


_CONFIG_KEY = "__config__"  # reserved: not a valid cluster id


def _gateways_json(gateways) -> str:
    return json.dumps([[g.host, g.port, g.generation, g.mesh_index]
                       for g in gateways])


def _entry_rank(entry: dict) -> tuple[float, str]:
    """Last-writer-wins order of one cluster's entry: its stamp, then its
    serialized gateways, so that equal stamps resolve the same way
    everywhere."""
    return entry["stamp"], _gateways_json(entry["gateways"])


def _config_rank(config: dict) -> tuple[float, str]:
    return config["stamp"], json.dumps(config, sort_keys=True)


def _data_to_json(data: MultiClusterData) -> dict:
    out = {cid: {"stamp": e["stamp"],
                 "gateways": [[g.host, g.port, g.generation, g.mesh_index]
                              for g in e["gateways"]]}
           for cid, e in data.clusters.items()}
    if data.config is not None:
        out[_CONFIG_KEY] = dict(data.config)
    return out


def _data_from_json(raw: dict) -> MultiClusterData:
    config = raw.get(_CONFIG_KEY)
    return MultiClusterData({
        cid: {"stamp": e["stamp"],
              "gateways": [SiloAddress(h, p, g, m)
                           for h, p, g, m in e["gateways"]]}
        for cid, e in raw.items() if cid != _CONFIG_KEY},
        dict(config) if config else None)


class FileGossipChannel(GossipChannel):
    """Cross-process channel: one JSON file shared by all clusters.
    Publish is read-merge-write with an atomic replace; the merge is
    commutative and idempotent (per-cluster last-writer-wins), so a lost
    race between two processes heals on the next gossip round."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = asyncio.Lock()

    def _load(self) -> MultiClusterData:
        try:
            with open(self.path, encoding="utf-8") as f:
                return _data_from_json(json.load(f))
        except (FileNotFoundError, json.JSONDecodeError):
            return MultiClusterData()

    async def publish(self, data: MultiClusterData) -> None:
        def write() -> None:
            merged = self._load()
            merged.merge(data)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(_data_to_json(merged), f)
            os.replace(tmp, self.path)

        async with self._lock:  # file I/O off the loop (like the sqlite
            # sibling): a slow/network filesystem must not stall turns
            await asyncio.get_running_loop().run_in_executor(None, write)

    async def read(self) -> MultiClusterData:
        async with self._lock:
            return await asyncio.get_running_loop().run_in_executor(
                None, self._load)


class SqliteGossipChannel(GossipChannel):
    """Cross-process channel over sqlite (real database locking): one row
    per cluster id, last-writer-wins by stamp."""

    def __init__(self, path: str) -> None:
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._dblock = threading.Lock()
        with self._dblock:
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS gossip ("
                " cluster TEXT PRIMARY KEY, stamp REAL, gateways TEXT)")
            self._db.commit()

    def close(self) -> None:
        with self._dblock:
            self._db.close()

    async def publish(self, data: MultiClusterData) -> None:
        def write() -> None:
            with self._dblock:
                for cid, e in data.clusters.items():
                    row = self._db.execute(
                        "SELECT stamp, gateways FROM gossip WHERE cluster=?",
                        (cid,)).fetchone()
                    gws = _gateways_json(e["gateways"])
                    if row is None or (e["stamp"], gws) > tuple(row):
                        self._db.execute(
                            "INSERT OR REPLACE INTO gossip VALUES (?,?,?)",
                            (cid, e["stamp"], gws))
                if data.config is not None:
                    # the admin configuration rides the same table under a
                    # reserved key; the gateways column carries its JSON
                    row = self._db.execute(
                        "SELECT gateways FROM gossip WHERE cluster=?",
                        (_CONFIG_KEY,)).fetchone()
                    if row is None or _config_rank(data.config) > \
                            _config_rank(json.loads(row[0])):
                        self._db.execute(
                            "INSERT OR REPLACE INTO gossip VALUES (?,?,?)",
                            (_CONFIG_KEY, data.config["stamp"],
                             json.dumps(data.config)))
                self._db.commit()

        await asyncio.get_running_loop().run_in_executor(None, write)

    async def read(self) -> MultiClusterData:
        def load() -> MultiClusterData:
            with self._dblock:
                rows = self._db.execute(
                    "SELECT cluster, stamp, gateways FROM gossip").fetchall()
            config = None
            clusters = {}
            for cid, stamp, gws in rows:
                if cid == _CONFIG_KEY:
                    config = json.loads(gws)
                else:
                    clusters[cid] = {
                        "stamp": stamp,
                        "gateways": [SiloAddress(h, p, g, m)
                                     for h, p, g, m in json.loads(gws)]}
            return MultiClusterData(clusters, config)

        return await asyncio.get_running_loop().run_in_executor(None, load)


class MultiClusterOracle:
    """Per-silo gossip oracle; silos of one cluster share a cluster_id."""

    def __init__(self, silo: "Silo", cluster_id: str,
                 channels: list[GossipChannel],
                 gossip_period: float = 1.0):
        self.silo = silo
        self.cluster_id = cluster_id
        self.channels = channels
        self.gossip_period = gossip_period
        self.data = MultiClusterData()
        self._task: asyncio.Task | None = None
        # fired (sync, with the new config dict) whenever a NEWER admin
        # configuration lands — whether injected locally or learned
        # through gossip; the GSI runtime hooks this for removed-cluster
        # entry demotion
        self.config_listeners: list = []

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        while True:
            try:
                await self.gossip_once()
            except Exception:  # noqa: BLE001
                log.exception("gossip round failed")
            await asyncio.sleep(self.gossip_period)

    async def gossip_once(self) -> None:
        """One round: stamp our view, merge every channel, publish back.
        A newer admin configuration learned from any channel fires the
        config listeners."""
        self.data.clusters[self.cluster_id] = {
            "gateways": list(self.silo.locator.alive_list),
            "stamp": time.time(),
        }
        before = self.config_stamp()
        for ch in self.channels:
            remote = await ch.read()
            self.data.merge(remote)
            await ch.publish(self.data)
        if self.config_stamp() != before:
            self._fire_config_listeners()

    def _fire_config_listeners(self) -> None:
        for fn in list(self.config_listeners):
            try:
                fn(self.data.config)
            except Exception:  # noqa: BLE001 — listeners are best-effort
                log.exception("multicluster config listener failed")

    # -- admin configuration (ManagementGrain.cs:387-427 backing) ---------
    def config_stamp(self) -> float | None:
        return self.data.config["stamp"] if self.data.config else None

    async def inject_configuration(self, clusters: list[str],
                                   comment: str = "") -> dict:
        """Replace the active multi-cluster configuration
        (MultiClusterOracle.InjectMultiClusterConfiguration): timestamped,
        last-writer-wins, gossiped immediately so peers converge within
        one channel round-trip. Returns the injected config."""
        clusters = sorted(set(clusters))
        if not clusters:
            raise ValueError("multi-cluster configuration must name at "
                             "least one cluster")
        cfg = {"clusters": clusters, "stamp": time.time(),
               "comment": comment}
        if self.data.config and cfg["stamp"] <= self.data.config["stamp"]:
            # same-clock-tick re-injection still must win LWW
            cfg["stamp"] = self.data.config["stamp"] + 1e-6
        self.data.config = cfg
        self._fire_config_listeners()
        await self.gossip_once()
        return dict(cfg)

    # -- queries ---------------------------------------------------------
    def active_config(self) -> dict | None:
        return dict(self.data.config) if self.data.config else None

    def known_clusters(self) -> list[str]:
        """The multi-cluster network's member set: the admin-injected
        configuration when one exists (the reference's conf-governed
        membership), else everything gossip has merged (zero-conf mode).
        A configured-but-never-seen cluster is still listed — its
        gateways just resolve empty until it gossips."""
        if self.data.config is not None:
            return list(self.data.config["clusters"])
        return sorted(self.data.clusters)

    def gateways_of(self, cluster_id: str) -> list[SiloAddress]:
        entry = self.data.clusters.get(cluster_id)
        return list(entry["gateways"]) if entry else []


def add_multicluster(builder, cluster_id: str, channels: list,
                     gossip_period: float = 1.0, gsi: bool = True,
                     maintainer_period: float = 1.0):
    """Install a gossip oracle on a SiloBuilder (silo.multicluster), plus —
    unless ``gsi=False`` — the Global-Single-Instance runtime: the
    per-cluster directory grain, the cross-cluster gateway bridge, and the
    Doubtful-retry maintainer (silo.gsi)."""
    if gsi:
        from .gsi import cluster_directory_grain_class
        builder.add_grains(cluster_directory_grain_class())

    def install(silo) -> None:
        oracle = MultiClusterOracle(silo, cluster_id, channels, gossip_period)
        silo.multicluster = oracle
        from ..runtime.silo import ServiceLifecycleStage
        silo.subscribe_lifecycle(
            ServiceLifecycleStage.RUNTIME_GRAIN_SERVICES,
            oracle.start, oracle.stop)
        if gsi:
            from .gsi import GsiRuntime
            runtime = GsiRuntime(silo, oracle,
                                 maintainer_period=maintainer_period)
            silo.gsi = runtime
            silo.subscribe_lifecycle(
                ServiceLifecycleStage.RUNTIME_GRAIN_SERVICES,
                runtime.start, runtime.stop)

    return builder.configure(install)
