"""Tick exchange: cross-shard grain messages as one tensor transpose.

The port of ``orleans_tpu.parallel.transport``. Each shard packs its
tick's outbound messages into per-destination buckets of ``capacity``
lanes (``ops.route.pack_by_dest``), and the buckets are exchanged: the
JAX package's ``all_to_all`` along the silo axis, which with every shard
on one device is a transpose of ``[n_src, n_dst, capacity, ...]`` to
``[n_dst, n_src, capacity, ...]``. Every shard takes part every tick
(empty lanes are padding). Overflow beyond ``capacity`` per (source,
destination) pair is dropped and counted; the host re-submits it.
"""

from __future__ import annotations

import torch

from ..ops.route import pack_by_dest

__all__ = ["build_exchange"]


def _pack_outbox(dest: torch.Tensor, valid: torch.Tensor, payload: dict,
                 n_shards: int, capacity: int):
    """Slot local messages into per-destination buckets.

    dest/valid: [n, B]; payload: dict of [n, B, ...]. Returns (outbox
    payload dict [n, n_shards, capacity, ...], outbox_valid [n, n_shards,
    capacity], drops [n] int32). Ranks come from the K2 prefix-count
    kernel, not a sort."""
    return pack_by_dest(dest, valid, payload, n_shards, capacity)


def build_exchange(mesh, capacity: int):
    """The per-tick message exchange for ``mesh``.

    Returns ``fn(dest, valid, payload) -> (recv_payload, recv_valid,
    drops)``: dest/valid [n_shards, B]; payload dict of [n_shards, B,
    ...]; recv_* [n_shards, n_shards * capacity, ...], the messages
    delivered to each shard flattened over (source shard, lane); drops
    [n_shards] int32 overflow counts per source shard."""
    n_shards = mesh.n_shards

    def exchange(dest: torch.Tensor, valid: torch.Tensor, payload: dict):
        outbox, ovalid, drops = _pack_outbox(dest, valid, payload,
                                             n_shards, capacity)

        def swap(a: torch.Tensor) -> torch.Tensor:
            inbox = a.transpose(0, 1)            # [dst, src, cap, ...]
            return inbox.reshape(n_shards, n_shards * capacity,
                                 *a.shape[3:])
        return {k: swap(v) for k, v in outbox.items()}, swap(ovalid), drops

    return exchange
