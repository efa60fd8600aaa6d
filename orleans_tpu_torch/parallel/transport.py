"""Tick exchange: cross-shard grain messages as one tensor transpose.

The port of ``orleans_tpu.parallel.transport``. Each shard packs its
tick's outbound messages into per-destination buckets of ``capacity``
lanes (``ops.route.pack_by_dest``), and the buckets are exchanged: the
JAX package's ``all_to_all`` along the silo axis, which with every shard
on one device is a transpose of ``[n_src, n_dst, capacity, ...]`` to
``[n_dst, n_src, capacity, ...]``. Every shard takes part every tick
(empty lanes are padding). Overflow beyond ``capacity`` per (source,
destination) pair is dropped and counted; the host re-submits it.

On a mesh over a process group (``make_mesh(..., group=g)``) each rank
packs its ``n_local`` shards with K2 into ``[n_local, n_shards,
capacity, ...]``, makes each destination rank's block contiguous, and
sends it with one ``torch.distributed.all_to_all_single`` a tensor; a
local transpose then gives ``[n_local, n_shards * capacity, ...]``, the
JAX function's per-shard output for this rank's shards. Every rank enters
every call, with its tensors in the same (sorted) order.
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
    if mesh.group is not None:
        return _group_exchange(mesh, capacity)

    def exchange(dest: torch.Tensor, valid: torch.Tensor, payload: dict):
        outbox, ovalid, drops = _pack_outbox(dest, valid, payload,
                                             n_shards, capacity)

        def swap(a: torch.Tensor) -> torch.Tensor:
            inbox = a.transpose(0, 1)            # [dst, src, cap, ...]
            return inbox.reshape(n_shards, n_shards * capacity,
                                 *a.shape[3:])
        return {k: swap(v) for k, v in outbox.items()}, swap(ovalid), drops

    return exchange


def _group_exchange(mesh, capacity: int):
    """:func:`build_exchange` across the ranks of ``mesh.group``: dest /
    valid [n_local, B] (global destination shards), payload [n_local, B,
    ...]; returns recv [n_local, n_shards * capacity, ...], flattened over
    (global source shard, lane), and drops [n_local]."""
    import torch.distributed as dist
    n_shards, n_local, world = mesh.n_shards, mesh.n_local, mesh.world
    group = mesh.group

    def swap(a: torch.Tensor) -> torch.Tensor:
        # [src_local, dst, cap, ...] -> destination-rank blocks, each
        # [dst_local, src_local, cap, ...], contiguous along dim 0; sent
        # as bytes, so every dtype (bool, f16) crosses bit for bit
        tail = a.shape[3:]
        raw = a.transpose(0, 1).contiguous().reshape(-1).view(torch.uint8)
        got = torch.empty_like(raw)
        dist.all_to_all_single(got, raw, group=group)
        got = got.view(a.dtype).reshape(world, n_local, n_local, capacity,
                                        *tail)
        # [src_rank, dst_local, src_local, cap] -> per local destination,
        # lanes ordered by global source shard (src_rank, src_local)
        return got.transpose(0, 1).reshape(n_local, n_shards * capacity,
                                           *tail)

    def exchange(dest: torch.Tensor, valid: torch.Tensor, payload: dict):
        if dest.shape[0] != n_local:
            raise ValueError(f"rank {mesh.rank} holds {n_local} shards; "
                             f"got {dest.shape[0]} rows")
        outbox, ovalid, drops = _pack_outbox(dest, valid, payload,
                                             n_shards, capacity)
        recv = {k: swap(outbox[k]) for k in sorted(outbox)}
        return recv, swap(ovalid), drops

    return exchange
