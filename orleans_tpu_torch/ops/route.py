"""Message routing (outbox pack): within-destination ranks and the pack.

The port of ``orleans_tpu.ops.route``. Each tick's outbound messages are
packed into per-destination buckets (``parallel.transport._pack_outbox``
delegates here). The rank of a message within its destination group is a
prefix count:

    rank[i] = #{ j < i : dest[j] == dest[i] }

``rank_by_dest`` launches the hand-written CUDA kernel K2
(``csrc/rank_by_dest.cu``, the port of the TPU kernel ``rank_by_dest``)
for every CUDA tensor, at every B: the TPU's size thresholds exist for MXU
tiling, and every regime computes the same ranks. On a CPU tensor the
plain version ``rank_by_dest_ref`` keeps the JAX package's regimes: a
pairwise mask below 512 lanes, a cumulative one-hot count above.
``pack_by_dest`` on a CPU tensor likewise ranks through
``rank_dense_keys`` past 32,768 lanes, as the JAX package does.

Shards: ``dest`` of shape ``[n, B]`` ranks each row on its own, in ONE
kernel launch; each block of the kernel ranks a tile of one row over that
row's ``n_dest`` destinations. :func:`rank_plan` is the launch plan: a
pure function of the shape that the tests check on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ._build import Kernel, check

__all__ = ["rank_by_dest", "rank_by_dest_ref", "rank_dense_keys",
           "pack_by_dest", "rank_plan", "RankPlan", "RANK_BY_DEST"]

RANK_BY_DEST = Kernel(
    "rank_by_dest", "rank_by_dest.cu",
    {"oat_rank_by_dest": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
     "oat_rank_by_dest_max_cluster": (ctypes.c_int, [ctypes.c_int])})
# the kernel's constants (csrc/rank_by_dest.cu)
_THREADS = 512
_WARPS = _THREADS // 32
_MAX_SHARED = 232448 - 1024   # dynamic shared memory a block may opt into
TILE = 16 * _THREADS           # lanes of one block: 16 a thread
_MAX_CLUSTER = 16
_MAX_LANES = 2**31 - 1        # per row: the kernel's row index math is int32
_PAIRWISE_BELOW = 512  # the JAX package's small-batch regime
_SORT_ABOVE = 32768    # the JAX package's sort-based regime in pack_by_dest


def _rank_1d_ref(d: torch.Tensor, n_dest: int) -> torch.Tensor:
    B = d.shape[0]
    if B < _PAIRWISE_BELOW:
        same = d[:, None] == d[None, :]
        lower = torch.tril(torch.ones((B, B), dtype=torch.bool,
                                      device=d.device), -1)
        return (same & lower).sum(dim=1).to(torch.int32)
    onehot = torch.nn.functional.one_hot(d.to(torch.int64), n_dest)
    before = onehot.cumsum(dim=0) - onehot                     # [B, S]
    return before.gather(1, d.to(torch.int64)[:, None])[:, 0] \
        .to(torch.int32)


def rank_by_dest_ref(dest: torch.Tensor, n_dest: int) -> torch.Tensor:
    """Plain version of K2. dest: [B] or [n, B] int in [0, n_dest) (map
    invalid lanes to a sink id first). Returns int32 of dest's shape."""
    d = dest.to(torch.int32)
    if d.ndim == 1:
        return _rank_1d_ref(d, n_dest)
    if d.ndim == 2:
        if d.shape[0] == 0:
            return torch.zeros(d.shape, dtype=torch.int32, device=d.device)
        return torch.stack([_rank_1d_ref(row, n_dest) for row in d])
    raise ValueError(f"dest must be [B] or [n, B], got {tuple(d.shape)}")


def _shared_bytes(n_dest: int, cluster_size: int) -> int:
    """Shared memory of one block: the tile, then per destination the
    per-warp counts, the totals of the cluster's earlier tiles, and the
    tile's total and offset."""
    return 4 * (TILE + (_WARPS + cluster_size + 2) * n_dest)


class RankPlan(NamedTuple):
    """How K2 covers ``rows`` rows of B lanes: blocks of 512 threads x
    16 lanes (one tile of :data:`TILE` lanes of one row each), grouped in
    clusters of ``cluster_size`` blocks, ``clusters_per_row`` clusters
    per row, and ``scratch_words`` zeroed 64-bit words (a ticket, a done
    count and one look-back word per row, cluster and destination) when a
    row takes more than one cluster."""
    cluster_size: int
    clusters_per_row: int
    scratch_words: int


@functools.lru_cache(maxsize=256)
def rank_plan(rows: int, B: int, n_dest: int,
              max_cluster: int = _MAX_CLUSTER) -> RankPlan:
    """K2's launch plan for ``[rows, B]`` dest over ``n_dest``
    destinations on a card that holds clusters of up to ``max_cluster``
    blocks: a row takes as few clusters as the cluster size allows, its
    tiles spread evenly over them. Raises ValueError for a shape the
    kernel does not take."""
    if rows < 1 or B < 0 or n_dest < 1:
        raise ValueError(f"rank_by_dest needs rows >= 1, B >= 0, n_dest >= 1;"
                         f" got {rows}, {B}, {n_dest}")
    if B > _MAX_LANES:
        raise ValueError(f"rank_by_dest kernel takes at most {_MAX_LANES} "
                         f"lanes per row; got {B}")
    if n_dest > max_dests():
        raise ValueError(
            f"rank_by_dest kernel holds per-warp counts of at most "
            f"{max_dests()} destinations per row in shared memory; got "
            f"{n_dest}")
    tiles = max(1, -(-B // TILE))
    room = max(c for c in range(1, _MAX_CLUSTER + 1)
               if _shared_bytes(n_dest, c) <= _MAX_SHARED)
    per_row = -(-tiles // min(max_cluster, room))
    size = -(-tiles // per_row)
    scratch = 2 + rows * per_row * n_dest if per_row > 1 else 0
    return RankPlan(size, per_row, scratch)


def max_dests() -> int:
    """The most destinations per row that K2 takes."""
    return (_MAX_SHARED // 4 - TILE) // (_WARPS + 3)


_max_cluster: dict = {}


def _cluster_limit(lib, device: torch.device, n_dest: int) -> int:
    """The card's cluster limit at ``n_dest`` destinations (16, or 8
    where the non-portable size does not fit), asked once per count."""
    key = (device.index, n_dest)
    if key not in _max_cluster:
        _max_cluster[key] = lib.oat_rank_by_dest_max_cluster(n_dest)
    return _max_cluster[key]


def _rank_by_dest_cuda(dest: torch.Tensor, n_dest: int) -> torch.Tensor:
    if dest.ndim not in (1, 2):
        raise ValueError(f"dest must be [B] or [n, B], got "
                         f"{tuple(dest.shape)}")
    d = dest if dest.dtype == torch.int32 else dest.to(torch.int32)
    d = d.contiguous()
    n, B = (1, d.shape[0]) if d.ndim == 1 else d.shape
    if n == 0 or B == 0:
        return torch.empty(d.shape, dtype=torch.int32, device=d.device)
    plan = rank_plan(n, B, n_dest)
    limit = _cluster_limit(RANK_BY_DEST.lib(), d.device, n_dest)
    if plan.cluster_size > limit:
        plan = rank_plan(n, B, n_dest, limit)
    return launch_rank(d, n_dest, plan)


def launch_rank(d: torch.Tensor, n_dest: int, plan: RankPlan,
                kernel: Kernel = RANK_BY_DEST) -> torch.Tensor:
    """K2 on a contiguous int32 CUDA ``d`` ([B] or [n, B]) by ``plan``,
    through ``kernel`` (a measurement build of the same source, or K2)."""
    n, B = (1, d.shape[0]) if d.ndim == 1 else d.shape
    rank = torch.empty(d.shape, dtype=torch.int32, device=d.device)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    scratch = kernel.scratch(plan.scratch_words, torch.int64, d.device,
                             stream)
    rc = kernel.lib().oat_rank_by_dest(
        d.data_ptr(), rank.data_ptr(), scratch, B, n, n_dest,
        plan.cluster_size, plan.clusters_per_row, stream)
    check(rc, "rank_by_dest")
    kernel.launches += 1
    return rank


def rank_by_dest(dest: torch.Tensor, n_dest: int) -> torch.Tensor:
    """rank[i] = position of message i within its destination group.

    dest: [B] or [n, B] int in [0, n_dest) — map invalid lanes to a sink
    id in [0, n_dest) *before* calling. Returns int32 of dest's shape:
    K2 on a CUDA tensor, the plain version on a CPU tensor."""
    if dest.is_cuda:
        return _rank_by_dest_cuda(dest, n_dest)
    if dest.device.type != "cpu":
        raise ValueError(f"rank_by_dest runs on cuda or cpu, not "
                         f"{dest.device}")
    return rank_by_dest_ref(dest, n_dest)


def rank_dense_keys(keys: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of element i within its key group — the same
    prefix count as :func:`rank_by_dest`, for LARGE key spaces: one stable
    sort and a cumulative max. keys: [B] int (any values). Returns [B]
    int32."""
    B = keys.shape[0]
    ks, order = torch.sort(keys, stable=True)
    idx = torch.arange(B, dtype=torch.int32, device=keys.device)
    is_start = torch.ones(B, dtype=torch.bool, device=keys.device)
    is_start[1:] = ks[1:] != ks[:-1]
    group_start = torch.cummax(torch.where(is_start, idx,
                                           torch.zeros_like(idx)), 0).values
    out = torch.zeros(B, dtype=torch.int32, device=keys.device)
    out[order] = idx - group_start
    return out


def pack_by_dest(dest: torch.Tensor, valid: torch.Tensor, payload: dict,
                 n_dest: int, capacity: int):
    """Sort-free outbox pack.

    dest/valid: [B] (or [n, B], each row packed on its own); payload:
    dict of [B, ...] (or [n, B, ...]). Returns (out_payload dict
    [n_dest, capacity, ...], out_valid [n_dest, capacity], drops int32
    scalar), with a leading [n] on each for the sharded form. Overflow
    beyond ``capacity`` per destination, and valid lanes whose dest is out
    of range, are dropped and counted."""
    batched = dest.ndim == 2
    if not batched:
        dest, valid = dest[None], valid[None]
        payload = {k: v[None] for k, v in payload.items()}
    n, B = dest.shape
    in_range = (dest >= 0) & (dest < n_dest)
    ok = valid & in_range
    d = torch.where(ok, dest, torch.full_like(dest, n_dest)).to(torch.int32)
    if dest.is_cuda or B <= _SORT_ABOVE:
        rank = rank_by_dest(d, n_dest + 1)
    else:
        rank = torch.stack([rank_dense_keys(row) for row in d])
    keep = ok & (rank < capacity)
    drops = ((ok & ~keep).sum(dim=1)
             + (valid & ~in_range).sum(dim=1)).to(torch.int32)
    sink = n_dest * capacity
    flat = torch.where(
        keep, d.to(torch.int64) * capacity
        + torch.clamp(rank, max=capacity - 1).to(torch.int64),
        torch.full_like(d, sink, dtype=torch.int64))
    shard = torch.arange(n, device=d.device)[:, None]

    def scatter(x: torch.Tensor) -> torch.Tensor:
        # padding and dropped lanes all land on the sink cell, whose write
        # order is undefined; it is cut off below
        buf = torch.zeros((n, sink + 1, *x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        buf[shard, flat] = x
        return buf[:, :-1].reshape(n, n_dest, capacity, *x.shape[2:])

    out_payload = {k: scatter(v) for k, v in payload.items()}
    out_valid = scatter(keep)
    if not batched:
        return ({k: v[0] for k, v in out_payload.items()}, out_valid[0],
                drops[0])
    return out_payload, out_valid, drops
