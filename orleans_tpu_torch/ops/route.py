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
kernel launch over ``n * n_dest`` destinations (the kernel offsets each
shard's dest by ``shard * n_dest``).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import Kernel, check

__all__ = ["rank_by_dest", "rank_by_dest_ref", "rank_dense_keys",
           "pack_by_dest", "RANK_BY_DEST"]

RANK_BY_DEST = Kernel(
    "rank_by_dest", "rank_by_dest.cu",
    {"oat_rank_by_dest": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
     "oat_rank_by_dest_max_dests": (ctypes.c_int, [])})
_TILE = 1024  # lanes per block of the kernel (csrc/rank_by_dest.cu)
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


def _rank_by_dest_cuda(dest: torch.Tensor, n_dest: int) -> torch.Tensor:
    if dest.ndim not in (1, 2):
        raise ValueError(f"dest must be [B] or [n, B], got "
                         f"{tuple(dest.shape)}")
    d = dest if dest.dtype == torch.int32 else dest.to(torch.int32)
    d = d.contiguous()
    n, B = (1, d.shape[0]) if d.ndim == 1 else d.shape
    lib = RANK_BY_DEST.lib()
    if n * n_dest > lib.oat_rank_by_dest_max_dests():
        raise ValueError(
            f"rank_by_dest kernel takes at most "
            f"{lib.oat_rank_by_dest_max_dests()} destinations (shards x "
            f"n_dest) per launch; got {n * n_dest}")
    rank = torch.empty(d.shape, dtype=torch.int32, device=d.device)
    counts = torch.empty(n * n_dest * max(1, -(-(n * B) // _TILE)),
                         dtype=torch.int32, device=d.device)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    rc = lib.oat_rank_by_dest(d.data_ptr(), rank.data_ptr(),
                              counts.data_ptr(), B, n, n_dest, stream)
    check(rc, "rank_by_dest")
    RANK_BY_DEST.launches += 1
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
