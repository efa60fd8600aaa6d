"""Fan-in segment reduction and the masked full reduction.

The port of ``orleans_tpu.ops.segment_reduce``. The fan-in hot op: N
messages carrying values land on S target actors (the Presence GameGrain
aggregating player heartbeats; every stream-consumer fan-in has the same
shape):

    out[s] = sum_i (seg_ids[i] == s) * values[i]

``segment_sum`` launches the hand-written CUDA kernel K1
(``csrc/segment_sum.cu``, the port of the TPU kernel
``segment_sum_pallas``) for every CUDA tensor, whatever its shape, and
raises for what the kernel does not take. On a CPU tensor it runs the
plain version ``segment_sum_ref``. Float values accumulate in float32 and
come back in their dtype, the TPU kernel's contract; float sums differ
from another summation order by float reassociation (the tests allow
rtol 1e-6 of sum |values|). Integer values are exact while each
per-segment sum stays below 2^24 (the plain version's float32
accumulator; the kernel sums integers in int32).

Shards: ``seg_ids`` of shape ``[n, B]`` (values ``[n, B]`` or
``[n, B, D]``) reduces each shard row on its own, giving ``[n, S(, D)]``,
in ONE launch; each block of the kernel folds a slice of one row.
:func:`segment_sum_plan` is the launch plan: a pure function of the
shape that the tests check on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ._build import Kernel, check, sm_count

__all__ = ["segment_sum", "segment_sum_ref", "segment_sum_onehot",
           "segment_sum_plan", "SegmentSumPlan", "masked_reduce",
           "host_fold", "REDUCE_OPS", "SEGMENT_SUM"]

_LAUNCH_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
_FN_BY_DTYPE = {torch.float32: "oat_segment_sum_f32",
                torch.int32: "oat_segment_sum_i32",
                torch.float16: "oat_segment_sum_f16"}
SEGMENT_SUM = Kernel(
    "segment_sum", "segment_sum.cu",
    {fn: (ctypes.c_int, _LAUNCH_ARGS) for fn in _FN_BY_DTYPE.values()})
# the kernel's limits (csrc/segment_sum.cu)
_MAX_CELLS = (232448 - 1024) // 4  # S*D 4-byte cells in shared memory
_MAX_ELEMS = 2**31 - 1             # B*D per row: int32 index math
_MIN_LANES = 2048                  # lanes per block, at the least


class SegmentSumPlan(NamedTuple):
    """How K1 covers ``rows`` rows of B lanes: ``blocks_per_row`` blocks
    per row, each folding ``chunk`` lanes (a multiple of 4, so that a
    slice of an aligned row starts aligned). When a row takes more than
    one block, the kernel needs ``counter_words`` zeroed 32-bit words (a
    counter per row, which it leaves zeroed) and ``partial_words`` 32-bit
    words (one histogram per block)."""
    chunk: int
    blocks_per_row: int
    counter_words: int
    partial_words: int


@functools.lru_cache(maxsize=256)
def segment_sum_plan(rows: int, B: int, D: int, S: int,
                     n_sms: int = 132) -> SegmentSumPlan:
    """K1's launch plan for ``[rows, B, D]`` values into ``S`` segments
    on a card of ``n_sms`` SMs: about one block per SM over all rows,
    each with at least 2048 lanes and with at least four elements per
    histogram cell it writes to scratch. Raises ValueError for a shape
    the kernel does not take."""
    if rows < 1 or B < 0 or D < 1 or S < 1:
        raise ValueError(f"segment_sum needs rows >= 1, B >= 0, D >= 1, "
                         f"S >= 1; got {rows}, {B}, {D}, {S}")
    cells = S * D
    if cells > _MAX_CELLS:
        raise ValueError(f"segment_sum kernel holds at most {_MAX_CELLS} "
                         f"4-byte cells per block in shared memory; got "
                         f"S*D = {cells}")
    if B * D > _MAX_ELEMS:
        raise ValueError(f"segment_sum kernel takes at most {_MAX_ELEMS} "
                         f"elements per row; got B*D = {B * D}")
    want = n_sms // rows
    cap = max(1, min(B // _MIN_LANES, B * D // (4 * cells)))
    per_row = max(1, min(want, cap))
    lanes = -(-B // per_row)
    chunk = max(4, (lanes + 3) // 4 * 4)
    per_row = max(1, -(-B // chunk))
    if per_row == 1:
        return SegmentSumPlan(chunk, 1, 0, 0)
    return SegmentSumPlan(chunk, per_row, rows, rows * per_row * cells)


def _rows(values: torch.Tensor, seg_ids: torch.Tensor):
    """(values [n, B, D], ids [n, B], squeeze) for the unbatched form
    (n = 1) or the sharded form."""
    if seg_ids.ndim == 1:
        if values.ndim not in (1, 2) or values.shape[0] != seg_ids.shape[0]:
            raise ValueError(f"values must be [B] or [B, D] with ids [B], got "
                             f"{tuple(values.shape)} and "
                             f"{tuple(seg_ids.shape)}")
        v = values if values.ndim == 2 else values[:, None]
        return v[None], seg_ids[None], values.ndim == 1
    if seg_ids.ndim == 2:
        if values.ndim not in (2, 3) or \
                tuple(values.shape[:2]) != tuple(seg_ids.shape):
            raise ValueError(f"sharded values must be [n, B] or [n, B, D] with "
                             f"ids [n, B], got {tuple(values.shape)} and "
                             f"{tuple(seg_ids.shape)}")
        v = values if values.ndim == 3 else values[..., None]
        return v, seg_ids, values.ndim == 2
    raise ValueError(f"seg_ids must be [B] or [n, B], got "
                     f"{tuple(seg_ids.shape)}")


def _finish(out: torch.Tensor, batched: bool, squeeze: bool, dtype):
    """[n, S, D] → the caller's shape in ``dtype``."""
    out = out.to(dtype)
    out = out if batched else out[0]
    return out[..., 0] if squeeze else out


def _flat_segments(v: torch.Tensor, ids: torch.Tensor, S: int):
    """[n, B, D], [n, B] → [n*B, D] values and [n*B] int64 segment ids in
    [0, n*S), or -1 for out-of-range lanes (the shard offset K1 applies
    inside the kernel)."""
    n, B = ids.shape
    off = torch.arange(n, dtype=torch.int64, device=ids.device)[:, None] * S
    ids = ids.to(torch.int64)
    seg = torch.where((ids >= 0) & (ids < S), ids + off,
                      torch.full_like(ids, -1))
    return v.reshape(n * B, v.shape[2]), seg.reshape(-1)


def segment_sum_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Plain version of K1: a float32 ``index_add_`` of the in-range lanes,
    cast to ``values.dtype``. Same shapes as :func:`segment_sum`."""
    v, ids, squeeze = _rows(values, seg_ids)
    n, S = ids.shape[0], num_segments
    fv, seg = _flat_segments(v, ids, S)
    ok = seg >= 0
    out = torch.zeros((n * S, fv.shape[1]), dtype=torch.float32,
                      device=fv.device)
    out.index_add_(0, seg[ok], fv[ok].to(torch.float32))
    return _finish(out.reshape(n, S, -1), seg_ids.ndim == 2, squeeze,
                   values.dtype)


def segment_sum_onehot(values: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """``onehot(seg_ids).T @ values`` in float32 (the JAX package's MXU
    form), cast to ``values.dtype``. Same shapes as :func:`segment_sum`."""
    v, ids, squeeze = _rows(values, seg_ids)
    n, S = ids.shape[0], num_segments
    fv, seg = _flat_segments(v, ids, S)
    cells = torch.arange(n * S, dtype=torch.int64, device=fv.device)
    mask = (cells[:, None] == seg[None, :]).to(torch.float32)   # [nS, nB]
    out = mask @ fv.to(torch.float32)
    return _finish(out.reshape(n, S, -1), seg_ids.ndim == 2, squeeze,
                   values.dtype)


def _segment_sum_cuda(values, seg_ids, num_segments):
    v, ids, squeeze = _rows(values, seg_ids)
    if values.dtype not in _FN_BY_DTYPE:
        raise TypeError(f"segment_sum kernel takes "
                        f"{sorted(map(str, _FN_BY_DTYPE))}, got {values.dtype}")
    if ids.device != v.device:
        raise ValueError("values and seg_ids must be on the same device")
    n, B, D = v.shape
    if n == 0:
        out = torch.empty((0, num_segments, D), dtype=values.dtype,
                          device=v.device)
    else:
        plan = segment_sum_plan(n, B, D, num_segments, sm_count(v.device))
        out = launch_segment_sum(v.contiguous(),
                                 ids.to(torch.int32).contiguous(),
                                 num_segments, plan)
    return _finish(out, seg_ids.ndim == 2, squeeze, values.dtype)


def launch_segment_sum(v: torch.Tensor, ids: torch.Tensor, S: int,
                       plan: SegmentSumPlan) -> torch.Tensor:
    """K1 on contiguous CUDA ``v`` [n, B, D] and int32 ``ids`` [n, B] by
    ``plan``; returns [n, S, D] in ``v``'s dtype."""
    n, B, D = v.shape
    out = torch.empty((n, S, D), dtype=v.dtype, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    counters = SEGMENT_SUM.scratch(plan.counter_words, torch.int32,
                                   v.device, stream)
    partials = SEGMENT_SUM.scratch(plan.partial_words, torch.int32,
                                   v.device, stream, zeroed=False)
    rc = getattr(SEGMENT_SUM.lib(), _FN_BY_DTYPE[v.dtype])(
        v.data_ptr(), ids.data_ptr(), out.data_ptr(), counters, partials, B,
        n, D, S, plan.chunk, plan.blocks_per_row, stream)
    check(rc, "segment_sum")
    SEGMENT_SUM.launches += 1
    return out


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Fan-in reduction: K1 for a CUDA tensor, the plain version for a CPU
    tensor. values [B] / [B, D] with ids [B], or values [n, B] /
    [n, B, D] with ids [n, B]; out-of-range ids contribute nothing."""
    if values.is_cuda:
        return _segment_sum_cuda(values, seg_ids, num_segments)
    if values.device.type != "cpu":
        raise ValueError(f"segment_sum runs on cuda or cpu, not "
                         f"{values.device}")
    return segment_sum_ref(values, seg_ids, num_segments)


# ---------------------------------------------------------------------------
# Masked full reduction (the reduce_actors device half)
# ---------------------------------------------------------------------------

# "mean" is NOT here deliberately: it is not associative per silo —
# callers combine it as (sum, count) pairs and divide once at the top.
REDUCE_OPS = ("sum", "max", "min")


def host_fold(op: str):
    """The numpy fold that combines :func:`masked_reduce` partials on the
    host (across deferral rounds and across silos). ``mean`` partials
    carry sums (divide once at the top)."""
    if op in ("sum", "mean"):
        return np.add
    if op == "max":
        return np.maximum
    if op == "min":
        return np.minimum
    raise ValueError(f"op must be one of {REDUCE_OPS + ('mean',)}, "
                     f"got {op!r}")


def _reduce_identity(op: str, dtype: torch.dtype):
    """What masked-off lanes contribute, as a Python scalar."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return -float("inf") if op == "max" else float("inf")
    if dtype == torch.bool:
        return op == "min"
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def masked_reduce(values, valid: torch.Tensor, op: str = "sum"):
    """Full reduction of per-lane results down to ONE row.

    values: a tensor or a dict of ``[n_shards, B, *feature]`` tensors;
    valid: ``[n_shards, B]`` bool. Reduces every leaf over the two lane
    axes — masked lanes contribute the op's identity — and returns
    ``[*feature]`` tensors. Sums keep the value dtype (torch sums integers
    in int64; the result is cast back, which wraps exactly as an int32
    sum would); bool sums count True lanes as int32. All-masked max/min
    return the identity."""
    if op not in REDUCE_OPS:
        raise ValueError(f"op must be one of {REDUCE_OPS}, got {op!r}")

    def one(v: torch.Tensor) -> torch.Tensor:
        dtype = v.dtype
        if op == "sum" and dtype == torch.bool:
            v, dtype = v.to(torch.int32), torch.int32
        mask = valid.reshape(valid.shape + (1,) * (v.ndim - valid.ndim))
        filled = torch.where(mask, v, torch.tensor(
            _reduce_identity(op, dtype), dtype=dtype, device=v.device))
        if op == "sum":
            return filled.sum(dim=(0, 1)).to(dtype)
        if dtype == torch.bool:
            u = filled.to(torch.uint8)
            red = u.amax(dim=(0, 1)) if op == "max" else u.amin(dim=(0, 1))
            return red.bool()
        if op == "max":
            return filled.amax(dim=(0, 1))
        return filled.amin(dim=(0, 1))

    if isinstance(values, dict):
        return {k: one(v) for k, v in values.items()}
    return one(values)
