"""Device mesh for the port: a shard count and one ``torch.device``.

The JAX package's mesh is a 1-D ``jax.sharding.Mesh`` over the ``"silo"``
axis. Here every shard lives on one device as a leading tensor dimension,
so ``shard_map`` becomes a batched index over dim 0 and the exchange's
``all_to_all`` becomes a transpose (parallel.transport).

A mesh may also span the ranks of a ``torch.distributed`` process group
(``make_mesh(n, device, group=g)``): one rank a device, ``n_local = n //
world`` shards a rank, and shard ``rank * n_local + local`` is the global
shard, so key → shard is what it is on one device. The caller builds the
group (NCCL for a CUDA device, gloo for the CPU; nothing falls back from
one to the other). The exchange then is one ``all_to_all_single`` a
tensor over the ranks, merged reads and reductions an ``all_reduce``,
and results every rank must hold a :func:`gather` of each rank's rows.
Every rank keeps the same host bookkeeping and makes the same calls in
the same order; a host decision that rests on a rank's own values (a
deadline, a device result) goes through :func:`agree` first. The entry
points that do not run across ranks yet raise :class:`GroupMeshError`.

A forked worker process of a multi-process silo (``runtime.multiproc``)
must never start CUDA: its parent holds a CUDA context, and torch cannot
initialize CUDA again in a forked child. ``_worker_main`` marks the
process (:func:`mark_worker_process`), and from then on the device entry
points (:func:`resolve_device`, so :func:`make_mesh` and the device
directories, and ``VectorRuntime``) raise :class:`WorkerProcessError`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["SILO_AXIS", "GroupMeshError", "Mesh", "WorkerProcessError",
           "agree", "all_reduce", "gather", "in_worker_process", "make_mesh",
           "mark_worker_process", "refuse_in_worker", "refuse_on_group",
           "resolve_device"]

SILO_AXIS = "silo"

# set once in a forked worker process, never cleared: the process's own
# state, not a setting (see the module docstring)
_worker_process = False


class WorkerProcessError(RuntimeError):
    """A device entry point was called in a forked worker process, where
    only the owner process may touch the device."""


def mark_worker_process() -> None:
    """Mark this process as a forked silo worker (``_worker_main``)."""
    global _worker_process
    _worker_process = True


def in_worker_process() -> bool:
    return _worker_process


def refuse_in_worker(what: str) -> None:
    """Raise :class:`WorkerProcessError` naming ``what`` in a worker."""
    if _worker_process:
        raise WorkerProcessError(
            f"{what} in a forked worker process of a multi-process silo: "
            f"only the owner process touches the device (its vector calls "
            f"cross the staging ring to the owner's engine)")


class GroupMeshError(NotImplementedError):
    """An entry point that does not run across the ranks of a process
    group yet was called on a group mesh."""


# what runs across ranks, and where the rest is queued
_GROUP_PATH = ("a process-group mesh runs the dispatch layer (the dense "
               "and per-key paths, the bulk collectives, the sparse route, "
               "the hashed regime, reshard_dense and replicated workers)")
_GROUP_NEXT = ("ROADMAP Queue 4 item 1: hosting, the off-loop worker on a "
               "group and move_rows between ranks")

_BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


@dataclass(frozen=True)
class Mesh:
    """``n_shards`` logical silo shards. Without ``group`` all of them
    are resident on ``device``; with a process group, this rank holds
    ``n_local`` of them, global shards ``shard0 .. shard0 + n_local - 1``,
    on ``device``."""

    n_shards: int
    device: torch.device
    group: object = None  # a torch.distributed ProcessGroup, or None
    rank: int = 0
    world: int = 1

    @property
    def n_local(self) -> int:
        """Shards resident on this process."""
        return self.n_shards // self.world

    @property
    def shard0(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * self.n_local


def make_mesh(n_shards: int = 1, device=None, *, group=None) -> Mesh:
    """Mesh of ``n_shards`` shards on ``device``.

    ``device=None`` means CUDA. Without CUDA this raises: pass
    ``device="cpu"`` to run the plain versions on the CPU explicitly.

    ``group``: a ``torch.distributed`` process group whose ranks each
    hold ``n_shards // world`` of the shards (``n_shards`` must divide
    evenly). Its backend must be NCCL for a CUDA device and gloo for the
    CPU.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = resolve_device(device)
    if group is None:
        return Mesh(int(n_shards), dev)
    import torch.distributed as dist
    world = dist.get_world_size(group)
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not divide over {world} "
                         f"ranks")
    backend = str(dist.get_backend(group)).lower()
    want = _BACKEND_FOR.get(dev.type)
    if backend != want:
        raise ValueError(
            f"a {dev.type} mesh needs a {want} process group, got "
            f"{backend!r}")
    return Mesh(int(n_shards), dev, group, dist.get_rank(group), world)


def refuse_on_group(mesh: Mesh, what: str) -> None:
    """Raise :class:`GroupMeshError` naming ``what`` and the ROADMAP item
    that queues it when ``mesh`` spans a process group."""
    if mesh.group is not None:
        raise GroupMeshError(
            f"{what} does not run on a process-group mesh yet: "
            f"{_GROUP_PATH}; the rest is {_GROUP_NEXT}")


_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` folded over the ranks of ``mesh`` with ``op`` ("sum" |
    "max" | "min"), the JAX package's ``psum``/``pmax``/``pmin`` over the
    silo axis once each rank has folded its own shards. The identity on a
    one-device mesh. A bool tensor crosses as int32 and comes back as
    bool (so "sum" is "any", as a bool sum over shards is)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduce op {op!r}; choose from "
                         f"{sorted(_REDUCE_OPS)}")
    if mesh.group is None:
        return t
    import torch.distributed as dist
    out = t.to(torch.int32) if t.dtype == torch.bool \
        else t.contiguous().clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]),
                    group=mesh.group)
    return out.to(t.dtype)


def gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's ``[n_local, ...]`` rows gathered over the ranks into
    ``[n_shards, ...]``, in global shard order; ``t`` itself on a
    one-device mesh. The rows cross as bytes, as the exchange's do, so
    every dtype (bool, float16) crosses bit for bit. Every rank must call
    it with the same shape and dtype."""
    if mesh.group is None:
        return t
    import torch.distributed as dist
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(mesh.world)]
    dist.all_gather(parts, raw, group=mesh.group)
    return torch.cat(parts).view(t.dtype).reshape(
        mesh.world * t.shape[0], *t.shape[1:])


def agree(mesh: Mesh, flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any rank (a MAX over
    the ranks): the one way a host decision that rests on a rank's own
    clock or values is taken alike everywhere. ``flag`` on a one-device
    mesh."""
    if mesh.group is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=mesh.device)
    return bool(all_reduce(mesh, t, "max").item())


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA, and raises when
    CUDA is absent instead of falling back to the CPU. Raises
    :class:`WorkerProcessError` in a forked worker process."""
    refuse_in_worker(f"resolve_device({device!r})")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None means CUDA, which is not available; pass "
                "device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)
