"""Per-(grain_class, method) invoker table — the IL-emitted-invoker analog.

The reference compiles one invoker per grain method at build time
(Orleans' src/Orleans.CodeGeneration/GrainMethodInvokerGenerator.cs,
``ILSerializerGenerator.cs``) so a hot call does a method-id switch instead
of reflection.  Python's analog: resolve everything resolvable ONCE per
(grain class, silo filter-state) — the unbound method object, its
concurrency flags, and the fused incoming-filter chain — so a hot call is
dict-lookup + gate-check + await instead of per-turn ``getattr`` walks and
chain rebuilds (the join-calculus "compile the match ahead of time" move,
arxiv 1302.6329).

Invalidation: entries revalidate on every lookup against two cheap tokens —
the silo's incoming-filter count (filter registration, including direct
``silo.incoming_call_filters.append`` mutation by tests) and the class's
``__orleans_version__`` (version bump).  A stale entry rebuilds in place;
there is no explicit flush API to forget to call.

The port's copy of ``orleans_tpu.runtime.invoker``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from .grain import Grain, remote_methods

if TYPE_CHECKING:
    from .silo import Silo

__all__ = ["MethodInvoker", "ClassInvokers", "InvokerTable"]


class MethodInvoker:
    """One remote method, flags pre-resolved (the codegen'd proxy body)."""

    __slots__ = ("name", "fn", "is_read_only", "is_always_interleave",
                 "is_one_way")

    def __init__(self, name: str, fn):
        self.name = name
        self.fn = fn  # unbound: called as fn(instance, *args, **kwargs)
        self.is_read_only = getattr(fn, "__orleans_read_only__", False)
        self.is_always_interleave = getattr(
            fn, "__orleans_always_interleave__", False)
        self.is_one_way = getattr(fn, "__orleans_one_way__", False)


class ClassInvokers:
    """Invoker set for one grain class under one silo filter-state."""

    __slots__ = ("cls", "methods", "silo_chain", "class_filtered",
                 "hot_ok", "stateless_cap", "nfilters", "version")

    def __init__(self, cls: type, silo_filters: list):
        self.cls = cls
        self.methods = {name: MethodInvoker(name, fn)
                        for name, fn in remote_methods(cls).items()}
        # fused filter chain, snapshotted (or the () "no filters" sentinel);
        # the grain-level on_incoming_call hook binds per instance at
        # invoke time, so only its presence is precomputed here
        self.silo_chain = tuple(silo_filters)
        self.class_filtered = \
            getattr(cls, "on_incoming_call", None) is not None
        # hot-lane eligibility, the class-level half: ordinary Grain
        # subclasses only (system targets / vector classes take the full
        # path), no filters of any kind. Stateless-worker replica sets
        # ARE eligible since the lane learned a cheap replica pick
        # (hotlane._pick_stateless_replica) — ``stateless_cap`` carries
        # the local replica cap so the lane serves IDLE replicas and
        # hands busy sets back to the catalog (whose least-loaded pick
        # and auto-scale semantics stay authoritative).
        self.stateless_cap = getattr(cls, "__orleans_stateless_worker__", 0)
        self.hot_ok = (not self.silo_chain
                       and not self.class_filtered
                       and isinstance(cls, type) and issubclass(cls, Grain))
        # revalidation tokens
        self.nfilters = len(silo_filters)
        self.version = getattr(cls, "__orleans_version__", 0)


class InvokerTable:
    """Per-silo cache of :class:`ClassInvokers`, built at activation-class
    registration (first activation of a class) and revalidated per lookup."""

    __slots__ = ("_silo", "_cache")

    def __init__(self, silo: "Silo"):
        self._silo = silo
        self._cache: dict[type, ClassInvokers] = {}

    def entry(self, cls: type) -> ClassInvokers:
        e = self._cache.get(cls)
        filters = self._silo.incoming_call_filters
        # revalidate by filter IDENTITY, not just count: remove-A-append-B
        # keeps the length but must still invalidate. The common no-filter
        # case short-circuits on the two int compares; the tuple compare
        # only runs when filters exist (already the slow path).
        if e is not None and e.nfilters == len(filters) and \
                e.version == getattr(cls, "__orleans_version__", 0) and \
                (e.nfilters == 0 or tuple(filters) == e.silo_chain):
            return e
        e = ClassInvokers(cls, filters)
        self._cache[cls] = e
        return e
