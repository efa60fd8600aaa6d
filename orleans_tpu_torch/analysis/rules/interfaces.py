"""OTPU009 — typed grain-interface checks (the Roslyn
``IncorrectGrainInterface`` analog).

Python grains have no codegen'd interfaces: a method name is a string
until the call fails at runtime — at the callee silo, one network hop
too late. Phase 1 builds per-class interface tables from the grain class
definitions themselves (host tier: public ``async def``s of ``Grain``
subclasses with positional arity, keyword names and ``@one_way``;
device tier: ``@actor_method`` handlers of ``VectorGrain`` subclasses,
inheritance-merged), and this rule checks every site where code commits
to a (class, method) pair statically:

* ``get_grain(Cls, key)`` call shapes (its own 2-3-arg contract), the
  methods invoked on refs assigned from it — existence, positional
  arity, keyword names — and ``await`` of a ``@one_way`` method (which
  returns None, not an awaitable);
* ``call_batch(Cls, "method", ...)`` method-name strings;
* ``map_actors`` / ``reduce_actors`` / ``broadcast_actors`` /
  ``join_when(method=...)`` — the named class must be a device-tier
  grain and the method an ``@actor_method`` handler.

Sites whose class argument is a variable (the runtime plumbing itself)
are skipped — the rule fires only where the class is named literally,
so a finding is always actionable.

The port's copy of ``orleans_tpu.analysis.rules.interfaces``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..model import FileContext, Finding, Rule, register
from ..summaries import dotted_name
from .common import iter_functions, lexical_walk

_BULK_VECTOR = {"map_actors", "reduce_actors", "reduce_actors_partial",
                "broadcast_actors"}


def _class_arg(node: ast.Call, program):
    """First positional arg as a known grain-class name, else None."""
    if not node.args:
        return None
    name = dotted_name(node.args[0]).rsplit(".", 1)[-1]
    return name if name and name in program.grains else None


def _method_str(node: ast.AST):
    return node.value if isinstance(node, ast.Constant) and \
        isinstance(node.value, str) else None


@register
class GrainInterface(Rule):
    id = "OTPU009"
    name = "grain-interface"
    severity = "error"
    description = ("grain call site disagrees with the class's "
                   "interface table (unknown method, wrong arity, "
                   "awaited one-way, or host grain in a device-tier "
                   "collective)")
    rationale = (
        "Grain method names are strings and refs are late-bound: a "
        "typo'd method, a wrong argument count, or a host-tier class "
        "handed to map_actors fails at the CALLEE silo, one network "
        "hop and one serialization round after the mistake. The "
        "interface tables are built from the grain class definitions "
        "(public async defs / @actor_method handlers, inheritance-"
        "merged), so the same check the Roslyn IncorrectGrainInterface "
        "analyzer performs at compile time happens here at lint time. "
        "Awaiting a @one_way method is flagged too — one-way invokes "
        "return None, so the await raises TypeError at runtime.")

    # -- per-shape checks -----------------------------------------------
    def _check_get_grain(self, ctx, node, qualname):
        cls = _class_arg(node, ctx.program)
        if cls is None:
            return None, []
        if any(isinstance(a, ast.Starred) for a in node.args) or \
                any(kw.arg is None for kw in node.keywords):
            return cls, []              # *args/**kwargs: unknown shape
        out = []
        kw_names = [kw.arg for kw in node.keywords]
        bad_kw = [k for k in kw_names if k not in ("key", "key_ext")]
        missing_key = len(node.args) < 2 and "key" not in kw_names
        if len(node.args) > 3 or bad_kw or missing_key:
            detail = f"got {len(node.args)} positional arg(s)"
            if bad_kw:
                detail += f" and keyword(s) {bad_kw}"
            if missing_key:
                detail += " — 'key' is required"
            out.append(ctx.finding(
                self, node,
                f"get_grain({cls}, ...) takes (grain_class, key, "
                f"key_ext) — {detail}", qualname))
        return cls, out

    def _check_ref_call(self, ctx, node, cls, awaited, qualname):
        meth = node.func.attr
        if meth.startswith("_"):
            return
        tbl = ctx.program.grains[cls]
        gm = tbl.methods.get(meth)
        if gm is None:
            known = ", ".join(sorted(tbl.methods)) or "none"
            yield ctx.finding(
                self, node,
                f"{cls} has no remote method '{meth}' "
                f"(remote methods: {known})", qualname)
            return
        if tbl.kind == "vector":
            return  # handler args ride kwargs dicts — no arity here
        if any(isinstance(a, ast.Starred) for a in node.args) or \
                any(kw.arg is None for kw in node.keywords):
            return  # *args/**kwargs at the call site: unknown arity
        npos = len(node.args)
        kw_names = [kw.arg for kw in node.keywords]
        if npos > (gm.max_pos if gm.max_pos is not None else npos) or \
                npos + len(kw_names) < gm.min_pos:
            want = f"{gm.min_pos}" if gm.max_pos == gm.min_pos else \
                f"{gm.min_pos}-{'*' if gm.max_pos is None else gm.max_pos}"
            yield ctx.finding(
                self, node,
                f"{cls}.{meth} takes {want} argument(s) — call passes "
                f"{npos} positional + {len(kw_names)} keyword",
                qualname)
        elif not gm.has_kwargs:
            for kw in kw_names:
                if kw not in gm.kwonly:
                    yield ctx.finding(
                        self, node,
                        f"{cls}.{meth} has no parameter '{kw}'",
                        qualname)
        if gm.one_way and awaited:
            yield ctx.finding(
                self, node,
                f"{cls}.{meth} is @one_way (returns None) — "
                "awaiting it raises TypeError", qualname)

    def _check_bulk(self, ctx, node, name, qualname):
        program = ctx.program
        cls = _class_arg(node, program)
        if cls is None:
            return
        tbl = program.grains[cls]
        if name == "call_batch":
            meth = _method_str(node.args[1]) if len(node.args) > 1 \
                else None
            if meth is not None and meth not in tbl.methods:
                yield ctx.finding(
                    self, node,
                    f"call_batch: {cls} has no method '{meth}'",
                    qualname)
            return
        # device-tier collectives
        if tbl.kind != "vector":
            yield ctx.finding(
                self, node,
                f"{name} requires a device-tier (VectorGrain) class — "
                f"{cls} is a host-tier grain", qualname)
            return
        meth = None
        if name == "join_when":
            for kw in node.keywords:
                if kw.arg == "method":
                    meth = _method_str(kw.value)
        elif len(node.args) > 1:
            meth = _method_str(node.args[1])
        if meth is not None and meth not in tbl.methods:
            known = ", ".join(sorted(tbl.methods)) or "none"
            yield ctx.finding(
                self, node,
                f"{name}: {cls} has no @actor_method '{meth}' "
                f"(handlers: {known})", qualname)

    # -- the rule's entry -----------------------------------------------
    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.program is None or not ctx.program.grains:
            return
        for qualname, fn in iter_functions(ctx.tree):
            # which Name-store nodes bind a typed grain ref (same
            # two-pass shape as OTPU005: binding effects apply at the
            # Store node's LEXICAL position, so a rebind to something
            # else kills the ref-ness for the calls after it — and only
            # those)
            ref_binds: dict[int, str] = {}
            for node in lexical_walk(fn):
                if isinstance(node, ast.Assign) and \
                        len(node.targets) == 1 and \
                        isinstance(node.targets[0], ast.Name) and \
                        isinstance(node.value, ast.Call) and \
                        isinstance(node.value.func, ast.Attribute) and \
                        node.value.func.attr == "get_grain":
                    cls = _class_arg(node.value, ctx.program)
                    if cls is not None:
                        ref_binds[id(node.targets[0])] = cls
            awaited_calls = {
                id(n.value) for n in lexical_walk(fn)
                if isinstance(n, ast.Await) and
                isinstance(n.value, ast.Call)}
            refs: dict[str, str] = {}   # live name → grain class
            for node in lexical_walk(fn):
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, (ast.Store, ast.Del)):
                    if id(node) in ref_binds:
                        refs[node.id] = ref_binds[id(node)]
                    else:
                        refs.pop(node.id, None)
                    continue
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else \
                    f.id if isinstance(f, ast.Name) else ""
                if name == "get_grain":
                    cls, findings = self._check_get_grain(
                        ctx, node, qualname)
                    yield from findings
                elif name in _BULK_VECTOR or name in ("call_batch",
                                                      "join_when"):
                    yield from self._check_bulk(ctx, node, name,
                                                qualname)
                # ref method calls: r.meth(...) and chained
                # get_grain(C, k).meth(...)
                if isinstance(f, ast.Attribute):
                    base = f.value
                    cls = None
                    if isinstance(base, ast.Name) and base.id in refs:
                        cls = refs[base.id]
                    elif isinstance(base, ast.Call) and isinstance(
                            base.func, ast.Attribute) and \
                            base.func.attr == "get_grain":
                        cls = _class_arg(base, ctx.program)
                    if cls is not None:
                        yield from self._check_ref_call(
                            ctx, node, cls, id(node) in awaited_calls,
                            qualname)
