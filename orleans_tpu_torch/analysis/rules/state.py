"""OTPU004 mutable-state-leak and OTPU005 unawaited-grain-call.

OTPU004: in-silo calls pass results by reference after ``copy_result``
isolation — but a grain method that does ``return self._rows`` hands the
caller the grain's OWN container on the direct-interleave and testing
paths, and the copy-isolation layer then shares structure across turns.
Returning internal mutable state by reference breaks the actor isolation
contract; return a copy.

OTPU005: ``ref.method(...)`` on a grain reference returns a coroutine;
dropping it on the floor means the call never happens (Python never
schedules it) — the classic silent-no-op. Either ``await`` it, keep the
handle (``t = ref.m()`` / ``asyncio.ensure_future(...)``), or mark intent
with ``# otpu: ignore[OTPU005]`` for a deliberate drop.

The port's copy of ``orleans_tpu.analysis.rules.state``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..model import FileContext, Finding, Rule, register
from .common import (
    dotted_name,
    iter_functions,
    iter_grain_classes,
    lexical_walk,
)

MUTABLE_CTORS = {
    "list", "dict", "set", "bytearray", "defaultdict", "deque",
    "Counter", "OrderedDict",
}

GRAIN_REF_PRODUCERS = {"get_grain", "get_ref", "grain_ref"}


def _is_mutable_value(node: ast.expr) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return dotted_name(node.func).rsplit(".", 1)[-1] in MUTABLE_CTORS
    return False


@register
class MutableStateLeak(Rule):
    id = "OTPU004"
    name = "mutable-state-leak"
    severity = "warning"
    description = ("grain method returns a shared mutable internal "
                   "by reference")
    rationale = (
        "In-silo calls pass results by reference on the hot lane and "
        "direct-interleave paths: returning self._rows hands the "
        "caller the grain's OWN container, and a later turn's "
        "mutation is visible across the actor isolation boundary. "
        "Return a copy (list(...)/dict(...)).")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for cls_qual, cls in iter_grain_classes(ctx.tree):
            mutable_attrs: set[str] = set()
            for node in ast.walk(cls):
                if isinstance(node, ast.Assign) and \
                        _is_mutable_value(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            mutable_attrs.add(t.attr)
                elif isinstance(node, ast.AnnAssign) and \
                        node.value is not None and \
                        _is_mutable_value(node.value) and \
                        isinstance(node.target, ast.Attribute) and \
                        isinstance(node.target.value, ast.Name) and \
                        node.target.value.id == "self":
                    mutable_attrs.add(node.target.attr)
            if not mutable_attrs:
                continue
            for stmt in cls.body:
                if not isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Return) and \
                            isinstance(node.value, ast.Attribute) and \
                            isinstance(node.value.value, ast.Name) and \
                            node.value.value.id == "self" and \
                            node.value.attr in mutable_attrs:
                        a = node.value.attr
                        yield ctx.finding(
                            self, node,
                            f"returns shared mutable grain state "
                            f"'self.{a}' by reference; return a copy "
                            f"(e.g. list(self.{a}) / dict(self.{a}))",
                            f"{cls_qual}.{stmt.name}")


@register
class UnawaitedGrainCall(Rule):
    id = "OTPU005"
    name = "unawaited-grain-call"
    severity = "error"
    description = ("grain-ref coroutine dropped without await or an "
                   "explicit fire-and-forget marker")
    rationale = (
        "ref.method() returns a coroutine; dropping it on the floor "
        "means Python never schedules it — the call silently does "
        "not happen. Await it, keep the handle, or mark a deliberate "
        "drop with # otpu: ignore[OTPU005]. @one_way methods are "
        "exempt via the typed interface tables: their invoke returns "
        "None by design.")

    def _ref_class(self, ctx: FileContext, call: ast.Call) -> str | None:
        """The grain class a get_grain(...) call names, when the program
        has an interface table for it."""
        if ctx.program is None or not call.args:
            return None
        name = dotted_name(call.args[0]).rsplit(".", 1)[-1]
        return name if name and name in ctx.program.grains else None

    def _is_one_way(self, ctx: FileContext, cls: str | None,
                    method: str) -> bool:
        """A dropped @one_way call is the CORRECT usage (the invoke
        returns None, there is no coroutine to lose) — the typed
        interface table makes that knowable statically."""
        if cls is None or ctx.program is None:
            return False
        gm = ctx.program.grains[cls].methods.get(method)
        return gm is not None and gm.one_way

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for qualname, fn in iter_functions(ctx.tree):
            # which Name-store nodes bind a grain ref (targets of
            # `x = <something>.get_grain(...)` assignments), and the
            # grain class when the call names it literally
            ref_binds: dict[int, str | None] = {}
            for node in lexical_walk(fn):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call) and \
                        dotted_name(node.value.func).rsplit(".", 1)[-1] \
                        in GRAIN_REF_PRODUCERS:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            ref_binds[id(t)] = self._ref_class(
                                ctx, node.value)
            # single lexical pass: a rebind to anything else KILLS the
            # ref-ness of the name, so `r = get_grain(..); r = conn();
            # r.flush()` is not flagged
            refs: dict[str, str | None] = {}
            for node in lexical_walk(fn):
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, (ast.Store, ast.Del)):
                    if id(node) in ref_binds:
                        refs[node.id] = ref_binds[id(node)]
                    else:
                        refs.pop(node.id, None)
                    continue
                if not (isinstance(node, ast.Expr) and
                        isinstance(node.value, ast.Call)):
                    continue
                call = node.value
                if not isinstance(call.func, ast.Attribute):
                    continue
                recv = call.func.value
                cls = None
                dropped = False
                if isinstance(recv, ast.Name) and recv.id in refs:
                    dropped = True
                    cls = refs[recv.id]
                elif isinstance(recv, ast.Call) and \
                        dotted_name(recv.func).rsplit(".", 1)[-1] \
                        in GRAIN_REF_PRODUCERS:
                    dropped = True
                    cls = self._ref_class(ctx, recv)
                if dropped and not self._is_one_way(ctx, cls,
                                                    call.func.attr):
                    yield ctx.finding(
                        self, call,
                        f"grain call '.{call.func.attr}(...)' result "
                        "dropped — the coroutine is never scheduled; "
                        "await it, keep the handle, or mark the drop "
                        "with # otpu: ignore[OTPU005]", qualname)
