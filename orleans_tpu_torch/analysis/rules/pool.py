"""OTPU001 — pool discipline for freelist-recycled objects.

The hot lane introduced freelists for ``Message``
(``core.message.recycle_message``) and ``CallbackData``
(``runtime_client._recycle_callback``) plus the
hot-lane running marker (``hotlane._release_marker``). A released shell may
be re-acquired and re-initialized by any later allocation on the event
loop, so touching a local variable after passing it to a releaser is a
use-after-free with Python characteristics: no crash, just another call's
fields. The rule runs the shared release dataflow
(``analysis.summaries.ReleaseWalker``) over each candidate function and
reports

* any read of a name after it was released on every path reaching the
  read,
* a second release of an already-released name along one path.

The dataflow is **cross-function, alias-aware, and
loop-carried**: a helper whose summary definitely releases a parameter
poisons the caller's argument at the call site (the Infer-style
compositional propagation, resolved module-locally plus through explicit
imports); ``y = x`` (and ``y = helper(x)`` when the helper returns its
argument) makes ``y`` an alias whose release poisons the group; and loop
bodies run twice with the back-edge state merged in, so a release in
iteration N reaches a use in iteration N+1. Rebinding (``x = ...``) or
``del x`` still clears the released state.

Since the context-sensitivity upgrade the alias flow also crosses
container and attribute boundaries: ``self._pending = m`` makes the
attribute an alias of ``m``, ``batch.append(m)`` records membership so
an item-release of the batch (``recycle_messages`` or a callee whose
summary releases its container elements) poisons ``m``, and release
depth is closed CROSS-module at link time via the Program's release
overlay — a wrapper around an imported releaser poisons its callers'
arguments even through multiple modules. The legacy intra-procedural
configuration (no call-site propagation) stays available via the CLI's
``--intra-only``.

The port's copy of ``orleans_tpu.analysis.rules.pool``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..model import FileContext, Finding, Rule, register
from ..summaries import (
    ITEM_RELEASERS,
    RELEASERS,
    ReleaseWalker,
    _arg_cell_name,
    _call_alias,
    _call_releases,
    _call_releases_items,
)
from .common import iter_functions


def _direct_releases(call: ast.Call) -> list[str]:
    fn = call.func
    name = fn.attr if isinstance(fn, ast.Attribute) else \
        fn.id if isinstance(fn, ast.Name) else ""
    if name in RELEASERS and call.args:
        nm = _arg_cell_name(call.args[0])
        if nm is not None:
            return [nm]
    return []


def _direct_item_releases(call: ast.Call) -> list[str]:
    fn = call.func
    name = fn.attr if isinstance(fn, ast.Attribute) else \
        fn.id if isinstance(fn, ast.Name) else ""
    if name in ITEM_RELEASERS and call.args:
        nm = _arg_cell_name(call.args[0])
        if nm is not None:
            return [nm]
    return []


def _has_releaser_call(fn) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                f.id if isinstance(f, ast.Name) else ""
            if name in RELEASERS or name in ITEM_RELEASERS:
                return True
    return False


def _pos_params(fn) -> list[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args)]


@register
class PoolDiscipline(Rule):
    id = "OTPU001"
    name = "pool-discipline"
    severity = "error"
    description = ("pooled Message/CallbackData/marker used after "
                   "release, or released twice along one path")
    rationale = (
        "Freelist-recycled objects (Message, CallbackData, the hot-lane "
        "running marker) may be re-acquired and re-initialized by ANY "
        "later allocation the moment they are released. Reading one "
        "after release silently observes another request's fields — no "
        "crash, just wrong data on the wire. The analysis is "
        "interprocedural: a helper that definitely recycles its "
        "argument poisons the caller's variable, aliases share the "
        "poison, and loop-carried state catches a release in iteration "
        "N used in iteration N+1.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        program = ctx.program
        ms = ctx.module
        releasing_short: set[str] = set()
        if ms is not None:
            for q, s in ms.functions.items():
                if s.releases or s.releases_items:
                    releasing_short.add(q.rsplit(".", 1)[-1])
            if program is not None:
                for key, s in program.functions.items():
                    eff = program.release_summary(key)
                    if eff.releases or eff.releases_items:
                        releasing_short.add(key[1].rsplit(".", 1)[-1])

        for qualname, fn in iter_functions(ctx.tree):
            candidate = _has_releaser_call(fn)
            if not candidate and releasing_short:
                for node in ast.walk(fn):
                    if isinstance(node, ast.Call):
                        f = node.func
                        name = f.attr if isinstance(f, ast.Attribute) \
                            else f.id if isinstance(f, ast.Name) else ""
                        if name in releasing_short:
                            candidate = True
                            break
            if not candidate:
                continue

            findings: list[Finding] = []

            def on_use(node, name, line, _q=qualname, _f=findings):
                _f.append(ctx.finding(
                    self, node,
                    f"pooled '{name}' used after release", _q))

            def on_double(node, name, _q=qualname, _f=findings):
                _f.append(ctx.finding(
                    self, node,
                    f"pooled '{name}' released twice along one path",
                    _q))

            if ms is not None:
                extern = program.extern_summary(ms, qualname) \
                    if program is not None else None
                rel = (lambda c, _q=qualname, _e=extern:
                       _call_releases(ms, _q, c, _e))
                alias = (lambda c, _q=qualname, _e=extern:
                         _call_alias(ms, _q, c, _e))
                items = (lambda c, _q=qualname, _e=extern:
                         _call_releases_items(ms, _q, c, _e))
            else:
                rel = _direct_releases
                alias = None
                items = _direct_item_releases

            walker = ReleaseWalker(_pos_params(fn), release_of_call=rel,
                                   alias_of_call=alias, on_use=on_use,
                                   on_double=on_double,
                                   items_release_of_call=items)
            walker.run(fn.body)
            yield from findings
