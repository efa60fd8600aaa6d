"""OTPU002 blocking-in-turn and OTPU003 interleaving-hazard.

Turn discipline: a grain/runtime turn is one coroutine sharing the silo's
event loop with every other activation. A synchronous block inside an
``async def`` (``time.sleep``, sync socket/file IO, ``Future.result()``)
stalls the whole silo, not one grain (OTPU002). And in a non-reentrant
grain the author assumes no interleaving — but ``always_interleave``
methods, call-chain reentrancy, read-only interleaving, and timer turns
can all run between an ``await`` and the code after it, so instance state
written before an await must be re-validated when read after it
(OTPU003).

The port's copy of ``orleans_tpu.analysis.rules.turns``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..model import FileContext, Finding, Rule, register
from .common import (
    decorator_names,
    dotted_name,
    is_reentrant_grain,
    iter_functions,
    iter_grain_classes,
    lexical_walk,
)

# Dotted call names that block the event loop outright.
BLOCKING_CALLS = {
    "time.sleep": "time.sleep() blocks the event loop; await asyncio.sleep",
    "os.system": "os.system() blocks the event loop",
    "subprocess.run": "subprocess.run() blocks the event loop",
    "subprocess.call": "subprocess.call() blocks the event loop",
    "subprocess.check_call": "subprocess.check_call() blocks the event loop",
    "subprocess.check_output":
        "subprocess.check_output() blocks the event loop",
    "socket.create_connection":
        "sync socket connect blocks the event loop",
    "urllib.request.urlopen": "sync HTTP blocks the event loop",
    "requests.get": "sync HTTP blocks the event loop",
    "requests.post": "sync HTTP blocks the event loop",
    "requests.request": "sync HTTP blocks the event loop",
}


@register
class BlockingInTurn(Rule):
    id = "OTPU002"
    name = "blocking-in-turn"
    severity = "error"
    description = ("time.sleep / sync IO / Future.result() inside an "
                   "async def turn")
    rationale = (
        "A grain turn shares the silo's single event loop with every "
        "other activation: one synchronous sleep, file read, or "
        ".result() wait stalls the WHOLE silo — probe responses "
        "included, which gets healthy silos voted dead under load. "
        "Await the async form, or move the blocking work to "
        "loop.run_in_executor.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for qualname, fn in iter_functions(ctx.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in lexical_walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name in BLOCKING_CALLS:
                    yield ctx.finding(self, node,
                                      f"{BLOCKING_CALLS[name]} in async "
                                      "turn", qualname)
                elif name == "open":
                    yield ctx.finding(
                        self, node,
                        "sync file IO (open) in async turn; use a thread "
                        "executor or accept the stall explicitly", qualname)
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "result" and not node.args \
                        and not node.keywords:
                    yield ctx.finding(
                        self, node,
                        "synchronous .result() in async turn blocks the "
                        "event loop unless the future is already done",
                        qualname)


class _InterleaveScan(ast.NodeVisitor):
    """Lexical-order event scan of one async grain method: attribute
    writes on ``self``, awaits, attribute reads on ``self``. Writes that
    an await has 'crossed' are hazardous to read until rewritten."""

    def __init__(self, rule: Rule, ctx: FileContext, qualname: str,
                 self_name: str):
        self.rule = rule
        self.ctx = ctx
        self.qualname = qualname
        self.self_name = self_name
        self.written: set[str] = set()
        self.crossed: set[str] = set()
        self.flagged: set[str] = set()
        self.findings: list[Finding] = []

    # -- helpers ---------------------------------------------------------
    def _is_self_attr(self, node: ast.AST) -> "str | None":
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == self.self_name:
            return node.attr
        return None

    def _write(self, attr: str) -> None:
        self.written.add(attr)
        self.crossed.discard(attr)

    def _read(self, node: ast.Attribute, attr: str) -> None:
        if attr in self.crossed and attr not in self.flagged:
            self.flagged.add(attr)
            self.findings.append(self.ctx.finding(
                self.rule, node,
                f"grain attribute '{attr}' written before an await and "
                "read after it in a non-reentrant grain method; an "
                "interleaved turn may have changed it — re-validate or "
                "move the await", self.qualname))

    # -- visitors (source order) ----------------------------------------
    def visit_If(self, node: ast.If) -> None:
        """Branch-aware: the else branch must not observe the then
        branch's write/await sequence (they are mutually exclusive).
        After the if, the union of branch states holds — a read then is
        hazardous if EITHER branch wrote-and-awaited."""
        self.visit(node.test)
        snap = (set(self.written), set(self.crossed))
        for s in node.body:
            self.visit(s)
        then_state = (self.written, self.crossed)
        self.written, self.crossed = set(snap[0]), set(snap[1])
        for s in node.orelse:
            self.visit(s)
        self.written |= then_state[0]
        self.crossed |= then_state[1]

    def visit_Await(self, node: ast.Await) -> None:
        self.generic_visit(node)        # reads inside the awaited expr
        self.crossed |= self.written

    def _write_target(self, t: ast.expr) -> None:
        """Register writes for one assignment target, unpacking
        tuple/list/starred targets (``self.a, self.b = ...``)."""
        attr = self._is_self_attr(t)
        if attr is not None:
            self._write(attr)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._write_target(el)
        elif isinstance(t, ast.Starred):
            self._write_target(t.value)
        else:
            self.visit(t)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)          # RHS reads happen first
        for t in node.targets:
            self._write_target(t)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
        attr = self._is_self_attr(node.target)
        if attr is not None:
            self._write(attr)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.visit(node.value)
        attr = self._is_self_attr(node.target)
        if attr is not None:
            # read-modify-write: the read half observes the stale value
            self._read(node.target, attr)
            self._write(attr)
        else:
            self.visit(node.target)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = self._is_self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            self._read(node, attr)
        self.generic_visit(node)

    # nested defs/lambdas execute later — out of turn order
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass


@register
class InterleavingHazard(Rule):
    id = "OTPU003"
    name = "interleaving-hazard"
    severity = "warning"
    description = ("grain attribute written before and read after an "
                   "await in a non-reentrant grain method")
    rationale = (
        "Non-reentrant grains still interleave at awaits: "
        "always-interleave methods, call-chain reentrancy, read-only "
        "interleaving, and timer turns can all run between an await "
        "and the statement after it. Instance state written before "
        "the await may be stale when read after — re-validate it, or "
        "move the await so the read-modify-write is atomic within "
        "one turn segment.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for cls_qual, cls in iter_grain_classes(ctx.tree):
            if is_reentrant_grain(cls):
                continue
            for stmt in cls.body:
                if not isinstance(stmt, ast.AsyncFunctionDef):
                    continue
                if "staticmethod" in decorator_names(stmt) or \
                        not stmt.args.args:
                    continue
                scan = _InterleaveScan(self, ctx,
                                       f"{cls_qual}.{stmt.name}",
                                       stmt.args.args[0].arg)
                for s in stmt.body:
                    scan.visit(s)
                yield from scan.findings
