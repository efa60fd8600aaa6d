"""OTPU006 — purity of functions handed to jit / shard_map / pjit.

DrJAX-style traced-primitive discipline for the device tier: a function
traced by ``jax.jit``/``shard_map``/``pjit`` runs ONCE at trace time and
is then replayed as a compiled kernel — any host state it captures is
frozen at trace time, and any host state it mutates mutates only during
tracing (then silently never again). In ``dispatch/``, ``ops/`` and
``parallel/`` that means: no reads of ``self.*`` (host runtime objects),
no mutation of captured containers, no wall clock / host RNG.

Scope is limited to those directories by design: host-tier code is free
to close over runtime state.

The port's copy of ``orleans_tpu.analysis.rules.traced``. It knows the
JAX tracing entry points only (``jit``, ``pjit``, ``shard_map``,
``shard_map_compat``). The port runs eagerly and calls none of them, so
over ``orleans_tpu_torch`` this rule checks nothing; it matters once the
port captures code (CUDA graphs).
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..model import FileContext, Finding, Rule, register
from .common import dotted_name, func_params, lexical_walk

TRACING_WRAPPERS = {"jit", "pjit", "shard_map", "shard_map_compat"}
DEVICE_DIRS = ("dispatch", "ops", "parallel")

IMPURE_CALLS = {
    "time.time", "time.monotonic", "time.perf_counter", "time.time_ns",
    "time.monotonic_ns", "random.random", "random.randint",
    "random.choice", "random.shuffle", "random.uniform",
    "np.random", "numpy.random",
}

MUTATOR_METHODS = {
    "append", "extend", "add", "update", "insert", "remove", "pop",
    "popleft", "appendleft", "setdefault", "clear", "discard",
}


def _wrapper_target(call: ast.Call) -> "ast.expr | None":
    """First positional arg of a tracing-wrapper call, else None.
    Handles ``jax.jit(f)``, ``shard_map_compat(f, mesh=...)``,
    ``partial(jax.jit, ...)`` (returns None — no target yet)."""
    last = dotted_name(call.func).rsplit(".", 1)[-1]
    if last in TRACING_WRAPPERS and call.args:
        return call.args[0]
    return None


def _decorator_traces(dec: ast.expr) -> bool:
    """True for ``@jax.jit`` / ``@jit`` / ``@partial(jax.jit, ...)``."""
    if isinstance(dec, ast.Call):
        last = dotted_name(dec.func).rsplit(".", 1)[-1]
        if last in TRACING_WRAPPERS:
            return True
        if last == "partial" and dec.args:
            return dotted_name(dec.args[0]).rsplit(".", 1)[-1] \
                in TRACING_WRAPPERS
        return False
    return dotted_name(dec).rsplit(".", 1)[-1] in TRACING_WRAPPERS


def _in_device_dir(rel_path: str) -> bool:
    parts = rel_path.split("/")
    return any(d in parts for d in DEVICE_DIRS)


@register
class TracedImpurity(Rule):
    id = "OTPU006"
    name = "traced-impurity"
    severity = "warning"
    description = ("jit/shard_map/pjit-traced function captures or "
                   "mutates host runtime state")
    rationale = (
        "A function handed to jit/pjit/shard_map runs ONCE at trace "
        "time: attribute writes, captured-container mutations, and "
        "host clock/RNG reads are baked into the compiled program (or "
        "silently lost), then never re-execute. Kernel specs must be "
        "closure-pure — pass runtime values as traced arguments and "
        "use jax.random with explicit keys.")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _in_device_dir(ctx.rel_path):
            return
        # Scope-aware name resolution: a jit(f) call resolves `f` against
        # the defs of its OWN scope, then outward through the enclosing
        # scope chain — never against a same-named def in an unrelated
        # scope (two classes both defining an inner `local` must not
        # taint each other).
        defs_in_scope: dict[int, dict[str, list]] = {}
        calls_in_scope: dict[int, list] = {}
        parent: dict[int, "int | None"] = {id(ctx.tree): None}
        qualnames: dict[int, str] = {}
        scopes: list = [ctx.tree]

        def collect(scope: ast.AST, prefix: str) -> None:
            table = defs_in_scope.setdefault(id(scope), {})
            calls = calls_in_scope.setdefault(id(scope), [])
            for node in lexical_walk(scope):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.ClassDef)):
                    qn = f"{prefix}{node.name}"
                    parent[id(node)] = id(scope)
                    qualnames[id(node)] = qn
                    scopes.append(node)
                    if not isinstance(node, ast.ClassDef):
                        table.setdefault(node.name, []).append(node)
                    collect(node, qn + ".")
                elif isinstance(node, ast.Call):
                    calls.append(node)

        collect(ctx.tree, "")

        traced: list = []           # (node, qualname) — defs or lambdas
        seen: set[int] = set()

        def resolve(name: str, scope_id: "int | None") -> list:
            while scope_id is not None:
                hits = defs_in_scope.get(scope_id, {}).get(name)
                if hits:
                    return hits
                scope_id = parent.get(scope_id)
            return []

        def mark(target: "ast.expr | None", scope_id: int) -> None:
            if target is None:
                return
            if isinstance(target, ast.Lambda):
                if id(target) not in seen:
                    seen.add(id(target))
                    traced.append((target, "<lambda>"))
            elif isinstance(target, ast.Name):
                for d in resolve(target.id, scope_id):
                    if id(d) not in seen:
                        seen.add(id(d))
                        traced.append((d, qualnames[id(d)]))
            elif isinstance(target, ast.Call):
                # jit(shard_map_compat(f, ...)) — unwrap one level
                mark(_wrapper_target(target), scope_id)

        for scope in scopes:
            for call in calls_in_scope.get(id(scope), ()):
                mark(_wrapper_target(call), id(scope))
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and any(_decorator_traces(d)
                            for d in scope.decorator_list) \
                    and id(scope) not in seen:
                seen.add(id(scope))
                traced.append((scope, qualnames[id(scope)]))

        for fn, qualname in traced:
            yield from self._check_traced(ctx, fn, qualname)

    def _check_traced(self, ctx: FileContext, fn, qualname: str
                      ) -> Iterator[Finding]:
        params = func_params(fn)
        stmts = [fn.body] if isinstance(fn, ast.Lambda) else fn.body
        locals_: set[str] = set(params)
        for stmt in stmts:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Store):
                    locals_.add(node.id)
        for stmt in stmts:
            for node in ast.walk(stmt):
                # global/nonlocal escape hatches
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    yield ctx.finding(
                        self, node,
                        "traced function declares "
                        f"{'global' if isinstance(node, ast.Global) else 'nonlocal'}"
                        " — host state mutated during tracing only",
                        qualname)
                # attribute mutation: x.attr = ... / x.attr += ... —
                # objects BUILT inside the traced function are exempt
                # (same rule as the mutator-method check below): mutating
                # a local scratch object replays fine; mutating a
                # captured one happens at trace time only
                elif isinstance(node, (ast.Assign, ast.AugAssign,
                                       ast.AnnAssign)):
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for t in targets:
                        if not isinstance(t, ast.Attribute):
                            continue
                        # unwrap to the base name: out[0].tag = ... roots
                        # at `out` (a subscripted local is still local)
                        base = t.value
                        while isinstance(base, (ast.Attribute,
                                                ast.Subscript,
                                                ast.Starred)):
                            base = base.value
                        if not isinstance(base, ast.Name):
                            continue    # temporary (f().attr): no capture
                        root = base.id
                        if root == "self" and "self" not in params:
                            pass        # captured host object
                        elif root in locals_:
                            continue    # local scratch object
                        yield ctx.finding(
                            self, t,
                            f"traced function mutates attribute "
                            f"'{dotted_name(t) or t.attr}' — the write "
                            "happens at trace time only", qualname)
                elif isinstance(node, ast.Call):
                    name = dotted_name(node.func)
                    root = name.split(".", 1)[0] if name else ""
                    if (name in IMPURE_CALLS or
                            (root in ("random",) and root not in locals_)
                            or name.startswith(("np.random.",
                                                "numpy.random."))):
                        yield ctx.finding(
                            self, node,
                            f"nondeterministic host call '{name}' inside "
                            "traced function — evaluated once at trace "
                            "time; use jax.random with an explicit key",
                            qualname)
                    elif isinstance(node.func, ast.Attribute) and \
                            node.func.attr in MUTATOR_METHODS:
                        recv_root = dotted_name(node.func.value)
                        recv_root = recv_root.split(".", 1)[0] \
                            if recv_root else ""
                        if recv_root and recv_root not in locals_:
                            yield ctx.finding(
                                self, node,
                                f"traced function mutates captured host "
                                f"object '{dotted_name(node.func.value)}"
                                f".{node.func.attr}(...)' — the mutation "
                                "runs at trace time only", qualname)
                # reads of self.* capture host runtime objects
                elif isinstance(node, ast.Attribute) and \
                        isinstance(node.ctx, ast.Load) and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id == "self" and "self" not in params:
                    yield ctx.finding(
                        self, node,
                        f"traced function captures host runtime state "
                        f"'self.{node.attr}' — frozen at trace time; "
                        "pass it as a traced argument or hoist to a "
                        "static closure value deliberately", qualname)
