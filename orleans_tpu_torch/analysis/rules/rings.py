"""OTPU010 — shm-ring discipline for the cross-process tier.

``runtime/multiproc.py`` stretches the multiloop SpscRing contract over
a process boundary: one shared-memory segment per direction, cumulative
u64 counters with exactly ONE writing side each, opaque-bytes records,
and a drain-before-unlink shutdown so ``pushed == drained`` holds when
the segment disappears. None of that is testable exhaustively — a
wrong-side counter store corrupts the backlog signal only under racing
load, and an object reference pushed across a segment deserializes as
garbage only in the *other* process. This rule audits the discipline
statically, in four checks:

**A — single-writer counters.** A ring counter may only be stored by
its owning side. Two shapes are recognised: header-offset stores
(``self._store(_OFF_READ, ...)`` / ``pack_into(.., _OFF_PUSHED, ..)``
against the shared ``_OFF_*`` layout constants) and cumulative counter
attributes (``self.pushed_* `` / ``self.drained_*`` on a class that
maintains both families — the SpscRing shape). The writing method's
side comes from its name (``*push*`` = producer; ``*pop*``/``*drain*``/
``*discard*`` = consumer); ``__init__`` is exempt (construction
precedes concurrency). A store from the opposite side OR from a method
on neither side is flagged — a "reset" helper that zeroes a cumulative
counter is exactly the race the layout comment forbids.

**B — only bytes cross a segment.** The payload handed to ``push`` on
an shm-owning ring (or to the native ``shm_push(buf, cap, payload,
n)``) must provably be bytes: a bytes literal, a serializer call
(``dumps``/``pack``/``to_bytes``/``encode``/...), a ``bytes``-annotated
parameter, or a local whose every assignment is one of those. A
container literal, str, or constructor result is a Python object
reference — meaningless in the consumer's address space — and is
flagged. Unprovable payloads are skipped, not flagged.

**C — drain-before-unlink.** Any function that unlinks a shared-memory
segment (an ``unlink`` call whose receiver chain mentions ``shm``) must
take a final drain sweep first (an earlier call whose name contains
``drain`` or ``pop``), so every pushed record is accounted before the
backing pages go away. Functions that themselves CREATE the segment
(``SharedMemory(create=True)`` rollback paths) are exempt.

**D — dual-affinity container mutation.** A list/dict/set attribute
mutated structurally (pop/remove/clear/subscript-store/...) from
worker-thread context while the main loop also touches it needs a lock
or fence; flagged when the worker-side mutation is bare. Plain appends
from the worker are the sanctioned stamp-and-replay feed (appends are
not writes — the OTPU007 contract), and ``deque`` attributes are the
sanctioned GIL-atomic hand-off (the SpscRing ``_items`` discipline), so
neither is flagged; shm-owning ring classes are covered by check A
instead. This check needs the linked program (worker affinity is a
phase-2 fixpoint) and is skipped under ``--intra-only``.

The free-threading direction is the motivation: every one of these
is a latent ``nogil`` crash that the GIL currently papers over.

The port's copy of ``orleans_tpu.analysis.rules.rings``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..model import FileContext, Finding, Rule, register
from ..summaries import dotted_name
from .common import iter_functions

# header-offset layout constants (multiproc.ShmRing and hotwire.c agree
# on these by name)
_PRODUCER_OFFS = {"_OFF_WRITE", "_OFF_PUSHED"}
_CONSUMER_OFFS = {"_OFF_READ", "_OFF_DRAINED"}
_PRODUCER_HINTS = ("push",)
_CONSUMER_HINTS = ("pop", "drain", "discard")
_STORE_NAMES = {"_store", "pack_into"}

_SERIALIZERS = {"dumps", "pack", "to_bytes", "tobytes", "encode",
                "serialize", "bytes", "bytearray", "memoryview"}

# container mutators; append/appendleft are the sanctioned worker-side
# stamp feed and are judged separately
_MUTATORS = {"append", "appendleft", "extend", "insert", "add", "pop",
             "popleft", "popitem", "remove", "discard", "clear",
             "update", "setdefault"}
_FEED_ONLY = {"append", "appendleft"}


def _method_side(name: str) -> str | None:
    """'producer' | 'consumer' | None from a method's short name."""
    low = name.lower()
    prod = any(h in low for h in _PRODUCER_HINTS)
    cons = any(h in low for h in _CONSUMER_HINTS)
    if prod and not cons:
        return "producer"
    if cons and not prod:
        return "consumer"
    return None


def _counter_owner(attr: str) -> str | None:
    if attr.startswith("pushed"):
        return "producer"
    if attr.startswith("drained"):
        return "consumer"
    return None


def _chain(call: ast.Call) -> tuple:
    dn = dotted_name(call.func)
    return tuple(dn.split(".")) if dn else ()


def _bytes_params(fn) -> set:
    out = set()
    a = fn.args
    for p in (*a.posonlyargs, *a.args, *a.kwonlyargs):
        ann = p.annotation
        if isinstance(ann, ast.Name) and ann.id == "bytes":
            out.add(p.arg)
        elif isinstance(ann, ast.Constant) and ann.value == "bytes":
            out.add(p.arg)
    return out


def _local_assigns(fn) -> dict:
    """name → [every value expr assigned to that bare name]."""
    out: dict = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            out.setdefault(node.targets[0].id, []).append(node.value)
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name) and \
                node.value is not None:
            out.setdefault(node.target.id, []).append(node.value)
    return out


def _payload_verdict(expr, assigns: dict, bytes_params: set,
                     depth: int = 0) -> str:
    """'ok' (provably bytes) | 'bad' (provably an object ref) |
    'unknown' (skipped — the check only convicts on proof)."""
    if depth > 3:
        return "unknown"
    if isinstance(expr, ast.Constant):
        return "ok" if isinstance(expr.value, bytes) else "bad"
    if isinstance(expr, (ast.List, ast.Tuple, ast.Set, ast.Dict,
                         ast.ListComp, ast.SetComp, ast.DictComp,
                         ast.JoinedStr)):
        return "bad"
    if isinstance(expr, ast.Call):
        last = _chain(expr)[-1:] or ("",)
        if last[0] in _SERIALIZERS:
            return "ok"
        if isinstance(expr.func, ast.Name) and expr.func.id[:1].isupper():
            return "bad"            # constructor by convention
        return "unknown"
    if isinstance(expr, ast.Name):
        if expr.id in bytes_params:
            return "ok"
        vals = assigns.get(expr.id)
        if not vals:
            return "unknown"
        verdicts = {_payload_verdict(v, assigns, bytes_params, depth + 1)
                    for v in vals}
        if "bad" in verdicts:
            return "bad"
        if verdicts == {"ok"}:
            return "ok"
        return "unknown"
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        l = _payload_verdict(expr.left, assigns, bytes_params, depth + 1)
        r = _payload_verdict(expr.right, assigns, bytes_params, depth + 1)
        if "bad" in (l, r):
            return "bad"
        return "ok" if (l, r) == ("ok", "ok") else "unknown"
    if isinstance(expr, ast.IfExp):
        b = _payload_verdict(expr.body, assigns, bytes_params, depth + 1)
        o = _payload_verdict(expr.orelse, assigns, bytes_params,
                             depth + 1)
        if "bad" in (b, o):
            return "bad"
        return "ok" if (b, o) == ("ok", "ok") else "unknown"
    return "unknown"


def _lockish(expr) -> bool:
    """A with-item that provides mutual exclusion: anything whose
    dotted name mentions lock or the tick fence."""
    if isinstance(expr, ast.Call):
        expr = expr.func
    dn = dotted_name(expr).lower()
    return any("lock" in seg or "fence" in seg for seg in dn.split("."))


def _self_attr_of(node) -> str | None:
    """'self.X' expression → 'X'."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


@register
class RingDiscipline(Rule):
    id = "OTPU010"
    name = "shm-ring-discipline"
    severity = "error"
    description = ("cross-process SPSC ring invariant broken: wrong-"
                   "side counter store, non-bytes payload across an "
                   "shm segment, unlink without a final drain, or an "
                   "unlocked dual-affinity container mutation")
    rationale = (
        "The shm rings interoperate with a native producer/consumer on "
        "a bare byte layout: each cumulative counter has exactly one "
        "writing side (a wrong-side store is a lost-update race that "
        "corrupts the backlog/backpressure signal), payloads must be "
        "bytes (an object reference is meaningless in the peer "
        "process), and segments must be drained before unlink so "
        "pushed == drained holds at teardown. Off-loop structural "
        "mutation of a shared list/dict without a lock is the same "
        "bug one tier down — all of these are latent nogil crashes "
        "the GIL currently hides.")

    # ---- A: header-offset counter stores ----------------------------
    def _check_offsets(self, ctx, qual, fn) -> Iterator[Finding]:
        side = _method_side(qual.rsplit(".", 1)[-1])
        if qual.rsplit(".", 1)[-1] == "__init__":
            return
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            ch = _chain(node)
            if not ch or ch[-1] not in _STORE_NAMES:
                continue
            for arg in node.args:
                if not isinstance(arg, ast.Name):
                    continue
                owner = "producer" if arg.id in _PRODUCER_OFFS else \
                    "consumer" if arg.id in _CONSUMER_OFFS else None
                if owner is None or owner == side:
                    continue
                where = f"the {side} side" if side else \
                    "a method on neither ring side"
                yield ctx.finding(
                    self, node,
                    f"{owner}-owned ring counter '{arg.id}' stored from "
                    f"{where}; only the owning side may write a "
                    "cumulative counter (single-writer SPSC contract)",
                    qual)

    # ---- A: cumulative counter attributes ---------------------------
    def _check_counter_attrs(self, ctx, tree) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            # (method, counter attr, owner, anchor) for every mutation
            muts = []
            for meth in node.body:
                if not isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                for sub in ast.walk(meth):
                    if isinstance(sub, ast.AugAssign):
                        targets = [sub.target]
                    elif isinstance(sub, ast.Assign):
                        targets = sub.targets
                    else:
                        continue
                    for t in targets:
                        attr = _self_attr_of(t)
                        owner = _counter_owner(attr) if attr else None
                        if owner is not None:
                            muts.append((meth.name, attr, owner, sub))
            owners = {m[2] for m in muts}
            if owners != {"producer", "consumer"}:
                continue                # not a two-sided ring class
            for meth_name, attr, owner, anchor in muts:
                if meth_name == "__init__":
                    continue
                side = _method_side(meth_name)
                if side == owner:
                    continue
                where = f"the {side}-side method '{meth_name}'" \
                    if side else f"'{meth_name}', a method on neither " \
                    "ring side"
                yield ctx.finding(
                    self, anchor,
                    f"{owner}-owned cumulative counter 'self.{attr}' "
                    f"written from {where}; only the owning side may "
                    "write it (single-writer SPSC contract)",
                    f"{node.name}.{meth_name}")

    # ---- B: bytes-only payloads -------------------------------------
    def _shm_receiver(self, program, ms, qual, ch) -> bool:
        if len(ch) < 2:
            return False
        if ch[:-1] == ("self",):
            cls = program.enclosing_class(ms, qual)
        else:
            cls = program.receiver_class(ms, qual, ch[:-1])
        if cls is None:
            return False
        hit = program.class_index.get(cls)
        return hit is not None and hit[1].shm_owner

    def _check_payloads(self, ctx, program, ms, qual,
                        fn) -> Iterator[Finding]:
        assigns = _local_assigns(fn)
        bparams = _bytes_params(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            ch = _chain(node)
            if not ch:
                continue
            payload = None
            if ch[-1] == "shm_push":
                # native: shm_push(buf, capacity, payload, n_msgs)
                if len(node.args) >= 3:
                    payload = node.args[2]
            elif ch[-1] in ("push", "_push_py") and \
                    self._shm_receiver(program, ms, qual, ch):
                if node.args:
                    payload = node.args[0]
            if payload is None:
                for kw in node.keywords:
                    if kw.arg == "payload":
                        payload = kw.value
            if payload is None:
                continue
            if _payload_verdict(payload, assigns, bparams) == "bad":
                yield ctx.finding(
                    self, node,
                    "non-bytes payload crosses the shm segment via "
                    f"'{'.'.join(ch)}'; only bytes/struct-packed "
                    "records are meaningful in the peer process — "
                    "serialize first (pickle.dumps/struct.pack)", qual)

    # ---- C: drain-before-unlink -------------------------------------
    def _check_unlink(self, ctx, qual, fn) -> Iterator[Finding]:
        unlinks, drains, creates = [], [], False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            ch = _chain(node)
            if not ch:
                continue
            if ch[-1] == "unlink" and any("shm" in s for s in ch[:-1]):
                unlinks.append(node)
            elif "drain" in ch[-1] or "pop" in ch[-1]:
                drains.append(node.lineno)
            elif ch[-1] == "SharedMemory":
                creates = True
        if creates:
            return                      # creation-rollback path
        for node in unlinks:
            if not any(ln < node.lineno for ln in drains):
                yield ctx.finding(
                    self, node,
                    "shm segment unlinked without a prior drain sweep "
                    "in this function; every shutdown path must drain "
                    "the ring first so pushed == drained when the "
                    "backing pages go away", qual)

    # ---- D: dual-affinity container mutation ------------------------
    def _collect_mutations(self, fn, attrs: set) -> list:
        """[(attr, structural, locked, anchor)] for mutations of
        ``self.<attr>`` with lexical lock/fence tracking."""
        out = []

        def visit(node, locked):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda,
                                      ast.ClassDef)):
                    continue
                sub_locked = locked
                if isinstance(child, (ast.With, ast.AsyncWith)) and \
                        any(_lockish(i.context_expr)
                            for i in child.items):
                    sub_locked = True
                if isinstance(child, ast.Call) and \
                        isinstance(child.func, ast.Attribute) and \
                        child.func.attr in _MUTATORS:
                    attr = _self_attr_of(child.func.value)
                    if attr in attrs:
                        out.append((attr,
                                    child.func.attr not in _FEED_ONLY,
                                    locked, child))
                targets = []
                if isinstance(child, (ast.Assign, ast.AugAssign)):
                    targets = child.targets \
                        if isinstance(child, ast.Assign) \
                        else [child.target]
                elif isinstance(child, ast.Delete):
                    targets = child.targets
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        attr = _self_attr_of(t.value)
                        if attr in attrs:
                            out.append((attr, True, locked, child))
                visit(child, sub_locked)

        visit(fn, False)
        return out

    def _check_dual_affinity(self, ctx, program, ms,
                             tree) -> Iterator[Finding]:
        # attr universe per class: plain list/dict/set attrs on classes
        # that are neither shm rings (check A's beat) nor deque-based
        watched = {}
        for cname, info in ms.classes.items():
            if info.shm_owner:
                continue
            attrs = {a for a, kind in info.container_attrs.items()
                     if kind != "deque"}
            if attrs:
                watched[cname] = attrs
        if not watched:
            return
        # mutation sites per (class, attr), split by affinity; "mixed"
        # functions run under both
        sites: dict = {}
        for qual, fn in iter_functions(tree):
            cls = program.enclosing_class(ms, qual)
            if cls not in watched:
                continue
            kind = program.worker_context((ms.module_key, qual))
            for attr, structural, locked, anchor in \
                    self._collect_mutations(fn, watched[cls]):
                rec = sites.setdefault((cls, attr), {
                    "worker": [], "main": False})
                if kind in ("seed", "only", "mixed"):
                    rec["worker"].append(
                        (structural, locked, anchor, qual,
                         program.worker.get((ms.module_key, qual),
                                            "mixed context")))
                if kind is None or kind == "mixed":
                    rec["main"] = True
        for (cls, attr), rec in sorted(
                sites.items(), key=lambda kv: kv[0]):
            if not rec["main"]:
                continue                # single affinity: no race
            for structural, locked, anchor, qual, reason in \
                    rec["worker"]:
                if not structural or locked:
                    continue            # appends = stamp feed; locked ok
                yield ctx.finding(
                    self, anchor,
                    f"unlocked structural mutation of 'self.{attr}' "
                    f"from worker context ({reason}) while the main "
                    "loop also touches it; guard with a lock/fence or "
                    "restrict the worker side to appends "
                    "(stamp-and-replay)", qual)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        program = ctx.program
        ms = ctx.module
        if program is None or ms is None:
            return                      # phase-2 rule: needs the link
        yield from self._check_counter_attrs(ctx, ctx.tree)
        for qual, fn in iter_functions(ctx.tree):
            yield from self._check_offsets(ctx, qual, fn)
            yield from self._check_payloads(ctx, program, ms, qual, fn)
            yield from self._check_unlink(ctx, qual, fn)
        yield from self._check_dual_affinity(ctx, program, ms, ctx.tree)
