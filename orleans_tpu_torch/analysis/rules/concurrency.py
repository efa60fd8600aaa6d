"""OTPU007/OTPU008 — concurrency-shaped invariants of the off-loop tick
and the multi-loop silo.

**OTPU007 loop-confinement.** StatsRegistry / Histogram / QueueWaitTrend /
SpanCollector / CallSiteStats are loop-confined by contract: concurrent
``+=`` loses updates, a first-key insert breaks sampler snapshot
iteration mid-walk, and an off-loop trend note corrupts the shed signal
(the off-loop tick's review rule). The rule computes the worker-context
set over the linked program — ``threading.Thread`` targets,
``Thread``-subclass ``run`` bodies, ``run_in_executor`` callables,
callbacks scheduled onto a shard loop (``asyncio.new_event_loop`` attr),
and everything those
call — and flags registry writes reachable from it. The sanctioned
escape is the **stamp-and-replay pattern**: append ``(key, value)``
stamps to a plain list off-loop and replay them loop-side
(``_complete_job`` / ``_drain_entry`` style); appends are not writes, so
the pattern is clean by construction. Two interprocedural refinements
keep the rule honest at boundaries: a write whose receiver is a bare
*parameter* (``decode_frames(buf, stats)``) or that is guarded by a
``sink is None`` branch is judged at each worker-context CALL SITE —
passing the live registry (or a None sink) from worker code is the
finding, injecting None is clean.

Context sensitivity is k=1 per call edge: a helper reached from BOTH a
worker context and the main loop (or declared as an entry point) is
"mixed" — its definite writes are flagged on each unambiguous worker
call edge into it, never at the definition, so the main-loop path needs
no suppression and the worker path cannot hide.

**OTPU008 fence-discipline.** Donated device state — ``tbl.state`` rows,
hit counters — may be mid-donation inside a worker-side kernel dispatch;
touching it without the tick fence can materialize a deleted array or
commit over a concurrent write (the grow-vs-upload race). Keyed on
the fence attr protocol: classes that assign ``self.fence``/``self._fence``
own donated state; accesses to ``.state``/``.hits`` on such receivers
must be lexically under ``with x.fence`` / ``x._fence`` /
``x.tick_fence():`` OR inside a function whose every known call site is
fence-held (the compositional summary propagation — ``snapshot()``
called only under the engine fence needs no fence of its own).
``__init__`` bodies are exempt (construction is single-threaded).

The port's copy of ``orleans_tpu.analysis.rules.concurrency``.
"""

from __future__ import annotations

from typing import Iterator

from ..model import FileContext, Finding, Rule, register
from ..summaries import REGISTRY_CLASSES, TYPED_WRITES, UNTYPED_WRITES


class _Anchor:
    """Line/col carrier so FileContext.finding works without an AST
    node at hand (summaries store positions, not nodes)."""

    def __init__(self, lineno: int, col: int):
        self.lineno = lineno
        self.col_offset = col - 1


@register
class LoopConfinement(Rule):
    id = "OTPU007"
    name = "loop-confinement"
    severity = "error"
    description = ("loop-confined registry (StatsRegistry/Histogram/"
                   "QueueWaitTrend/SpanCollector/CallSiteStats) written "
                   "from a worker-thread or ingress-shard context")
    rationale = (
        "The observability registries are loop-confined: they are plain "
        "dicts and floats with no locks. A worker-thread write races "
        "the event loop — concurrent '+=' loses updates, a first-key "
        "histogram insert breaks sampler snapshot iteration, an "
        "off-loop QueueWaitTrend note corrupts the load-shed signal. "
        "The sanctioned pattern is stamp-and-replay: collect (key, "
        "value) stamps in a plain list off-loop, replay them loop-side "
        "(engine._complete_job, multiloop._drain_entry). Passing the "
        "live registry into a decode helper from shard code is the "
        "same bug one call deeper, so call sites are checked too.")

    def _typed_ok(self, program, ms, qual, w) -> bool:
        if w.method in UNTYPED_WRITES:
            return True
        if w.method in TYPED_WRITES:
            cls = program.receiver_class(ms, qual, w.recv)
            return cls in REGISTRY_CLASSES
        return False

    @staticmethod
    def _arg_for(callee, edge, pname):
        """('none'|'live'|'missing') — what the call site passes for the
        callee parameter ``pname``."""
        try:
            idx = list(callee.params).index(pname)
        except ValueError:
            idx = None
        if idx is not None:
            if callee.params and callee.params[0] in ("self", "cls") \
                    and len(edge.chain) >= 2:
                idx -= 1
            if 0 <= idx < edge.nargs:
                return "none" if idx in edge.none_args else "live"
        for kw_name, kw_val in edge.kwargs:
            if kw_name == pname:
                return "none" if kw_val is True else "live"
        return "missing"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        program = ctx.program
        ms = ctx.module
        if program is None or ms is None:
            return
        for qual, s in ms.functions.items():
            key = (ms.module_key, qual)
            kind = program.worker_context(key)
            if kind is None:
                continue
            reason = program.worker.get(key)
            if kind == "mixed":
                # k=1 edge context: this helper is ALSO reached from
                # main-loop context (or is a declared entry point), so
                # its body is not unconditionally worker code — the
                # violation is judged on each worker call EDGE into it
                # (emitted from the caller's side below)
                continue
            # -- direct writes in unambiguous worker context ------------
            for w in s.writes:
                if w.recv_is_param is not None:
                    continue            # judged at call sites below
                if w.guard is not None and w.guard in s.params:
                    continue            # stamp-and-replay guard: ditto
                if not self._typed_ok(program, ms, qual, w):
                    continue
                recv = ".".join(w.recv)
                yield ctx.finding(
                    self, _Anchor(w.lineno, w.col),
                    f"loop-confined registry write '{recv}.{w.method}()'"
                    f" in worker-thread context ({reason}); stamp "
                    "off-loop and replay loop-side", qual)
            # -- call edges out of unambiguous worker context -----------
            seen: set = set()
            for e in s.calls:
                ckey = program.resolve_call(ms, qual, e.chain)
                if ckey is None:
                    continue
                callee = program.functions[ckey]
                callee_kind = program.worker_context(ckey)
                for w in callee.writes:
                    is_param_recv = w.recv_is_param is not None
                    has_guard = w.guard is not None and \
                        w.guard in callee.params
                    if not (is_param_recv or has_guard):
                        # a definite write: flagged at the callee's
                        # definition unless the callee is MIXED — then
                        # THIS worker edge is the k=1 context
                        if callee_kind != "mixed":
                            continue
                        if not self._typed_ok(
                                program, program.modules[ckey[0]],
                                ckey[1], w):
                            continue
                        dkey = (ckey, "edge", w.recv, w.method)
                        if dkey in seen:
                            continue
                        seen.add(dkey)
                        yield ctx.finding(
                            self, _Anchor(e.lineno, e.col),
                            f"worker-context call edge into "
                            f"'{ckey[1]}' (which writes "
                            f"'{'.'.join(w.recv)}.{w.method}()'); the "
                            "helper is also reached from main-loop "
                            "context, so the worker edge is the "
                            f"violation ({reason}); stamp off-loop and "
                            "replay loop-side", qual)
                        continue
                    if not self._typed_ok(
                            program, program.modules[ckey[0]],
                            ckey[1], w):
                        continue
                    if has_guard:
                        g = self._arg_for(callee, e, w.guard)
                        if g == "live":
                            continue    # guard non-None: write skipped
                    if is_param_recv:
                        r = self._arg_for(callee, e, w.recv_is_param)
                        if r in ("none", "missing"):
                            continue    # None injected: write skipped
                    dkey = (ckey, w.recv_is_param or w.guard)
                    if dkey in seen:
                        continue
                    seen.add(dkey)
                    what = f"live registry for '{w.recv_is_param}'" \
                        if is_param_recv else \
                        f"a None '{w.guard}' sink"
                    yield ctx.finding(
                        self, _Anchor(e.lineno, e.col),
                        f"passes {what} into '{ckey[1]}' (which then "
                        f"writes '{'.'.join(w.recv)}.{w.method}()') "
                        f"from worker-thread context ({reason}); "
                        "stamp off-loop and replay loop-side", qual)


@register
class FenceDiscipline(Rule):
    id = "OTPU008"
    name = "fence-discipline"
    severity = "error"
    description = ("donated device state (.state/.hits on a "
                   "fence-owning table/engine) touched outside a held "
                   "tick fence")
    rationale = (
        "The off-loop tick worker holds the engine fence for a whole "
        "batch while tbl.state and the staging operands are DONATED to "
        "the kernel — XLA may already have freed the old buffers. "
        "Reading or swapping .state/.hits without the fence can "
        "materialize a deleted array or commit a tree that erases a "
        "concurrent write (the grow-racing-upload case). A "
        "function whose every known call site runs under 'with "
        "x.fence'/'x.tick_fence()' is fence-held by summary "
        "propagation and needs no fence of its own; __init__ bodies "
        "are exempt (construction precedes concurrency).")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        program = ctx.program
        ms = ctx.module
        if program is None or ms is None:
            return
        for qual, s in ms.functions.items():
            key = (ms.module_key, qual)
            accesses = program.protected_accesses(ms, s)
            if not accesses:
                continue
            if program.held.get(key, False):
                continue
            witness = program.unfenced_witness(key) or \
                "an unfenced call path exists"
            seen: set = set()
            for p in accesses:
                if p.fenced:
                    continue
                if p.attr in seen:
                    continue            # one finding per attr per fn
                seen.add(p.attr)
                recv = ".".join(p.recv)
                yield ctx.finding(
                    self, _Anchor(p.lineno, p.col),
                    f"donated device state '{recv}.{p.attr}' touched "
                    f"outside the tick fence ({witness})", qual)
