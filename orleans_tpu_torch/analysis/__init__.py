"""Actor-invariant static analyzer (the RoslynCodeGenerator/analyzer story
for a Python runtime).

Orleans keeps grain code inside the virtual-actor contract with compile-time
codegen and Roslyn analyzers; this package is the reproduction's equivalent:
a two-phase, summary-based interprocedural engine over ``orleans_tpu/``
that statically checks the invariants the hot lane, the migration
fences, and the multi-loop split made load-bearing.
Phase 1 summarizes each file independently (release/escape/alias
behavior per function, thread-affinity and scheduling edges, fence
state, registry writes, grain interface tables — cached per content
hash); phase 2 links the summaries into a program index the rules query
at call sites (``analysis.summaries``).

Rules
-----

========  ==========================================================
OTPU001   pool-discipline: pooled object used/stored after release,
          or released twice along one path — cross-function,
          alias-aware, loop-carried
OTPU002   blocking-in-turn: ``time.sleep`` / sync IO / ``.result()``
          inside an ``async def`` turn
OTPU003   interleaving-hazard: grain attribute written before and
          read after an ``await`` in a non-reentrant grain method
OTPU004   mutable-state-leak: grain method returns a shared mutable
          internal (``return self._rows``)
OTPU005   unawaited-grain-call: grain-ref coroutine dropped without
          an explicit fire-and-forget marker (``@one_way`` drops are
          recognized via the typed interface tables)
OTPU006   traced-impurity: function traced by ``jit``/``shard_map``/
          ``pjit`` captures or mutates host runtime state
OTPU007   loop-confinement: loop-confined registry (StatsRegistry/
          Histogram/QueueWaitTrend/SpanCollector/CallSiteStats)
          written from a worker-thread or ingress-shard context
          without the stamp-and-replay pattern
OTPU008   fence-discipline: donated device state (``.state`` /
          ``.hits`` on a fence-owning receiver) touched outside a
          held tick fence
OTPU009   grain-interface: ``get_grain``/``call_batch``/
          ``map_actors``/``broadcast_actors``/``join_when`` call site
          disagrees with the class's interface table (the Roslyn
          ``IncorrectGrainInterface`` analog)
========  ==========================================================

Usage::

    python -m orleans_tpu.analysis orleans_tpu/ \
        --baseline analysis/baseline.json

``--explain OTPU007`` prints a rule's rationale plus its canonical
bad/clean fixture pair; ``--format sarif`` emits SARIF 2.1.0 for CI
annotation rendering; ``--intra-only`` reproduces the legacy
per-function configuration (no summaries — OTPU007-009 disabled).

Suppress one finding in place with a trailing (or preceding full-line)
comment: ``# otpu: ignore[OTPU002]`` (rule list, or bare ``# otpu: ignore``
for all rules). Accepted pre-existing findings live in the checked-in
baseline; ``--write-baseline`` regenerates it (sorted, deterministic).
``tests/test_analysis.py`` runs the analyzer over the package as part of
tier-1, so any new finding fails CI until fixed, suppressed, or explicitly
baselined.

The port's copy of ``orleans_tpu.analysis``. Over the port::

    python -m orleans_tpu_torch.analysis          # orleans_tpu_torch/

prints ``clean: no findings``, as the JAX package's analyzer does over
the port; ``tests/test_torch_analysis.py`` holds every fixture's findings
equal to the JAX package's. One repair: OTPU007 also takes a loop handed
to a constructor and stored on ``self`` for a worker loop
(``summaries._HANDED_LOOP_PARAM``).
"""

from .baseline import load_baseline, match_baseline, write_baseline
from .engine import analyze_paths, analyze_source
from .model import RULES, Finding, Rule, all_rules
from .summaries import Program, build_program, module_summary

__all__ = [
    "Finding", "Program", "Rule", "RULES", "all_rules",
    "analyze_paths", "analyze_source", "build_program",
    "load_baseline", "match_baseline", "module_summary",
    "write_baseline",
]
