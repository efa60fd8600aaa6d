"""Analyzer entry: file discovery, parsing, suppression, rule dispatch.

Deterministic by construction — files are walked in sorted order and
findings are sorted (path, line, col, rule) — so the CLI output and the
baseline file diff cleanly across runs.

The port's copy of ``orleans_tpu.analysis.engine``.
"""

from __future__ import annotations

import ast
import io
import os
import re
import time
import tokenize
from typing import Iterable, Sequence

from .model import RULES, FileContext, Finding, all_rules

__all__ = ["analyze_paths", "analyze_source", "iter_python_files",
           "suppressed_lines"]

# `# otpu: ignore` or `# otpu: ignore[OTPU001, OTPU003]`
_SUPPRESS_RE = re.compile(
    r"#\s*otpu:\s*ignore(?:\[([A-Za-z0-9_,\s]+)\])?")


def _comment_lines(source: str) -> list[tuple[int, str]]:
    """(line, comment-text) for every real comment token. Tokenizing —
    rather than regex-scanning raw lines — keeps a marker INSIDE a string
    literal from suppressing anything. Falls back to the raw-line scan
    only when the source does not tokenize (it then rarely parses either,
    so the fallback practically never decides a finding)."""
    try:
        return [(tok.start[0], tok.string)
                for tok in tokenize.generate_tokens(
                    io.StringIO(source).readline)
                if tok.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return [(i, line) for i, line in
                enumerate(source.splitlines(), start=1) if "#" in line]


def suppressed_lines(source: str) -> dict[int, frozenset[str] | None]:
    """Map line number → suppressed rule ids (None = all rules).

    A marker on a code line covers that line; a marker on a comment-only
    line covers the following line too (the idiomatic place when the code
    line is already long).
    """
    lines = source.splitlines()
    out: dict[int, frozenset | None] = {}
    for i, comment in _comment_lines(source):
        m = _SUPPRESS_RE.search(comment)
        if not m:
            continue
        rules = None
        if m.group(1):
            rules = frozenset(r.strip().upper()
                              for r in m.group(1).split(",") if r.strip())
        targets = [i]
        if i <= len(lines) and lines[i - 1].lstrip().startswith("#"):
            targets.append(i + 1)
        for t in targets:
            prev = out.get(t, frozenset())
            if prev is None or rules is None:
                out[t] = None
            else:
                out[t] = prev | rules
    return out


# simple (non-compound) statements: a marker anywhere on one covers the
# whole statement, so the natural end-of-line comment on a black-wrapped
# multi-line call still silences the finding anchored to its first line
_SIMPLE_STMTS = (ast.Expr, ast.Assign, ast.AugAssign, ast.AnnAssign,
                 ast.Return, ast.Raise, ast.Assert, ast.Delete)


def _spread_over_statements(supp: dict, tree: ast.Module) -> None:
    if not supp:
        return
    for stmt in ast.walk(tree):
        if not isinstance(stmt, _SIMPLE_STMTS):
            continue
        lo, hi = stmt.lineno, stmt.end_lineno or stmt.lineno
        if hi <= lo:
            continue
        marked = [supp[m] for m in range(lo, hi + 1) if m in supp]
        if not marked:
            continue
        rules = None if any(m is None for m in marked) else \
            frozenset().union(*marked)
        for line in range(lo, hi + 1):
            prev = supp.get(line, frozenset())
            supp[line] = None if (prev is None or rules is None) else \
                prev | rules


def _is_suppressed(f: Finding,
                   supp: dict[int, frozenset | None]) -> bool:
    rules = supp.get(f.line, frozenset())
    return rules is None or f.rule in rules


def analyze_source(source: str, rel_path: str, *,
                   rules: Iterable | None = None,
                   path: str | None = None,
                   program: "object | None" = None,
                   interprocedural: bool = True,
                   tree: "ast.Module | None" = None,
                   suppressed: "list[Finding] | None" = None
                   ) -> list[Finding]:
    """Run the (selected) rules over one source blob. Syntax errors come
    back as an ``OTPU000`` error finding rather than an exception — a
    file the analyzer cannot parse is a finding about that file.

    ``program`` is the linked cross-module summary index; when None and
    ``interprocedural`` is set, a single-module program is built from
    this source alone (helper + caller in one file still link).
    ``interprocedural=False`` reproduces the legacy per-function pass —
    no summaries, no call-site propagation, no program-backed rules.
    ``suppressed`` (optional list) collects the findings silenced by an
    inline ``# otpu: ignore`` marker instead of dropping them — SARIF
    reports them as ``suppressions`` so dashboards can trend the debt."""
    rel_path = rel_path.replace(os.sep, "/")
    if tree is None:
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            return [Finding("OTPU000", "error", rel_path, e.lineno or 0,
                            (e.offset or 0) or 1,
                            f"file does not parse: {e.msg}")]
    if program is None and interprocedural:
        from .summaries import build_program
        program = build_program([(source, rel_path, tree)])
    ctx = FileContext(path=path or rel_path, rel_path=rel_path,
                      source=source, tree=tree,
                      lines=source.splitlines(), program=program)
    supp = suppressed_lines(source)
    _spread_over_statements(supp, tree)
    findings: list[Finding] = []
    for rule in (rules if rules is not None else all_rules()):
        for f in rule.check(ctx):
            if _is_suppressed(f, supp):
                if suppressed is not None:
                    suppressed.append(f)
            else:
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_python_files(paths: Sequence[str]) -> list[tuple[str, str]]:
    """Expand files/dirs into sorted (abs_path, rel_path) pairs. Relative
    paths are rooted at each argument's parent so ``orleans_tpu/runtime/x``
    stays stable regardless of the directory the CLI runs from."""
    out: list[tuple[str, str]] = []
    seen: set[str] = set()

    def add(full: str, rel: str) -> None:
        # overlapping CLI args (a dir and a file inside it) must not scan
        # a file twice — duplicates would double findings past their
        # baseline multiplicity and falsely fail the gate
        key = os.path.realpath(full)
        if key not in seen:
            seen.add(key)
            out.append((full, rel))

    for p in paths:
        p = p.rstrip("/")
        if os.path.isfile(p):
            # keep a relative CLI arg verbatim. An absolute one becomes
            # cwd-relative when possible, else keeps its full segment
            # chain (minus the root) — reducing to a basename would
            # silently disable path-scoped rules (OTPU006's dispatch/ops/
            # parallel check) and break baseline key matching
            rel = p
            if os.path.isabs(p):
                rel = os.path.relpath(p)
                if rel.startswith(".."):
                    rel = os.path.splitdrive(p)[1].lstrip(os.sep)
            add(p, rel)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    full = os.path.join(dirpath, fn)
                    add(full, os.path.relpath(
                        full, os.path.dirname(p) or "."))
    out.sort(key=lambda t: t[1])
    return out


def analyze_paths(paths: Sequence[str], *,
                  rules: Iterable | None = None,
                  interprocedural: bool = True,
                  stats: "dict | None" = None,
                  suppressed: "list[Finding] | None" = None
                  ) -> list[Finding]:
    """Two-phase run: phase 1 summarizes every file (cached per content
    hash — see summaries.module_summary), phase 2 links them into one
    Program, then the rules run per file against the linked view. Files
    are parsed once and the tree shared between summary and rules.

    ``stats`` (optional dict) receives per-phase wall times in seconds
    (``read_parse_s``, ``summarize_s``, ``link_s``, ``rules_s``), the
    file count, and the phase-1 cache counters for this run
    (``cache_hits``/``cache_misses``). ``suppressed`` collects inline-
    suppressed findings (see ``analyze_source``)."""
    t0 = time.perf_counter()
    loaded: list[tuple[str, str, str, "ast.Module | None"]] = []
    for full, rel in iter_python_files(paths):
        with open(full, encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree = ast.parse(src)
        except SyntaxError:
            tree = None
        loaded.append((full, rel.replace(os.sep, "/"), src, tree))
    t1 = time.perf_counter()

    program = None
    t2 = t1
    if interprocedural:
        from .summaries import CACHE_STATS, Program, module_summary
        before = dict(CACHE_STATS)
        mods = []
        for _, rel, src, tree in loaded:
            if tree is None:
                continue
            try:
                mods.append(module_summary(src, rel, tree))
            except SyntaxError:
                continue
        t2 = time.perf_counter()
        program = Program(mods)
        if stats is not None:
            stats["cache_hits"] = CACHE_STATS["hits"] - before["hits"]
            stats["cache_misses"] = (CACHE_STATS["misses"] -
                                     before["misses"])
    t3 = time.perf_counter()

    findings: list[Finding] = []
    for full, rel, src, tree in loaded:
        findings.extend(analyze_source(
            src, rel, rules=rules, path=full, program=program,
            interprocedural=interprocedural, tree=tree,
            suppressed=suppressed))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    if stats is not None:
        stats["files"] = len(loaded)
        stats["read_parse_s"] = t1 - t0
        stats["summarize_s"] = t2 - t1
        stats["link_s"] = t3 - t2
        stats["rules_s"] = time.perf_counter() - t3
    return findings
