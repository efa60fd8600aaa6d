"""Finding/Rule model and the rule registry.

A Rule is a stateless checker over one parsed module; the registry maps
rule ids (``OTPU001``…) to singleton instances. Findings carry both an
exact location (path/line/col — what the CLI prints and fixtures assert)
and a location-insensitive identity (``key`` — what the baseline matches,
so accepted findings survive unrelated line churn above them).

The port's copy of ``orleans_tpu.analysis.model``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

__all__ = ["Finding", "Rule", "RULES", "register", "all_rules",
           "FileContext"]

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    path: str          # posix-style path relative to the scan root
    line: int
    col: int
    message: str
    symbol: str = ""   # enclosing def/class qualname (baseline stability)

    @property
    def key(self) -> tuple:
        """Baseline identity: everything except line/col, so a finding
        accepted once is not re-reported when code above it moves."""
        return (self.rule, self.path, self.symbol, self.message)

    def to_json(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line, "col": self.col,
                "symbol": self.symbol, "message": self.message}

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} {self.severity}: {self.message}{sym}")


@dataclass
class FileContext:
    """Per-file inputs shared by every rule."""

    path: str                       # as given on the command line
    rel_path: str                   # posix, relative to the scan root
    source: str
    tree: ast.Module
    lines: list[str] = field(default_factory=list)
    # the linked cross-module summary index (summaries.Program), or None
    # when running the legacy intra-procedural configuration
    program: object | None = None

    @property
    def module(self):
        """This file's ModuleSummary inside ``program`` (or None)."""
        if self.program is None:
            return None
        return self.program.by_rel.get(self.rel_path)

    def finding(self, rule: "Rule", node: ast.AST, message: str,
                symbol: str = "") -> Finding:
        return Finding(rule.id, rule.severity, self.rel_path,
                       getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0) + 1,
                       message, symbol)


class Rule:
    """Base class: subclasses set ``id``/``name``/``severity`` and
    implement :meth:`check`."""

    id: str = ""
    name: str = ""
    severity: str = "error"
    description: str = ""
    # longer prose for ``--explain``: WHY the invariant exists and what
    # breaks when it is violated
    rationale: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError


RULES: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    if not cls.id or cls.severity not in SEVERITIES:
        raise ValueError(f"bad rule class {cls!r}")
    if cls.id in RULES:
        raise ValueError(f"duplicate rule id {cls.id}")
    RULES[cls.id] = cls()
    return cls


def all_rules() -> list[Rule]:
    """Registered rules in id order (imports the rule modules on first
    use so the registry is populated lazily, not at package import)."""
    from . import rules  # noqa: F401 — registration side effect
    return [RULES[k] for k in sorted(RULES)]
