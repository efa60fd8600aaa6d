"""Checked-in finding baseline (the analyzer ratchet).

The baseline records accepted pre-existing findings by their
location-insensitive key (rule, path, symbol, message) with multiplicity,
so the gate fails only on NEW findings. Entries are written sorted, with
line numbers included for the human reader but ignored for matching —
unrelated edits above an accepted finding do not churn the gate.

The port's copy of ``orleans_tpu.analysis.baseline``.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Iterable, Sequence

from .model import Finding

__all__ = ["load_baseline", "write_baseline", "match_baseline"]

BASELINE_VERSION = 1


def _key_of(entry: dict) -> tuple:
    return (entry["rule"], entry["path"], entry.get("symbol", ""),
            entry["message"])


def load_baseline(path: str) -> Counter:
    """Baseline file → Counter of finding keys (missing file = empty:
    a fresh tree starts with an empty ratchet, not an error)."""
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return Counter()
    if not isinstance(data, dict) or "findings" not in data:
        raise ValueError(f"malformed baseline file {path!r}")
    return Counter(_key_of(e) for e in data["findings"])


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = sorted((f.to_json() for f in findings),
                     key=lambda e: (e["path"], e["line"], e["col"],
                                    e["rule"], e["message"]))
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": BASELINE_VERSION,
                   "count": len(entries),
                   "findings": entries}, fh, indent=1, sort_keys=True)
        fh.write("\n")


def match_baseline(findings: Iterable[Finding],
                   baseline: Counter) -> tuple[list[Finding], Counter]:
    """Split findings into (new, stale-baseline-keys).

    Each baseline entry absorbs at most its multiplicity of matching
    findings; the leftover Counter names entries whose finding no longer
    exists (fixed code — prune them with ``--write-baseline``).
    """
    budget = Counter(baseline)
    new: list[Finding] = []
    for f in findings:
        if budget[f.key] > 0:
            budget[f.key] -= 1
        else:
            new.append(f)
    stale = Counter({k: v for k, v in budget.items() if v > 0})
    return new, stale
