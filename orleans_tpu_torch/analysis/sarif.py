"""SARIF 2.1.0 output — findings as CI-renderable annotations.

Minimal but valid static-analysis interchange: one run, one driver, the
rule metadata from the registry, one result per finding. GitHub code
scanning and most CI viewers render these as inline annotations at the
exact line/column the text format prints.

Suppressed findings are EMITTED, not omitted: an inline
``# otpu: ignore`` marker becomes a result with an ``inSource``
suppression, a baseline match becomes an ``external`` one (justified by
the ratchet file). Dashboards can therefore trend suppression debt —
an omitted finding looks identical to a fixed one, which is exactly the
signal loss the ratchet exists to prevent.

The port's copy of ``orleans_tpu.analysis.sarif``.
"""

from __future__ import annotations

import json
from typing import Iterable, Sequence

from .model import RULES, Finding, all_rules

__all__ = ["to_sarif", "sarif_json"]

_LEVELS = {"error": "error", "warning": "warning"}

SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
          "master/Schemata/sarif-schema-2.1.0.json")


def to_sarif(findings: Sequence[Finding], *,
             suppressed: Sequence[Finding] = (),
             baselined: Sequence[Finding] = (),
             baseline_path: str = "analysis/baseline.json",
             tool_version: str = "1.0") -> dict:
    all_rules()  # ensure the registry is populated
    rule_ids = sorted({f.rule for f in (*findings, *suppressed,
                                        *baselined)} | set(RULES))
    rules_meta = []
    for rid in rule_ids:
        rule = RULES.get(rid)
        meta = {"id": rid}
        if rule is not None:
            meta["name"] = rule.name
            meta["shortDescription"] = {"text": rule.description}
            if rule.rationale:
                meta["fullDescription"] = {"text": rule.rationale}
            meta["defaultConfiguration"] = {
                "level": _LEVELS.get(rule.severity, "warning")}
        else:  # OTPU000 parse errors carry no registered rule
            meta["shortDescription"] = {"text": "file does not parse"}
            meta["defaultConfiguration"] = {"level": "error"}
        rules_meta.append(meta)
    index = {rid: i for i, rid in enumerate(rule_ids)}

    def result(f: Finding, suppressions: "list | None") -> dict:
        out = {
            "ruleId": f.rule,
            "ruleIndex": index[f.rule],
            "level": _LEVELS.get(f.severity, "warning"),
            "message": {"text": f.message +
                        (f" [{f.symbol}]" if f.symbol else "")},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(f.line, 1),
                               "startColumn": max(f.col, 1)},
                },
                **({"logicalLocations": [{
                    "fullyQualifiedName": f.symbol}]}
                   if f.symbol else {}),
            }],
        }
        if suppressions is not None:
            out["suppressions"] = suppressions
        return out

    results = [result(f, None) for f in findings]
    results += [result(f, [{"kind": "inSource"}]) for f in suppressed]
    results += [result(f, [{"kind": "external",
                            "justification":
                                f"accepted in {baseline_path}"}])
                for f in baselined]

    return {
        "$schema": SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "orleans-tpu-analysis",
                "informationUri":
                    "https://github.com/rikbosch/orleans",
                "version": tool_version,
                "rules": rules_meta,
            }},
            "results": results,
            "columnKind": "unicodeCodePoints",
        }],
    }


def sarif_json(findings: Iterable[Finding], **kw) -> str:
    return json.dumps(to_sarif(list(findings), **kw), indent=1,
                      sort_keys=True)
