"""CLI: ``python -m orleans_tpu_torch.analysis [paths] [options]``.

Exit codes: 0 — no non-baselined findings; 1 — new findings (or parse
errors); 2 — usage/configuration error.

The port's copy of ``orleans_tpu.analysis.__main__``; its default path
is the port's package, ``orleans_tpu_torch``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from .baseline import load_baseline, match_baseline, write_baseline
from .engine import analyze_paths
from .model import RULES, all_rules

SEVERITY_ORDER = {"warning": 0, "error": 1}


def _explain(rule_id: str) -> int:
    """``--explain OTPU007``: the rule's rationale plus the canonical
    bad/clean fixture pair, so a finding is self-documenting at the
    CLI without opening the docs."""
    rule_id = rule_id.strip().upper()
    all_rules()
    rule = RULES.get(rule_id)
    if rule is None:
        print(f"unknown rule id {rule_id!r} (known: "
              f"{', '.join(sorted(RULES))})", file=sys.stderr)
        return 2
    print(f"{rule.id} {rule.name} [{rule.severity}]")
    print(f"  {rule.description}\n")
    if rule.rationale:
        print("Why:")
        for line in rule.rationale.split(". "):
            line = line.strip().rstrip(".")
            if line:
                print(f"  {line}.")
        print()
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    fixtures = os.path.join(repo, "tests", "analysis_fixtures")
    shown = False
    for kind, label in (("bad", "Flagged (the canonical violation)"),
                        ("clean", "Clean (the sanctioned pattern)")):
        pats = [os.path.join(fixtures, f"{rule_id.lower()}_{kind}.py"),
                os.path.join(fixtures, "*",
                             f"{rule_id.lower()}_{kind}.py")]
        for pat in pats:
            for path in sorted(glob.glob(pat)):
                shown = True
                rel = os.path.relpath(path, repo)
                print(f"--- {label} — {rel} ---")
                with open(path, encoding="utf-8") as fh:
                    print(fh.read().rstrip())
                print()
                break
            else:
                continue
            break
    if not shown:
        print("(no fixture pair found beside this checkout — see "
              "tests/analysis_fixtures/ in the repository)")
    return 0


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m orleans_tpu_torch.analysis",
        description="Actor-invariant static analyzer (OTPU001-OTPU010).",
        epilog="Exit codes: 0 — clean (no findings, or every finding "
               "matched the baseline / an inline suppression); 1 — at "
               "least one NEW finding or a file that does not parse "
               "(OTPU000); 2 — usage or configuration error (unknown "
               "rule id, filtered --write-baseline). Rule selection via "
               "--rules is deterministic: ids are sorted and resolved "
               "against the registry populated by importing every rule "
               "module, so rules added in new modules load the same way "
               "the built-ins do.")
    parser.add_argument("paths", nargs="*", default=["orleans_tpu_torch"],
                        help="files or directories to scan "
                             "(default: orleans_tpu_torch)")
    parser.add_argument("--format", choices=("text", "json", "sarif"),
                        default="text")
    parser.add_argument("--baseline", metavar="FILE",
                        help="accepted-findings file; only NEW findings "
                             "fail the run")
    parser.add_argument("--write-baseline", metavar="FILE",
                        help="write ALL current findings to FILE and "
                             "exit 0 (regenerates the ratchet)")
    parser.add_argument("--rules", metavar="IDS",
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--min-severity", choices=("warning", "error"),
                        default="warning",
                        help="drop findings below this severity")
    parser.add_argument("--intra-only", action="store_true",
                        help="legacy per-function configuration: no "
                             "summaries, no cross-function propagation, "
                             "program-backed rules (OTPU007-OTPU009) "
                             "disabled")
    parser.add_argument("--explain", metavar="RULE",
                        help="print a rule's rationale and its "
                             "canonical bad/clean fixture pair, then "
                             "exit")
    parser.add_argument("--stats", action="store_true",
                        help="print per-phase wall time and the "
                             "summary-cache hit ratio to stderr")
    args = parser.parse_args(argv)

    if args.explain:
        return _explain(args.explain)

    if args.write_baseline and (args.rules
                                or args.min_severity != "warning"
                                or args.intra_only):
        # a filtered write would silently DROP accepted findings outside
        # the filter from the ratchet, and the next full gate run would
        # report them as new — refuse rather than corrupt the baseline
        print("--write-baseline must run unfiltered (no --rules / "
              "--min-severity / --intra-only): the baseline is the "
              "full ratchet", file=sys.stderr)
        return 2

    rules = all_rules()
    if args.rules:
        wanted = {r.strip().upper() for r in args.rules.split(",")}
        unknown = wanted - set(RULES)
        if unknown:
            print(f"unknown rule ids: {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [RULES[r] for r in sorted(wanted)]

    stats: "dict | None" = {} if args.stats else None
    suppressed: list = []
    findings = analyze_paths(args.paths, rules=rules,
                             interprocedural=not args.intra_only,
                             stats=stats, suppressed=suppressed)
    if stats is not None:
        total = sum(v for k, v in stats.items() if k.endswith("_s"))
        lookups = stats.get("cache_hits", 0) + \
            stats.get("cache_misses", 0)
        ratio = stats.get("cache_hits", 0) / lookups if lookups else 0.0
        print(f"stats: {stats.get('files', 0)} file(s) in "
              f"{total * 1000:.1f} ms — read+parse "
              f"{stats.get('read_parse_s', 0.0) * 1000:.1f} ms, "
              f"summarize {stats.get('summarize_s', 0.0) * 1000:.1f} ms"
              f" (cache {stats.get('cache_hits', 0)}/{lookups} hit, "
              f"{ratio:.0%}), link "
              f"{stats.get('link_s', 0.0) * 1000:.1f} ms, rules "
              f"{stats.get('rules_s', 0.0) * 1000:.1f} ms",
              file=sys.stderr)
    floor = SEVERITY_ORDER[args.min_severity]
    findings = [f for f in findings
                if SEVERITY_ORDER.get(f.severity, 1) >= floor
                or f.rule == "OTPU000"]

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"wrote {len(findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else None
    if baseline is not None:
        new, stale = match_baseline(findings, baseline)
        if args.rules or args.min_severity != "warning" or \
                args.intra_only:
            # a filtered run cannot produce findings outside the filter,
            # so baseline entries for them are NOT evidence of fixed code
            # — reporting them stale would nudge the user toward churning
            # a correct ratchet
            stale = {}
    else:
        new, stale = findings, {}

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_json() for f in new],
            "baselined": len(findings) - len(new),
            "stale_baseline": [list(k) for k in sorted(stale)],
        }, indent=1, sort_keys=True))
    elif args.format == "sarif":
        from .sarif import sarif_json
        new_set = {id(f) for f in new}
        baselined = [f for f in findings if id(f) not in new_set]
        print(sarif_json(new, suppressed=suppressed,
                         baselined=baselined,
                         baseline_path=args.baseline or
                         "analysis/baseline.json"))
    else:
        for f in new:
            print(f.render())
        if stale:
            print(f"note: {sum(stale.values())} baseline entr"
                  f"{'y is' if sum(stale.values()) == 1 else 'ies are'} "
                  "stale (finding fixed) — regenerate with "
                  "--write-baseline", file=sys.stderr)
        summary = (f"{len(new)} new finding(s), "
                   f"{len(findings) - len(new)} baselined, "
                   f"{len({f.path for f in findings})} file(s) with "
                   "findings")
        print(summary if findings else "clean: no findings",
              file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
