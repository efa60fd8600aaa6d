"""The port's copy of the actor-invariant analyzer
(``orleans_tpu_torch.analysis``) against the JAX package's
(``orleans_tpu.analysis``): every fixture of ``tests/analysis_fixtures/``
through both, with equal findings; the scenarios of
``tests/test_analysis.py`` through the copy (and, where they judge
source, through the reference too); the copy's self-run over the port,
which must be clean, as the reference's run over the port is; and the
one divergence, the OTPU007 repair: a loop handed to a constructor and
stored on ``self`` is a worker loop (``tests/torch_analysis_fixtures/``,
flagged by the copy only).

The whole-package scans are shared in module-scoped fixtures."""

import contextlib
import io
import json
import multiprocessing
import os
import re
import time
from concurrent.futures import ProcessPoolExecutor

import pytest

import orleans_tpu.analysis as ra
import orleans_tpu.analysis.summaries as rsum
import orleans_tpu_torch.analysis as ta
import orleans_tpu_torch.analysis.summaries as tsum
from orleans_tpu.analysis.__main__ import main as ref_cli
from orleans_tpu.analysis.model import all_rules as ref_rules
from orleans_tpu_torch.analysis.__main__ import main as cli_main
from orleans_tpu_torch.analysis.model import all_rules

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "analysis_fixtures")
PORT_FIXTURES = os.path.join(HERE, "torch_analysis_fixtures")
PORT = os.path.join(REPO, "orleans_tpu_torch")

FIXTURE_FILES = sorted(
    os.path.relpath(os.path.join(dp, f), FIXTURES)
    for dp, _, fs in os.walk(FIXTURES) for f in fs if f.endswith(".py"))
BAD = [f for f in FIXTURE_FILES if f.endswith("_bad.py")]
CLEAN = [f for f in FIXTURE_FILES if not f.endswith("_bad.py")]
RULE_IDS = [f"OTPU{i:03d}" for i in range(1, 11)]


def _rows(findings):
    return sorted((f.rule, f.severity, f.path, f.line, f.col, f.message,
                   f.symbol) for f in findings)


def _of(findings, rel):
    want = "analysis_fixtures/" + rel.replace(os.sep, "/")
    return [f for f in findings if f.path == want]


@pytest.fixture(scope="module")
def fixture_scans():
    """Each analyzer over the whole fixture directory (scanned through
    the directory, so OTPU006's dispatch/ scoping stays in effect)."""
    return {"port": ta.analyze_paths([FIXTURES]),
            "ref": ra.analyze_paths([FIXTURES])}


_STATS = re.compile(r"summarize ([0-9.]+) ms \(cache (\d+)/(\d+) hit")


@pytest.fixture(scope="module")
def port_scans():
    """The copy over the port: cold (cache cleared) with stats, then warm
    through the CLI with no path from the repository's root (its
    default, ``python -m orleans_tpu_torch.analysis --stats``); and the
    reference over the port, in a fresh process meanwhile (the scans are
    CPU-bound, and the reference shares no cache with the copy)."""
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=spawn) as pool:
        ref = pool.submit(ra.analyze_paths, [PORT])
        tsum._CACHE.clear()
        cold: dict = {}
        cold_findings = ta.analyze_paths([PORT], stats=cold)
        out, err = io.StringIO(), io.StringIO()
        here = os.getcwd()
        os.chdir(REPO)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli_main(["--stats"])
            warm_s = time.perf_counter() - t0
        finally:
            os.chdir(here)
        ref_findings = ref.result(timeout=120)
    summarize_ms, hits, lookups = _STATS.search(err.getvalue()).groups()
    warm = {"summarize_s": float(summarize_ms) / 1e3,
            "cache_hits": int(hits),
            "cache_misses": int(lookups) - int(hits)}
    return {"cold": cold_findings, "cold_stats": cold, "cli_rc": rc,
            "cli_out": out.getvalue(), "cli_err": err.getvalue(),
            "warm_stats": warm, "warm_s": warm_s,
            "ref": ref_findings}


# ---------------------------------------------------------------------------
# The rule registry and the fixtures, through both analyzers
# ---------------------------------------------------------------------------

def test_rule_registry_equals_the_reference():
    def reg(rules):
        return sorted((r.id, r.name, r.severity, r.description)
                      for r in rules)
    assert reg(all_rules()) == reg(ref_rules())
    assert [r.id for r in all_rules()] == RULE_IDS


@pytest.mark.parametrize("rid", RULE_IDS)
def test_rule_texts_equal_the_reference(rid):
    """Each rule's name, description and rationale (what ``--explain``
    and SARIF print) as the reference has them; OTPU008's rationale in
    the copy names the race it guards against without the reference's
    history."""
    port = {r.id: r for r in all_rules()}[rid]
    ref = {r.id: r for r in ref_rules()}[rid]
    assert (port.name, port.severity, port.description) == \
        (ref.name, ref.severity, ref.description)
    if rid == "OTPU008":
        assert "grow-racing-upload case" in port.rationale
    else:
        assert port.rationale == ref.rationale


@pytest.mark.parametrize("rid", RULE_IDS)
def test_every_rule_has_bad_and_clean_fixture(rid):
    names = {os.path.basename(f) for f in FIXTURE_FILES}
    assert f"{rid.lower()}_bad.py" in names
    assert f"{rid.lower()}_clean.py" in names


@pytest.mark.parametrize("rel", FIXTURE_FILES)
def test_fixture_findings_equal_the_reference(fixture_scans, rel):
    port = _rows(_of(fixture_scans["port"], rel))
    assert port == _rows(_of(fixture_scans["ref"], rel)), rel


@pytest.mark.parametrize("rel", BAD)
def test_bad_fixture_fires_only_its_own_rule(fixture_scans, rel):
    rule = os.path.basename(rel).split("_")[0].upper()
    found = _of(fixture_scans["port"], rel)
    assert found and {f.rule for f in found} == {rule}, rel
    severity = {r.id: r.severity for r in all_rules()}[rule]
    assert {f.severity for f in found} == {severity}


@pytest.mark.parametrize("rel", CLEAN)
def test_clean_fixture_is_silent(fixture_scans, rel):
    assert _of(fixture_scans["port"], rel) == []


def test_whole_fixture_scan_equals_the_reference(fixture_scans):
    assert _rows(fixture_scans["port"]) == _rows(fixture_scans["ref"])


# ---------------------------------------------------------------------------
# Source-level cases of tests/test_analysis.py, through both analyzers
# ---------------------------------------------------------------------------

SOURCE_CASES = {
    "suppression_same_line_and_preceding_comment": (
        "import time\n"
        "async def t():\n"
        "    time.sleep(1)  # otpu: ignore[OTPU002]\n"
        "    # otpu: ignore[OTPU002]\n"
        "    time.sleep(2)\n"
        "    time.sleep(3)\n", "s.py", [("OTPU002", 6)]),
    "suppression_wrong_rule_id_does_not_silence": (
        "import time\n"
        "async def t():\n"
        "    time.sleep(1)  # otpu: ignore[OTPU001]\n", "s.py",
        [("OTPU002", 3)]),
    "bare_ignore_silences_all_rules": (
        "import time\n"
        "async def t():\n"
        "    time.sleep(1)  # otpu: ignore\n", "s.py", []),
    "suppression_on_multiline_statement_closing_line": (
        "import time\n"
        "async def t():\n"
        "    time.sleep(\n"
        "        1)  # otpu: ignore[OTPU002]\n", "s.py", []),
    "marker_inside_string_literal_does_not_suppress": (
        'import time\n'
        'async def t():\n'
        '    time.sleep(bad("x # otpu: ignore"))\n', "s.py",
        [("OTPU002", 3)]),
    "otpu006_same_name_in_unrelated_scope_not_flagged": (
        "import jax\n"
        "class A:\n"
        "    def build(self):\n"
        "        def local(x):\n"
        "            return x + self.offset\n"
        "        return local\n"
        "class B:\n"
        "    def build(self):\n"
        "        def local(x):\n"
        "            return x * self.scale\n"
        "        return jax.jit(local)\n", "orleans_tpu/dispatch/p.py",
        [("OTPU006", 10)]),
    "otpu006_local_scratch_object_writes_exempt": (
        "import jax\n"
        "def make(self):\n"
        "    def local(x):\n"
        "        box = Scratch()\n"
        "        box.total = 1\n"
        "        self.hits = 2\n"
        "        return x\n"
        "    return jax.jit(local)\n", "orleans_tpu/dispatch/p.py",
        [("OTPU006", 6)]),
    "otpu006_subscripted_local_and_temporary_exempt": (
        "import jax\n"
        "def make(self, cfg):\n"
        "    def local(x):\n"
        "        out = [Scratch()]\n"
        "        out[0].tag = 1\n"
        "        f().attr = 2\n"
        "        cfg.limit = 3\n"
        "        return x\n"
        "    return jax.jit(local)\n", "orleans_tpu/dispatch/p.py",
        [("OTPU006", 7)]),
    "otpu003_tuple_assignment_counts_as_write": (
        "from orleans_tpu.runtime.grain import Grain\n"
        "class G(Grain):\n"
        "    async def ok(self):\n"
        "        self.x = 1\n"
        "        await self.f()\n"
        "        self.x, self.y = await self.g()\n"
        "        return self.x\n"
        "    async def bad(self):\n"
        "        self.a, self.b = 1, 2\n"
        "        await self.f()\n"
        "        return self.a\n", "g.py", [("OTPU003", 11)]),
    "otpu003_if_else_branches_are_exclusive": (
        "from orleans_tpu.runtime.grain import Grain\n"
        "class G(Grain):\n"
        "    async def ok(self, cond):\n"
        "        if cond:\n"
        "            self.x = 1\n"
        "            await self.f()\n"
        "        else:\n"
        "            print(self.x)\n"
        "    async def bad(self, cond):\n"
        "        if cond:\n"
        "            self.x = 1\n"
        "            await self.f()\n"
        "        return self.x\n", "g.py", [("OTPU003", 13)]),
    "otpu005_rebinding_kills_ref": (
        "async def ok(factory):\n"
        "    r = factory.get_grain('X', 1)\n"
        "    r = connect()\n"
        "    r.flush()\n"
        "async def bad(factory):\n"
        "    r = factory.get_grain('X', 1)\n"
        "    r.add(1)\n", "g.py", [("OTPU005", 7)]),
    "otpu005_one_way_drop_recognized_via_tables": (
        "from orleans_tpu_torch.runtime.grain import Grain, one_way\n"
        "class Pinger(Grain):\n"
        "    @one_way\n"
        "    async def ping(self):\n"
        "        pass\n"
        "    async def work(self):\n"
        "        pass\n"
        "async def go(factory):\n"
        "    r = factory.get_grain(Pinger, 1)\n"
        "    r.ping()\n"
        "    r.work()\n", "g.py", [("OTPU005", 11)]),
    "syntax_error_is_a_finding_not_a_crash": (
        "def broken(:\n", "b.py", [("OTPU000", 1)]),
}


@pytest.mark.parametrize("case", sorted(SOURCE_CASES))
def test_source_case_through_both_analyzers(case):
    src, rel, want = SOURCE_CASES[case]
    port = ta.analyze_source(src, rel)
    assert [(f.rule, f.line) for f in port] == want
    assert _rows(port) == _rows(ra.analyze_source(src, rel))


def test_absolute_file_arg_keeps_path_scoping():
    target = os.path.join(FIXTURES, "dispatch", "otpu006_bad.py")
    findings = ta.analyze_paths([target])
    assert findings and all(f.rule == "OTPU006" for f in findings)
    assert "dispatch" in findings[0].path.split("/")
    assert _rows(findings) == _rows(ra.analyze_paths([target]))


# ---------------------------------------------------------------------------
# The interprocedural engine
# ---------------------------------------------------------------------------

def test_interproc_fixture_split_vs_intra_only():
    target = os.path.join(FIXTURES, "otpu001_interproc_bad.py")
    inter = {(f.rule, f.line) for f in ta.analyze_paths([target])}
    intra = {(f.rule, f.line)
             for f in ta.analyze_paths([target], interprocedural=False)}
    assert {("OTPU001", 14), ("OTPU001", 24)} <= inter
    assert ("OTPU001", 14) not in intra and ("OTPU001", 24) not in intra
    assert ("OTPU001", 29) in inter and ("OTPU001", 29) in intra
    assert intra == {(f.rule, f.line) for f in ra.analyze_paths(
        [target], interprocedural=False)}
    assert cli_main([target, "--rules", "OTPU001"]) == 1
    assert cli_main([target, "--rules", "OTPU001", "--intra-only",
                     "--format", "json"]) == 1
    assert cli_main([os.path.join(FIXTURES, "otpu001_clean.py"),
                     "--rules", "OTPU001", "--intra-only"]) == 0


@pytest.mark.parametrize("fname", ["otpu007_bad.py", "otpu008_bad.py",
                                   "otpu009_bad.py", "otpu010_bad.py"])
def test_intra_only_disables_program_backed_rules(fname, capsys):
    target = os.path.join(FIXTURES, fname)
    assert cli_main([target]) == 1
    assert cli_main([target, "--intra-only"]) == 0


def test_edge_context_judged_per_call_edge(fixture_scans):
    findings = _of(fixture_scans["port"], "otpu007_edge_bad.py")
    assert [(f.rule, f.line) for f in findings] == [("OTPU007", 26)]
    assert "call edge" in findings[0].message
    assert findings[0].symbol == "MixedBump._worker_main"


def test_entry_point_witness_labels(fixture_scans):
    by_line = {f.line: f.message
               for f in _of(fixture_scans["port"], "otpu008_entry_bad.py")}
    assert "entry point: ctl_* control handler" in by_line[26]
    assert "ring-drain/fd-ready callback" in by_line[29]
    assert "grain timer callback" in by_line[32]


def test_otpu010_scope_covers_the_ports_multiproc_ring():
    """The OTPU010 scope markers recognise the port's shm ring, so the
    self-run over ``orleans_tpu_torch/runtime/multiproc.py`` is not
    vacuous."""
    path = os.path.join(PORT, "runtime", "multiproc.py")
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    prog = tsum.build_program(
        [(src, "orleans_tpu_torch/runtime/multiproc.py", None)])
    assert prog.class_index["ShmRing"][1].shm_owner
    assert not [f for f in ta.analyze_paths([path]) if f.rule == "OTPU010"]


def test_release_summaries_and_aliases():
    src = (
        "from orleans_tpu_torch.core.message import recycle_message\n"
        "def helper(m):\n"
        "    recycle_message(m)\n"
        "def wrapper(shell):\n"
        "    helper(shell)\n"
        "def conditional(m, flag):\n"
        "    if flag:\n"
        "        recycle_message(m)\n"
        "def ident(x):\n"
        "    return x\n"
        "def escaper(pool, m):\n"
        "    pool.append(m)\n")
    ms = tsum.module_summary(src, "m.py")
    assert ms.functions["helper"].releases == frozenset({0})
    assert ms.functions["wrapper"].releases == frozenset({0})
    assert ms.functions["conditional"].releases == frozenset()
    assert ms.functions["ident"].returns_param == 0
    assert ms.functions["escaper"].returns_param is None


WORKER_SRC = (
    "import asyncio, threading\n"
    "class Shard(threading.Thread):\n"
    "    def __init__(self):\n"
    "        self.loop = asyncio.new_event_loop()\n"
    "        self.main = asyncio.get_running_loop()\n"
    "    def run(self):\n"
    "        self.loop.call_soon(self.pump)\n"
    "    def pump(self):\n"
    "        self.decode()\n"
    "        self.main.call_soon_threadsafe(self.replay)\n"
    "    def decode(self):\n"
    "        pass\n"
    "    def replay(self):\n"
    "        pass\n"
    "class Handed:\n"
    "    def __init__(self, main_loop, loop):\n"
    "        self.loop = loop\n"
    "        self.main_loop = main_loop\n"
    "    def feed(self):\n"
    "        self.loop.call_soon_threadsafe(self.drain)\n"
    "    def drain(self):\n"
    "        self.main_loop.call_soon_threadsafe(self.replay)\n"
    "    def replay(self):\n"
    "        pass\n")


def test_worker_set_and_loop_kinds():
    """The reference's shapes, and the repair: a loop handed to the
    constructor and stored on ``self`` is a worker loop; a
    ``main_loop`` parameter is not inferred."""
    port = {q for (_, q) in tsum.build_program(
        [(WORKER_SRC, "shard.py", None)]).worker}
    ref = {q for (_, q) in rsum.build_program(
        [(WORKER_SRC, "shard.py", None)]).worker}
    assert {"Shard.run", "Shard.pump", "Shard.decode"} <= port
    assert "Shard.replay" not in port
    assert "Handed.drain" in port
    assert "Handed.replay" not in port and "Handed.feed" not in port
    assert port - ref == {"Handed.drain"}
    info = tsum.build_program([(WORKER_SRC, "shard.py", None)]) \
        .class_index["Handed"][1]
    assert info.loop_attrs == {"loop": "worker"}


def test_the_ports_egress_shard_write_client_is_worker_code():
    """The repair over the real port: ``EgressShard`` is handed its loop
    (``runtime/multiloop.py``), so its client flush, scheduled onto that
    loop, is in the copy's worker set and not in the reference's."""
    path = os.path.join(PORT, "runtime", "multiloop.py")
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    rel = "orleans_tpu_torch/runtime/multiloop.py"
    port = {q for (_, q) in tsum.build_program([(src, rel, None)]).worker}
    ref = {q for (_, q) in rsum.build_program([(src, rel, None)]).worker}
    assert {"EgressShard._client_now", "EgressShard._write_client"} <= port
    assert "EgressShard._write_client" not in ref
    assert "IngressShard._deliver" in port and "IngressShard._deliver" \
        in ref


def test_fence_held_propagation():
    src = (
        "import threading\n"
        "class Tbl:\n"
        "    def __init__(self):\n"
        "        self.fence = threading.RLock()\n"
        "        self.state = {}\n"
        "    def peek(self):\n"
        "        return self.state\n"
        "def fenced(t: Tbl):\n"
        "    with t.fence:\n"
        "        return t.peek()\n")
    assert tsum.build_program([(src, "t.py", None)]) \
        .held[("t", "Tbl.peek")] is True
    src2 = src + "def rogue(t: Tbl):\n    return t.peek()\n"
    assert tsum.build_program([(src2, "t.py", None)]) \
        .held[("t", "Tbl.peek")] is False


def test_summary_cache_hits_on_identical_content():
    src = "def f(x):\n    return x\n"
    a = tsum.module_summary(src, "same.py")
    assert tsum.module_summary(src, "same.py") is a
    assert tsum.module_summary(src + "\n# changed\n", "same.py") is not a


def test_cache_staleness_editing_callee_rejudges_caller(tmp_path):
    a = tmp_path / "ring_helper.py"
    b = tmp_path / "ring_caller.py"
    b.write_text("from ring_helper import free\n"
                 "def use(m):\n"
                 "    free(m)\n"
                 "    return m.seq\n")
    a.write_text("def free(m):\n    pass\n")
    assert ta.analyze_paths([str(tmp_path)]) == []
    a.write_text("from orleans_tpu_torch.core.message import "
                 "recycle_message\n"
                 "def free(m):\n"
                 "    recycle_message(m)\n")
    before = dict(tsum.CACHE_STATS)
    findings = ta.analyze_paths([str(tmp_path)])
    assert [(f.rule, f.line) for f in findings] == [("OTPU001", 4)]
    assert tsum.CACHE_STATS["hits"] - before["hits"] >= 1
    assert tsum.CACHE_STATS["misses"] - before["misses"] == 1


# ---------------------------------------------------------------------------
# The OTPU007 repair: a loop handed to the constructor
# ---------------------------------------------------------------------------

def test_handed_loop_fixture_is_flagged_by_the_copy_only():
    bad = os.path.join(PORT_FIXTURES, "otpu007_handed_loop_bad.py")
    port = ta.analyze_paths([bad])
    assert [(f.rule, f.line, f.symbol) for f in port] == \
        [("OTPU007", 21, "EgressShard._write_client")]
    assert "shard/worker loop" in port[0].message
    assert ra.analyze_paths([bad]) == []
    assert cli_main([bad]) == 1 and ref_cli([bad]) == 0


def test_handed_loop_clean_fixture_is_silent_in_both():
    clean = os.path.join(PORT_FIXTURES, "otpu007_handed_loop_clean.py")
    assert ta.analyze_paths([clean]) == [] == ra.analyze_paths([clean])


# ---------------------------------------------------------------------------
# The self-run over the port
# ---------------------------------------------------------------------------

def test_port_tree_is_clean_and_equal_to_the_references_run(port_scans):
    assert port_scans["cold"] == [], "\n".join(
        f.render() for f in port_scans["cold"])
    assert _rows(port_scans["ref"]) == []


def test_cli_default_path_is_the_port(port_scans):
    assert port_scans["cli_rc"] == 0
    assert "clean: no findings" in port_scans["cli_err"]
    assert port_scans["cli_out"] == ""


def test_overlapping_path_args_scan_once(fixture_scans):
    once = ta.analyze_paths([FIXTURES])
    twice = ta.analyze_paths([FIXTURES, os.path.join(FIXTURES,
                                                     "otpu001_bad.py")])
    assert len(once) == len(twice) == len(fixture_scans["port"])


def test_self_run_performance_budget(port_scans):
    assert port_scans["warm_s"] < 10.0
    assert tsum._CACHE


def test_warm_cache_floor_on_package_tree(port_scans):
    cold, warm = port_scans["cold_stats"], port_scans["warm_stats"]
    assert warm["cache_misses"] == 0
    assert warm["cache_hits"] == cold["cache_misses"] > 0
    assert warm["summarize_s"] * 3 <= cold["summarize_s"]


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

def test_baseline_round_trip_and_staleness(fixture_scans, tmp_path):
    findings = _of(fixture_scans["port"], "otpu001_bad.py")
    path = str(tmp_path / "b.json")
    ta.write_baseline(path, findings)
    base = ta.load_baseline(path)
    new, stale = ta.match_baseline(findings, base)
    assert new == [] and not stale
    new, stale = ta.match_baseline(findings[1:], base)
    assert new == [] and sum(stale.values()) == 1
    other = _of(fixture_scans["port"], "otpu002_bad.py")
    new, _ = ta.match_baseline(findings + other, base)
    assert {f.rule for f in new} == {"OTPU002"}


def test_baseline_matching_survives_line_churn(fixture_scans, tmp_path):
    findings = _of(fixture_scans["port"], "otpu001_bad.py")
    path = str(tmp_path / "b.json")
    ta.write_baseline(path, findings)
    moved = [type(f)(f.rule, f.severity, f.path, f.line + 40, f.col,
                     f.message, f.symbol) for f in findings]
    new, stale = ta.match_baseline(moved, ta.load_baseline(path))
    assert new == [] and not stale


def test_baseline_file_is_sorted_and_equal_to_the_references(
        fixture_scans, tmp_path):
    findings = fixture_scans["port"]
    p1, p2, p3 = (str(tmp_path / n) for n in ("a.json", "b.json",
                                              "ref.json"))
    ta.write_baseline(p1, findings)
    ta.write_baseline(p2, list(reversed(findings)))
    ra.write_baseline(p3, fixture_scans["ref"])
    with open(p1) as f1, open(p2) as f2, open(p3) as f3:
        text = f1.read()
        assert text == f2.read() == f3.read()
    entries = json.loads(text)["findings"]
    keys = [(e["path"], e["line"], e["col"], e["rule"]) for e in entries]
    assert keys == sorted(keys)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fname,rc", [("otpu001_bad.py", 1),
                                      ("otpu001_clean.py", 0)])
def test_cli_exit_code_on_a_fixture(fname, rc, capsys):
    assert cli_main([os.path.join(FIXTURES, fname)]) == rc
    out = capsys.readouterr().out
    assert ("OTPU001" in out) == bool(rc)


def test_cli_json_format_equals_the_reference(capsys):
    target = os.path.join(FIXTURES, "otpu004_bad.py")
    assert cli_main([target, "--format", "json"]) == 1
    port = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in port["findings"]} == {"OTPU004"}
    assert ref_cli([target, "--format", "json"]) == 1
    assert port == json.loads(capsys.readouterr().out)


def test_cli_rule_selection(capsys):
    assert cli_main([FIXTURES, "--rules", "OTPU003"]) == 1
    out = capsys.readouterr().out
    assert "OTPU003" in out and "OTPU001" not in out


def test_cli_unknown_rule_is_usage_error():
    assert cli_main([FIXTURES, "--rules", "OTPU999"]) == 2


def test_cli_filtered_run_does_not_report_stale(capsys, tmp_path):
    target = os.path.join(FIXTURES, "otpu001_bad.py")
    baseline = str(tmp_path / "b.json")
    assert cli_main([target, "--write-baseline", baseline]) == 0
    capsys.readouterr()
    assert cli_main([os.path.join(FIXTURES, "otpu001_clean.py"),
                     "--rules", "OTPU001", "--baseline", baseline]) == 0
    assert "stale" not in capsys.readouterr().err


def test_cli_write_baseline_refuses_filters(tmp_path):
    out = str(tmp_path / "b.json")
    for extra in (["--rules", "OTPU001"], ["--min-severity", "error"],
                  ["--intra-only"]):
        assert cli_main([FIXTURES, "--write-baseline", out] + extra) == 2
    assert not os.path.exists(out)
    assert cli_main([FIXTURES, "--write-baseline", out]) == 0
    assert os.path.exists(out)


@pytest.mark.parametrize("fname", ["otpu007_bad.py", "otpu007_clean.py",
                                   "suppressed.py"])
def test_cli_sarif_equals_the_reference(fname, capsys):
    """The whole SARIF document but the rules' texts (compared in
    ``test_rule_texts_equal_the_reference``)."""
    def core(doc):
        for run in doc["runs"]:
            run["tool"]["driver"]["rules"] = [
                r["id"] for r in run["tool"]["driver"]["rules"]]
        return doc
    target = os.path.join(FIXTURES, fname)
    rc = cli_main([target, "--format", "sarif"])
    port = json.loads(capsys.readouterr().out)
    assert rc == ref_cli([target, "--format", "sarif"])
    assert core(port) == core(json.loads(capsys.readouterr().out))
    run = port["runs"][0]
    assert port["version"] == "2.1.0"
    assert run["tool"]["driver"]["name"] == "orleans-tpu-analysis"
    if fname == "otpu007_bad.py":
        assert rc == 1
        assert {r["ruleId"] for r in run["results"]} == {"OTPU007"}
        assert {r["level"] for r in run["results"]} == {"error"}
    elif fname == "suppressed.py":
        assert rc == 0 and run["results"]
        for r in run["results"]:
            assert r["suppressions"] == [{"kind": "inSource"}]
    else:
        assert rc == 0 and run["results"] == []


def test_cli_sarif_reports_baselined_as_external(tmp_path, capsys):
    bad = os.path.join(FIXTURES, "otpu002_bad.py")
    baseline = str(tmp_path / "b.json")
    assert cli_main([bad, "--write-baseline", baseline]) == 0
    capsys.readouterr()
    assert cli_main([bad, "--baseline", baseline, "--format", "sarif"]) == 0
    results = json.loads(capsys.readouterr().out)["runs"][0]["results"]
    assert results
    for r in results:
        (supp,) = r["suppressions"]
        assert supp["kind"] == "external"
        assert baseline in supp["justification"]


def test_cli_stats_prints_phases_and_cache_ratio(capsys):
    assert cli_main([os.path.join(FIXTURES, "otpu007_clean.py"),
                     "--stats"]) == 0
    err = capsys.readouterr().err
    for word in ("stats:", "read+parse", "summarize", "cache", "link",
                 "rules"):
        assert word in err


@pytest.mark.parametrize("rid", ["otpu007", "OTPU001", "OTPU999"])
def test_cli_explain_equals_the_reference(rid, capsys):
    rc = cli_main(["--explain", rid])
    port = capsys.readouterr().out
    assert rc == ref_cli(["--explain", rid])
    assert port == capsys.readouterr().out
    if rid == "OTPU999":
        assert rc == 2
    else:
        assert rc == 0 and rid.upper() in port
        assert f"{rid.lower()}_bad.py" in port
