"""Phase-1 per-function summaries + the phase-2 program index.

The interprocedural half of the analyzer (the Infer-style compositional
design): each module is summarized ONCE — independently of every other
module, so summaries cache per file keyed on content hash — and a cheap
linking pass stitches the summaries into a :class:`Program` that rules
query at call sites.

Per function the summary records
* **release behavior** — which parameters are definitely handed to a
  freelist releaser on every normal exit (``recycle_message`` and
  friends, directly or transitively through callees), which parameters
  escape into containers/fields, and whether the function returns one of
  its parameters (an alias the caller must keep tracking);
* **thread affinity** — callables spawned as worker entries
  (``threading.Thread(target=...)``, ``Thread`` subclass ``run`` bodies,
  ``run_in_executor`` callables) and callables handed BACK to an event
  loop (``call_soon_threadsafe``/``add_reader``/``create_task``...),
  keyed on the loop object's inferred kind — ``asyncio.new_event_loop``
  assignments are shard/worker loops, and so is a loop handed to the
  constructor and stored on ``self`` (``__init__(self, ..., loop)``:
  ``self.loop = loop``, as an egress shard is given its loop);
  ``get_running_loop`` is the main loop;
* **fence state** — accesses to donated device state (``.state`` /
  ``.hits`` on a fence-owning receiver) and call edges, each tagged with
  whether a tick fence (``with x.fence``/``x._fence``/``x.tick_fence()``)
  is lexically held;
* **registry writes** — mutating calls on the loop-confined observability
  classes (StatsRegistry/Histogram/QueueWaitTrend/SpanCollector/
  CallSiteStats), each tagged with the parameter that guards it
  (the ``sink is None`` stamp-and-replay idiom) when there is one.

Modules additionally contribute grain interface tables (host-tier
``Grain`` subclasses → public async method arity/one-way; device-tier
``VectorGrain`` subclasses → ``@actor_method`` names) and lightweight
type specs (annotations, constructor assignments, typed attribute
chains) that phase 2 resolves lazily.

Context sensitivity is k=1 per call edge: phase 2 classifies every
worker-tainted function as a seed, worker-only, or MIXED (also reached
from main-loop context or declared as a runtime entry point), and the
loop-confinement rule judges mixed helpers on the worker call edge
instead of at the definition. Aliases flow through 2-chain attributes
(``self._pending``) and container membership (``batch.append(m)``), and
cross-module release depth closes over a link-time overlay (phase 2
never mutates the cached summaries — re-summarizing an edited module is
enough to re-judge every caller into it). Zero-call-site entry points
(``ctl_*``, timer/reminder callbacks, loop-scheduled and ring-drain
callbacks) get declared contexts from ``entrypoints.py``.

Known, deliberate imprecision (ROADMAP): calling contexts are depth-1
(k>1 chains collapse); bare-name call resolution is module-scoped (plus
explicit imports).

The port's copy of ``orleans_tpu.analysis.summaries``.
"""

from __future__ import annotations

import ast
import hashlib
import itertools
from dataclasses import dataclass, field, replace
from typing import Iterable

from .entrypoints import entry_label_for_name, entry_label_for_sched

__all__ = [
    "CallEdge", "FunctionSummary", "GrainMethod", "GrainTable",
    "GRAIN_BASES", "ModuleSummary", "Program", "ReleaseWalker",
    "build_program", "dotted_name", "func_params", "module_summary",
    "RELEASERS",
]

# Class bases that make a class a host-tier grain (turn discipline
# applies). VectorGrain is deliberately absent: its methods are kernel
# specs executed by the tick engine, not turns. (Shared with
# rules/common.py, which re-exports these helpers — rule modules import
# common, common imports this module, never the reverse.)
GRAIN_BASES = {
    "Grain", "StatefulGrain", "JournaledGrain", "TransactionalGrain",
    "GrainService",
}


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, "" for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def func_params(node: "ast.FunctionDef | ast.AsyncFunctionDef |"
                " ast.Lambda") -> set[str]:
    a = node.args
    names = {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names

RELEASERS = {
    "recycle_message", "_recycle_callback", "recycle_callback",
    "_release_marker", "release_marker",
}

# batch releasers: release every ELEMENT of their container argument
# (the container itself stays live)
ITEM_RELEASERS = {"recycle_messages"}

# loop-confined observability classes and their mutating surface
REGISTRY_CLASSES = {"StatsRegistry", "Histogram", "QueueWaitTrend",
                    "SpanCollector", "CallSiteStats", "CostLedger"}
# distinctive enough to flag on ANY receiver (these names are only used
# as registry writes in this tree); see also _TYPED_WRITES
UNTYPED_WRITES = {"observe", "increment", "set_gauge", "exemplar", "note",
                  "charge_turn", "charge_tick", "charge_wire",
                  "charge_stream"}
# generic names: flagged only when the receiver's class is inferred
TYPED_WRITES = {"record", "histogram", "histogram_with", "force_retain",
                "mark_remote", "presampled", "pull", "merge"}

# loop-callback registration APIs: (method name, callable arg index)
_LOOP_CB_APIS = {"call_soon_threadsafe": 0, "call_soon": 0, "call_at": 1,
                 "call_later": 1, "add_reader": 1, "add_writer": 1,
                 "run_until_complete": 0}

# donated device state on fence-owning receivers (the tick-fence protocol)
PROTECTED_ATTRS = {"state", "hits", "cost"}

# Grain base-class methods that are NOT remote interface (mirrors
# runtime.grain._GRAIN_BASE_METHODS without importing the runtime)
_GRAIN_BASE_EXCLUDE = {
    "on_activate", "on_deactivate", "read_state", "write_state",
    "clear_state", "get_grain", "register_timer", "register_reminder",
    "unregister_reminder", "get_reminder", "get_stream_provider",
    "deactivate_on_idle", "delay_deactivation",
}


def _chain(node: ast.AST) -> tuple[str, ...]:
    """('self', 'tables') for self.tables; () when not a pure chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


# ---------------------------------------------------------------------------
# Type specs: lazily-resolved descriptions of "what class is this value"
# ---------------------------------------------------------------------------
# spec forms:
#   ("cls", name)              — concrete class name
#   ("dict", valspec)          — dict with valspec values
#   ("expr", base, steps)      — walk: base ("var", name) | ("self",);
#                                steps: ("attr", a) | ("sub",) | ("call", m)
#   None                       — unknown

def _ann_spec(node: ast.AST):
    """Annotation AST → spec. Unwraps Optional[...] / ``X | None`` /
    quoted forward references; dict[...] keeps its value type so
    subscripts resolve element classes."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None
        return _ann_spec(node)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        left = _ann_spec(node.left)
        return left if left is not None else _ann_spec(node.right)
    if isinstance(node, ast.Subscript):
        head = dotted_name(node.value).rsplit(".", 1)[-1]
        if head in ("Optional",):
            return _ann_spec(node.slice)
        if head in ("dict", "Dict", "defaultdict"):
            sl = node.slice
            if isinstance(sl, ast.Tuple) and len(sl.elts) == 2:
                val = _ann_spec(sl.elts[1])
                if val is not None:
                    return ("dict", val)
            return None
        if head in ("list", "List", "tuple", "Tuple", "set", "Set"):
            return None
        return _ann_spec(node.value)
    name = dotted_name(node)
    if name:
        last = name.rsplit(".", 1)[-1]
        if last in ("None", "Any", "object", "int", "float", "str",
                    "bool", "bytes", "type", "Callable"):
            return None
        return ("cls", last)
    return None


def _expr_spec(node: ast.AST):
    """Value expression → spec (constructor call, attribute chain,
    subscript of a chain, or a method-call return)."""
    if isinstance(node, ast.Call):
        fn = node.func
        ch = _chain(fn)
        if len(ch) == 1 and ch[0][:1].isupper():
            return ("cls", ch[0])          # ClassName(...)
        if len(ch) > 1 and ch[-1][:1].isupper():
            return ("cls", ch[-1])         # mod.ClassName(...)
        if len(ch) >= 2:                   # obj.method(...): return type
            base = _expr_spec(fn.value)
            if base is not None:
                return _step(base, ("call", ch[-1]))
        return None
    if isinstance(node, ast.Await):
        return _expr_spec(node.value)
    if isinstance(node, ast.Subscript):
        base = _expr_spec(node.value)
        return _step(base, ("sub",)) if base is not None else None
    ch = _chain(node)
    if not ch:
        return None
    if ch[0] == "self":
        spec = ("expr", ("self",), ())
    else:
        spec = ("expr", ("var", ch[0]), ())
    for a in ch[1:]:
        spec = _step(spec, ("attr", a))
    return spec


def _step(spec, step):
    if spec is None:
        return None
    if spec[0] == "expr":
        return ("expr", spec[1], spec[2] + (step,))
    return ("expr", ("spec", spec), (step,))


# ---------------------------------------------------------------------------
# Summary dataclasses
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CallEdge:
    chain: tuple[str, ...]          # callee as written: ("self","m")...
    lineno: int
    col: int
    args: tuple                     # positional arg Name ids (or None)
    kwargs: tuple                   # (name, is_none_literal|arg-name|True)
    nargs: int
    fenced: bool                    # lexically under a held tick fence
    none_args: frozenset            # positional indices passed literal None


@dataclass(frozen=True)
class SchedEdge:
    """A callable handed to a thread/executor/loop-scheduling API."""
    target: tuple[str, ...]         # chain of the callable passed
    kind: str                       # "thread" | "executor" | "loop" | "timer"
    loop: tuple | None              # receiver chain for kind == "loop"
    lineno: int
    api: str = ""                   # the registration API name


@dataclass(frozen=True)
class RegistryWrite:
    method: str
    recv: tuple[str, ...]
    lineno: int
    col: int
    guard: str | None               # param name guarding (stamp-and-replay)
    recv_is_param: str | None       # receiver IS this bare parameter


@dataclass(frozen=True)
class ProtectedAccess:
    attr: str
    recv: tuple[str, ...]
    lineno: int
    col: int
    fenced: bool


@dataclass
class FunctionSummary:
    qualname: str
    lineno: int
    params: tuple[str, ...] = ()
    is_async: bool = False
    releases: frozenset = frozenset()       # definite param releases
    releases_items: frozenset = frozenset()  # params whose ELEMENTS die
    escapes: frozenset = frozenset()
    returns_param: int | None = None
    calls: tuple[CallEdge, ...] = ()
    sched: tuple[SchedEdge, ...] = ()
    writes: tuple[RegistryWrite, ...] = ()
    protected: tuple[ProtectedAccess, ...] = ()
    var_specs: dict = field(default_factory=dict)   # name → spec
    has_releasers: bool = False             # direct releaser call present


@dataclass(frozen=True)
class GrainMethod:
    name: str
    min_pos: int                    # required positional (self excluded)
    max_pos: int | None             # None = *args
    kwonly: frozenset
    has_kwargs: bool
    one_way: bool


@dataclass
class GrainTable:
    name: str
    kind: str                       # "host" | "vector"
    bases: tuple[str, ...] = ()
    methods: dict = field(default_factory=dict)     # name → GrainMethod


@dataclass
class ClassInfo:
    name: str
    bases: tuple[str, ...] = ()
    is_thread: bool = False
    fence_owner: bool = False
    attr_specs: dict = field(default_factory=dict)  # attr → spec
    loop_attrs: dict = field(default_factory=dict)  # attr → "worker"|"main"
    method_returns: dict = field(default_factory=dict)  # meth → spec
    # shm-segment owner: assigns self.shm or lists "shm"/"buf" in
    # __slots__ — the OTPU010 ring-discipline scope marker
    shm_owner: bool = False
    # mutable container attrs: attr → "list"|"dict"|"set"|"deque"
    container_attrs: dict = field(default_factory=dict)


@dataclass
class ModuleSummary:
    rel_path: str
    module_key: str
    functions: dict = field(default_factory=dict)   # qualname → summary
    classes: dict = field(default_factory=dict)     # name → ClassInfo
    grains: dict = field(default_factory=dict)      # name → [GrainTable]
    imports: dict = field(default_factory=dict)     # name → (modkey, orig)
    globals_specs: dict = field(default_factory=dict)
    # ClassName.attr = ... monkey-patches: the attached name joins the
    # class's interface table as an open (unknown-arity) method
    grain_patches: list = field(default_factory=list)
    # qualname → function AST node. Retained for the link-time release
    # overlay (Program re-walks callers of cross-module releasers). A
    # pure function of the source text like everything else here, so
    # the content-hash cache stays sound; in-memory only.
    fn_nodes: dict = field(default_factory=dict, repr=False)


# ---------------------------------------------------------------------------
# Release dataflow walker (shared by phase 1 and the OTPU001 check)
# ---------------------------------------------------------------------------

_TERMINATED = None


class _Cell:
    __slots__ = ("gid", "released", "param")

    def __init__(self, gid, released=None, param=None):
        self.gid, self.released, self.param = gid, released, param


class ReleaseWalker:
    """Branch-aware, alias-aware, loop-carried released-state dataflow
    over ONE function body.

    State per path: ``bind`` maps name → (gid, released_line, param_idx);
    aliases share a ``gid`` so releasing any alias poisons the group.
    Branch merges keep DEFINITE facts only (released on all paths);
    loops run the body twice with the back-edge state merged in, so a
    release in iteration N is seen by a use in iteration N+1.

    Beyond bare names, 2-chain attributes (``self._pending``) are
    tracked as pseudo-variables that alias whatever was stored into
    them, and container membership (``batch.append(m)`` / ``d[k] = m``)
    is recorded per path so an ITEM-release of the container
    (``recycle_messages(batch)`` or a callee with a ``releases_items``
    summary) poisons the stashed members.

    ``release_of_call(call)`` maps a Call node to the names it releases
    ([] for unknown calls) — the interprocedural hook; ``alias_of_call``
    maps a Call to the argument Name its result aliases (or None);
    ``items_release_of_call`` maps a Call to the container names whose
    ELEMENTS it releases. Callbacks ``on_use(node, name, release_line)``
    and ``on_double(node, name)`` fire findings; both optional (summary
    mode records exit states instead).
    """

    _META = ("//rel//", "//mem//")

    def __init__(self, params: Iterable[str], release_of_call,
                 alias_of_call=None, on_use=None, on_double=None,
                 items_release_of_call=None):
        self._gids = itertools.count()
        self.release_of_call = release_of_call
        self.alias_of_call = alias_of_call or (lambda c: None)
        self.items_release_of_call = items_release_of_call or \
            (lambda c: [])
        self.on_use = on_use
        self.on_double = on_double
        self.reported: set = set()
        self.exit_releases: list[frozenset] = []
        self.return_params: list = []
        self.escaped: set[int] = set()
        self.items_released: set[int] = set()
        self.entry = {}
        for i, p in enumerate(params):
            self.entry[p] = (next(self._gids), None, i)

    @staticmethod
    def _attr_pseudo(node) -> str | None:
        """'a.b' pseudo-variable name for a 2-chain attribute."""
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name):
            return f"{node.value.id}.{node.attr}"
        return None

    @staticmethod
    def _cell_name(node) -> str | None:
        if isinstance(node, ast.Name):
            return node.id
        return ReleaseWalker._attr_pseudo(node)

    # -- state helpers --------------------------------------------------
    def _merge(self, states):
        live = [s for s in states if s is not _TERMINATED]
        if not live:
            return _TERMINATED
        if len(live) == 1:
            return live[0]
        merged = live[0]
        for other in live[1:]:
            out = {}
            memo: dict = {}
            rel0, rel1 = merged.get("//rel//"), other.get("//rel//")
            mem0 = merged.get("//mem//", frozenset())
            mem1 = other.get("//mem//", frozenset())
            for name, c in merged.items():
                if name in self._META:
                    continue
                o = other.get(name)
                if o is None:
                    continue
                if c[0] == o[0]:
                    # same alias group, but the branches may disagree on
                    # the release (a release REPLACES the cell per
                    # branch): definite semantics — released only when
                    # released on BOTH paths
                    if c[1] == o[1]:
                        out[name] = c
                    elif c[1] is not None and o[1] is not None:
                        out[name] = (c[0], min(c[1], o[1]), c[2])
                    else:
                        out[name] = (c[0], None, c[2])
                    continue
                key = (c[0], o[0])
                if key not in memo:
                    rel = c[1] if (c[1] is not None and o[1] is not None) \
                        else None
                    if rel is not None:
                        rel = min(c[1], o[1])
                    par = c[2] if c[2] == o[2] else None
                    memo[key] = (next(self._gids), rel, par)
                out[name] = memo[key]
            out["//rel//"] = (rel0 or frozenset()) & (rel1 or frozenset())
            # definite membership only: facts on both paths, and only
            # for alias groups that survived the merge un-remapped
            gids = {c[0] for n, c in out.items() if n not in self._META}
            out["//mem//"] = frozenset(
                t for t in (mem0 & mem1)
                if t[0] in gids and t[1] in gids)
            merged = out
        return merged

    @staticmethod
    def _rel_set(state) -> frozenset:
        return state.get("//rel//", frozenset())

    def run(self, body: list[ast.stmt]) -> None:
        state = dict(self.entry)
        state["//rel//"] = frozenset()
        state["//mem//"] = frozenset()
        end = self.exec_block(body, state)
        if end is not _TERMINATED:
            self.exit_releases.append(self._rel_set(end))
            self.return_params.append(None)

    def exec_block(self, stmts, state):
        for stmt in stmts:
            if state is _TERMINATED:
                return _TERMINATED
            state = self.exec_stmt(stmt, state)
        return state

    # -- per-statement events -------------------------------------------
    def _walk_shallow(self, root):
        stack = [root]
        while stack:
            node = stack.pop()
            if node is not root and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda, ast.ClassDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _release_events(self, stmt):
        out = []
        for node in self._walk_shallow(stmt):
            if isinstance(node, ast.Call):
                names = self.release_of_call(node)
                if names:
                    out.append((node, names))
        return out

    def _item_release_events(self, stmt):
        out = []
        for node in self._walk_shallow(stmt):
            if isinstance(node, ast.Call):
                names = self.items_release_of_call(node)
                if names:
                    out.append((node, names))
        return out

    def _emit_use(self, node, name, line):
        key = ("use", name, getattr(node, "lineno", 0))
        if self.on_use is not None and key not in self.reported:
            self.reported.add(key)
            self.on_use(node, name, line)

    def _apply_simple(self, stmt, state):
        releases = self._release_events(stmt)
        item_releases = self._item_release_events(stmt)
        # the arg Names a call releases are the release EVENT, not a
        # use — skip them in the use scan so a second release reports
        # as double-release, not use-after-release
        skip = set()
        for call, names in (*releases, *item_releases):
            for arg in (*call.args,
                        *(kw.value for kw in call.keywords)):
                if self._cell_name(arg) in names:
                    skip.add(id(arg))
        # uses first: the statement's loads see the PRE-statement state
        for node in self._walk_shallow(stmt):
            if id(node) in skip or not isinstance(
                    getattr(node, "ctx", None), ast.Load):
                continue
            if isinstance(node, ast.Name):
                c = state.get(node.id)
                if c is not None and c[1] is not None:
                    self._emit_use(node, node.id, c[1])
            elif isinstance(node, ast.Attribute):
                ps = self._attr_pseudo(node)
                c = state.get(ps) if ps is not None else None
                if c is not None and c[1] is not None:
                    self._emit_use(node, ps, c[1])
        # escapes: a param stored into a container/field
        self._scan_escapes(stmt, state)
        # container membership BEFORE releases: a same-statement stash
        # never outruns the release sweep
        self._scan_members(stmt, state)
        # releases
        for call, names in releases:
            for name in names:
                c = state.get(name)
                if c is None:
                    gid = next(self._gids)
                    state[name] = (gid, call.lineno, None)
                    continue
                if c[1] is not None:
                    key = ("double", name, call.lineno)
                    if self.on_double is not None and \
                            key not in self.reported:
                        self.reported.add(key)
                        self.on_double(call, name)
                    continue
                self._release_gid(state, c[0], call.lineno)
        # item releases: the container stays live, its members die
        for call, names in item_releases:
            for name in names:
                c = state.get(name)
                if c is None:
                    continue
                if c[2] is not None:
                    self.items_released.add(c[2])
                mem = state.get("//mem//", frozenset())
                for cont_gid, member_gid in mem:
                    if cont_gid == c[0]:
                        self._release_gid(state, member_gid, call.lineno,
                                          definite_only=True)
        # alias-aware rebinds (last: assignment targets bind AFTER rhs)
        self._apply_binds(stmt, state)
        return state

    def _release_gid(self, state, gid, lineno, definite_only=False):
        for n2, c2 in list(state.items()):
            if n2 in self._META or c2[0] != gid:
                continue
            if definite_only and c2[1] is not None:
                continue  # already released: no double-report for items
            state[n2] = (gid, lineno, c2[2])
            if c2[2] is not None:
                state["//rel//"] = self._rel_set(state) | {c2[2]}

    def _scan_escapes(self, stmt, state):
        for node in self._walk_shallow(stmt):
            names = []
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) and fn.attr in (
                        "append", "add", "put", "put_nowait", "setdefault"):
                    names = [a for a in node.args
                             if isinstance(a, ast.Name)]
            elif isinstance(node, ast.Assign):
                if any(isinstance(t, (ast.Attribute, ast.Subscript))
                       for t in node.targets) and \
                        isinstance(node.value, ast.Name):
                    names = [node.value]
            for nm in names:
                c = state.get(nm.id)
                if c is not None and c[2] is not None:
                    self.escaped.add(c[2])

    def _scan_members(self, stmt, state):
        """Record container membership: ``c.append(m)`` / ``c[k] = m``
        links m's alias group to c's so an item-release of c poisons
        m."""
        for node in self._walk_shallow(stmt):
            cont = None
            members: list = []
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) and node.args:
                    if fn.attr in ("append", "add", "put", "put_nowait"):
                        cont = self._cell_name(fn.value)
                        members = [node.args[0]]
                    elif fn.attr in ("setdefault", "insert") and \
                            len(node.args) > 1:
                        cont = self._cell_name(fn.value)
                        members = [node.args[1]]
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        cont = self._cell_name(t.value)
                        members = [node.value]
            if cont is None or not members:
                continue
            c = state.get(cont)
            if c is None:
                c = (next(self._gids), None, None)
                state[cont] = c
            add = set()
            for mnode in members:
                mname = self._cell_name(mnode)
                mc = state.get(mname) if mname is not None else None
                if mc is not None:
                    add.add((c[0], mc[0]))
            if add:
                state["//mem//"] = state.get("//mem//",
                                             frozenset()) | add

    def _bind_source(self, value, state):
        """The cell an assignment RHS aliases, or None."""
        if isinstance(value, ast.Name):
            return state.get(value.id)
        if isinstance(value, ast.Attribute):
            ps = self._attr_pseudo(value)
            return state.get(ps) if ps is not None else None
        if isinstance(value, ast.Call):
            al = self.alias_of_call(value)
            if al is not None:
                return state.get(al)
        return None

    def _invalidate_pseudo(self, state, base: str):
        """Rebinding ``x`` invalidates every tracked ``x.attr`` cell."""
        prefix = base + "."
        for k in [k for k in state
                  if k not in self._META and k.startswith(prefix)]:
            state[k] = (next(self._gids), None, None)

    def _apply_binds(self, stmt, state):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            t = stmt.targets[0]
            if isinstance(t, ast.Name):
                src = self._bind_source(stmt.value, state)
                self._invalidate_pseudo(state, t.id)
                if src is not None:
                    state[t.id] = src       # alias: share the gid
                    return
                state[t.id] = (next(self._gids), None, None)
                return
            ps = self._attr_pseudo(t)
            if ps is not None:
                src = self._bind_source(stmt.value, state)
                state[ps] = src if src is not None else \
                    (next(self._gids), None, None)
                return
        for node in self._walk_shallow(stmt):
            if isinstance(node, ast.Name) and \
                    isinstance(node.ctx, (ast.Store, ast.Del)):
                if node.id in state:
                    state[node.id] = (next(self._gids), None, None)
                self._invalidate_pseudo(state, node.id)

    # -- control flow ----------------------------------------------------
    def exec_stmt(self, stmt, state):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            state.pop(stmt.name, None)
            return state
        if isinstance(stmt, ast.Return):
            self._apply_simple(stmt, state)
            self.exit_releases.append(self._rel_set(state))
            rp = None
            if isinstance(stmt.value, ast.Name):
                c = state.get(stmt.value.id)
                if c is not None:
                    rp = c[2]
            self.return_params.append(rp)
            return _TERMINATED
        if isinstance(stmt, ast.Raise):
            self._apply_simple(stmt, state)
            return _TERMINATED
        if isinstance(stmt, (ast.Break, ast.Continue)):
            return _TERMINATED
        if isinstance(stmt, ast.If):
            self._apply_simple(ast.Expr(stmt.test), state)
            s_body = self.exec_block(stmt.body, dict(state))
            s_else = self.exec_block(stmt.orelse, dict(state))
            return self._merge([s_body, s_else])
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            if isinstance(stmt, ast.While):
                self._apply_simple(ast.Expr(stmt.test), state)
            else:
                self._apply_simple(ast.Expr(stmt.iter), state)
            entry = dict(state)

            def rebind_targets(st):
                if not isinstance(stmt, ast.While):
                    for node in ast.walk(stmt.target):
                        if isinstance(node, ast.Name):
                            st[node.id] = (next(self._gids), None, None)
                return st

            rebind_targets(entry)
            # pass 1: straight-line release→use inside one iteration
            exit1 = self.exec_block(stmt.body, dict(entry))
            # pass 2 runs the body again FROM the iteration-exit state:
            # a definite release at the end of iteration N reaches a use
            # in iteration N+1 (loop-carried). Break/continue paths
            # terminate and so never feed the back edge — a
            # release-then-break body stays clean.
            if exit1 is not _TERMINATED:
                self.exec_block(stmt.body, rebind_targets(dict(exit1)))
            after = self._merge([dict(state), exit1])
            if after is _TERMINATED:
                after = dict(state)
            self.exec_block(stmt.orelse, dict(after))
            return after
        if isinstance(stmt, (ast.Try, getattr(ast, "TryStar", ast.Try))):
            s_body = self.exec_block(stmt.body, dict(state))
            if s_body is not _TERMINATED and stmt.orelse:
                s_body = self.exec_block(stmt.orelse, s_body)
            ends = [s_body]
            for handler in stmt.handlers:
                ends.append(self.exec_block(handler.body, dict(state)))
            merged = self._merge(ends)
            fin_in = merged if merged is not _TERMINATED else dict(state)
            fin_out = self.exec_block(stmt.finalbody, dict(fin_in))
            if merged is _TERMINATED or fin_out is _TERMINATED:
                return _TERMINATED
            return fin_out
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._apply_simple(ast.Expr(item.context_expr), state)
                if item.optional_vars is not None:
                    for node in ast.walk(item.optional_vars):
                        if isinstance(node, ast.Name):
                            state[node.id] = (next(self._gids), None, None)
            return self.exec_block(stmt.body, state)
        match_cls = getattr(ast, "Match", None)
        if match_cls is not None and isinstance(stmt, match_cls):
            self._apply_simple(ast.Expr(stmt.subject), state)
            ends = [self.exec_block(case.body, dict(state))
                    for case in stmt.cases]
            ends.append(dict(state))
            return self._merge(ends)
        return self._apply_simple(stmt, state)

    # -- summary products ------------------------------------------------
    def definite_releases(self) -> frozenset:
        if not self.exit_releases:
            return frozenset()
        out = self.exit_releases[0]
        for s in self.exit_releases[1:]:
            out = out & s
        return out

    def returned_param(self):
        vals = {v for v in self.return_params}
        if len(vals) == 1:
            v = vals.pop()
            return v
        return None


# ---------------------------------------------------------------------------
# Phase 1: one module → ModuleSummary
# ---------------------------------------------------------------------------

def _module_key(rel_path: str) -> str:
    key = rel_path[:-3] if rel_path.endswith(".py") else rel_path
    key = key.replace("/", ".")
    return key[:-9] if key.endswith(".__init__") else key


def _fence_exprs(item_expr: ast.AST) -> bool:
    """Is this with-item a tick-fence acquisition? ``x.fence`` /
    ``x._fence`` attribute, or an ``x.tick_fence()`` call."""
    if isinstance(item_expr, ast.Call):
        ch = _chain(item_expr.func)
        return bool(ch) and ch[-1] in ("tick_fence", "fence", "_fence")
    ch = _chain(item_expr)
    return bool(ch) and ch[-1] in ("fence", "_fence")


class _FuncCollector:
    """Single source-ordered walk of one function body collecting call
    edges, scheduling edges, registry writes, protected accesses and
    local type specs — with the lexical fence/guard context threaded
    through the recursion."""

    def __init__(self, fn, qualname: str):
        self.fn = fn
        self.summary = FunctionSummary(
            qualname=qualname, lineno=fn.lineno,
            params=tuple(self._pos_params(fn)),
            is_async=isinstance(fn, ast.AsyncFunctionDef))
        self.calls: list[CallEdge] = []
        self.sched: list[SchedEdge] = []
        self.writes: list[RegistryWrite] = []
        self.protected: list[ProtectedAccess] = []
        self.var_specs: dict = {}
        self.param_set = func_params(fn)
        a = fn.args
        for p in (*a.posonlyargs, *a.args, *a.kwonlyargs):
            spec = _ann_spec(p.annotation)
            if spec is not None:
                self.var_specs[p.arg] = spec
        self._has_releasers = False

    @staticmethod
    def _pos_params(fn) -> list[str]:
        a = fn.args
        return [p.arg for p in (*a.posonlyargs, *a.args)]

    def collect(self):
        self._block(self.fn.body, fenced=False, guard=None)
        s = self.summary
        s.calls = tuple(self.calls)
        s.sched = tuple(self.sched)
        s.writes = tuple(self.writes)
        s.protected = tuple(self.protected)
        s.var_specs = self.var_specs
        s.has_releasers = self._has_releasers
        s.returns_param = self._returns_param()
        return s

    def _returns_param(self):
        """Cheap identity-function detection: every return in the body
        returns the SAME bare parameter and the body never rebinds it —
        callers then treat the result as an alias of the argument. (The
        release walker recomputes this precisely for releasing
        functions; this scan covers plain pass-through helpers.)"""
        returned: set = set()
        params = list(self.summary.params)
        stack: list = list(self.fn.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue  # nested scope: its returns are not ours
            if isinstance(node, ast.Return):
                if not isinstance(node.value, ast.Name):
                    return None
                returned.add(node.value.id)
            elif isinstance(node, ast.Name) and \
                    isinstance(node.ctx, (ast.Store, ast.Del)) and \
                    node.id in params:
                return None
            stack.extend(ast.iter_child_nodes(node))
        if len(returned) == 1:
            name = returned.pop()
            if name in params:
                return params.index(name)
        return None

    # -- recursion ------------------------------------------------------
    def _block(self, stmts, fenced: bool, guard):
        for stmt in stmts:
            self._stmt(stmt, fenced, guard)

    def _stmt(self, stmt, fenced, guard):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs are summarized as their own functions
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            now_fenced = fenced
            for item in stmt.items:
                self._expr(item.context_expr, fenced, guard)
                if _fence_exprs(item.context_expr):
                    now_fenced = True
            self._block(stmt.body, now_fenced, guard)
            return
        if isinstance(stmt, ast.If):
            self._expr(stmt.test, fenced, guard)
            g = self._none_guard(stmt.test)
            if g is not None:
                name, none_branch = g
                self._block(stmt.body, fenced,
                            name if none_branch else guard)
                self._block(stmt.orelse, fenced,
                            guard if none_branch else name)
                return
            self._block(stmt.body, fenced, guard)
            self._block(stmt.orelse, fenced, guard)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, fenced, guard)
            self._type_for_target(stmt.target, stmt.iter)
            self._block(stmt.body, fenced, guard)
            self._block(stmt.orelse, fenced, guard)
            return
        if isinstance(stmt, ast.While):
            self._expr(stmt.test, fenced, guard)
            self._block(stmt.body, fenced, guard)
            self._block(stmt.orelse, fenced, guard)
            return
        if isinstance(stmt, (ast.Try, getattr(ast, "TryStar", ast.Try))):
            self._block(stmt.body, fenced, guard)
            for h in stmt.handlers:
                self._block(h.body, fenced, guard)
            self._block(stmt.orelse, fenced, guard)
            self._block(stmt.finalbody, fenced, guard)
            return
        if isinstance(stmt, ast.Assign):
            self._expr(stmt.value, fenced, guard)
            for t in stmt.targets:
                self._maybe_protected(t, fenced, store=True)
            if len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name):
                spec = _expr_spec(stmt.value)
                if spec is not None:
                    self.var_specs[stmt.targets[0].id] = spec
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._expr(stmt.value, fenced, guard)
            self._maybe_protected(stmt.target, fenced, store=True)
            if isinstance(stmt.target, ast.Name):
                spec = _ann_spec(stmt.annotation)
                if spec is not None:
                    self.var_specs[stmt.target.id] = spec
            return
        if isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value, fenced, guard)
            self._maybe_protected(stmt.target, fenced, store=True)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child, fenced, guard)
            elif isinstance(child, ast.stmt):
                self._stmt(child, fenced, guard)

    @staticmethod
    def _none_guard(test):
        """``x is None`` / ``x is not None`` / bare ``x`` / ``not x`` for
        a simple name → (name, none_branch_is_body). The guard threads
        into the branch where x may be None — the stamp-and-replay
        detector keys on it."""
        if isinstance(test, ast.Compare) and len(test.ops) == 1 and \
                isinstance(test.left, ast.Name) and \
                isinstance(test.comparators[0], ast.Constant) and \
                test.comparators[0].value is None:
            if isinstance(test.ops[0], ast.Is):
                return test.left.id, True
            if isinstance(test.ops[0], ast.IsNot):
                return test.left.id, False
        if isinstance(test, ast.Name):
            return test.id, False
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
                and isinstance(test.operand, ast.Name):
            return test.operand.id, True
        return None

    def _type_for_target(self, target, iter_expr):
        """``for cls, tbl in X.tables.items()`` → tbl: dict-value type."""
        if not (isinstance(iter_expr, ast.Call) and
                isinstance(iter_expr.func, ast.Attribute)):
            return
        meth = iter_expr.func.attr
        if meth not in ("items", "values"):
            return
        base = _expr_spec(iter_expr.func.value)
        if base is None:
            return
        val = ("expr", ("spec", base), (("dictval",),)) \
            if base[0] != "dict" else base[1]
        if meth == "values" and isinstance(target, ast.Name):
            self.var_specs[target.id] = val
        elif meth == "items" and isinstance(target, ast.Tuple) and \
                len(target.elts) == 2 and \
                isinstance(target.elts[1], ast.Name):
            self.var_specs[target.elts[1].id] = val

    # -- expressions ----------------------------------------------------
    def _expr(self, node, fenced, guard):
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            for gen in node.generators:
                self._expr(gen.iter, fenced, guard)
                self._type_for_target(gen.target, gen.iter)
                for cond in gen.ifs:
                    self._expr(cond, fenced, guard)
            if isinstance(node, ast.DictComp):
                self._expr(node.key, fenced, guard)
                self._expr(node.value, fenced, guard)
            else:
                self._expr(node.elt, fenced, guard)
            return
        if isinstance(node, ast.Call):
            self._call(node, fenced, guard)
            if isinstance(node.func, ast.Attribute):
                # x.state.values(): the protected attr hides inside the
                # callee chain, which _call does not treat as a load
                self._maybe_protected(node.func.value, fenced,
                                      store=False)
            for a in node.args:
                if not isinstance(a, ast.Starred):
                    self._expr(a, fenced, guard)
                else:
                    self._expr(a.value, fenced, guard)
            for kw in node.keywords:
                self._expr(kw.value, fenced, guard)
            return
        self._maybe_protected(node, fenced, store=False)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, fenced, guard)

    def _maybe_protected(self, node, fenced, store):
        tgt = node
        while isinstance(tgt, ast.Subscript):
            tgt = tgt.value
        if isinstance(tgt, ast.Attribute) and tgt.attr in PROTECTED_ATTRS:
            ch = _chain(tgt)
            if ch:
                self.protected.append(ProtectedAccess(
                    tgt.attr, ch[:-1], tgt.lineno, tgt.col_offset + 1,
                    fenced))

    def _call(self, node: ast.Call, fenced, guard):
        ch = _chain(node.func)
        if not ch:
            return
        name = ch[-1]
        if name in RELEASERS:
            self._has_releasers = True
        # -- scheduling / spawning edges --------------------------------
        if name == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    tch = _chain(kw.value)
                    if tch:
                        self.sched.append(SchedEdge(
                            tch, "thread", None, node.lineno,
                            api="Thread"))
        elif name == "run_in_executor" and len(node.args) >= 2:
            tch = _chain(node.args[1])
            if tch:
                self.sched.append(SchedEdge(
                    tch, "executor", None, node.lineno,
                    api="run_in_executor"))
            elif isinstance(node.args[1], ast.Lambda):
                self.sched.append(SchedEdge(
                    (f"<lambda@{node.args[1].lineno}>",), "executor",
                    None, node.lineno, api="run_in_executor"))
        elif name in _LOOP_CB_APIS and len(ch) >= 2:
            idx = _LOOP_CB_APIS[name]
            if len(node.args) > idx:
                tch = _chain(node.args[idx])
                if tch:
                    self.sched.append(SchedEdge(
                        tch, "loop", ch[:-1], node.lineno, api=name))
        elif name == "create_task" and len(ch) >= 2 and node.args:
            inner = node.args[0]
            if isinstance(inner, ast.Call):
                tch = _chain(inner.func)
                if tch:
                    self.sched.append(SchedEdge(
                        tch, "loop", ch[:-1], node.lineno,
                        api="create_task"))
        elif name == "register_timer" and node.args:
            # grain/activation timers: the callback fires as a turn on
            # the silo main loop — a declared entry point at link time
            tch = _chain(node.args[0])
            if tch:
                self.sched.append(SchedEdge(
                    tch, "timer", None, node.lineno,
                    api="register_timer"))
        # -- registry writes --------------------------------------------
        if len(ch) >= 2 and (name in UNTYPED_WRITES or
                             name in TYPED_WRITES):
            recv = ch[:-1]
            recv_is_param = recv[0] if (
                len(recv) == 1 and recv[0] in self.param_set) else None
            self.writes.append(RegistryWrite(
                name, recv, node.lineno, node.col_offset + 1,
                guard, recv_is_param))
        # -- plain call edge --------------------------------------------
        args = tuple(a.id if isinstance(a, ast.Name) else None
                     for a in node.args)
        none_args = frozenset(
            i for i, a in enumerate(node.args)
            if isinstance(a, ast.Constant) and a.value is None)
        kwargs = tuple(
            (kw.arg, (kw.value.value is None
                      if isinstance(kw.value, ast.Constant) else
                      kw.value.id if isinstance(kw.value, ast.Name)
                      else False))
            for kw in node.keywords if kw.arg is not None)
        self.calls.append(CallEdge(
            ch, node.lineno, node.col_offset + 1, args, kwargs,
            len(node.args), fenced, none_args))


def _grain_method(fn) -> GrainMethod:
    a = fn.args
    pos = [p.arg for p in (*a.posonlyargs, *a.args)]
    if pos and pos[0] in ("self", "cls"):
        pos = pos[1:]
    n_def = len(a.defaults)
    min_pos = max(0, len(pos) - n_def)
    max_pos = None if a.vararg else len(pos)
    kwonly = frozenset(p.arg for p in a.kwonlyargs) | frozenset(pos)
    one_way = any(
        dotted_name(d if not isinstance(d, ast.Call) else d.func)
        .rsplit(".", 1)[-1] == "one_way" for d in fn.decorator_list)
    return GrainMethod(fn.name, min_pos, max_pos, kwonly,
                       a.kwarg is not None, one_way)


def _container_kind(val) -> str | None:
    """'list'|'dict'|'set'|'deque' for a container-constructor RHS."""
    if isinstance(val, ast.List):
        return "list"
    if isinstance(val, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(val, (ast.Set, ast.SetComp)):
        return "set"
    if isinstance(val, ast.ListComp):
        return "list"
    if isinstance(val, ast.Call):
        ch = _chain(val.func)
        if ch and ch[-1] in ("list", "dict", "set", "deque",
                             "defaultdict", "OrderedDict", "Counter"):
            return "deque" if ch[-1] == "deque" else (
                "dict" if ch[-1] in ("dict", "defaultdict",
                                     "OrderedDict", "Counter")
                else ch[-1])
    return None


# the constructor parameter that hands an object the loop it runs on:
# stored on ``self`` it is a worker loop, as a ``new_event_loop()`` attr
# is (the main loop is spelled ``main_loop``; a ``consumer_loop`` may be
# either side, so neither is inferred)
_HANDED_LOOP_PARAM = "loop"


def _class_info(node: ast.ClassDef) -> ClassInfo:
    bases = tuple(dotted_name(b).rsplit(".", 1)[-1] for b in node.bases
                  if dotted_name(b))
    info = ClassInfo(node.name, bases=bases,
                     is_thread="Thread" in bases)
    for stmt in node.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                stmt.targets[0].id == "__slots__":
            slots = {e.value for e in ast.walk(stmt.value)
                     if isinstance(e, ast.Constant) and
                     isinstance(e.value, str)}
            if "shm" in slots:
                info.shm_owner = True
        if isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name):
            spec = _ann_spec(stmt.annotation)
            if spec is not None:
                info.attr_specs[stmt.target.id] = spec
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ret = _ann_spec(stmt.returns)
            if ret is not None:
                info.method_returns[stmt.name] = ret
            handed = stmt.name == "__init__" and any(
                a.arg == _HANDED_LOOP_PARAM
                for a in stmt.args.args + stmt.args.kwonlyargs)
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    t = sub.targets[0]
                    tch = _chain(t)
                    if len(tch) == 2 and tch[0] == "self":
                        attr = tch[1]
                        if attr in ("fence", "_fence"):
                            info.fence_owner = True
                        if attr == "shm":
                            info.shm_owner = True
                        val = sub.value
                        ckind = _container_kind(val)
                        if ckind is not None:
                            info.container_attrs.setdefault(attr, ckind)
                        vch = _chain(val if not isinstance(val, ast.Call)
                                     else val.func)
                        if isinstance(val, ast.Call):
                            if vch[-2:] == ("asyncio", "new_event_loop") \
                                    or vch == ("new_event_loop",):
                                info.loop_attrs[attr] = "worker"
                            elif vch and vch[-1] in (
                                    "get_running_loop", "get_event_loop"):
                                info.loop_attrs[attr] = "main"
                        elif handed and isinstance(val, ast.Name) and \
                                val.id == _HANDED_LOOP_PARAM:
                            info.loop_attrs.setdefault(attr, "worker")
                        if attr not in info.attr_specs:
                            spec = _expr_spec(val)
                            if spec is not None:
                                info.attr_specs[attr] = spec
                elif isinstance(sub, ast.AnnAssign):
                    tch = _chain(sub.target)
                    if len(tch) == 2 and tch[0] == "self":
                        spec = _ann_spec(sub.annotation)
                        if spec is not None:
                            info.attr_specs.setdefault(tch[1], spec)
    return info


def _grain_table(node: ast.ClassDef, kind: str) -> GrainTable:
    bases = tuple(dotted_name(b).rsplit(".", 1)[-1] for b in node.bases
                  if dotted_name(b))
    tbl = GrainTable(node.name, kind, bases=bases)
    for stmt in node.body:
        if kind == "host":
            if isinstance(stmt, ast.AsyncFunctionDef) and \
                    not stmt.name.startswith("_") and \
                    stmt.name not in _GRAIN_BASE_EXCLUDE:
                tbl.methods[stmt.name] = _grain_method(stmt)
        else:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for d in stmt.decorator_list:
                    dn = dotted_name(d if not isinstance(d, ast.Call)
                                     else d.func).rsplit(".", 1)[-1]
                    if dn == "actor_method":
                        tbl.methods[stmt.name] = _grain_method(stmt)
    return tbl


_VECTOR_BASES = {"VectorGrain"}


def summarize_module(source: str, rel_path: str,
                     tree: ast.Module | None = None) -> ModuleSummary:
    if tree is None:
        tree = ast.parse(source)
    ms = ModuleSummary(rel_path=rel_path.replace("\\", "/"),
                       module_key=_module_key(rel_path))
    pkg_parts = ms.module_key.split(".")

    for stmt in tree.body:
        if isinstance(stmt, ast.ImportFrom):
            if stmt.level:
                base = pkg_parts[:-stmt.level] if stmt.level <= \
                    len(pkg_parts) else []
                mod = ".".join(base + ([stmt.module] if stmt.module
                                       else []))
            else:
                mod = stmt.module or ""
            for alias in stmt.names:
                ms.imports[alias.asname or alias.name] = (mod, alias.name)
        elif isinstance(stmt, ast.Import):
            for alias in stmt.names:
                ms.imports[alias.asname or alias.name] = (alias.name, "")
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            spec = _expr_spec(stmt.value)
            if spec is not None:
                ms.globals_specs[stmt.targets[0].id] = spec

    fn_nodes: dict = {}

    def visit(node, prefix, cls_name):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                fn_nodes[qn] = child
                ms.functions[qn] = _FuncCollector(child, qn).collect()
                visit(child, qn + ".", cls_name)
                # lambdas handed to executors get synthetic empty
                # summaries so scheduling edges resolve to something
                for sub in ast.walk(child):
                    if isinstance(sub, ast.Lambda):
                        lqn = f"{qn}.<lambda@{sub.lineno}>"
                        body = ast.Expr(sub.body)
                        ast.copy_location(body, sub.body)
                        shim = ast.FunctionDef(
                            name=lqn, args=sub.args, body=[body],
                            decorator_list=[], returns=None,
                            type_comment=None)
                        ast.copy_location(shim, sub)
                        ms.functions[lqn] = _FuncCollector(
                            shim, lqn).collect()
            elif isinstance(child, ast.ClassDef):
                qn = f"{prefix}{child.name}"
                info = _class_info(child)
                ms.classes[child.name] = info
                base_last = {b for b in info.bases}
                if base_last & GRAIN_BASES:
                    ms.grains.setdefault(child.name, []).append(
                        _grain_table(child, "host"))
                elif base_last & _VECTOR_BASES:
                    ms.grains.setdefault(child.name, []).append(
                        _grain_table(child, "vector"))
                visit(child, qn + ".", child.name)

    visit(tree, "", None)
    # ClassName.method = fn monkey-patches widen the interface table:
    # the attached name becomes an open (unknown-arity) method, so the
    # typed checks never flag a dynamically-grafted entry point
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id[:1].isupper():
                    ms.grain_patches.append((t.value.id, t.attr))
    _close_releases(ms, fn_nodes)
    ms.fn_nodes = fn_nodes
    return ms


def resolve_local(ms: ModuleSummary, caller_qual: str,
                  chain: tuple) -> str | None:
    """Module-local callee resolution: bare names search the caller's
    enclosing scopes then the top level; ``self.m`` searches the
    enclosing class (no base-class walk here — that is phase 2)."""
    if len(chain) == 1:
        name = chain[0]
        parts = caller_qual.split(".")
        for i in range(len(parts), 0, -1):
            cand = ".".join(parts[:i]) + "." + name
            if cand in ms.functions:
                return cand
        return name if name in ms.functions else None
    if len(chain) == 2 and chain[0] in ("self", "cls"):
        parts = caller_qual.split(".")
        for i in range(len(parts) - 1, 0, -1):
            if parts[i - 1] in ms.classes:
                cand = ".".join(parts[:i]) + "." + chain[1]
                if cand in ms.functions:
                    return cand
        return None
    return None


def _arg_cell_name(node) -> str | None:
    """Name id or 2-chain attribute pseudo-name for a call argument."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name):
        return f"{node.value.id}.{node.attr}"
    return None


def _callee_summary(ms: ModuleSummary, caller_qual: str, ch: tuple,
                    extern=None):
    """Resolve a call chain to a FunctionSummary. ``extern(chain) ->
    FunctionSummary|None`` extends resolution across modules at
    link/check time and is consulted FIRST when present: the Program
    hook resolves locals too and applies its release overlay, which is
    how an edit to module A re-judges B's edges into A without
    re-summarizing B."""
    if extern is not None:
        summ = extern(ch)
        if summ is not None:
            return summ
    local = resolve_local(ms, caller_qual, ch)
    return ms.functions[local] if local is not None else None


def _param_args(summ, ch: tuple, call: ast.Call,
                indices) -> list:
    """Map callee param indices to caller-side cell names."""
    out = []
    offset = 1 if (summ.params and summ.params[0] in ("self", "cls")
                   and len(ch) >= 2) else 0
    for j in sorted(indices):
        pos = j - offset
        if 0 <= pos < len(call.args):
            nm = _arg_cell_name(call.args[pos])
            if nm is not None:
                out.append(nm)
                continue
        if j < len(summ.params):
            pname = summ.params[j]
            for kw in call.keywords:
                if kw.arg == pname:
                    nm = _arg_cell_name(kw.value)
                    if nm is not None:
                        out.append(nm)
    return out


def _call_releases(ms: ModuleSummary, caller_qual: str, call: ast.Call,
                   extern=None) -> list:
    """Names a Call releases: the direct releasers, plus calls to
    functions whose (current) summary definitely releases a
    parameter."""
    ch = _chain(call.func)
    if not ch:
        return []
    if ch[-1] in RELEASERS and call.args:
        nm = _arg_cell_name(call.args[0])
        return [nm] if nm is not None else []
    summ = _callee_summary(ms, caller_qual, ch, extern)
    if summ is None or not summ.releases:
        return []
    return _param_args(summ, ch, call, summ.releases)


def _call_releases_items(ms: ModuleSummary, caller_qual: str,
                         call: ast.Call, extern=None) -> list:
    """Container names whose ELEMENTS a Call releases (the container
    itself stays live): the batch releasers, plus calls to functions
    with a ``releases_items`` summary."""
    ch = _chain(call.func)
    if not ch:
        return []
    if ch[-1] in ITEM_RELEASERS and call.args:
        nm = _arg_cell_name(call.args[0])
        return [nm] if nm is not None else []
    summ = _callee_summary(ms, caller_qual, ch, extern)
    if summ is None or not summ.releases_items:
        return []
    return _param_args(summ, ch, call, summ.releases_items)


def _call_alias(ms: ModuleSummary, caller_qual: str, call: ast.Call,
                extern=None) -> str | None:
    """The argument Name a call's RESULT aliases (callee returns one of
    its parameters), or None."""
    ch = _chain(call.func)
    if not ch:
        return None
    summ = _callee_summary(ms, caller_qual, ch, extern)
    if summ is None or summ.returns_param is None:
        return None
    offset = 1 if (summ.params and summ.params[0] in ("self", "cls")
                   and len(ch) >= 2) else 0
    pos = summ.returns_param - offset
    if 0 <= pos < len(call.args):
        return _arg_cell_name(call.args[pos])
    return None


def _for_loop_item_releases(ms: ModuleSummary, qual: str, fn,
                            extern=None) -> frozenset:
    """Param indices whose ELEMENTS the function definitely releases via
    the ``for m in batch: recycle_message(m)`` idiom (direct body
    statements only — a conditional release is not definite for the
    stash the caller tracked)."""
    params = _FuncCollector._pos_params(fn)
    out: set[int] = set()
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
        if not isinstance(node, ast.For) or \
                not isinstance(node.target, ast.Name):
            continue
        it = node.iter
        base = None
        if isinstance(it, ast.Name):
            base = it.id
        elif isinstance(it, ast.Call) and \
                isinstance(it.func, ast.Attribute) and \
                it.func.attr in ("values",) and \
                isinstance(it.func.value, ast.Name):
            base = it.func.value.id
        if base not in params:
            continue
        t = node.target.id
        for stmt in node.body:
            if isinstance(stmt, (ast.If, ast.For, ast.While, ast.Try,
                                 ast.With)):
                continue
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) and t in _call_releases(
                        ms, qual, sub, extern):
                    out.add(params.index(base))
    return frozenset(out)


def _summarize_releases(ms: ModuleSummary, qual: str, fn,
                        extern=None) -> tuple:
    """(releases, returns_param, escapes, releases_items) for one
    function via the dataflow walker, consulting the module's current
    summaries (plus ``extern`` at link time) for callee release
    behavior."""
    params = _FuncCollector._pos_params(fn)
    walker = ReleaseWalker(
        params,
        release_of_call=lambda c: _call_releases(ms, qual, c, extern),
        alias_of_call=lambda c: _call_alias(ms, qual, c, extern),
        items_release_of_call=lambda c: _call_releases_items(
            ms, qual, c, extern))
    walker.run(fn.body)
    items = frozenset(walker.items_released) | \
        _for_loop_item_releases(ms, qual, fn, extern)
    return (walker.definite_releases(), walker.returned_param(),
            frozenset(walker.escaped), items)


def _close_releases(ms: ModuleSummary, fn_nodes: dict) -> None:
    """Module-local transitive release closure: seed with functions that
    call a releaser directly, then re-walk callers of releasing
    functions until the summaries stop changing (bounded — chains in
    practice are 2-3 deep). Cross-module closure happens at link time
    via the Program's release overlay."""
    releasing_names: set[str] = set()
    for qual, s in ms.functions.items():
        if not s.has_releasers and not any(
                e.chain[-1] in ITEM_RELEASERS for e in s.calls):
            continue
        rel, ret, esc, items = _summarize_releases(
            ms, qual, fn_nodes[qual])
        s.releases, s.returns_param, s.escapes = rel, ret, esc
        s.releases_items = items
        if rel or items:
            releasing_names.add(qual.rsplit(".", 1)[-1])
    if not releasing_names:
        return
    for _ in range(4):
        changed = False
        for qual, s in ms.functions.items():
            if qual not in fn_nodes:
                continue
            calls_releasing = any(
                e.chain[-1] in releasing_names or
                e.chain[-1] in RELEASERS or
                e.chain[-1] in ITEM_RELEASERS for e in s.calls)
            if not calls_releasing:
                continue
            rel, ret, esc, items = _summarize_releases(
                ms, qual, fn_nodes[qual])
            if rel != s.releases or ret != s.returns_param or \
                    items != s.releases_items:
                changed = True
                s.releases, s.returns_param, s.escapes = rel, ret, esc
                s.releases_items = items
                if rel or items:
                    releasing_names.add(qual.rsplit(".", 1)[-1])
        if not changed:
            break


# phase-1 cache: content hash → ModuleSummary (summaries are pure
# functions of the source text; phase 2 never mutates them)
_CACHE: dict = {}
_CACHE_CAP = 4096
# monotonic counters for --stats; callers snapshot-and-diff around a run
CACHE_STATS = {"hits": 0, "misses": 0}


def module_summary(source: str, rel_path: str,
                   tree: ast.Module | None = None) -> ModuleSummary:
    key = (hashlib.sha1(source.encode("utf-8", "replace")).hexdigest(),
           rel_path)
    hit = _CACHE.get(key)
    if hit is not None:
        CACHE_STATS["hits"] += 1
        return hit
    CACHE_STATS["misses"] += 1
    ms = summarize_module(source, rel_path, tree)
    if len(_CACHE) >= _CACHE_CAP:
        _CACHE.clear()
    _CACHE[key] = ms
    return ms


# ---------------------------------------------------------------------------
# Phase 2: link ModuleSummaries into a Program
# ---------------------------------------------------------------------------

class Program:
    """The linked view rules query: cross-module call resolution, the
    worker-context set (with reasons), the fence-held fixpoint, resolved
    receiver types, and merged grain interface tables. Built fresh per
    analysis run from cached per-module summaries — linking is cheap,
    summarizing is not."""

    def __init__(self, modules: list[ModuleSummary]):
        self.modules: dict[str, ModuleSummary] = {
            m.module_key: m for m in modules}
        self.by_rel: dict[str, ModuleSummary] = {
            m.rel_path: m for m in modules}
        # dotted-suffix index: an import records the module string as
        # WRITTEN ('from ring_helper import free'), but module keys are
        # derived from scan-root-relative paths, so a sibling import
        # carries no directory prefix. A unique dotted suffix resolves;
        # an ambiguous one stays unresolved (None tombstone).
        self._suffix_index: dict[str, str | None] = {}
        for key in self.modules:
            parts = key.split(".")
            for i in range(len(parts)):
                suf = ".".join(parts[i:])
                if suf in self._suffix_index and \
                        self._suffix_index[suf] != key:
                    self._suffix_index[suf] = None
                else:
                    self._suffix_index[suf] = key
        # class name → (module, ClassInfo); first definition wins, which
        # is fine for THIS tree (no duplicate class names across layers)
        self.class_index: dict[str, tuple] = {}
        for m in modules:
            for name, info in m.classes.items():
                self.class_index.setdefault(name, (m, info))
        self.grains: dict[str, GrainTable] = {}
        self._merge_grains(modules)
        # (module_key, qualname) → summary
        self.functions: dict[tuple, FunctionSummary] = {}
        for m in modules:
            for q, s in m.functions.items():
                self.functions[(m.module_key, q)] = s
        self._call_sites: dict[tuple, list] = {}
        self._index_call_sites()
        # declared entry-point contexts (ctl_* handlers, timer and
        # loop-scheduled callbacks, ring drains): key → label
        self.entry_contexts: dict[tuple, str] = {}
        self._collect_entry_contexts()
        self.worker: dict[tuple, str] = {}
        self.worker_seeds: set = set()
        self._worker_fixpoint()
        self._worker_kind: dict[tuple, str] = {}
        self._classify_worker_contexts()
        self.held: dict[tuple, bool] = {}
        self._fence_fixpoint()
        # link-time cross-module release closure (phase 2 NEVER mutates
        # the cached summaries — re-judged facts live here)
        self._rel_overlay: dict[tuple, tuple] = {}
        self._release_overlay()

    # -- grain tables ----------------------------------------------------
    def _merge_grains(self, modules):
        raw: dict[str, list] = {}
        for m in modules:
            for name, tables in m.grains.items():
                raw.setdefault(name, []).extend(tables)
        for name, tables in raw.items():
            if len(tables) == 1:
                merged = GrainTable(name, tables[0].kind,
                                    tables[0].bases,
                                    dict(tables[0].methods))
            else:
                # same-name grain classes in different modules: union the
                # methods and widen arity — never a false positive from a
                # name collision
                merged = GrainTable(name, tables[0].kind, tables[0].bases)
                for t in tables:
                    for mn, gm in t.methods.items():
                        prev = merged.methods.get(mn)
                        if prev is None:
                            merged.methods[mn] = gm
                        else:
                            merged.methods[mn] = GrainMethod(
                                mn, min(prev.min_pos, gm.min_pos),
                                None if (prev.max_pos is None or
                                         gm.max_pos is None)
                                else max(prev.max_pos, gm.max_pos),
                                prev.kwonly | gm.kwonly,
                                prev.has_kwargs or gm.has_kwargs,
                                prev.one_way and gm.one_way)
            self.grains[name] = merged
        # monkey-patched methods (Class.attr = fn anywhere in the tree)
        # join as open unknown-arity entries BEFORE inheritance, so
        # subclasses see them too
        for m in modules:
            for cls, attr in m.grain_patches:
                tbl = self.grains.get(cls)
                if tbl is not None and not attr.startswith("_") and \
                        attr not in tbl.methods:
                    tbl.methods[attr] = GrainMethod(
                        attr, 0, None, frozenset(), True, False)
        # single-level-at-a-time base inheritance, to fixpoint
        for _ in range(4):
            changed = False
            for tbl in self.grains.values():
                for b in tbl.bases:
                    base = self.grains.get(b)
                    if base is None or base.kind != tbl.kind:
                        continue
                    for mn, gm in base.methods.items():
                        if mn not in tbl.methods:
                            tbl.methods[mn] = gm
                            changed = True
            if not changed:
                break

    # -- resolution ------------------------------------------------------
    def module_named(self, mod: str) -> ModuleSummary | None:
        """Module summary for an import-recorded module string: exact
        key first, else the unique dotted-suffix match."""
        hit = self.modules.get(mod)
        if hit is not None:
            return hit
        key = self._suffix_index.get(mod)
        return self.modules[key] if key is not None else None

    def enclosing_class(self, ms: ModuleSummary, qual: str) -> str | None:
        parts = qual.split(".")
        for p in parts[:-1]:
            if p in ms.classes:
                return p
        return None

    def resolve_call(self, ms: ModuleSummary, caller_qual: str,
                     chain: tuple) -> tuple | None:
        """CallEdge chain → (module_key, qualname) or None."""
        if not chain:
            return None
        local = resolve_local(ms, caller_qual, chain)
        if local is not None:
            return (ms.module_key, local)
        if len(chain) == 1:
            imp = ms.imports.get(chain[0])
            if imp is not None:
                mod, orig = imp
                target = self.module_named(mod)
                if target is not None and (orig or chain[0]) in \
                        target.functions:
                    return (target.module_key, orig or chain[0])
            return None
        if chain[0] in ("self", "cls") and len(chain) == 2:
            # unresolved locally: walk base classes by name
            cls = self.enclosing_class(ms, caller_qual)
            return self._method_on(cls, chain[1], seen=set()) \
                if cls else None
        # module-alias call: mod.func(...)
        if len(chain) == 2:
            imp = ms.imports.get(chain[0])
            if imp is not None and imp[1] == "":
                target = self.module_named(imp[0])
                if target is not None and chain[1] in target.functions:
                    return (target.module_key, chain[1])
        # typed receiver: resolve the receiver chain's class, then the
        # method on it (or its bases)
        recv = self.receiver_class(ms, caller_qual, chain[:-1])
        if recv is not None:
            return self._method_on(recv, chain[-1], seen=set())
        return None

    def _method_on(self, cls_name: str, meth: str,
                   seen: set) -> tuple | None:
        if cls_name in seen or len(seen) > 8:
            return None
        seen.add(cls_name)
        hit = self.class_index.get(cls_name)
        if hit is None:
            return None
        m, info = hit
        qual = f"{cls_name}.{meth}"
        if qual in m.functions:
            return (m.module_key, qual)
        for b in info.bases:
            found = self._method_on(b, meth, seen)
            if found is not None:
                return found
        return None

    def release_summary(self, key) -> FunctionSummary | None:
        """A function's summary with the link-time release overlay
        applied (the cached summary itself is never touched)."""
        s = self.functions.get(key)
        if s is None:
            return None
        ov = self._rel_overlay.get(key)
        if ov is None:
            return s
        return replace(s, releases=ov[0], returns_param=ov[1],
                       releases_items=ov[2])

    def extern_summary(self, ms: ModuleSummary, caller_qual: str):
        """Cross-module callee-summary lookup hook for the release
        walker (same signature as ``_call_releases``'s ``extern``).
        Resolves locals too and applies the release overlay, so
        check-time walks always see the freshest cross-module facts."""
        def look(chain):
            key = self.resolve_call(ms, caller_qual, chain)
            return self.release_summary(key) if key is not None else None
        return look

    def _release_overlay(self):
        """Cross-module transitive release closure: re-walk callers of
        releasing functions against the PROGRAM's resolution (overlay-
        aware), recording changed facts in ``_rel_overlay``. This is
        what closes the summary-cache staleness hole: the overlay is
        rebuilt from the current summaries on every link, so editing
        module A re-judges B's call edges into A while B's cached
        summary stays untouched."""
        work = {k for k in self.functions
                if self.functions[k].releases or
                self.functions[k].releases_items}
        for _ in range(6):
            if not work:
                break
            cands: set = set()
            for k in work:
                changed_callee = k in self._rel_overlay
                for gkey, _e in self._call_sites.get(k, []):
                    # same-module callers already saw the raw summary in
                    # the phase-1 closure; re-judge them only when the
                    # callee's facts CHANGED at link time
                    if changed_callee or gkey[0] != k[0]:
                        cands.add(gkey)
            work = set()
            for gkey in sorted(cands):
                mod, qual = gkey
                m = self.modules[mod]
                fn = m.fn_nodes.get(qual)
                if fn is None:
                    continue
                look = self.extern_summary(m, qual)
                rel, ret, _esc, items = _summarize_releases(
                    m, qual, fn, extern=look)
                cur = self.release_summary(gkey)
                if (rel, ret, items) != (cur.releases,
                                         cur.returns_param,
                                         cur.releases_items):
                    self._rel_overlay[gkey] = (rel, ret, items)
                    work.add(gkey)

    # -- type specs ------------------------------------------------------
    def resolve_spec(self, ms: ModuleSummary, fn: FunctionSummary | None,
                     spec, depth: int = 0):
        """spec → normal form ("cls", name) | ("dict", spec) | None."""
        if spec is None or depth > 10:
            return None
        tag = spec[0]
        if tag == "cls":
            return spec
        if tag == "dict":
            return spec
        if tag != "expr":
            return None
        _, base, steps = spec
        cur = None
        if base[0] == "self":
            cls = self.enclosing_class(ms, fn.qualname) if fn else None
            cur = ("cls", cls) if cls else None
        elif base[0] == "var":
            name = base[1]
            if fn is not None and name in fn.var_specs:
                sub = fn.var_specs[name]
                if sub != spec:  # self-reference guard
                    cur = self.resolve_spec(ms, fn, sub, depth + 1)
            if cur is None and name in ms.globals_specs:
                cur = self.resolve_spec(ms, None,
                                        ms.globals_specs[name], depth + 1)
            if cur is None and name in ms.imports:
                mod, orig = ms.imports[name]
                if orig and (orig in self.class_index):
                    cur = ("cls", orig)
                elif orig == "":
                    cur = ("mod", mod)
            if cur is None and name in ms.classes:
                cur = ("cls", name)
        elif base[0] == "spec":
            cur = self.resolve_spec(ms, fn, base[1], depth + 1)
        for step in steps:
            if cur is None:
                return None
            cur = self._apply_step(cur, step, depth)
        return cur

    def _apply_step(self, cur, step, depth):
        kind = step[0]
        if cur[0] == "mod" and kind == "attr":
            target = self.module_named(cur[1])
            if target is None:
                return None
            if step[1] in target.classes:
                return ("cls", step[1])
            sub = target.globals_specs.get(step[1])
            return self.resolve_spec(target, None, sub, depth + 1) \
                if sub is not None else None
        if kind == "attr":
            if cur[0] != "cls":
                return None
            hit = self.class_index.get(cur[1])
            if hit is None:
                return None
            m, info = hit
            sub = info.attr_specs.get(step[1])
            if sub is None:
                return None
            # class-level specs resolve in the CLASS's module, with
            # "self" meaning that class
            fake = FunctionSummary(f"{cur[1]}.__attr__", 0)
            return self.resolve_spec(m, fake, sub, depth + 1)
        if kind in ("sub", "dictval"):
            return cur[1] if cur[0] == "dict" else None
        if kind == "call":
            if cur[0] != "cls":
                return None
            hit = self.class_index.get(cur[1])
            if hit is None:
                return None
            m, info = hit
            ret = info.method_returns.get(step[1])
            if ret is None:
                return None
            fake = FunctionSummary(f"{cur[1]}.__ret__", 0)
            return self.resolve_spec(m, fake, ret, depth + 1)
        return None

    def receiver_class(self, ms: ModuleSummary, caller_qual: str,
                       recv_chain: tuple) -> str | None:
        """('self','ring') → 'SpscRing'-style receiver typing."""
        if not recv_chain:
            return None
        fn = ms.functions.get(caller_qual)
        if recv_chain[0] == "self":
            spec = ("expr", ("self",), tuple(
                ("attr", a) for a in recv_chain[1:]))
        else:
            spec = ("expr", ("var", recv_chain[0]), tuple(
                ("attr", a) for a in recv_chain[1:]))
        out = self.resolve_spec(ms, fn, spec)
        return out[1] if out is not None and out[0] == "cls" else None

    # -- worker-context fixpoint ----------------------------------------
    def loop_kind(self, ms: ModuleSummary, caller_qual: str,
                  loop_chain: tuple) -> str | None:
        """'worker' | 'main' | None for the receiver of a loop-callback
        registration."""
        if not loop_chain:
            return None
        fn = ms.functions.get(caller_qual)
        # direct: self.<attr> where the enclosing class assigned the
        # attr from new_event_loop()/get_running_loop()
        if loop_chain[0] in ("self", "cls") and len(loop_chain) == 2:
            cls = self.enclosing_class(ms, caller_qual)
            if cls:
                hit = self.class_index.get(cls)
                if hit is not None:
                    kind = hit[1].loop_attrs.get(loop_chain[1])
                    if kind is not None:
                        return kind
        # one alias hop: a local whose spec is a chain ending in a
        # loop-kind attr (loop = self.loop; pool.main_loop; ...)
        if fn is not None and len(loop_chain) == 1:
            spec = fn.var_specs.get(loop_chain[0])
            if spec is not None and spec[0] == "expr" and spec[2] and \
                    spec[2][-1][0] == "attr":
                attr = spec[2][-1][1]
                owner = self.resolve_spec(
                    ms, fn, ("expr", spec[1], spec[2][:-1]))
                if owner is not None and owner[0] == "cls":
                    hit = self.class_index.get(owner[1])
                    if hit is not None:
                        return hit[1].loop_attrs.get(attr)
                if spec[1][0] == "self" and len(spec[2]) == 1:
                    cls = self.enclosing_class(ms, caller_qual)
                    hit = self.class_index.get(cls) if cls else None
                    if hit is not None:
                        return hit[1].loop_attrs.get(attr)
        if len(loop_chain) == 2:
            owner = self.receiver_class(ms, caller_qual, loop_chain[:1])
            if owner is not None:
                hit = self.class_index.get(owner)
                if hit is not None:
                    return hit[1].loop_attrs.get(loop_chain[1])
        return None

    def _worker_fixpoint(self):
        work: list = []

        def mark(key, reason):
            if key is not None and key in self.functions and \
                    key not in self.worker:
                self.worker[key] = reason
                work.append(key)

        for m in self.modules.values():
            for name, info in m.classes.items():
                if info.is_thread:
                    mark((m.module_key, f"{name}.run"),
                         "Thread-subclass run()")
            for q, s in m.functions.items():
                for e in s.sched:
                    if e.kind == "thread":
                        mark(self.resolve_call(m, q, e.target),
                             "threading.Thread target")
                    elif e.kind == "executor":
                        mark(self.resolve_call(m, q, e.target),
                             "run_in_executor callable")
                    elif e.kind == "loop":
                        # affinity follows the LOOP's kind, not the
                        # scheduling caller's: the main loop handing a
                        # callback to a shard loop makes it worker code
                        if self.loop_kind(m, q, e.loop or ()) == \
                                "worker":
                            mark(self.resolve_call(m, q, e.target),
                                 "scheduled onto a shard/worker loop "
                                 f"in '{q.rsplit('.', 1)[-1]}'")
        self.worker_seeds = set(self.worker)
        while work:
            key = work.pop()
            mod, qual = key
            m = self.modules[mod]
            s = self.functions[key]
            short = qual.rsplit(".", 1)[-1]
            for e in s.calls:
                # a callable HANDED to a scheduler is not called here —
                # scheduling edges decide its affinity below
                if e.chain[-1] in _LOOP_CB_APIS or e.chain[-1] in (
                        "Thread", "run_in_executor", "create_task"):
                    continue
                mark(self.resolve_call(m, qual, e.chain),
                     f"called from worker context '{short}'")
            # sched edges need no re-scan here: thread/executor targets
            # and worker-loop callbacks were all seeded globally above
            # (loop affinity is a property of the loop, not the caller)

    # -- entry-point registry (link-time) --------------------------------
    def _collect_entry_contexts(self):
        """Consult the declared entry-point registry: naming
        conventions (``ctl_*``, ``receive_reminder``) plus the targets
        of loop/timer scheduling edges whose loop is NOT worker-kind
        (worker-loop callbacks belong to the worker fixpoint)."""
        for key in self.functions:
            label = entry_label_for_name(key[1])
            if label is not None:
                self.entry_contexts[key] = label
        for m in self.modules.values():
            for q, s in m.functions.items():
                for e in s.sched:
                    if e.kind not in ("loop", "timer"):
                        continue
                    if e.kind == "loop" and \
                            self.loop_kind(m, q, e.loop or ()) == \
                            "worker":
                        continue
                    target = self.resolve_call(m, q, e.target)
                    if target is None:
                        continue
                    label = entry_label_for_sched(e.api, q)
                    if label is not None:
                        self.entry_contexts.setdefault(target, label)

    # -- per-call-edge context classification (k=1) ----------------------
    def worker_context(self, key) -> str | None:
        """None (not worker-reachable) | "seed" (a thread target /
        executor callable / worker-loop callback itself) | "only"
        (every call edge comes from worker context) | "mixed" (also
        reached from main-loop context or a declared entry point —
        judged per call edge, not at the definition)."""
        return self._worker_kind.get(key)

    def _classify_worker_contexts(self):
        for key in self.worker:
            if key in self.worker_seeds:
                self._worker_kind[key] = "seed"
                continue
            mixed = key in self.entry_contexts
            if not mixed:
                for gkey, _e in self._call_sites.get(key, []):
                    if gkey not in self.worker:
                        mixed = True
                        break
            self._worker_kind[key] = "mixed" if mixed else "only"

    # -- fence fixpoint --------------------------------------------------
    def fence_owner_class(self, name: str | None) -> bool:
        if name is None:
            return False
        hit = self.class_index.get(name)
        return hit is not None and hit[1].fence_owner

    def protected_accesses(self, ms: ModuleSummary,
                           s: FunctionSummary) -> list:
        """The subset of a function's recorded protected-attr accesses
        whose receiver actually resolves to a fence-owning class."""
        if not s.protected:
            return []
        if s.qualname.rsplit(".", 1)[-1] == "__init__":
            return []  # construction: single-threaded by definition
        out = []
        for p in s.protected:
            if p.recv == ("self",):
                cls = self.enclosing_class(ms, s.qualname)
                if self.fence_owner_class(cls):
                    out.append(p)
                continue
            cls = self.receiver_class(ms, s.qualname, p.recv)
            if self.fence_owner_class(cls):
                out.append(p)
        return out

    def _index_call_sites(self):
        for m in self.modules.values():
            for q, s in m.functions.items():
                for e in s.calls:
                    key = self.resolve_call(m, q, e.chain)
                    if key is not None:
                        self._call_sites.setdefault(key, []).append(
                            ((m.module_key, q), e))

    def call_sites(self, key) -> list:
        return self._call_sites.get(key, [])

    def _sccs(self) -> dict:
        """Condense the call graph (caller → callee) into strongly
        connected components; returns key → scc id. Iterative Tarjan —
        deep call chains must not hit the recursion limit."""
        adj: dict[tuple, list] = {k: [] for k in self.functions}
        for callee, sites in self._call_sites.items():
            for gkey, _e in sites:
                if gkey in adj:
                    adj[gkey].append(callee)
        index: dict[tuple, int] = {}
        low: dict[tuple, int] = {}
        on_stack: set = set()
        stack: list = []
        scc_of: dict[tuple, int] = {}
        counter = itertools.count()
        scc_counter = itertools.count()
        for root in adj:
            if root in index:
                continue
            work = [(root, 0)]
            while work:
                node, ci = work[-1]
                if ci == 0:
                    index[node] = low[node] = next(counter)
                    stack.append(node)
                    on_stack.add(node)
                recurse = False
                children = adj[node]
                while ci < len(children):
                    ch = children[ci]
                    ci += 1
                    if ch not in index:
                        work[-1] = (node, ci)
                        work.append((ch, 0))
                        recurse = True
                        break
                    if ch in on_stack:
                        low[node] = min(low[node], index[ch])
                if recurse:
                    continue
                work[-1] = (node, ci)
                if ci >= len(children):
                    work.pop()
                    if low[node] == index[node]:
                        sid = next(scc_counter)
                        while True:
                            w = stack.pop()
                            on_stack.discard(w)
                            scc_of[w] = sid
                            if w == node:
                                break
                    if work:
                        parent = work[-1][0]
                        low[parent] = min(low[parent], low[node])
        return scc_of

    def _fence_fixpoint(self):
        """held(F): every call site ENTERING F's call-graph cycle is
        lexically fenced or in a held caller. Roots (no known external
        call sites) are NOT held — an unfenced protected access there
        is a finding.

        Computed over the SCC condensation with LEAST-fixpoint
        promotion: within-cycle edges are ignored (a recursive helper's
        back edge inherits whatever its entry established), but a cycle
        cannot vouch for ITSELF — the optimistic per-function form let
        two unfenced mutually-recursive callers hide the exact bug
        class the rule gates, while a naive pessimistic form could
        never promote a fence-rooted recursive walk."""
        scc_of = self._sccs()
        entering: dict[int, list] = {}
        members: dict[int, int] = {}
        for key in self.functions:
            sid = scc_of[key]
            members[sid] = members.get(sid, 0) + 1
            entering.setdefault(sid, [])
        for callee, sites in self._call_sites.items():
            sid = scc_of.get(callee)
            if sid is None:
                continue
            for gkey, e in sites:
                if scc_of.get(gkey) != sid:
                    entering[sid].append((gkey, e))
        # a declared entry point is entered UNFENCED by the runtime
        # regardless of its visible call sites — its SCC can never be
        # promoted (the registry edge is a permanent unfenced entry)
        entry_sccs = {scc_of[k] for k in self.entry_contexts
                      if k in scc_of}
        held_scc: dict[int, bool] = {sid: False for sid in entering}
        changed = True
        guard = 0
        while changed and guard < 50:
            changed = False
            guard += 1
            for sid, edges in entering.items():
                if held_scc[sid] or not edges or sid in entry_sccs:
                    continue
                if all(e.fenced or held_scc.get(scc_of.get(gkey), False)
                       for gkey, e in edges):
                    held_scc[sid] = True
                    changed = True
        for key in self.functions:
            self.held[key] = held_scc.get(scc_of[key], False)

    def unfenced_witness(self, key) -> str | None:
        """A human-readable example of why a function is not fence-held
        (a declared entry context, one unfenced call site, or 'no call
        sites')."""
        label = self.entry_contexts.get(key)
        if label is not None:
            return f"entry point: {label}"
        sites = self._call_sites.get(key, [])
        if not sites:
            return "no fenced call path (entry point)"
        for gkey, e in sites:
            if not e.fenced and not self.held.get(gkey, False):
                return f"called unfenced from {gkey[1]} " \
                       f"({gkey[0].rsplit('.', 1)[-1]}.py:{e.lineno})"
        return None


def build_program(sources: "list[tuple[str, str, ast.Module | None]]"
                  ) -> Program:
    """[(source, rel_path, tree-or-None)] → linked Program. Files that
    do not parse contribute nothing (the engine reports them as
    OTPU000)."""
    mods = []
    for source, rel_path, tree in sources:
        try:
            mods.append(module_summary(source, rel_path, tree))
        except SyntaxError:
            continue
    return Program(mods)
