"""Profiling: the host-loop occupancy profiler + flight recorder, and the
torch.profiler device-trace wrappers.

Two lenses live here:

**Device lens** (the original thin wrapper): ``Profiler.start/stop``
captures a ``torch.profiler`` trace (a Chrome/Perfetto timeline),
``annotate`` / ``@traced`` bridge host sections onto it
(``torch.profiler.record_function``), ``StepTimer`` counts slow ticks.

**Host-loop lens** (the continuous occupancy profiler): the silo's wall
time is one event loop, and at closed-loop saturation the residual
queue-wait is loop *contention* — host turns, the device tick's
sync-materialize, the socket pump, and our own observability machinery
all time-share it. :class:`LoopProfiler` measures where that loop time
actually goes, continuously and cheaply enough to leave on:

* **Interposition** (py3.10-safe — no eager task factory, no loop
  subclass needed on a running loop): :func:`install_loop_profiler`
  shadows the loop instance's ``call_soon`` / ``call_at`` /
  ``call_soon_threadsafe`` with wrappers that time every callback the
  loop runs. ``call_later`` funnels through the patched ``call_at``;
  gaps between callbacks accrue to ``idle`` — so occupancy shares sum to
  ~1.0 of wall time by construction. Uninstall deletes the instance
  attributes, restoring the class methods (refcounted per loop: the last
  silo to stop removes the hooks; co-hosted silos share one profiler
  because occupancy is a property of the LOOP, not the silo).
* **Attribution**: each callback defaults to the category riding the
  :data:`LOOP_CATEGORY` contextvar (task steps run in the task's context,
  so one ``enter``/``mark_loop_category`` at the top of a turn/pump task
  labels every later step of that task); instrumented sites segment
  finer with :meth:`LoopProfiler.set_category` (the engine splits one
  tick callback into schedule/staging/transfer/sync slices).
* **Flight recorder**: per-window occupancy slices plus the top-K
  slowest callbacks (category + grain class/method label when the turn
  declared one) land in a bounded ring; :meth:`LoopProfiler.trigger`
  snapshots the ring on anomalies — load-shed, watchdog lag,
  queue-wait-trend breach, tail-retained traces — rate-limited per
  reason, into a bounded snapshot deque the management surface serves.

Disabled (``SiloConfig.profiling_enabled=False``, the default) nothing is
installed: the loop keeps its class methods, hot paths pay one ``None``
check per site, and the off path is structurally zero-overhead.

The port's copy of ``orleans_tpu.observability.profiling``, with
``jax.profiler`` replaced by ``torch.profiler`` (``TraceAnnotation`` →
``record_function``; ``start_trace``/``stop_trace`` → a
``torch.profiler.profile`` that writes ``trace.json`` into the log
directory). Its native ``hotloop`` runner is the port's own build of the
same C source (``orleans_tpu_torch.native``).
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import functools
import inspect
import logging
import os
import sys
import time
import weakref
from collections import deque
from typing import TYPE_CHECKING, Iterator

import torch

if TYPE_CHECKING:
    from .stats import StatsRegistry

log = logging.getLogger("orleans.profiling")

# native per-callback runner (native/hotloop.c): the same accounting as
# LoopProfiler._run_cb compiled to C (~0.2us vs ~1.3us per callback).
# None when the toolchain is unavailable or ORLEANS_TPU_NATIVE=0 — the
# pure-Python path below is the behavioural reference and the fallback.
# Linux-only: the C side stamps CLOCK_MONOTONIC, which shares a base
# with time.perf_counter ONLY on Linux — on e.g. macOS the two clocks
# diverge by cumulative system-sleep time, and the Python slow paths
# (flush/finalize/profile) compare perf_counter against C-written marks.
try:
    if sys.platform.startswith("linux"):
        from ..native import load as _load_native
        _hotloop = _load_native("_hotloop")
    else:
        _hotloop = None
except Exception:  # noqa: BLE001 — native must never break import
    _hotloop = None

__all__ = ["Profiler", "annotate", "traced", "StepTimer",
           "LoopProfiler", "LOOP_CATEGORIES", "LOOP_CATEGORY",
           "install_loop_profiler", "uninstall_loop_profiler",
           "loop_profiler", "mark_loop_category"]


# ---------------------------------------------------------------------------
# Host-loop occupancy profiler
# ---------------------------------------------------------------------------

# the named occupancy buckets loop time is attributed into. "tick_sync" is
# the distinct device-sync category — host materialize/block_until_ready,
# where asynchronously-dispatched device execution is actually paid — the
# slice the "move the tick's device sync off-loop" lever would reclaim.
LOOP_CATEGORIES = (
    "turns",          # host grain turns (dispatcher._run_turn)
    "timers",         # __timer__ tick turns + timer machinery
    "tick_schedule",  # engine tick dispatch: claiming, conflict defer,
                      # future resolution
    "tick_staging",   # pending invocations -> host staging arrays
    "tick_transfer",  # host arrays -> device operands + kernel dispatch
    "tick_sync",      # host materialize: where device execution is paid
    "pump",           # socket pump + wire decode + batched routing
    "egress",         # outbound wire: response/request encode + sender
                      # writes (per-endpoint sender tasks, gateway
                      # client-route batch writes) — the slice sharded
                      # egress (SiloConfig.egress_shards) moves onto
                      # shard loops; its main-loop share is the
                      # sharded-egress A/B signal
    "client",         # client-side gateway machinery sharing the loop
                      # (GatewayClient pumps/senders/reconnector) — split
                      # out of "other" so harness cost is separately
                      # attributable from silo cost in loop_attribution
    "storage",        # storage & journal provider IO awaited on-loop
    "observability",  # sampler/tracer/exporter internals
    "other",          # unattributed callbacks
    "idle",           # the loop waiting in select()
)

# Ambient default category for the CURRENT task/callback. Task steps run
# in the task's own context, so setting this once at the top of a task
# (dispatcher turn, socket pump, sampler loop) labels every later step of
# that task without per-step work; the interposition wrapper reads it at
# each callback start.
LOOP_CATEGORY: contextvars.ContextVar[str] = contextvars.ContextVar(
    "orleans_loop_category", default="other")

# 3.12+ eager task factories: ``asyncio.tasks._eager_tasks`` is the
# interpreter's registry of tasks CURRENTLY executing their first step
# eagerly (occupied for exactly that stretch). ``enter()`` consults it
# to guard the live-slice switch (see its docstring). On interpreters
# without eager factories (py3.10/3.11) this is None and the guard is a
# single constant test — the reference environment's behavior is
# unchanged.
_EAGER_TASKS = getattr(getattr(asyncio, "tasks", None), "_eager_tasks", None)


def mark_loop_category(category: str) -> None:
    """Tag the current task so its future steps default to ``category``
    (no-op cost when no profiler is installed — it only sets a
    contextvar the wrapper would read)."""
    LOOP_CATEGORY.set(category)


def _describe_callback(cb) -> str:
    """Best-effort label for an unlabeled slow callback. Task steps name
    their coroutine; everything else falls back to the qualname."""
    owner = getattr(cb, "__self__", None)
    if owner is not None:
        get_coro = getattr(owner, "get_coro", None)
        if get_coro is not None:
            try:
                coro = get_coro()
                return getattr(coro, "__qualname__", None) or repr(coro)
            except Exception:  # noqa: BLE001 — labels are best-effort
                pass
    return getattr(cb, "__qualname__", None) or type(cb).__name__


class LoopProfiler:
    """Continuous occupancy accounting for ONE event loop.

    Single-threaded by construction (every mutation happens on the loop);
    the only cross-thread entry is the ``call_soon_threadsafe`` wrapper,
    which merely wraps the callback — timing runs loop-side.

    ``window`` seconds of attribution roll into one slice dict appended
    to ``ring`` (the flight-recorder substrate); ``snapshots`` holds
    anomaly-triggered copies of the ring. ``totals`` accumulates per
    category since install — the benchmark/management read."""

    __slots__ = ("window", "top_k", "trigger_interval", "ring",
                 "snapshots", "trigger_counts", "trigger_hooks", "totals",
                 "last_shares", "closed", "started", "_win_start",
                 "_win_cats", "_win_top", "_top_min", "_last_end",
                 "_depth", "_mark", "_cur", "_cb_label",
                 "_last_trigger")

    def __init__(self, window: float = 1.0, ring: int = 120,
                 top_k: int = 8, trigger_interval: float = 1.0,
                 max_snapshots: int = 8):
        self.window = window
        self.top_k = top_k
        self.trigger_interval = trigger_interval
        self.ring: deque[dict] = deque(maxlen=ring)
        self.snapshots: deque[dict] = deque(maxlen=max_snapshots)
        self.trigger_counts: dict[str, int] = {}
        self.trigger_hooks: list = []  # called with each new snapshot
        self.totals: dict[str, float] = {}
        self.last_shares: dict[str, float] = {}
        self.closed = False
        now = time.perf_counter()
        self.started = now
        self._win_start = now
        self._win_cats: dict[str, float] = {}
        # (duration, category, label, within-window start offset)
        self._win_top: list[tuple[float, str, str, float | None]] = []
        self._top_min = 0.0      # admission bar for the top-K record path
        self._last_end = now     # end of the previous callback (idle from)
        self._depth = 0          # >0 while inside a wrapped callback
        self._mark = now         # last attribution boundary
        self._cur = "other"      # category accruing since _mark
        self._cb_label: str | None = None
        self._last_trigger: dict[str, float] = {}

    # -- interposition side ------------------------------------------------
    def _entry(self):
        """The ONE callable every schedule reuses (scheduled with the
        real callback as its first argument — no per-callback closure)."""
        return self._run_cb

    def _wrap(self, cb):
        """Compatibility/test shim around :meth:`_entry`. The installed
        loop hooks do NOT use this — they schedule the entry callable
        with the real callback as its first argument, so the steady
        state allocates no closure per scheduled callback."""
        return functools.partial(self._entry(), cb)

    def _run_cb(self, cb, *args,
                _perf=time.perf_counter, _get_cat=LOOP_CATEGORY.get):
        """Execute one scheduled callback inside occupancy boundaries.
        This runs for EVERY callback the loop executes while profiling is
        on, so the steady state is kept flat and allocation-free: two
        clock reads, one contextvar get, two dict upserts (idle gap +
        category slice — cumulative ``totals`` are folded in once per
        window, not per callback), zero extra frames. The top-K record
        path only engages for callbacks slower than the current window's
        admission bar (``_top_min``); ``_perf``/``_get_cat`` are
        default-arg locals. A closed profiler passes straight through
        (callbacks scheduled before uninstall may still run after)."""
        if self.closed or self._depth:
            if self.closed:
                return cb(*args)
            # nested invocation (a wrapped fn called synchronously from
            # inside another): inner boundaries are a no-op
            self._depth += 1
            try:
                return cb(*args)
            finally:
                self._depth -= 1
        now = _perf()
        gap = now - self._last_end
        wc = self._win_cats
        if gap > 0.0:
            # the loop was in select() between callbacks: idle
            # (try/except: the key exists after the window's first gap)
            try:
                wc["idle"] += gap
            except KeyError:
                wc["idle"] = gap
        self._depth = 1
        self._mark = now
        self._cur = _get_cat()
        self._cb_label = None
        try:
            return cb(*args)
        finally:
            end = _perf()
            self._depth = 0
            d = end - self._mark
            if d > 0.0:
                # re-read the dict slot: robust against anything inside
                # cb ever rebinding the open window
                wc = self._win_cats
                cat = self._cur
                try:
                    wc[cat] += d
                except KeyError:
                    wc[cat] = d
            self._last_end = end
            if end - now > self._top_min:
                # top-K slow-callback record (rare by construction: the
                # bar rises to the K-th slowest as the window fills)
                self._record_top(cb, end - now, now - self._win_start)
            if end - self._win_start >= self.window:
                self._finalize_window(end)

    def _record_top(self, cb, dur: float,
                    offset: float | None = None) -> None:
        """``offset`` = the callback's START relative to the open
        window's start (stamped by the hot path — C runner or the
        Python reference — so the Perfetto flame row places each record
        exactly instead of laying durations end-to-end from the window
        start). None only from legacy callers; the exporter falls back
        to cursor placement then."""
        top = self._win_top
        top.append((dur, self._cur,
                    self._cb_label or _describe_callback(cb), offset))
        if len(top) > self.top_k:
            top.sort(key=lambda t: t[0], reverse=True)
            del top[self.top_k:]
            self._top_min = top[-1][0]

    def _accrue(self, now: float) -> None:
        d = now - self._mark
        if d > 0.0:
            cat = self._cur
            self._win_cats[cat] = self._win_cats.get(cat, 0.0) + d
        self._mark = now

    # -- attribution side (instrumented runtime sites) ---------------------
    def set_category(self, category: str, label=None, *,
                     _perf=time.perf_counter) -> None:
        """Attribute loop time from here to the next boundary to
        ``category`` (segmenting WITHIN the current callback — the engine
        splits one tick callback into staging/transfer/sync). Outside a
        wrapped callback this is a no-op: there is no loop time to
        attribute, and a stale mark must not accrue. ``label`` may be a
        string or a tuple of parts — tuples are joined with "." only if
        the callback actually lands in the top-K record (the per-turn
        hot path never pays the format). Accrual is inlined — this runs
        several times per device tick and twice per host turn."""
        if not self._depth or self.closed:
            return
        now = _perf()
        d = now - self._mark
        if d > 0.0:
            wc = self._win_cats
            cat = self._cur
            try:
                wc[cat] += d
            except KeyError:
                wc[cat] = d
        self._mark = now
        self._cur = category
        if label is not None:
            self._cb_label = label

    def enter(self, category: str, label: str | None = None):
        """Category for the current slice AND the current task's future
        steps (turn bodies suspend; their resumptions must keep the
        label). Returns a token for :meth:`exit` — token discipline
        mirrors the dispatcher's contextvar usage across one task.

        Eager-aware guarded boundary (3.12+ eager task factories): an
        eagerly-executed first step runs INSIDE the callback that
        created the task, so a live-slice switch here would bleed into
        the creator's remaining frame if the step suspends (exit only
        runs on completion, in a LATER callback). The guard consults the
        interpreter's own eager-task registry (``asyncio.tasks``'
        ``_eager_tasks``, the set a task occupies exactly while its
        first step executes eagerly): inside an eager step the live
        switch is DEFERRED — the contextvar alone labels the task's
        post-suspension steps (read at each callback start), and the
        inline stretch stays honestly booked to the creator's category,
        which is where it physically ran. On interpreters without eager
        factories (the py3.10 reference environment) the registry does
        not exist, the guard is a single module-constant None test, and
        the switch is exact as before."""
        token = LOOP_CATEGORY.set(category)
        if _EAGER_TASKS is not None and self._depth:
            try:
                t = asyncio.current_task()
            except RuntimeError:
                t = None
            if t is not None and t in _EAGER_TASKS:
                return token  # deferred: guarded eager boundary
        self.set_category(category, label)
        return token

    def exit(self, token) -> None:
        LOOP_CATEGORY.reset(token)
        self.set_category(LOOP_CATEGORY.get())

    # -- windows / flight recorder ----------------------------------------
    def _finalize_window(self, now: float) -> None:
        wall = now - self._win_start
        shares = ({k: round(v / wall, 4) for k, v in self._win_cats.items()}
                  if wall > 0 else {})
        # cumulative totals are folded once per window, not per callback
        # (the hot path touches only _win_cats)
        tot = self.totals
        for k, v in self._win_cats.items():
            tot[k] = tot.get(k, 0.0) + v
        self._win_top.sort(key=lambda t: t[0], reverse=True)
        self.ring.append({
            "ts": time.time(),
            "wall_s": round(wall, 6),
            "seconds": {k: round(v, 6) for k, v in self._win_cats.items()},
            "shares": shares,
            "top": [{"seconds": round(d, 6), "category": c,
                     "label": lb if isinstance(lb, str)
                     else ".".join(str(p) for p in lb),
                     # within-window start offset: exact flame-row
                     # placement (None only via legacy _record_top calls)
                     "offset": None if off is None else round(off, 6)}
                    for d, c, lb, off in self._win_top[:self.top_k]],
        })
        self.last_shares = shares
        self._win_cats = {}
        self._win_top = []
        self._top_min = 0.0
        self._win_start = now

    def _flush(self) -> None:
        """Force an attribution boundary so reads see everything up to
        now (reads run inside a callback — a ctl turn — so depth > 0)."""
        if self._depth and not self.closed:
            self._accrue(time.perf_counter())

    def trigger(self, reason: str, **attrs) -> dict | None:
        """Anomaly hook: snapshot the ring (plus the partial current
        window) into ``snapshots``. Rate-limited per reason so a shed
        storm yields one snapshot per ``trigger_interval``, not one per
        message; every trigger still counts."""
        self.trigger_counts[reason] = self.trigger_counts.get(reason, 0) + 1
        now = time.monotonic()
        if now - self._last_trigger.get(reason, -1e9) < self.trigger_interval:
            return None
        self._last_trigger[reason] = now
        self._flush()
        snap = {
            "reason": reason,
            "ts": time.time(),
            "attrs": attrs,
            "slices": list(self.ring),
            "current": {
                "seconds": {k: round(v, 6)
                            for k, v in self._win_cats.items()},
                "window_open_s": round(
                    time.perf_counter() - self._win_start, 6),
            },
        }
        self.snapshots.append(snap)
        for hook in self.trigger_hooks:
            try:
                hook(snap)
            except Exception:  # noqa: BLE001 — a sink must not break the loop
                log.exception("flight-recorder trigger hook failed")
        return snap

    # -- reads -------------------------------------------------------------
    def _cumulative(self) -> dict[str, float]:
        """Finalized-window totals plus the open window's accrual (the
        hot path folds into ``totals`` only at window boundaries)."""
        self._flush()
        out = dict(self.totals)
        for k, v in self._win_cats.items():
            out[k] = out.get(k, 0.0) + v
        return out

    def occupancy(self) -> dict[str, float]:
        """Cumulative per-category shares of accounted wall time
        (busy + idle); sums to ~1.0 by construction."""
        cum = self._cumulative()
        wall = sum(cum.values())
        if wall <= 0:
            return {}
        return {k: v / wall for k, v in cum.items()}

    def profile(self, windows: int = 20,
                snapshots: bool = True) -> dict:
        """The management-surface payload: cumulative seconds + shares,
        the last ``windows`` slices, and (optionally) the flight-recorder
        snapshots."""
        cum = self._cumulative()
        wall = sum(cum.values())
        out = {
            "window_s": self.window,
            "wall_s": round(wall, 6),
            "seconds": {k: round(v, 6) for k, v in cum.items()},
            "shares": {k: round(v / wall, 4)
                       for k, v in cum.items()} if wall else {},
            "windows": list(self.ring)[-windows:] if windows else [],
            "triggers": dict(self.trigger_counts),
        }
        if snapshots:
            out["snapshots"] = list(self.snapshots)
        return out


class _NativeLoopProfiler(LoopProfiler):
    """LoopProfiler whose per-callback hot path runs in C
    (native/hotloop.c). The C ``Runner`` owns the hot state — attribution
    boundary, open-window category dict, top-K admission bar, depth/
    closed flags — and every Python slow path (window finalize, trigger,
    flush, enter/exit) keeps working unchanged through the delegating
    properties installed below, which read and write the very same C
    struct members. Semantics are identical to the pure-Python parent
    (the behavioural reference, still exercised by the unit tests and
    the ``ORLEANS_TPU_NATIVE=0`` fallback)."""

    __slots__ = ("_c",)

    def __init__(self, *args, **kwargs):
        # the runner must exist BEFORE the parent __init__ writes state
        # through the delegating properties
        object.__setattr__(self, "_c", _hotloop.Runner(LOOP_CATEGORY, self))
        super().__init__(*args, **kwargs)

    def _entry(self):
        return self._c  # the Runner IS the scheduled callable

    def set_category(self, category: str, label=None) -> None:
        self._c.set_category(category, label)


def _delegate(cname: str) -> property:
    return property(lambda self, _n=cname: getattr(self._c, _n),
                    lambda self, v, _n=cname: setattr(self._c, _n, v))


for _name, _cname in (("window", "window"), ("closed", "closed"),
                      ("_win_start", "win_start"), ("_win_cats", "win_cats"),
                      ("_top_min", "top_min"), ("_last_end", "last_end"),
                      ("_depth", "depth"), ("_mark", "mark"),
                      ("_cur", "cur"), ("_cb_label", "cb_label")):
    setattr(_NativeLoopProfiler, _name, _delegate(_cname))
del _name, _cname


def _profiler_class() -> type[LoopProfiler]:
    return LoopProfiler if _hotloop is None else _NativeLoopProfiler


# one interposition per loop, refcounted: loop -> [refs, profiler,
# originals]. Weakly keyed: a loop abandoned without uninstall (a silo
# that died mid-start, a test loop dropped on the floor) must not leave
# an entry behind — id() reuse on a later loop would alias it onto the
# stale closed profiler and silently skip installing hooks.
_loop_profilers: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def loop_profiler(loop) -> LoopProfiler | None:
    """The profiler installed on ``loop``, or None."""
    ent = _loop_profilers.get(loop)
    return ent[1] if ent else None


def install_loop_profiler(loop, *, window: float = 1.0, ring: int = 120,
                          top_k: int = 8,
                          trigger_interval: float = 1.0) -> LoopProfiler:
    """Interpose occupancy accounting on ``loop`` (idempotent +
    refcounted: silos sharing a loop share ONE profiler — occupancy is a
    loop property — and the last :func:`uninstall_loop_profiler` removes
    the hooks). Instance-attribute shadowing keeps this py3.10-safe: no
    loop subclass, no task factory, works on a loop that is already
    running. ``call_later`` is covered through the patched ``call_at``;
    executor completions arrive via the patched ``call_soon_threadsafe``;
    selector IO-ready callbacks (transport ``_read_ready`` — the recv
    syscall + buffer feed that would otherwise land in the inter-callback
    gap and be booked as idle) are covered through the patched
    ``_add_reader``/``_add_writer`` and attributed to ``pump`` (in this
    runtime an FD becoming readable IS fabric/gateway socket work).

    Known tradeoff: scheduling hooks prepend the runner via C-level
    ``functools.partial`` — no Python frame per schedule, which is the
    whole overhead budget — so asyncio's callable check inspects the
    runner, not the user callback; a non-callable (e.g. a bare
    coroutine object) fails inside the Handle via the loop exception
    handler instead of raising TypeError at the buggy call site. A
    pre-validating Python wrapper would re-add the per-schedule frame
    this design exists to avoid."""
    ent = _loop_profilers.get(loop)
    if ent is not None:
        ent[0] += 1
        return ent[1]
    prof = _profiler_class()(window=window, ring=ring, top_k=top_k,
                             trigger_interval=trigger_interval)
    # the ONE entry callable every schedule reuses (the C Runner when
    # native, the bound _run_cb otherwise): scheduling it with the real
    # callback as its first argument costs no closure/partial allocation
    # per callback (the dominant interposition tax otherwise).
    # call_soon/call_soon_threadsafe prepend it via a C-level
    # functools.partial — zero Python frames on the schedule path:
    #   loop.call_soon(cb, *a, context=c)
    #     -> orig_call_soon(run_cb, cb, *a, context=c)
    # call_at needs a real wrapper (``when`` precedes the callback), and
    # timers are orders of magnitude rarer than call_soon.
    run_cb = prof._entry()
    call_soon = functools.partial(loop.call_soon, run_cb)
    call_soon_threadsafe = functools.partial(loop.call_soon_threadsafe,
                                             run_cb)

    def call_at(when, callback, *args, context=None,
                _at=loop.call_at, _run=run_cb):
        return _at(when, _run, callback, *args, context=context)

    loop.call_soon = call_soon
    loop.call_at = call_at
    loop.call_soon_threadsafe = call_soon_threadsafe
    names = ["call_soon", "call_at", "call_soon_threadsafe"]
    if hasattr(loop, "_add_reader"):
        # selector loops only (proactor has no fd readers). The Handle
        # captures its context at REGISTRATION, so registering inside a
        # context with LOOP_CATEGORY already set to "pump" labels every
        # run of the IO callback without per-run work.
        pump_ctx = contextvars.Context()
        pump_ctx.run(LOOP_CATEGORY.set, "pump")

        def _add_reader(fd, callback, *args, _orig=loop._add_reader,
                        _run=run_cb, _ctx=pump_ctx):
            return _ctx.run(_orig, fd, _run, callback, *args)

        def _add_writer(fd, callback, *args, _orig=loop._add_writer,
                        _run=run_cb, _ctx=pump_ctx):
            return _ctx.run(_orig, fd, _run, callback, *args)

        loop._add_reader = _add_reader
        loop._add_writer = _add_writer
        names += ["_add_reader", "_add_writer"]
    _loop_profilers[loop] = [1, prof, tuple(names)]
    log.info("loop profiler installed (window=%.2fs, ring=%d)", window, ring)
    return prof


def uninstall_loop_profiler(loop) -> None:
    """Drop one reference; the last removes the instance-attribute hooks
    (class methods take over again) and closes the profiler so
    already-wrapped callbacks pass straight through."""
    ent = _loop_profilers.get(loop)
    if ent is None:
        return
    ent[0] -= 1
    if ent[0] > 0:
        return
    del _loop_profilers[loop]
    _, prof, names = ent
    prof.closed = True
    for name in names:
        try:
            delattr(loop, name)
        except AttributeError:
            pass


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span on the profiler timeline (no-op cost when no trace is
    active)."""
    with torch.profiler.record_function(name):
        yield


def traced(name: str):
    """Decorator form of :func:`annotate`. Coroutine-aware: wrapping an
    ``async def`` keeps the annotation open across the whole awaited turn
    (a naive wrapper would return the coroutine object and close the span
    before the turn ever ran). Function metadata is preserved."""
    def wrap(fn):
        if inspect.iscoroutinefunction(fn):
            @functools.wraps(fn)
            async def inner(*args, **kwargs):
                with torch.profiler.record_function(name):
                    return await fn(*args, **kwargs)
            return inner

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class Profiler:
    """Start/stop a ``torch.profiler`` capture (host ops, and CUDA kernels
    when the card is present); ``stop()`` waits for the card's queued
    work, so every kernel launched in the window is in the capture, then
    writes it to ``<log_dir>/trace.json`` and keeps the finished profile
    as ``last`` (``last.key_averages()`` sums it by op and kernel). One
    active capture per process; ``stop()`` is idempotent. In a forked
    worker process of a multi-process silo it captures the CPU only and
    makes no ``torch.cuda`` call (``parallel.mesh.in_worker_process``):
    CUDA must not start there."""

    def __init__(self) -> None:
        self.active_dir: str | None = None
        self._prof = None
        self.last = None

    @staticmethod
    def _device() -> bool:
        from ..parallel.mesh import in_worker_process
        return not in_worker_process() and torch.cuda.is_available()

    def start(self, log_dir: str) -> None:
        if self.active_dir is not None:
            raise RuntimeError(f"trace already active → {self.active_dir}")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self._device():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        self.active_dir = log_dir
        log.info("device trace capturing → %s", log_dir)

    def stop(self) -> str | None:
        if self.active_dir is None:
            return None
        prof, self._prof = self._prof, None
        if self._device():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        self.last = prof
        out, self.active_dir = self.active_dir, None
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        log.info("device trace written → %s", out)
        return out

    @contextlib.contextmanager
    def capture(self, log_dir: str) -> Iterator[None]:
        self.start(log_dir)
        try:
            yield
        finally:
            self.stop()


class StepTimer:
    """Wall-clock per named step into a stats histogram, warning on slow
    steps (the device-tier TurnWarningLengthThreshold,
    OrleansTaskScheduler.cs:26)."""

    def __init__(self, stats: "StatsRegistry", name: str,
                 warn_threshold: float = 0.2):
        self.stats = stats
        self.name = name
        self.warn_threshold = warn_threshold

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(self.name):
                yield
        finally:
            # record failed steps too — crashed/timed-out ticks are the
            # most important ones in the latency telemetry
            dt = time.perf_counter() - t0
            self.stats.observe(f"{self.name}.seconds", dt)
            if dt > self.warn_threshold:
                self.stats.increment(f"{self.name}.slow")
                log.warning("%s took %.3fs (threshold %.3fs)", self.name,
                            dt, self.warn_threshold)
