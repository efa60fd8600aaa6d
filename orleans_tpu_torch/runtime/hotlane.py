"""Hot lane: frame-collapsed dispatch for local grain calls.

A ping attribution profile (benchmarks/BENCH_r05_ping_attribution.json) showed the
host tier capped at ~43k calls/sec against a 129-175k bare-asyncio ceiling,
with the gap being the ~40 Python frames of full messaging semantics per
call — resolve → Message → queue → turn task → callback → response-route —
not any single component.  This module collapses that pipeline for the
dominant case (a local, Valid, gate-admitting activation with nothing
special in flight) into a handful of frames: dict lookups, a gate check,
and a direct await of the grain method, resolving the caller directly with
no ``Message``, no ``CallbackData``, and no timeout-sweeper entry.  It
generalizes ``InsideRuntimeClient.try_direct_interleave`` (which covered
only always-interleave methods) into the default in-silo path.

Anything complicated falls back to the untouched full messaging path, so
the hot lane never has to replicate rare-path semantics:

* no local single Valid activation (remote, activating, deactivating,
  migration-fenced, stateless-worker replica set, duplicate race);
* the reentrancy gate does not admit the call (busy non-reentrant
  activation) — the messaging path enqueues it in arrival order, so hot
  calls can never reorder ahead of queued turns;
* any call filter is registered (outgoing, silo incoming, or a grain-level
  ``on_incoming_call`` hook) — interception fires identically regardless
  of placement;
* tracing actually sampled this call — the lane rolls the head-sample die
  itself (collector installed with a non-zero rate) and hands a winning
  roll to the messaging path via ``SpanCollector.presampled``, so at
  sample rates ≪1 only the sampled minority leaves the lane and sampled
  traces keep their intact span tree; an ambient trace context to
  propagate always falls back;
* ambient RequestContext baggage, including a transaction context — the
  header round-trip (TransactionInfo piggyback) only exists on the
  messaging path;
* a cancellation token argument — token target bookkeeping rides the send
  path;
* an explicit per-call timeout / armed expiry (grain references never pass
  one today, so this is structural: hot calls rely on the stuck-activation
  watchdog, exactly like the direct-interleave path always has).

The ``DISPATCH_STATS`` counter pair (observability.stats) makes the
hit/fallback ratio observable: plain int fields on the client (a registry
increment per call was itself measurable in the attribution), surfaced as
gauges on the silo's StatsRegistry and in the ping benchmark ``extra``.

The port's copy of ``orleans_tpu.runtime.hotlane``.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from typing import TYPE_CHECKING

from ..core.serialization import copy_call_body, copy_result
from ..observability.tracing import current_trace
from .activation import ActivationState
from .cancellation import GrainCancellationToken
from .context import _request_context, current_activation, current_call_chain

if TYPE_CHECKING:
    from .activation import ActivationData
    from .silo import Silo

__all__ = ["try_hot_invoke", "HotTurnMarker"]


class HotTurnMarker:
    """Pooled stand-in for a Message in ``ActivationData.running`` while a
    hot-lane turn executes: enough surface for the reentrancy gate
    (``is_read_only``), call-chain building (``call_chain``), and the
    stuck-activation probe (``id`` keyed into ``running_since``).  This is
    the "pooled context" of the inline turn — acquired from a freelist,
    released when the turn ends."""

    __slots__ = ("id", "call_chain", "is_read_only")

    def __init__(self, id: int, call_chain: tuple, is_read_only: bool):
        self.id = id
        self.call_chain = call_chain
        self.is_read_only = is_read_only


_MARKER_POOL: list[HotTurnMarker] = []
_MARKER_POOL_CAP = 256
# forced-yield cadence when the loop has nothing else ready (see the
# batch-aware fairness note at the end of _hot_turn)
_HOT_YIELD_EVERY = 64
# ONE sequence of negative ids for every running-marker kind (hot-lane
# markers here AND silo._DirectCallMarker): negative so they can never
# collide with wire message ids in an activation's running_since map, and
# shared so two marker kinds concurrently running on one activation can
# never collide with each other (which would blind the stuck-activation
# probe to whichever turn lost the running_since entry).
marker_ids = itertools.count(1)


def _acquire_marker(chain: tuple, read_only: bool) -> HotTurnMarker:
    mid = -next(marker_ids)
    pool = _MARKER_POOL
    if pool:
        m = pool.pop()
        m.id = mid
        m.call_chain = chain
        m.is_read_only = read_only
        return m
    return HotTurnMarker(mid, chain, read_only)


def _release_marker(m: HotTurnMarker) -> None:
    if len(_MARKER_POOL) < _MARKER_POOL_CAP:
        m.call_chain = ()
        _MARKER_POOL.append(m)


def _gate_admits(act: "ActivationData", inv, is_read_only: bool,
                 grain_id, chain: tuple) -> bool:
    """Inline reentrancy gate (Dispatcher.CanInterleave): a refusal means
    the messaging path will ENQUEUE the call behind the running turn — so
    a hot-lane fallback on refusal preserves arrival order exactly."""
    if not act.running:
        return True
    return (act.is_reentrant or inv.is_always_interleave
            or (is_read_only and all(m.is_read_only for m in act.running))
            or grain_id in chain)


def _pick_stateless_replica(acts):
    """Cheap replica choice for a StatelessWorker set (the ROADMAP
    carry-over): the first VALID replica with nothing running — an idle
    replica trivially admits, so no gate walk or load compare is needed.
    None when every replica is busy/transitioning: the call then takes
    the messaging path, where the catalog's least-loaded pick and
    auto-scale (maybe_add_stateless_replica) stay authoritative — the
    lane never grows or queues on a replica set itself."""
    for a in acts:
        if a.state is ActivationState.VALID and not a.running:
            return a
    return None


def try_hot_invoke(client, silo: "Silo", grain_id, grain_class: type,
                   interface_name: str, method_name: str,
                   args: tuple, kwargs: dict, is_read_only: bool):
    """Gate-check a local call for the hot lane.  Returns the inline-turn
    coroutine on admission, None to take the messaging path.  ``client``
    is the RuntimeClient the call originates from (its filters/tracer
    gate the lane; its counters record the outcome)."""
    acts = silo.catalog.by_grain.get(grain_id)
    if not acts:
        return None
    act = acts[0]
    entry = silo.invokers.entry(act.grain_class)
    if not entry.hot_ok or client.outgoing_call_filters:
        return None
    if entry.stateless_cap:
        # StatelessWorker: serve an idle replica inline, hand busy sets
        # to the messaging path (catalog replica pick + auto-scale)
        act = _pick_stateless_replica(acts)
        if act is None:
            return None
    elif len(acts) != 1:
        return None  # duplicate-activation race on a single-activation grain
    if act.state is not ActivationState.VALID:
        return None  # activating/deactivating/migration-fenced/invalid
    inv = entry.methods.get(method_name)
    if inv is None or inv.is_one_way:
        return None
    # per-INSTANCE shadowing: a hook or method attached to the instance
    # (fault injection, grain-level gate set in __init__) is invisible to
    # the class-level table — the messaging path resolves both, so decline
    instance = act.grain_instance
    d = getattr(instance, "__dict__", None)
    if d is not None and (method_name in d or "on_incoming_call" in d):
        return None
    if current_trace.get() is not None:
        return None  # continuing a sampled trace: headers must propagate
    if _request_context.get():
        return None  # baggage/txn context rides message headers
    for a in args:
        if type(a) is GrainCancellationToken:
            return None
    if kwargs:
        for a in kwargs.values():
            if type(a) is GrainCancellationToken:
                return None
    # caller chain (deadlock/reentrancy bookkeeping — the same shared
    # construction as the messaging send path)
    chain = current_call_chain()
    if not _gate_admits(act, inv, is_read_only, grain_id, chain):
        return None
    tracer = client.tracer
    if tracer is not None and tracer.sample_rate > 0:
        # sampled-trace hot lane: roll the head-sample die HERE instead of
        # declining whenever a collector is installed — at sample rates
        # ≪1 the lane keeps serving the unsampled majority and only the
        # sampled minority pays the messaging path. The roll is handed to
        # send_request via the collector's one-shot ``presampled`` slot
        # (consumed synchronously in this same step), so the effective
        # rate stays exactly ``sample_rate``, never its square. Rolled
        # LAST, after every other decline: a call the lane turns away for
        # a different reason must reach the messaging path un-rolled, or
        # its record probability would double.
        if tracer.sample():
            tracer.presampled = True
            return None
    return _hot_turn(client, silo, act, inv, grain_id, grain_class,
                     interface_name, args, kwargs, is_read_only, chain,
                     tracer)


async def _hot_turn(client, silo: "Silo", act: "ActivationData", inv,
                    grain_id, grain_class: type, interface_name: str,
                    args: tuple, kwargs: dict, is_read_only: bool,
                    chain: tuple, admitted_tracer):
    """The collapsed turn: copy-isolate, run gated on a pooled running
    marker, copy-isolate the result, pump, once-per-RPC fairness yield.
    Error semantics match the messaging path (the grain's exception object
    reaches the caller; InconsistentState still triggers rebuild); the
    per-call timeout is intentionally absent (the stuck-activation
    watchdog observes via the running marker)."""
    # Re-verify admission at EXECUTION time: the gate decision above ran
    # synchronously when the caller built the coroutine, but a deferred
    # start (ensure_future/gather) executes it later — by which time the
    # activation may be migration-fenced or mid-turn, a filter/tracer may
    # have been registered, or an instance-level hook attached.  The
    # messaging path resolves ALL of those at dispatch time, so a stale
    # admission hands the call over rather than running it inline with
    # creation-time semantics.  (For the dominant ``await ref.method()``
    # shape the coroutine starts synchronously inside the caller's await,
    # so this re-check sees exactly what the gate just saw.)
    instance = act.grain_instance
    d = getattr(instance, "__dict__", None)
    tracer = client.tracer
    # tracer re-verify: admission already rolled (and lost) the sampling
    # die against ``admitted_tracer``, so running inline IS the unsampled
    # outcome — re-rolling here would skew the rate. Only a collector
    # INSTALLED/SWAPPED since admission (which never got a roll) forces
    # the messaging path, preserving the old install-after-creation guard.
    if (act.state is not ActivationState.VALID
            or not silo.invokers.entry(act.grain_class).hot_ok
            or client.outgoing_call_filters
            or (tracer is not admitted_tracer and tracer is not None
                and tracer.sample_rate > 0)
            or current_trace.get() is not None
            or (d is not None and (inv.name in d or "on_incoming_call" in d))
            or not _gate_admits(act, inv, is_read_only, grain_id, chain)):
        client.hot_hits -= 1
        client.hot_fallbacks += 1
        if (tracer is admitted_tracer and tracer is not None
                and tracer.sample_rate > 0
                and not client.outgoing_call_filters
                and current_trace.get() is None):
            # admission already rolled (and lost) the head-sample die for
            # this call — hand the UNSAMPLED outcome over too, or the
            # messaging path would re-roll and double this call class's
            # record probability. Skipped when filters appeared since
            # (their deferred send consumes the slot in a later task,
            # where it could suppress a different call's roll).
            tracer.presampled = False
        # send_request, not _send_request_unfiltered: an outgoing filter
        # registered since coroutine creation must wrap this call too
        return await client.send_request(
            target_grain=grain_id, grain_class=grain_class,
            interface_name=interface_name, method_name=inv.name,
            args=args, kwargs=kwargs, is_read_only=is_read_only,
            is_always_interleave=inv.is_always_interleave)
    args, kwargs = copy_call_body(args, kwargs)
    ctx_token = None
    if _request_context.get() is not None:
        # the caller attached baggage AFTER building the call coroutine;
        # the messaging path captures headers at call time (when the
        # context was empty — the gate checked), so the callee must not
        # see it — and the caller must get it back afterwards
        ctx_token = _request_context.set(None)
    marker = _acquire_marker(chain, is_read_only)
    act.record_running(marker)
    token = current_activation.set(act)
    # cost attribution (observability.ledger): an inline turn is exec
    # only — it never queued, and the lane declined any baggage-carrying
    # call above, so tenancy comes from the tenant_of hook alone. The
    # clock is read only when a ledger is installed (the disabled lane
    # pays one attribute load).
    led = silo.ledger
    t_led = time.monotonic() if led is not None else 0.0
    try:
        result = copy_result(await inv.fn(act.grain_instance,
                                          *args, **kwargs))
    except asyncio.CancelledError:
        raise
    except BaseException as e:
        silo.catalog.on_invoke_error(act, e)
        raise
    finally:
        if led is not None:
            led.charge_turn(
                interface_name, inv.name, time.monotonic() - t_led,
                key=f"{act.grain_class.__name__}/{grain_id.key}")
        current_activation.reset(token)
        if ctx_token is not None:
            _request_context.reset(ctx_token)  # restore caller baggage
        elif _request_context.get() is not None:
            # the callee set baggage during the inline turn; the messaging
            # path clears turn-local context, so must we (the caller's own
            # context was None — a hot call never admits ambient baggage)
            _request_context.set(None)
        act.reset_running(marker)
        _release_marker(marker)
        # messages that arrived during the call queued behind the running
        # marker; nothing else pumps them for an inline turn
        silo.dispatcher.run_message_pump(act)
    # Batch-aware fairness yield — the liveness contract the messaging
    # path enforces in RuntimeClient._await_response, minus its tax when
    # it buys nothing.  The old once-per-RPC unconditional sleep(0) cost
    # ~30% of the collapsed turn's headroom; yielding is only USEFUL when
    # the event loop actually has other ready callbacks to run (a starved
    # ticker task, a queued turn, a completed IO wakeup).  So: yield when
    # the loop's ready queue is non-empty (our own frame was popped off it
    # before running, so anything in it is someone else), and otherwise
    # force one yield every _HOT_YIELD_EVERY collapsed turns — timer
    # callbacks (membership probes, reminders) sit in the SCHEDULED heap,
    # not the ready queue, and only migrate across a loop iteration, so a
    # ready-queue check alone would re-open the starvation hazard
    # test_tight_call_loop guards (the bound keeps it to ~64 sub-30µs
    # turns, far under any probe period).  Loops without a _ready deque
    # (non-CPython event loops) keep the per-call yield.
    ready = getattr(asyncio.get_running_loop(), "_ready", None)
    client.hot_calls_since_yield += 1
    if ready is None or ready or \
            client.hot_calls_since_yield >= _HOT_YIELD_EVERY:
        client.hot_calls_since_yield = 0
        await asyncio.sleep(0)
    return result
