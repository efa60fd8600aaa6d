"""RuntimeClient: the RPC engine shared by silo-interior and external clients.

Re-design of Orleans' src/Orleans.Runtime/Core/InsideRuntimeClient.cs:28
(``SendRequest:120-229`` with callback registry :207-217, ``Invoke:294-474``,
``ReceiveResponse:569-627``, ``BreakOutstandingMessagesToDeadSilo:726``) and
``CallbackData`` (Core/Runtime/CallbackData.cs).

The port's copy of ``orleans_tpu.runtime.runtime_client``.
"""

from __future__ import annotations

import asyncio
import random
import logging
import time
from typing import TYPE_CHECKING

from ..core.errors import (
    GrainCallTimeoutError,
    RejectionError,
    SiloUnavailableError,
)
from ..core.ids import GrainId, SiloAddress
from ..core import message as _msg_mod
from ..core.message import (
    Category,
    Direction,
    Message,
    ResponseKind,
    make_request_fast,
    recycle_message,
    recycle_messages,
)
from ..core.serialization import copy_call_body, deep_copy
from ..observability.tracing import (
    TRACE_KEY,
    context_from_headers,
    current_trace,
    mark_remote_if_traced,
    pending_root_link,
)
from .cancellation import register_outgoing_tokens
from .context import (
    TXN_KEY,
    RequestContext,
    build_call_chain,
    current_activation,
)

if TYPE_CHECKING:
    from .activation import ActivationData

log = logging.getLogger("orleans.rpc")

MAX_RESEND_COUNT = 3  # SiloMessagingOptions.MaxResendCount analog


async def _finish_span_after(tracer, span, res):
    """Close the client span when the RPC settles (success or error) —
    the span covers the full round trip including transparent resends."""
    try:
        result = await res
    except BaseException as e:
        tracer.close(span, error=type(e).__name__)
        raise
    tracer.close(span)
    return result


def _resolve_future(fut: asyncio.Future, value, exc) -> None:
    if fut.done():
        return  # timed out / broken / cancelled while deferred
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(value)


class CallbackData:
    """One outstanding request: future + timeout bookkeeping (CallbackData.cs).
    ``txn_info`` is the caller's ambient TransactionInfo (if any) so
    callee joins piggybacked on the response can merge back into it.
    ``gen`` is the request shell's pool generation captured at registration
    (debug pool-poisoning only, ORLEANS_TPU_DEBUG_POOL=1): the shell must
    still be that incarnation when the response correlates back.
    ``span`` is the still-open client invoke span for sampled calls (None
    otherwise) so rejection/resend events can attach to it mid-flight."""

    __slots__ = ("message", "future", "deadline", "txn_info", "gen", "span")

    def __init__(self, message: Message, future: asyncio.Future,
                 deadline: float | None, txn_info=None, span=None):
        self.message = message
        self.future = future
        self.deadline = deadline
        self.txn_info = txn_info
        self.gen = None
        self.span = span


# CallbackData freelist (the BufferPool.cs discipline): one acquired per
# round-trip RPC, released wherever the entry leaves the registry for good.
_CB_POOL: list[CallbackData] = []
_CB_POOL_CAP = 1024


def _fresh_callback(message: Message, future: asyncio.Future,
                    deadline: float | None, txn_info,
                    span=None) -> CallbackData:
    pool = _CB_POOL
    if pool:
        cb = pool.pop()
        cb.message = message
        cb.future = future
        cb.deadline = deadline
        cb.txn_info = txn_info
        cb.gen = _msg_mod.pool_generation(message) \
            if _msg_mod._DEBUG_POOL else None
        cb.span = span
        return cb
    cb = CallbackData(message, future, deadline, txn_info, span)
    if _msg_mod._DEBUG_POOL:
        cb.gen = _msg_mod.pool_generation(message)
    return cb


def _recycle_callback(cb: CallbackData) -> None:
    cb.message = None
    cb.future = None
    cb.txn_info = None
    cb.span = None
    if len(_CB_POOL) < _CB_POOL_CAP:
        _CB_POOL.append(cb)


class RuntimeClient:
    """Shared base: callback registry + response correlation. Subclassed by
    the silo interior (:class:`InsideRuntimeClient`) and the external client
    (orleans_tpu.runtime.client.ClusterClient)."""

    def __init__(self, response_timeout: float = 30.0):
        self.callbacks: dict[int, CallbackData] = {}
        self.response_timeout = response_timeout
        self._timeout_sweeper: asyncio.Task | None = None
        # outgoing call filter chain (IOutgoingGrainCallFilter; silo-side
        # registration via SiloBuilder.add_outgoing_call_filter, client-side
        # via ClusterClient.add_outgoing_call_filter)
        self.outgoing_call_filters: list = []
        self._filter_tasks: set[asyncio.Task] = set()
        # distributed-tracing collector (observability.tracing): None on
        # the hot path unless tracing is enabled — silo-side wired from
        # SiloConfig.trace_*, client-side via enable_tracing()
        self.tracer = None
        # hot-lane dispatch (runtime.hotlane): hit/fallback counter pair
        # (DISPATCH_STATS) as plain ints — a StatsRegistry increment per
        # call was itself measurable in a ping attribution profile — plus an
        # on/off switch (benchmarks and the perf floor flip it to measure
        # the messaging path alone)
        self.hot_hits = 0
        self.hot_fallbacks = 0
        self.hot_lane_enabled = True
        # batch-aware fairness (hotlane._hot_turn): collapsed turns since
        # the last event-loop yield — bounds the forced-yield cadence when
        # the loop has nothing else ready
        self.hot_calls_since_yield = 0
        # batched response correlation (receive_response_batch): the
        # client-side half of the batched-egress A/B lever — off restores
        # per-message receive_response for every delivered batch
        self.batched_egress = True

    def enable_tracing(self, sample_rate: float = 1.0,
                       buffer_size: int = 4096, name: str = "client", *,
                       tail: bool = False, tail_window: float = 0.25,
                       slow_threshold: float | None = None,
                       slow_percentile: float | None = None,
                       auto_threshold: bool = False,
                       leg_ttl: float | None = None,
                       max_pending: int = 256,
                       policy=None, otlp_endpoint: str | None = None):
        """Install a SpanCollector so calls through this client open
        root client spans (head-based sampling at ``sample_rate``).
        ``tail=True`` defers keep/drop to trace completion (slow/errored/
        forced survive — see TracingOptions.tail_*); ``auto_threshold``
        self-tunes the slow threshold from the root-duration percentile
        history (the ``trace_tail_auto`` knob); ``otlp_endpoint``
        attaches a streaming OTLP/HTTP sink for retained spans."""
        from ..observability.tracing import (LatencyErrorPolicy,
                                             SpanCollector)
        if policy is None and (slow_threshold is not None
                               or slow_percentile is not None
                               or auto_threshold):
            # an omitted threshold keeps the class default (matching the
            # silo-side SiloConfig default) so one with_tracing() call
            # yields the SAME policy for client- and silo-rooted traces
            policy = LatencyErrorPolicy(
                LatencyErrorPolicy().slow_threshold
                if slow_threshold is None else slow_threshold,
                slow_percentile or 0.0, auto=auto_threshold)
        kw = {}
        if leg_ttl is not None:
            kw["leg_ttl"] = leg_ttl
        self.tracer = SpanCollector(name, sample_rate, buffer_size,
                                    tail=tail, tail_window=tail_window,
                                    policy=policy, max_pending=max_pending,
                                    **kw)
        if otlp_endpoint:
            raise NotImplementedError(
                "an OTLP sink needs observability/export.py, which "
                "orleans_tpu_torch does not port yet (ROADMAP Queue 1 "
                "item 17)")
        return self.tracer

    def _mark_remote_trace(self, msg: Message) -> None:
        """Stamp the "went remote" retention hint for a traced message
        leaving this process (tail mode only): client transmits always
        cross a process/collector boundary, so the rooting collector must
        pull peer legs before export. Called by the client transmit paths
        (ClusterClient/GatewayClient); silo egress stamps the same hint in
        MessageCenter.send_message through the same shared helper."""
        mark_remote_if_traced(self.tracer, msg)

    def try_direct_interleave(self, grain_id, method_name: str,
                              args: tuple, kwargs: dict):
        """In-silo fast path for always-interleave calls to a local, valid
        activation; None when not applicable (take the messaging path).
        Overridden by InsideRuntimeClient — external clients always
        message."""
        return None

    def try_hot_invoke(self, grain_id, grain_class: type,
                       interface_name: str, method_name: str,
                       args: tuple, kwargs: dict,
                       is_read_only: bool = False):
        """Hot-lane dispatch (runtime.hotlane): inline turn for ordinary
        calls to a local, Valid, gate-admitting activation; None when any
        complication demands the full messaging path.  Overridden where a
        local catalog is reachable (InsideRuntimeClient; ClusterClient
        over the in-proc fabric)."""
        return None

    # -- to be provided by subclass -------------------------------------
    @property
    def silo_address(self) -> SiloAddress | None:  # pragma: no cover
        raise NotImplementedError

    def transmit(self, msg: Message) -> None:  # pragma: no cover
        """Hand the message to the transport/dispatch layer."""
        raise NotImplementedError

    def transmit_batch(self, msgs: list) -> None:
        """Hand a pre-built request group to the transport as ONE unit.
        Default: per-message transmit; clients with a batched fabric
        hand-off override this so the group rides one wire batch and one
        receive-side routing hop (``MessageCenter.deliver_batch``).

        Contract for overrides: a failure AFTER any message reached the
        transport must be isolated to the failed slice via
        :meth:`_fail_transmit` (never re-raised) — raising then would
        make the caller unregister callbacks for messages that were
        already delivered and will execute. Raising is only allowed
        while provably nothing has been handed off (e.g. no gateways at
        all)."""
        for m in msgs:
            try:
                self.transmit(m)
            except Exception as e:  # noqa: BLE001 — scoped to this item
                self._fail_transmit([m], e)

    def _fail_transmit(self, msgs: list, exc: Exception) -> None:
        """Per-item transport-failure isolation for batched sends: fail
        (and unregister) exactly the messages that did NOT reach the
        transport, so already-delivered members of the same call_batch
        group complete normally. One-way messages carry no callback —
        dropped with a log, the per-message one-way contract."""
        for m in msgs:
            cb = self.callbacks.pop(m.id, None)
            if cb is not None:
                _resolve_future(cb.future, None, exc)
                # terminal before any response can correlate: the shell
                # returns to the freelist; the request message does NOT
                # (nothing proves no transport frame still holds it)
                _recycle_callback(cb)
            else:
                log.warning("batched one-way %s.%s dropped: %s",
                            m.interface_name, m.method_name, exc)

    # -- deliberate client-side batching ---------------------------------
    def call_batch(self, grain_class: type, method_name: str,
                   calls, *, timeout: float | None = None) -> list:
        """Send N ``(key, kwargs)`` invocations of ONE (class, method) as
        a deliberately-filled batch: the messages are built in one pass
        (one clock read, one call-chain/context export) and handed to the
        transport as a unit, so they ride one wire batch
        (``encode_message_batch``) and land receive-side as one routing
        hop — device-tier calls coalesce straight into a grouped
        ``VectorRuntime.call_group`` enqueue instead of relying on the
        sender's greedy drain to happen to group them.

        Returns a list of awaitables index-aligned with ``calls`` (None
        per item when the method is ``@one_way``). Per-item errors
        resolve that item's awaitable only.

        Scope: plain data-parallel payloads. When outgoing filters, a
        tracer, or ambient transaction baggage are active the batch falls
        back to N ordinary ``send_request`` calls — identical semantics,
        no batched hand-off — so interception and trace/txn propagation
        are never bypassed. Cancellation-token arguments are not
        registered on the batched path."""
        from .grain import grain_type_of, remote_methods
        fn = remote_methods(grain_class).get(method_name)
        if fn is None:
            raise AttributeError(
                f"{grain_class.__name__} has no remote method "
                f"{method_name!r}")
        read_only = getattr(fn, "__orleans_read_only__", False)
        one_way = getattr(fn, "__orleans_one_way__", False)
        interleave = getattr(fn, "__orleans_always_interleave__", False)
        gtype = grain_type_of(grain_class)
        iface = grain_class.__name__
        if (self.outgoing_call_filters or self.tracer is not None
                or RequestContext.get(TXN_KEY) is not None):
            return [self.send_request(
                target_grain=GrainId.for_grain(gtype, key),
                grain_class=grain_class, interface_name=iface,
                method_name=method_name, args=(), kwargs=kwargs,
                is_read_only=read_only, is_always_interleave=interleave,
                is_one_way=one_way, timeout=timeout)
                for key, kwargs in calls]
        timeout = self.response_timeout if timeout is None else timeout
        deadline = (time.monotonic() + timeout) if timeout else None
        sender = current_activation.get()
        chain = build_call_chain(sender)
        req_ctx = RequestContext.export()
        version = getattr(grain_class, "__orleans_version__", 0)
        send_silo = self.silo_address
        s_grain = sender.grain_id if sender else None
        s_act = sender.activation_id if sender else None
        direction = Direction.ONE_WAY if one_way else Direction.REQUEST
        loop = None if one_way else asyncio.get_running_loop()
        msgs: list[Message] = []
        out: list = []
        for key, kwargs in calls:
            msg = make_request_fast(
                Category.APPLICATION, direction, send_silo,
                s_grain, s_act, None, GrainId.for_grain(gtype, key),
                iface, method_name, copy_call_body((), kwargs),
                deadline, chain, read_only, interleave, req_ctx, version)
            msgs.append(msg)
            if one_way:
                out.append(None)
            else:
                fut = loop.create_future()
                self.callbacks[msg.id] = _fresh_callback(
                    msg, fut, deadline, None)
                out.append(fut)
        if not one_way:
            self._ensure_sweeper()
        try:
            self.transmit_batch(msgs)
        except BaseException:
            # transmit_batch's contract: it only raises while provably
            # NOTHING was handed off (partial failures are isolated
            # per-slice via _fail_transmit and not re-raised), so
            # unregistering every callback here is safe
            for m in msgs:
                self.callbacks.pop(m.id, None)
            raise
        return out

    # -- bulk-population collectives (MapReduce over actors) -------------
    _bulk_seq = 0

    def _bulk_request(self, grain_class: type, bulk_method: str,
                      spec: dict, timeout: float | None = None):
        """One APPLICATION request carrying a whole population-wide
        collective: the receiving silo anchors it (dispatcher
        ``BULK_METHODS``) — fan-out to peers, device-tier execution, and
        the combine all happen silo-side, so the CLIENT side of a
        million-actor operation is exactly one envelope + one response.
        The anchor key is SALTED per request: any silo can anchor by
        design, and a constant key would hash every bulk op for a class
        onto one gateway — concentrating the partition/combine work on
        one silo while the rest idle."""
        from .grain import grain_type_of
        self._bulk_seq += 1
        gid = GrainId.for_grain(grain_type_of(grain_class),
                                f"__bulk__{self._bulk_seq}")
        return self.send_request(
            target_grain=gid, grain_class=grain_class,
            interface_name=grain_class.__name__, method_name=bulk_method,
            args=(), kwargs={"spec": spec}, timeout=timeout)

    async def map_actors(self, grain_class: type, method: str,
                         kwargs: dict | None = None, keys=None,
                         timeout: float | None = None) -> int:
        """Apply one device-tier method (one broadcast kwargs row) to
        every live activation of ``grain_class`` — or an explicit key
        subset — as single-dispatch bulk ticks. Returns the number of
        activations applied across the cluster."""
        spec: dict = {"method": method, "kwargs": kwargs or {}}
        if keys is not None:
            spec["keys"] = list(keys) if not hasattr(keys, "tolist") \
                else keys
        if timeout is not None:
            spec["timeout"] = timeout  # anchor extends it to peer legs
        return await self._bulk_request(grain_class, "__bulk_map__",
                                        spec, timeout)

    async def reduce_actors(self, grain_class: type, method: str,
                            kwargs: dict | None = None, keys=None,
                            combine: str = "sum",
                            timeout: float | None = None):
        """Run a device-tier method over the population and reduce the
        per-actor results on device + across silos: ONE row crosses each
        host boundary (and each silo boundary) instead of N responses.
        ``combine``: "sum" | "max" | "min" | "mean". Returns the reduced
        result pytree (None when no live actor matched)."""
        spec: dict = {"method": method, "kwargs": kwargs or {},
                      "combine": combine}
        if keys is not None:
            spec["keys"] = list(keys) if not hasattr(keys, "tolist") \
                else keys
        if timeout is not None:
            spec["timeout"] = timeout
        r = await self._bulk_request(grain_class, "__bulk_reduce__",
                                     spec, timeout)
        return r["value"]

    async def broadcast_actors(self, grain_class: type, method: str,
                               targets, args: dict | None = None,
                               timeout: float | None = None) -> int:
        """Edge-list fan-out: deliver ``method`` to ``targets[i]`` with
        per-edge payload ``args[f][i]`` (scalars broadcast) — the
        celebrity-post multicast as ONE client envelope, partitioned by
        the anchor silo into one envelope per owning silo and scattered
        into target rows as device collectives. Returns edges
        delivered."""
        spec: dict = {"method": method, "targets": targets,
                      "args": args or {}}
        if timeout is not None:
            spec["timeout"] = timeout
        return await self._bulk_request(grain_class, "__bulk_broadcast__",
                                        spec, timeout)

    # server-armed join lease: the anchor polls locally this long per
    # watch envelope. Capped WELL under the 30s response timeout so a
    # watch answer (met or honest expiry) always beats the RPC deadline
    _JOIN_LEASE = 10.0

    async def join_when(self, grain_class: type, keys, k: int | None = None,
                        *, method: str, kwargs: dict | None = None,
                        timeout: float | None = None,
                        poll: float = 0.02, server: bool = True) -> int:
        """Readiness-mask join (join-calculus style): resolve when at
        least ``k`` of ``keys`` (default: all) report ready through
        ``method`` — a read-only actor method returning 0/1.

        Default (``server=True``): the client registers a readiness
        WATCH — one ``__bulk_join__`` envelope arms the anchor's poll
        reduction for a lease and the answer comes back once (met, or
        an honest lease expiry the client re-arms after). A K-poll wait
        costs ceil(wait/lease) client envelopes instead of K — the
        long-poll of the ROADMAP carry-over. ``server=False`` restores
        the per-poll client loop (one reduce_actors envelope per poll).
        Returns the ready count."""
        keys = list(keys)
        need = len(keys) if k is None else int(k)
        if not server:
            # the poll loop is the engine's (ONE readiness semantics
            # for both surfaces); imported lazily — only vector-facing
            # callers pull the dispatch stack into a client process
            from ..dispatch.engine import join_poll
            return await join_poll(
                lambda: self.reduce_actors(grain_class, method, kwargs,
                                           keys=keys, combine="sum"),
                need, timeout, poll)
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout
        ready = 0
        while True:
            remaining = None if deadline is None \
                else deadline - loop.time()
            if remaining is not None and remaining <= 0:
                raise asyncio.TimeoutError(
                    f"join_when: {ready}/{need} ready after {timeout}s")
            lease = self._JOIN_LEASE if remaining is None \
                else max(0.05, min(self._JOIN_LEASE, remaining))
            spec: dict = {"method": method, "kwargs": kwargs or {},
                          "keys": keys, "need": need, "poll": poll,
                          "lease": lease}
            r = await self._bulk_request(grain_class, "__bulk_join__",
                                         spec, timeout=lease + 15.0)
            ready = int(r.get("ready", 0))
            if r.get("met"):
                return ready

    # -- request path (SendRequest) --------------------------------------
    def send_request(self, *, target_grain: GrainId, grain_class: type,
                     interface_name: str, method_name: str,
                     args: tuple, kwargs: dict,
                     is_read_only: bool = False,
                     is_always_interleave: bool = False,
                     is_one_way: bool = False,
                     timeout: float | None = None,
                     target_silo: SiloAddress | None = None,
                     category=None):
        # filters wrap APPLICATION grain calls only: system/ping traffic
        # (membership probes, directory RPCs) must not be interceptable —
        # a user short-circuit filter would otherwise fail probes and get
        # healthy silos declared dead
        if self.outgoing_call_filters and (
                category is None or category == Category.APPLICATION):
            from .filters import OutgoingCallContext, run_call_chain

            # copy-isolate NOW, in the caller's turn: the chain runs in a
            # later task, and caller mutations between send and task start
            # must not leak into the callee (the same invariant the
            # unfiltered path gets from deep_copy at make_request time)
            args, kwargs = deep_copy((args, kwargs))

            async def terminal(c):
                res = self._send_request_unfiltered(
                    target_grain=target_grain, grain_class=grain_class,
                    interface_name=c.interface_name,
                    method_name=c.method_name,
                    args=tuple(c.args), kwargs=dict(c.kwargs),
                    is_read_only=is_read_only,
                    is_always_interleave=is_always_interleave,
                    is_one_way=is_one_way, timeout=timeout,
                    target_silo=target_silo, category=category,
                    body_precopied=True)
                return None if res is None else await res

            ctx = OutgoingCallContext(
                list(self.outgoing_call_filters), terminal,
                grain_class=grain_class, target_grain=target_grain,
                interface_name=interface_name, method_name=method_name,
                args=args, kwargs=kwargs)

            async def bounded_chain():
                # the whole chain — filters AND the call they wrap — runs
                # under the response timeout: a stalled filter must fail
                # like a stalled silo would, not wedge the caller's turn
                budget = self.response_timeout if timeout is None else timeout
                try:
                    return await asyncio.wait_for(
                        run_call_chain(ctx), budget or None)
                except asyncio.TimeoutError:
                    raise GrainCallTimeoutError(
                        f"{interface_name}.{method_name} outgoing filter "
                        f"chain timed out after {budget}s") from None

            # the task copies the caller's context NOW, so the sender
            # activation / RequestContext seen inside the chain (and by
            # the eventual unfiltered send) is the caller's
            task = asyncio.ensure_future(bounded_chain())
            if not is_one_way:
                return task
            # fire-and-forget: retain the task (weakly-held loop refs) and
            # surface filter errors in the log — there is no caller future
            self._filter_tasks.add(task)

            def _done(t: asyncio.Task) -> None:
                self._filter_tasks.discard(t)
                if not t.cancelled() and t.exception() is not None:
                    log.error("outgoing filter chain failed for one-way "
                              "%s.%s", interface_name, method_name,
                              exc_info=t.exception())

            task.add_done_callback(_done)
            return None
        return self._send_request_unfiltered(
            target_grain=target_grain, grain_class=grain_class,
            interface_name=interface_name, method_name=method_name,
            args=args, kwargs=kwargs, is_read_only=is_read_only,
            is_always_interleave=is_always_interleave,
            is_one_way=is_one_way, timeout=timeout,
            target_silo=target_silo, category=category)

    def _send_request_unfiltered(self, *, target_grain: GrainId,
                                 grain_class: type,
                                 interface_name: str, method_name: str,
                                 args: tuple, kwargs: dict,
                                 is_read_only: bool = False,
                                 is_always_interleave: bool = False,
                                 is_one_way: bool = False,
                                 timeout: float | None = None,
                                 target_silo: SiloAddress | None = None,
                                 category=None,
                                 body_precopied: bool = False):
        timeout = self.response_timeout if timeout is None else timeout
        sender = current_activation.get()
        call_chain: tuple[GrainId, ...] = build_call_chain(sender)
        # record call targets on any cancellation-token argument so
        # source.cancel() can reach remote twins (the reference's
        # _targetGrainReferences bookkeeping)
        register_outgoing_tokens(self, target_grain, grain_class,
                                 args, kwargs)
        # client span (the ActivityId-correlation upgrade): the ROOT of a
        # trace rolls head-based sampling here; unsampled calls carry no
        # header and pay only this None/ContextVar check. SYSTEM traffic
        # never roots a trace (membership probes would spam the buffer)
        # but joins an ambient sampled one — so a traced app call's
        # directory RPC shows up as a child "directory" span.
        req_ctx = RequestContext.export()
        span = None
        tracer = self.tracer
        if tracer is not None:
            tctx = current_trace.get()
            if tctx is not None:
                trace_id, parent_id = tctx
            elif (category is None or category == Category.APPLICATION) \
                    and tracer.consume_head_roll():
                # consume_head_roll honors a die already rolled by the hot
                # lane this synchronous step (the lane falls back to this
                # path on the sampled minority), else rolls here
                trace_id, parent_id = tracer.new_trace_id(), None
            else:
                trace_id = None
            if trace_id is not None:
                span = tracer.open(
                    f"{interface_name}.{method_name}",
                    "directory" if interface_name == "DirectoryTarget"
                    else "client",
                    trace_id, parent_id)
                if parent_id is None:
                    # fresh root: timer/reminder/stream-triggered work
                    # carries its ARMING context as a span link, so the
                    # new trace shows causality to the trace that armed
                    # it without the two merging
                    link = pending_root_link.get()
                    if link is not None:
                        span.links = [tuple(link)]
                req_ctx = dict(req_ctx) if req_ctx else {}
                req_ctx[TRACE_KEY] = (trace_id, span.span_id, span.start)
        # One clock read serves both the caller-side callback deadline and
        # the server-side expiry stamp (the message previously stamped its
        # own — a second monotonic read per call, ~2% in the r5
        # attribution). Server-side expiry semantics are unchanged: a
        # request that outlives its timeout while queued is still dropped
        # by the dispatcher, preserving the at-most-once story for
        # timed-out-and-retried callers.
        deadline = (time.monotonic() + timeout) if timeout else None
        # Copy-isolate arguments at send time (SerializationManager.DeepCopy
        # for in-silo calls): caller mutations after the call cannot leak into
        # the callee. Immutable-wrapped args pass by reference.
        msg = make_request_fast(
            category if category is not None else Category.APPLICATION,
            Direction.ONE_WAY if is_one_way else Direction.REQUEST,
            self.silo_address,
            sender.grain_id if sender else None,
            sender.activation_id if sender else None,
            target_silo, target_grain, interface_name, method_name,
            # filtered sends already copy-isolated at send_request time;
            # copying twice would double serialization on the hot path
            (args, kwargs) if body_precopied
            else copy_call_body(args, kwargs),
            deadline,
            call_chain, is_read_only, is_always_interleave,
            req_ctx,
            getattr(grain_class, "__orleans_version__", 0),
        )
        if span is None:
            return self._send(msg, is_one_way, deadline)
        # addressing work triggered inside transmit (directory lookups,
        # placement) runs in tasks that copy the context NOW — parent them
        # under this call's span, then restore the caller's ambient trace
        token = current_trace.set((span.trace_id, span.span_id))
        try:
            res = self._send(msg, is_one_way, deadline, span)
        except BaseException as e:
            tracer.close(span, error=type(e).__name__)
            raise
        finally:
            current_trace.reset(token)
        if res is None:  # one-way: the span covers the local send only
            tracer.close(span, one_way=True)
            return None
        return _finish_span_after(tracer, span, res)

    def _send(self, msg: Message, is_one_way: bool,
              deadline: float | None, span=None):
        if is_one_way:
            self.transmit(msg)
            return None
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        self.callbacks[msg.id] = _fresh_callback(
            msg, future, deadline, RequestContext.get(TXN_KEY), span)
        self._ensure_sweeper()
        try:
            self.transmit(msg)
        except BaseException:
            self.callbacks.pop(msg.id, None)
            raise
        return self._await_response(future)

    async def _await_response(self, future: asyncio.Future):
        """Await the response with a once-per-RPC fairness yield.

        Responses resolve synchronously (receive_response), so with inline
        delivery + eager turns a whole RPC can complete before the caller
        first awaits and an await on a done future never suspends — tight
        call loops would then starve every background task (membership
        refresh, reminder ticks). Yielding here when the future is already
        done guarantees each RPC crosses the event loop exactly once, like
        a real wire hop — and exactly once, not twice, which is what the
        previous call_soon-deferred resolution cost (resolve callback +
        waiter wakeup were two separate loop iterations per call)."""
        if future.done():
            await asyncio.sleep(0)
            # non-blocking by construction: the done() check above ran
            # before the only await, and a done future cannot un-done
            return future.result()  # otpu: ignore[OTPU002]
        return await future

    # -- response path (ReceiveResponse:569-627) --------------------------
    def receive_response(self, msg: Message) -> None:
        cb = self.callbacks.pop(msg.id, None)
        if cb is None:
            log.debug("dropping late/unknown response %s", msg.id)
            # a late response's envelope is dead on arrival (its request's
            # entry already timed out/broke); the request shell itself is
            # NOT recycled on those paths — its turn may still be running
            recycle_message(msg)
            return
        if cb.future.done():
            # timed out / broken while in flight: the caller is gone and
            # this response envelope is dead on arrival — same recycle
            # rationale as the late/unknown path above. The REQUEST shell
            # stays out of the pool (its turn may still be running).
            _recycle_callback(cb)
            recycle_message(msg)
            return
        if _msg_mod._DEBUG_POOL and cb.gen is not None:
            # pool poisoning: the request shell registered with this
            # callback must not have been recycled (and possibly handed to
            # another call) while the RPC was outstanding — the dynamic
            # twin of OTPU001's static proof
            _msg_mod.assert_generation(cb.message, cb.gen,
                                       "RuntimeClient.receive_response")
        if self.tracer is not None and msg.request_context is not None:
            # response-leg network span: the server stamped the response
            # header at send (dispatcher._run_turn) — without this the
            # breakdown only sees the request leg and return-path latency
            # hides in the client-span remainder. Parented under the
            # server turn span (the sending side), like the request leg
            # parents under the client span.
            hdr = context_from_headers(msg.request_context)
            if hdr is not None:
                self.tracer.record(hdr[0], hdr[1], "network", "network",
                                   hdr[2], time.time() - hdr[2],
                                   leg="response")
        # fold callee transaction joins back into the caller's ambient
        # info (the TransactionInfo response-header merge; idempotent for
        # the in-proc shared-object case)
        if cb.txn_info is not None and msg.transaction_info is not None:
            tid, participants = msg.transaction_info
            if tid == cb.txn_info.id:
                cb.txn_info.merge(participants)
        if msg.response_kind == ResponseKind.SUCCESS:
            # synchronous resolve: the once-per-RPC fairness yield lives in
            # _await_response, so resolution itself need not burn an extra
            # event-loop iteration per call
            _resolve_future(cb.future, msg.body, None)
            # settled for good: both envelopes and the callback entry are
            # provably dereferenced now — the ONLY frames still holding the
            # request are synchronous callers up-stack (the in-proc server's
            # _run_turn finally block), which finish their reads before any
            # pool re-acquire can run on this event loop
            request = cb.message
            _recycle_callback(cb)
            recycle_message(request)
            recycle_message(msg)
        elif msg.response_kind == ResponseKind.ERROR:
            exc = msg.body if isinstance(msg.body, BaseException) else \
                RejectionError(str(msg.body))
            _resolve_future(cb.future, None, exc)
            request = cb.message
            _recycle_callback(cb)
            recycle_message(request)
            recycle_message(msg)
        else:  # rejection — transparently resend transient rejections
            # GATEWAY_TOO_BUSY is retryable: the resend re-picks a gateway
            # (the reference's client reroutes around overloaded gateways)
            if cb.span is not None and msg.rejection_type is not None:
                # span event on the still-open client invoke span: the
                # rejection (and any resend below) is part of THIS call's
                # story — without it the retry backoff reads as opaque
                # client-span time and tail-retained slow traces can't
                # show why they were slow
                cb.span.add_event(
                    "rejected", rejection=msg.rejection_type.name,
                    info=msg.rejection_info or "",
                    resend_count=cb.message.resend_count)
            if (msg.rejection_type is not None
                    and cb.message.target_grain is not None
                    and cb.message.target_grain.is_system_target()):
                # system targets are silo-bound by construction: when the
                # pinned silo is gone, re-addressing would place the id as
                # an ordinary grain and bounce to the forward limit —
                # break the caller instead (the reference's
                # BreakOutstandingMessagesToDeadSilo for pinned targets)
                _resolve_future(cb.future, None, SiloUnavailableError(
                    msg.rejection_info or "system target unreachable"))
                # terminal rejection: the callback entry left the registry
                # for good (popped above), so its shell and the rejection
                # envelope go back to the freelists. The REQUEST shell is
                # NOT recycled: on the in-proc path the rejecting silo's
                # _reject frames may still be up-stack holding it, and
                # rejections are rare enough that GC is fine.
                _recycle_callback(cb)
                recycle_message(msg)
                return
            if (msg.rejection_type is not None
                    and cb.message.resend_count < MAX_RESEND_COUNT
                    and msg.rejection_type.name in (
                        "TRANSIENT", "CACHE_INVALIDATION",
                        "GATEWAY_TOO_BUSY")):
                cb.message.resend_count += 1
                cb.message.target_silo = None  # re-address from scratch
                cb.message.target_activation = None
                self.callbacks[msg.id] = cb
                if cb.span is not None:
                    cb.span.add_event(
                        "resend", rejection=msg.rejection_type.name,
                        resend_count=cb.message.resend_count)
                # back off before re-addressing: transient rejections during
                # silo death need the directory/membership view a moment to
                # converge before the retry can land elsewhere. Jittered —
                # a shed burst retried on a synchronized schedule arrives as
                # the same burst and sheds again (thundering herd).
                delay = 0.05 * (2 ** cb.message.resend_count) * \
                    (0.5 + random.random())

                def _resend(mid=msg.id, m=cb.message):
                    if mid in self.callbacks:
                        if self.tracer is not None:
                            # the retry is a fresh hop: clear the arrival
                            # stamp and refresh the header's sent_at NOW
                            # (post-backoff) so the receiver's queue/
                            # network spans exclude the backoff — the
                            # client span still covers the whole call
                            from ..observability.tracing import \
                                restamp_header
                            m.received_at = None
                            m.request_context = restamp_header(
                                m.request_context)
                        self.transmit(m)

                asyncio.get_running_loop().call_later(delay, _resend)
                # the rejection envelope is dead once its fields were read
                # above (_resend closes over cb.message, not msg): under
                # rejection-retry storms this is the envelope churn the
                # freelist exists for
                recycle_message(msg)
                return
            if msg.rejection_type is not None and \
                    msg.rejection_type.name == "GATEWAY_TOO_BUSY":
                from ..core.errors import GatewayTooBusyError
                _resolve_future(cb.future, None, GatewayTooBusyError(
                    msg.rejection_info or "gateway overloaded"))
                _recycle_callback(cb)   # terminal: see system-target note
                recycle_message(msg)
                return
            _resolve_future(cb.future, None,
                            RejectionError(msg.rejection_info or "rejected"))
            _recycle_callback(cb)       # terminal: see system-target note
            recycle_message(msg)

    def deliver_batch(self, msgs: list) -> None:
        """Batched inbound delivery for clients (the gateway pump and the
        in-proc fabric hand one decoded/delivered group here): contiguous
        RESPONSE runs correlate via :meth:`receive_response_batch`, and
        anything else (observer notifications) takes the subclass's
        per-message ``deliver`` in arrival order. Only meaningful on
        client subclasses that define ``deliver``."""
        if not self.batched_egress:
            for m in msgs:
                self.deliver(m)  # type: ignore[attr-defined]
            return
        run: list | None = None
        for m in msgs:
            if m.direction == Direction.RESPONSE:
                if run is None:
                    run = []
                run.append(m)
                continue
            if run:
                self.receive_response_batch(run)
                run = None
            self.deliver(m)  # type: ignore[attr-defined]
        if run:
            self.receive_response_batch(run)

    def receive_response_batch(self, msgs: list) -> None:
        """Batched response correlation — the client-side leg of batched
        egress: N ``CallbackData`` lookups resolve in one pass and the
        common SUCCESS/ERROR terminals defer their freelist releases into
        ONE sweep per batch (request shell + response envelope each
        released exactly once, after every future has resolved), instead
        of per-message dict/recycle churn. Rejections (resend backoff,
        terminal-rejection bookkeeping) delegate to
        :meth:`receive_response`, which preserves their exact
        per-message semantics."""
        callbacks = self.callbacks
        tracer = self.tracer
        dead: list[Message] = []          # envelopes settled for good
        shells: list[CallbackData] = []   # callback shells to release
        for msg in msgs:
            kind = msg.response_kind
            if kind is not ResponseKind.SUCCESS and \
                    kind is not ResponseKind.ERROR:
                self.receive_response(msg)  # rejection machinery: rare
                continue
            cb = callbacks.pop(msg.id, None)
            if cb is None:
                log.debug("dropping late/unknown response %s", msg.id)
                # dead on arrival (see receive_response: the request
                # shell stays out — its turn may still be running)
                dead.append(msg)
                continue
            if cb.future.done():
                # timed out / broken while in flight: the envelope is
                # dead on arrival, the request shell stays out
                shells.append(cb)
                dead.append(msg)
                continue
            if _msg_mod._DEBUG_POOL and cb.gen is not None:
                _msg_mod.assert_generation(
                    cb.message, cb.gen,
                    "RuntimeClient.receive_response_batch")
            if tracer is not None and msg.request_context is not None:
                # response-leg network span: identical to the
                # per-message path — the server's send-side wall stamp
                # (_stamp_response) rides the batched wire unchanged
                hdr = context_from_headers(msg.request_context)
                if hdr is not None:
                    tracer.record(hdr[0], hdr[1], "network", "network",
                                  hdr[2], time.time() - hdr[2],
                                  leg="response")
            if cb.txn_info is not None and msg.transaction_info is not None:
                tid, participants = msg.transaction_info
                if tid == cb.txn_info.id:
                    cb.txn_info.merge(participants)
            if kind is ResponseKind.SUCCESS:
                _resolve_future(cb.future, msg.body, None)
            else:
                exc = msg.body if isinstance(msg.body, BaseException) else \
                    RejectionError(str(msg.body))
                _resolve_future(cb.future, None, exc)
            # settled for good: same safety argument as receive_response
            # (waiter wakeups are call_soon-deferred, so only synchronous
            # callers up-stack still hold these and they finish their
            # reads before any pool re-acquire runs on this loop)
            dead.append(cb.message)
            dead.append(msg)
            shells.append(cb)
        if dead:
            recycle_messages(dead)
        for cb in shells:
            _recycle_callback(cb)

    def break_outstanding_to_dead_silo(self, silo: SiloAddress) -> None:
        """``BreakOutstandingMessagesToDeadSilo:726``."""
        for mid, cb in list(self.callbacks.items()):
            if cb.message.target_silo is not None and \
                    cb.message.target_silo.same_endpoint(silo):
                self.callbacks.pop(mid, None)
                if not cb.future.done():
                    cb.future.set_exception(SiloUnavailableError(
                        f"silo {silo} declared dead with request in flight"))
                    # suppress "exception never retrieved" if nobody awaits
                    cb.future.exception()
                # the request envelope is NOT recycled: a dead-silo verdict
                # says nothing about whether its turn still runs somewhere
                _recycle_callback(cb)

    # -- timeout sweep (CallbackData timer analog) -------------------------
    def _ensure_sweeper(self) -> None:
        if self._timeout_sweeper is None or self._timeout_sweeper.done():
            self._timeout_sweeper = asyncio.get_running_loop().create_task(
                self._sweep_timeouts())

    async def _sweep_timeouts(self) -> None:
        while self.callbacks:
            await asyncio.sleep(0.05)
            now = time.monotonic()
            for mid, cb in list(self.callbacks.items()):
                if cb.deadline is not None and now > cb.deadline:
                    self.callbacks.pop(mid, None)
                    if not cb.future.done():
                        cb.future.set_exception(GrainCallTimeoutError(
                            f"{cb.message.interface_name}.{cb.message.method_name} "
                            f"to {cb.message.target_grain} timed out"))
                    # request envelope NOT recycled: its turn may still be
                    # running server-side (in-proc it is the same object)
                    _recycle_callback(cb)
        self._timeout_sweeper = None

    def close(self) -> None:
        for cb in self.callbacks.values():
            if not cb.future.done():
                cb.future.set_exception(SiloUnavailableError("client closed"))
                cb.future.exception()  # mark retrieved; close is best-effort
            _recycle_callback(cb)
        self.callbacks.clear()
        if self._timeout_sweeper is not None:
            self._timeout_sweeper.cancel()
            self._timeout_sweeper = None
