"""Dispatcher: central message router for a silo.

Re-design of Orleans' src/Orleans.Runtime/Core/Dispatcher.cs:19 —
``ReceiveMessage:75``, ``ReceiveRequest:262``, ``ActivationMayAcceptRequest:313``,
``CheckDeadlock:364``, ``HandleIncomingRequest:399``, ``EnqueueRequest:431``,
``TryForwardRequest:526``, ``AsyncSendMessage:645``, ``AddressMessage:715``,
``SendResponse:769``, ``RunMessagePump:845`` — fused with the invoke engine of
``InsideRuntimeClient.Invoke:294-474``.

asyncio re-design notes: a "turn" is one request coroutine; the message pump
is event-driven (runs after every turn completion) rather than a dedicated
thread loop; forwarding/re-addressing reuses the same ``send_message`` path.

The port's copy of ``orleans_tpu.runtime.dispatcher``: the bulk
join's and the reduce finalizer's ``jax.tree_util`` walks are the
port engine's tree helpers (``_leaves``, ``_tree_map``, ``_tree_map2``);
a system-target request whose target is gone is rejected at once; and
batched gateway ingress for a device-tier key a peer owns is sent
straight to its ring owner, in arrival order
(:meth:`Dispatcher.receive_vector_batch`).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import TYPE_CHECKING

from ..core.errors import (
    GrainOverloadedError,
    NonExistentActivationError,
    TransientPlacementError,
)
from ..core import message as _msg_mod
from ..core.message import (
    Category,
    Direction,
    Message,
    RejectionType,
    make_error_response,
    make_rejection,
    make_response,
)
from ..observability.tracing import (
    TRACE_KEY,
    context_from_headers,
    current_trace,
    restamp_header,
)
from .cancellation import CANCEL_METHOD, maybe_intern_tokens
from .context import TXN_KEY
from ..core.serialization import copy_result
from .activation import ActivationData, ActivationState
from .context import RequestContext, current_activation

if TYPE_CHECKING:
    from .silo import Silo

log = logging.getLogger("orleans.dispatcher")

# default for _finish_vector_call's hdr: "not parsed yet" (None means a
# parse already happened and found no trace header)
_HDR_UNPARSED = object()

from ..observability.stats import INGEST_STATS as _INGEST  # noqa: E402
from ..observability.stats import SLO_STATS as _SLO  # noqa: E402

_QUEUE_WAIT = _INGEST["queue_wait"]
_TURNS = _INGEST["turns"]
_TURN_ERRORS = _SLO["turn_errors"]

MAX_FORWARD_COUNT = 2  # SiloMessagingOptions.MaxForwardCount default

# Bulk-population collective methods (MapReduce over actors): reserved
# method names carried by ordinary APPLICATION requests to a vector
# interface. Intercepted BEFORE per-key ring-ownership routing — any silo
# receiving one anchors the collective (fans ONE envelope per peer silo,
# never one per actor/edge) or, with spec["local"], executes its own
# partition. PING/SYSTEM QoS lanes are untouched: bulk traffic rides the
# APPLICATION category end to end.
BULK_METHODS = {
    "__bulk_map__": "map",
    "__bulk_reduce__": "reduce",
    "__bulk_broadcast__": "broadcast",
    # device-tier stream delivery (streams.device): one publish batch's
    # pre-stacked edge slice — broadcast semantics through stream_fanout
    "__stream_deliver__": "stream",
    # server-armed join_when watch: the anchor runs the poll reduction
    # locally for the lease and answers once (readiness met or lease
    # expiry) instead of the client emitting one envelope per poll
    "__bulk_join__": "join",
}

# op -> wire method name for anchor-fanned peer legs. NOT always the
# inbound msg.method_name: a join watch's nested reductions must reach
# peers as __bulk_reduce__, or every peer would arm its own watch.
_BULK_WIRE = {v: k for k, v in BULK_METHODS.items()}


class Dispatcher:
    def __init__(self, silo: "Silo"):
        self.silo = silo
        self.detect_deadlocks = silo.config.detect_deadlocks
        # ingest stage metrics (observability.stats.INGEST_STATS): the
        # silo's registry when metrics_enabled, else None — cached here so
        # the per-turn guard is one attribute load
        self._istats = silo.ingest_stats
        # per-(grain_class, method) call-site table (observability.stats.
        # CallSiteStats): the silo's table when metrics_enabled, else
        # None — fed in the turn epilogue, read by ctl_call_sites and
        # the SLO breach drill-down
        self._call_sites = silo.call_sites
        # cost-attribution ledger (observability.ledger): the silo's
        # ledger when ledger_enabled, else None — charged in the turn
        # epilogue (exec + queue-wait seconds per grain/method/key),
        # one attribute load per turn when off
        self._ledger = silo.ledger
        # host-loop occupancy profiler (observability.profiling): set by
        # Silo._install_loop_profiler when profiling_enabled, else None —
        # the per-turn guard is one attribute load
        self._loop_prof = None
        # batched response egress (runtime.egress.EgressBatcher): set by
        # the Silo ctor when batched_egress is on, else None —
        # send_response pays one attribute check on the per-message path
        self._egress = None
        # in-flight device-tier state recoveries: (class, key_hash) →
        # future; concurrent calls for one recovering key share the load
        self._vector_recoveries: dict = {}
        self._turn_count = 0
        # strong refs to every in-flight turn/addressing task: the event
        # loop holds tasks weakly, so an unreferenced turn can be GC'd
        # mid-await — its coroutine is then close()d in a foreign context
        # and the contextvar reset in the finally block raises. This is
        # the scheduler's owned-work-item discipline (WorkItemGroup.cs:12
        # owns its queued tasks); also what stop() drains.
        self._turn_tasks: set[asyncio.Task] = set()

    def _track(self, task: "asyncio.Task | asyncio.Future"):
        if task.done():
            # eager task factory ran it to completion inline: nothing to
            # retain, and skipping add_done_callback saves a call_soon
            # round per message. (Every tracked coroutine either catches
            # its own errors or has a result callback attached by the
            # caller, so no exception goes unretrieved.)
            return task
        self._turn_tasks.add(task)
        task.add_done_callback(self._turn_tasks.discard)
        return task

    async def drain_turns(self, timeout: float | None = None) -> None:
        """Wait for in-flight turns to finish; cancel stragglers after
        ``timeout``. Called on graceful silo stop so no turn outlives the
        runtime that its response path needs."""
        pending = [t for t in self._turn_tasks if not t.done()]
        if not pending:
            return
        done, still = await asyncio.wait(pending, timeout=timeout)
        for t in still:
            t.cancel()
        if still:
            await asyncio.gather(*still, return_exceptions=True)

    def cancel_turns(self) -> None:
        """Abandon all in-flight turns (ungraceful kill)."""
        for t in list(self._turn_tasks):
            t.cancel()

    # ==================================================================
    # Receive path
    # ==================================================================
    def receive_message(self, msg: Message) -> None:
        """Entry for every message arriving at this silo (ReceiveMessage:75)."""
        if msg.direction == Direction.RESPONSE:
            self.silo.runtime_client.receive_response(msg)
            return
        if msg.received_at is None and (self.silo.tracer is not None
                                        or self._istats is not None
                                        or self.silo.shed_trend is not None):
            # arrival stamp for queue-wait attribution (covers the
            # loopback path; fabric arrivals are stamped at deliver)
            msg.received_at = time.monotonic()
        vcls = self.silo.vector_interfaces.get(msg.interface_name)
        if vcls is not None:
            # device-tier interface: the north-star interception — instead
            # of a per-message activation turn, the call joins the vector
            # runtime's current tick and runs inside a batched kernel
            # (concurrent requests to one class coalesce automatically)
            self._handle_vector_request(vcls, msg)
            return
        if self.silo.gsi is not None and \
                not self.silo.catalog.by_grain.get(msg.target_grain):
            cls = self.silo.registry.resolve(msg.interface_name)
            if cls is not None and getattr(
                    cls, "__orleans_global_single_instance__", False):
                # global-single-instance grain with no local activation:
                # acquire cluster ownership first; calls for grains owned
                # by another cluster forward to its gateway
                # (GSI protocol + return-to-origin, Dispatcher.cs:534-546)
                self._track(asyncio.ensure_future(self._gsi_route(msg)))
                return
        self._receive_local(msg)

    def _receive_local(self, msg: Message) -> None:
        if msg.method_name == CANCEL_METHOD and \
                msg.direction != Direction.RESPONSE:
            # grain cancellation fan-in (GrainCancellationTokenRuntime →
            # CancellationSourcesExtension.CancelRemoteToken): per-silo,
            # handled BEFORE activation lookup — a cancel for a grain
            # whose activation aged out must not resurrect it just to
            # touch the silo interner
            self.silo.cancellation_tokens.fire(msg.body[0][0])
            if msg.direction == Direction.REQUEST:
                self.send_response(msg, make_response(msg, None))
            return
        try:
            activation = self.silo.catalog.get_or_create_activation(msg)
        except NonExistentActivationError as e:
            # heal any directory entry that routed this message here
            # (UnregisterAfterNonexistingActivation, Catalog.cs:29), THEN
            # forward — re-addressing before the owner drops the stale
            # entry would just bounce back here
            reason = str(e)  # `e` unbinds when the except block exits
            heal = getattr(self.silo.locator,
                           "unregister_after_nonexistent", None)
            if heal is None or msg.target_grain.is_system_target():
                # a system target is in no directory: nothing to heal
                self._reject_or_forward(msg, reason)
                return

            async def heal_then_forward() -> None:
                await heal(msg.target_grain)
                self._reject_or_forward(msg, reason)

            self._track(asyncio.ensure_future(heal_then_forward()))
            return
        except Exception as e:  # placement/registration failure
            self._reject(msg, RejectionType.TRANSIENT, f"activation failed: {e}")
            return
        if activation.state == ActivationState.ACTIVATING:
            # queue behind OnActivate (Catalog.cs:487-502 dummy-activation
            # queue) — bounded by the same overload limit as the mailbox
            if len(activation.activating_backlog) >= activation.max_enqueued:
                self._reject(msg, RejectionType.OVERLOADED,
                             f"{activation.grain_id} activating backlog full")
                return
            activation.activating_backlog.append(msg)
            return
        if activation.state == ActivationState.DEACTIVATING:
            # park behind the deactivation: the catalog re-dispatches the
            # waiting queue once the activation is destroyed AND its
            # directory entry removed (Catalog.cs:780-917). Forwarding
            # now would re-address against a registration that still
            # points here and bounce to the forward limit. The mailbox
            # bound still applies — a stuck on_deactivate must not grow
            # the queue without limit.
            if len(activation.waiting) >= activation.max_enqueued:
                self._reject(msg, RejectionType.OVERLOADED,
                             f"{activation.grain_id} deactivating with "
                             "full mailbox")
                return
            activation.waiting.append(msg)
            return
        if activation.state == ActivationState.INVALID:
            self._reject_or_forward(msg, "activation invalid")
            return
        self.receive_request(activation, msg)

    async def _gsi_route(self, msg: Message) -> None:
        """Resolve cluster-level ownership for a GSI grain, then either
        handle locally (we own / own-with-doubt) or forward to the owner
        cluster's gateway and relay the response."""
        gsi = self.silo.gsi
        try:
            state, owner = await gsi.acquire(msg.target_grain)
        except Exception as e:  # noqa: BLE001 — registrar unreachable
            self._reject(msg, RejectionType.TRANSIENT,
                         f"GSI ownership unresolved: {e}")
            return
        if owner == gsi.cluster_id:
            self._receive_local(msg)    # we own: ordinary activation path
            return
        from ..core.errors import GrainCallTimeoutError, SiloUnavailableError
        try:
            result = await gsi.forward_call(owner, msg)
        except asyncio.CancelledError:
            raise  # silo stop cancelled the forward: no bogus response
        except (ConnectionError, OSError, SiloUnavailableError,
                GrainCallTimeoutError) as e:
            # transport failure: transient — the resend retries, and the
            # maintainer may flip us to Doubtful-owner later
            self._reject(msg, RejectionType.TRANSIENT,
                         f"GSI forward to {owner} failed: {e}")
            return
        except BaseException as e:  # noqa: BLE001 — the remote grain
            # raised: an application error, NOT retryable — relay it
            if msg.direction == Direction.REQUEST:
                self.send_response(msg, make_error_response(msg, e))
            return
        if msg.direction == Direction.REQUEST:
            self.send_response(msg, make_response(msg, result))

    def _handle_vector_request(self, vcls: type, msg: Message) -> None:
        """Bridge a host-tier message onto the device tier (the
        Orleans.Runtime.TpuDispatch provider of the north-star design):
        key → slot, kwargs → batch lane, future resolves after the tick
        that ran the kernel."""
        rt = self.silo.vector
        if msg.is_expired:
            log.warning("dropping expired vector request %s", msg.method_name)
            return
        proxy = getattr(rt, "is_shm_proxy", False)
        if msg.method_name in BULK_METHODS:
            if proxy:
                # worker process: population-wide ops anchor where the
                # engine lives — re-address to the owner silo over the
                # normal wire (bulk ops carry their own peer fan-out;
                # the staging ring is for per-key call batches)
                msg.target_silo = rt.owner_address
                self.transmit(msg)
                return
            # population-wide collective: no single target key, so the
            # per-key ownership forward below must not see it — the
            # receiving silo anchors (or runs its partition of) the op
            self._handle_vector_bulk(vcls, msg)
            return
        # (no queue-wait observe here: vector requests record it in the
        # engine, enqueue -> batch start, so only the OWNING silo's tick
        # counts it — a forwarded/rejected hop must not add samples)
        # single-owner routing: device-tier state for a key lives in ONE
        # silo's table (the single-activation constraint); ring ownership
        # decides which, exactly like directory partitioning. Forward-count
        # bound prevents ping-pong during membership transitions. A shm
        # proxy skips the forward outright: every call from a worker
        # process funnels over the staging ring into the ONE owner-process
        # engine, so the constraint holds by topology, not by routing.
        if not proxy:
            owner = self.silo.locator.ring.owner(
                msg.target_grain.uniform_hash)
            if owner is not None and owner != self.silo.silo_address:
                if msg.forward_count >= MAX_FORWARD_COUNT:
                    # never execute on a non-owner: that would mint a
                    # second divergent copy of the key's device state.
                    # Reject so the caller retries against a converged
                    # membership view.
                    self._reject(msg, RejectionType.TRANSIENT,
                                 f"vector owner unresolved after "
                                 f"{msg.forward_count} forwards")
                    return
                msg.forward_count += 1
                msg.target_silo = owner
                self.transmit(msg)
                return
        try:
            args, kwargs = msg.body if msg.body is not None else ((), {})
            if args:
                raise TypeError(
                    f"vector grain methods take keyword arguments only "
                    f"(schema-bound); got {len(args)} positional")
            key_hash = rt.key_hash_for(msg.target_grain.key,
                                       msg.target_grain.uniform_hash)
            # record the routing hash so ownership sweeps can re-derive
            # who owns this resident row after a membership change
            rt.table(vcls).note_route(key_hash,
                                      msg.target_grain.uniform_hash)
            bridge = getattr(self.silo, "vector_bridges", {}).get(vcls)
            if bridge is not None and \
                    self._vector_key_is_fresh(rt, vcls, key_hash):
                # virtual-actor recovery (Catalog.cs:443 +
                # StateStorageBridge.cs:49 on the device tier): this silo
                # became the key's ring owner without its state — e.g.
                # after the previous owner died — so rehydrate the row
                # from write-behind storage before the first kernel tick
                # touches it. Keys with no stored state proceed fresh
                # (the lazy-recreate contract).
                fut = self._track(asyncio.ensure_future(
                    self._recover_then_call(
                        rt, vcls, bridge, key_hash, msg.method_name, kwargs)))
            else:
                fut = rt.call(vcls, key_hash, msg.method_name, **kwargs)
        except Exception as e:  # noqa: BLE001 — schema/arg errors → caller
            if msg.direction != Direction.ONE_WAY:
                self.send_response(msg, make_error_response(msg, e))
            return
        self._finish_vector_call(msg, fut)

    def _finish_vector_call(self, msg: Message, fut: "asyncio.Future",
                            hdr=_HDR_UNPARSED) -> None:
        """Attach the response plumbing for one device-tier call: the
        device span (host view of the batched kernel turn) and the
        tick-resolved response callback. Shared by the per-message bridge
        and the batched ingress path (receive_vector_batch, which hands
        in the trace header it already parsed for the want-future
        decision)."""
        tracer = self.silo.tracer
        vspan = None
        if tracer is not None:
            if hdr is _HDR_UNPARSED:
                hdr = context_from_headers(msg.request_context)
            if hdr is not None:
                # request-leg network span (host-path twin): the
                # client's send-side wall stamp → here, so the traced
                # waterfall has no dark gap between the client root and
                # the first silo-side span (under worker
                # processes the next span is the shm staging-ring leg)
                tracer.record(hdr[0], hdr[1], "network", "network",
                              hdr[2], time.time() - hdr[2])
                # device span: enqueue → tick-resolved future (the host
                # view of the batched kernel turn; the engine's own tick
                # spans + TraceAnnotation carry the per-tick detail)
                vspan = tracer.open(
                    f"{msg.interface_name}.{msg.method_name}", "device",
                    hdr[0], hdr[1])
                fut.add_done_callback(lambda f, s=vspan: tracer.close(s))
        if msg.direction == Direction.ONE_WAY:
            # retrieve a failed tick's exception so the loop never logs
            # "exception was never retrieved" for fire-and-forget calls
            fut.add_done_callback(
                lambda f: None if f.cancelled() else f.exception())
            return

        def done(f: "asyncio.Future") -> None:
            if f.cancelled():
                return
            exc = f.exception()
            if exc is not None:
                resp = make_error_response(msg, exc)
            else:
                resp = make_response(msg, f.result())
            if vspan is not None:
                # response-leg wall stamp, as on host turns: the client
                # measures stamp → arrival as the response network span
                # (under worker processes this stamp lands right after
                # the response-ring pop, so the waterfall's tail —
                # egress encode + wire — is covered too)
                self._stamp_response(resp, vspan)
            self.send_response(msg, resp)

        fut.add_done_callback(done)

    def receive_vector_batch(self, vcls: type, msgs: list) -> None:
        """Batched twin of :meth:`_handle_vector_request`: one ingress
        batch's calls for a device-tier class join the engine as grouped
        per-method enqueues (``VectorRuntime.call_group``) — one method/
        table resolution and ONE tick schedule for N messages instead of
        N ``rt.call`` hops. This is the queue-wait killer on the vector
        path: the whole socket read's calls land in the same tick batch.
        Messages needing the slow path (ownership forward, storage
        recovery, malformed bodies) peel off to the per-message handler,
        which preserves their exact semantics."""
        rt = self.silo.vector
        my_addr = self.silo.silo_address
        ring = self.silo.locator.ring
        # worker process (runtime.multiproc): no ownership forwards —
        # the staging ring funnels everything into the owner engine
        proxy = getattr(rt, "is_shm_proxy", False)
        bridge = getattr(self.silo, "vector_bridges", {}).get(vcls)
        tbl = rt.table(vcls)
        tracer = self.silo.tracer
        now = time.monotonic()
        groups: dict[str, list] = {}
        for msg in msgs:
            if msg.expires_at is not None and now > msg.expires_at:
                log.warning("dropping expired vector request %s",
                            msg.method_name)
                continue
            if msg.method_name in BULK_METHODS:
                if proxy:
                    # anchor where the engine lives (see
                    # _handle_vector_request)
                    msg.target_silo = rt.owner_address
                    self.transmit(msg)
                    continue
                # bulk collectives peel before the per-key ownership
                # check (they have no single target key to route by)
                self._handle_vector_bulk(vcls, msg)
                continue
            owner = None if proxy else \
                ring.owner(msg.target_grain.uniform_hash)
            if owner is not None and owner != my_addr:
                if msg.target_silo is None or msg.target_silo != my_addr:
                    # unaddressed gateway ingress: the ring owner IS the
                    # key's address, so send it there at once, in arrival
                    # order (no forward budget burned). Addressing it
                    # through send_message's directory lookup instead
                    # sent a key's first calls after an async directory
                    # hop and its later ones from the cache, so a later
                    # call could overtake an earlier one.
                    try:
                        msg.target_silo = owner
                        self.transmit(msg)
                    except Exception:  # noqa: BLE001 — one message only
                        log.exception("batched vector re-address failed "
                                      "for %s", msg.method_name)
                else:
                    # a peer deliberately addressed this HERE and our
                    # ring view disagrees — a real stale-view hop: the
                    # per-message handler's forward_count++/bound keeps
                    # split-view ping-pong finite (without it, two
                    # batched silos with crossed views would relay a
                    # message forever)
                    self._handle_vector_request(vcls, msg)
                continue
            try:
                args, kwargs = msg.body if msg.body is not None else ((), {})
                if args:
                    raise TypeError(
                        f"vector grain methods take keyword arguments only "
                        f"(schema-bound); got {len(args)} positional")
                if not isinstance(kwargs, dict):
                    # scope the bad payload HERE: a non-dict reaching
                    # call_group would raise outside its per-item guard
                    # and error-bounce the whole group
                    raise TypeError(
                        f"vector grain call body must carry a kwargs dict; "
                        f"got {type(kwargs).__name__}")
                key_hash = rt.key_hash_for(msg.target_grain.key,
                                           msg.target_grain.uniform_hash)
            except Exception as e:  # noqa: BLE001 — body shape → caller
                if msg.direction != Direction.ONE_WAY:
                    self.send_response(msg, make_error_response(msg, e))
                continue
            if bridge is not None and \
                    self._vector_key_is_fresh(rt, vcls, key_hash):
                # first touch with write-behind storage: recovery path
                self._handle_vector_request(vcls, msg)
                continue
            tbl.note_route(key_hash, msg.target_grain.uniform_hash)
            g = groups.get(msg.method_name)
            if g is None:
                g = groups[msg.method_name] = []
            # one-way calls need no result plumbing — the engine skips
            # their futures entirely. Exception: a SAMPLED one-way (trace
            # header present) still needs its device span closed at tick
            # resolution; the unsampled majority must not pay the
            # future/callback cost just because a tracer is installed.
            # Parsed once here and handed to _finish_vector_call below.
            hdr = (context_from_headers(msg.request_context)
                   if tracer is not None else None)
            want = msg.direction != Direction.ONE_WAY or hdr is not None
            g.append((msg, key_hash, kwargs, want, hdr))
        for method, items in groups.items():
            try:
                # per-item trace contexts ride beside the group: the
                # engine (or the shm proxy, in a worker process) parents
                # the device-tick span into each sampled request's trace
                # — hdr differs per message within one group, so it
                # threads per item, not per group
                traces = ([hdr[:2] if hdr is not None else None
                           for _, _, _, _, hdr in items]
                          if tracer is not None else None)
                futs = rt.call_group(vcls, method,
                                     [(kh, kw, w) for _, kh, kw, w, _ in
                                      items], traces=traces)
            except Exception as e:  # noqa: BLE001 — unknown method etc.
                # the whole group failed together: one egress flush per
                # destination instead of N per-message response hops
                self.send_response_batch(
                    (m, make_error_response(m, e))
                    for m, _, _, _, _ in items
                    if m.direction != Direction.ONE_WAY)
                continue
            for (m, _, _, _, hdr), fut in zip(items, futs):
                if fut is not None:
                    self._finish_vector_call(m, fut, hdr)

    # ==================================================================
    # Bulk-population collectives (MapReduce over actors): the host-tier
    # surface of VectorRuntime.map_actors/reduce_actors/broadcast_actors.
    # One client envelope reaches an anchor silo; the anchor fans ONE
    # envelope per peer silo (broadcast edges partitioned by ring
    # ownership, map/reduce key sets filtered at each silo), combines the
    # partials, and answers once — O(silos) envelopes end to end instead
    # of O(actors)/O(edges) messages.
    # ==================================================================
    def _handle_vector_bulk(self, vcls: type, msg: Message) -> None:
        try:
            _args, kwargs = msg.body if msg.body is not None else ((), {})
            spec = kwargs["spec"]
            if not isinstance(spec, dict) or "method" not in spec:
                raise TypeError(
                    "bulk collective body must carry a spec dict with "
                    "a 'method' field")
            # validate the target method exists up front so a typo fails
            # fast instead of after the peer fan-out
            self.silo.vector.method_of(vcls, spec["method"])
        except Exception as e:  # noqa: BLE001 — malformed spec → caller
            if msg.direction != Direction.ONE_WAY:
                self.send_response(msg, make_error_response(msg, e))
            return
        self.silo.stats.increment("vector.bulk.ops")
        self._track(asyncio.ensure_future(
            self._run_vector_bulk(vcls, msg, spec)))

    async def _run_vector_bulk(self, vcls: type, msg: Message,
                               spec: dict) -> None:
        op = BULK_METHODS[msg.method_name]
        try:
            if op == "join":
                # always anchored: the watch IS the anchor-side loop
                result = await self._vector_bulk_join(vcls, msg, spec)
            elif spec.get("local"):
                result = await self._vector_bulk_local(vcls, op, spec)
            else:
                result = await self._vector_bulk_anchor(vcls, msg, op,
                                                        spec)
        except asyncio.CancelledError:
            raise  # silo stop: the caller's future breaks via close()
        except BaseException as e:  # noqa: BLE001 — op errors → caller
            log.exception("bulk collective %s failed on %s",
                          msg.method_name, vcls.__name__)
            if msg.direction != Direction.ONE_WAY:
                self.send_response(msg, make_error_response(msg, e))
            return
        if msg.direction != Direction.ONE_WAY:
            self.send_response(msg, make_response(msg, result))

    def _bulk_owned_hashes(self, rt, vcls: type, keys):
        """Explicit bulk key list → the key-hash slice THIS silo's ring
        view owns (every silo receives the full list and applies its own
        partition — byte cost O(silos × keys), envelope cost O(silos)).
        Routing hashes are noted so ownership sweeps can re-range
        bulk-touched rows exactly like per-key traffic. Fast path: on a
        single-silo ring, dense-range int keys ARE their key hashes
        (``key_hash_for``) and dense rows are never ownership-swept, so
        the whole int subset vectorizes — no per-key GrainId work for
        the million-key populations this surface exists for. Multi-silo
        ownership needs the per-key uniform hash (vectorizing it is a
        ROADMAP follow-on)."""
        import numpy as np

        from ..core.ids import GrainId, GrainType
        ring = self.silo.locator.ring
        me = self.silo.silo_address
        multi = len(ring.silos) > 1
        tbl = rt.table(vcls)
        slow = list(keys)
        fast = np.zeros(0, dtype=np.int64)
        if not multi:
            arr = np.asarray(slow)
            if arr.dtype.kind in "iu":
                dense = (arr >= 0) & (arr < tbl.dense_n)
                fast = arr[dense].astype(np.int64)
                slow = arr[~dense].tolist()
        gtype = GrainType.of(vcls.__name__)
        out = []
        for k in slow:
            k = k.item() if hasattr(k, "item") else k
            gid = GrainId.for_grain(gtype, k)
            if multi and (ring.owner(gid.uniform_hash) or me) != me:
                continue
            kh = rt.key_hash_for(k, gid.uniform_hash)
            tbl.note_route(kh, gid.uniform_hash)
            out.append(kh)
        return np.concatenate([fast, np.asarray(out, dtype=np.int64)])

    async def _vector_bulk_local(self, vcls: type, op: str, spec: dict):
        """Execute this silo's partition of one bulk collective. Map/
        reduce key sets filter by ring ownership here (keys=None targets
        local live actors, which ARE the owned partition); broadcast
        slices arrive pre-partitioned by the anchor."""
        import numpy as np
        rt = self.silo.vector
        method = spec["method"]
        kwargs = spec.get("kwargs") or None
        st = self.silo.stats
        if op == "map":
            keys = spec.get("keys")
            if keys is not None:
                keys = self._bulk_owned_hashes(rt, vcls, keys)
            n = await rt.map_actors(vcls, method, kwargs, keys=keys)
            st.increment("vector.bulk.applied", n)
            return n
        if op == "reduce":
            keys = spec.get("keys")
            if keys is not None:
                keys = self._bulk_owned_hashes(rt, vcls, keys)
            value, count = await rt.reduce_actors_partial(
                vcls, method, kwargs, keys=keys,
                combine=spec.get("combine", "sum"))
            st.increment("vector.bulk.applied", count)
            return {"value": value, "count": count}
        targets = np.asarray(spec["targets"], dtype=np.int64)
        if op == "stream":
            # device-tier stream delivery: same broadcast machinery via
            # the engine's stream entry (delivery-group bookkeeping +
            # streams.* stats ride along)
            d = await rt.stream_fanout(vcls, method, targets,
                                       spec.get("args") or {},
                                       chunk=spec.get("chunk", 16384))
            st.increment("streams.device.bulk_delivered", d)
            return d
        d = await rt.broadcast_actors(vcls, method, targets,
                                      spec.get("args") or {},
                                      chunk=spec.get("chunk", 16384))
        st.increment("vector.bulk.delivered", d)
        return d

    async def _vector_bulk_anchor(self, vcls: type, msg: Message,
                                  op: str, spec: dict):
        """Anchor role: fan one ``local=True`` envelope per peer silo,
        run the local partition, combine. A peer failure fails the whole
        collective to the caller (honest partial-cluster semantics — the
        caller retries against a converged view)."""
        ring = self.silo.locator.ring
        me = self.silo.silo_address
        peers = [s for s in ring.silos if s != me]
        combine = spec.get("combine", "sum")
        rc = self.silo.runtime_client
        work = []
        if op in ("broadcast", "stream") and peers:
            # stream deliveries partition exactly like broadcast edges:
            # targets + per-edge payload rows travel to their ring owner
            slices = self._partition_broadcast(vcls, spec, peers)
            local_spec = slices.pop(me, None)
            if local_spec is not None:
                work.append(self._vector_bulk_local(vcls, op, local_spec))
            peer_specs = list(slices.items())
        else:
            work.append(self._vector_bulk_local(
                vcls, op, {**spec, "local": True}))
            peer_specs = [(p, {**spec, "local": True}) for p in peers]
        for peer, pspec in peer_specs:
            work.append(rc.send_request(
                target_grain=msg.target_grain, grain_class=vcls,
                interface_name=msg.interface_name,
                # the op's OWN wire name, not msg.method_name: a join
                # watch's nested reductions must arrive as
                # __bulk_reduce__ at the peers (_BULK_WIRE)
                method_name=_BULK_WIRE[op], args=(),
                kwargs={"spec": pspec}, target_silo=peer,
                # the caller's budget rides the spec: without it a
                # 120s-budget collective would die at the peer leg's
                # 30s default
                timeout=spec.get("timeout")))
        # return_exceptions: a failing partition must not abandon the
        # other in-flight peer futures with no awaiter (their late
        # rejections would log "exception was never retrieved"); the
        # first failure still fails the whole collective to the caller
        parts = await asyncio.gather(*work, return_exceptions=True)
        for p in parts:
            if isinstance(p, BaseException):
                raise p
        if op == "reduce":
            return self._finalize_reduce(parts, combine)
        return int(sum(parts))

    async def _vector_bulk_join(self, vcls: type, msg: Message,
                                spec: dict) -> dict:
        """Server-armed ``join_when`` watch (the long-poll half of the
        join-calculus readiness step): the anchor runs the poll
        reduction loop LOCALLY for up to ``spec['lease']`` seconds —
        each poll is one cluster reduce through the normal anchor
        fan-out — and answers once, either readiness-met or an honest
        lease expiry carrying the last observed count. The client
        re-arms until its own deadline, so a K-poll wait costs
        ceil(wait/lease) client envelopes instead of K."""
        from ..dispatch.engine import _leaves, join_poll
        need = int(spec.get("need", 0))
        poll = float(spec.get("poll", 0.02))
        lease = spec.get("lease")
        lease = None if lease is None else float(lease)
        rspec: dict = {"method": spec["method"],
                       "kwargs": spec.get("kwargs") or {},
                       "combine": "sum"}
        if spec.get("keys") is not None:
            rspec["keys"] = spec["keys"]
        if spec.get("timeout") is not None:
            rspec["timeout"] = spec["timeout"]
        self.silo.stats.increment("vector.join.watches")
        last = {"ready": 0}

        async def reduce_once():
            r = await self._vector_bulk_anchor(vcls, msg, "reduce", rspec)
            val = r["value"]
            leaves = _leaves(val) if val is not None else []
            last["ready"] = int(leaves[0]) if leaves else 0
            return val

        try:
            ready = await join_poll(reduce_once, need, lease, poll)
            return {"ready": ready, "met": True}
        except asyncio.TimeoutError:
            # lease expiry is a normal answer, not an error: the client
            # decides (re-arm vs its own deadline) — a marshalled
            # TimeoutError could not carry the observed count
            return {"ready": last["ready"], "met": False}

    def _partition_broadcast(self, vcls: type, spec: dict,
                             peers: list) -> dict:
        """Partition a broadcast edge list by ring ownership: one spec
        slice per owning silo (targets + per-edge args rows travel with
        their edges; scalar args replicate). The anchor pays O(unique
        targets) hash computations once so the wire carries each edge
        exactly once."""
        import numpy as np

        from ..core.ids import GrainId, GrainType
        ring = self.silo.locator.ring
        me = self.silo.silo_address
        targets = np.asarray(spec["targets"], dtype=np.int64)
        args = spec.get("args") or {}
        E = targets.shape[0]
        gtype = GrainType.of(vcls.__name__)
        silos = [me] + peers
        idx_of = {s: i for i, s in enumerate(silos)}
        uniq, inv = np.unique(targets, return_inverse=True)
        owner_idx = np.fromiter(
            (idx_of.get(ring.owner(
                GrainId.for_grain(gtype, int(k)).uniform_hash) or me, 0)
             for k in uniq), dtype=np.int64, count=uniq.size)
        per_edge = owner_idx[inv]
        # per-edge vs replicated is decided by the method's args schema
        # when one exists (an arg is per-edge iff it is [E, *feature]):
        # a replicated feature vector whose length happens to equal E
        # must NOT be sliced per edge — a peer owning k edges would
        # receive a k-length fragment and fail the whole collective.
        # With no schema yet (method never called), the engine will
        # infer per-edge semantics from these arrays, so the shape
        # heuristic matches what the engine is about to assume.
        schema = self.silo.vector.method_of(vcls,
                                            spec["method"]).args_schema

        def per_edge_arg(f, arr):
            if schema is not None and f in schema:
                return arr.shape == (E, *schema[f][1])
            return bool(arr.ndim) and arr.shape[0] == E
        out = {}
        for i, addr in enumerate(silos):
            m = per_edge == i
            if not m.any():
                continue
            sliced = {}
            for f, a in args.items():
                arr = np.asarray(a)
                sliced[f] = arr[m] if per_edge_arg(f, arr) else a
            out[addr] = {**spec, "local": True, "targets": targets[m],
                         "args": sliced}
        return out

    @staticmethod
    def _finalize_reduce(parts: list, combine: str) -> dict:
        """Fold per-silo reduce partials (``{"value", "count"}``) into
        the final answer with the shared op→fold mapping
        (``ops.segment_reduce.host_fold`` — the same one the engine's
        round combiner uses, so the two cannot drift). Partials carry
        SUMS for mean (division happens exactly once, here)."""
        from ..dispatch.engine import _tree_map, _tree_map2
        from ..ops.segment_reduce import host_fold
        count = sum(p["count"] for p in parts)
        vals = [p["value"] for p in parts if p["value"] is not None]
        if not vals or count == 0:
            return {"value": None, "count": 0}
        fold = host_fold(combine)
        total = vals[0]
        for v in vals[1:]:
            total = _tree_map2(fold, total, v)
        if combine == "mean":
            total = _tree_map(lambda a: a / count, total)
        return {"value": total, "count": count}

    @staticmethod
    def _vector_key_is_fresh(rt, vcls: type, key_hash: int) -> bool:
        """True iff the key has no live row in the local table (first
        touch on this silo — the recovery trigger)."""
        tbl = rt.table(vcls)
        if 0 <= key_hash < tbl.dense_n:
            return not bool(tbl.dense_active[key_hash])
        return tbl.lookup(key_hash) is None

    async def _recover_then_call(self, rt, vcls: type, bridge,
                                 key_hash: int, method: str, kwargs: dict):
        """Rehydrate one key from write-behind storage, then run the call.
        Concurrent first-touch calls share a single storage read; the
        call itself joins the next tick as usual."""
        rec_key = (vcls, key_hash)
        rec = self._vector_recoveries.get(rec_key)
        if rec is None:
            if not self._vector_key_is_fresh(rt, vcls, key_hash):
                # a recovery completed between the fresh-check in
                # _handle_vector_request and this task running: loading
                # again would re-scatter stale stored state over ticks
                # that already ran
                return await rt.call(vcls, key_hash, method, **kwargs)
            rec = asyncio.ensure_future(bridge.load([key_hash]))
            self._vector_recoveries[rec_key] = rec
            try:
                restored = await rec
                if restored:
                    self.silo.stats.increment("vector.storage.recovered")
            finally:
                self._vector_recoveries.pop(rec_key, None)
        else:
            await rec
        return await rt.call(vcls, key_hash, method, **kwargs)

    def receive_request(self, activation: ActivationData, msg: Message) -> None:
        """ReceiveRequest:262 — gate, then run or enqueue."""
        # inline expiry check (vs the is_expired property: sheds the
        # descriptor + method frame on every turn); unarmed messages
        # (timer turns, timeout=0) pay one attribute load + None test
        if msg.expires_at is not None and time.monotonic() > msg.expires_at:
            log.warning("dropping expired request %s", msg.method_name)
            return
        if self.detect_deadlocks and activation.grain_id in msg.call_chain \
                and not activation.may_accept_request(msg):
            # cycle through a busy non-interleavable activation: with the
            # call-chain reentrancy rule in the gate this is unreachable,
            # but stays as the CheckDeadlock:364 guard when that rule is off.
            self._reject(msg, RejectionType.UNRECOVERABLE,
                         f"deadlock cycle detected: {msg.call_chain}")
            return
        if activation.may_accept_request(msg):
            self._handle_incoming(activation, msg)
        else:
            try:
                activation.check_overloaded()
            except GrainOverloadedError as e:
                self._reject(msg, RejectionType.OVERLOADED, str(e))
                return
            activation.waiting.append(msg)  # EnqueueRequest:431

    def _handle_incoming(self, activation: ActivationData, msg: Message) -> None:
        """HandleIncomingRequest:399 → schedule the turn.

        With the eager task factory (silo.py) the turn's first steps run
        inline INSIDE a properly-constructed Task — a non-suspending grain
        method completes here without a loop round-trip, while
        current_task()-dependent code in user methods (asyncio.timeout,
        wait_for) still sees the turn's own task. (A hand-rolled inline
        first step without a Task was measured ~2µs cheaper and reverted:
        it breaks exactly that contract — wait_for during the inline step
        armed its timeout against the CALLER's task.)"""
        if _msg_mod._DEBUG_POOL:
            # pool poisoning: starting a turn on a recycled shell would
            # invoke with another call's method/body
            _msg_mod.assert_live(msg, "dispatcher._handle_incoming")
        activation.record_running(msg)
        self._track(asyncio.get_running_loop().create_task(
            self._run_turn(activation, msg)))

    async def _run_turn(self, activation: ActivationData, msg: Message) -> None:
        """One turn: invoke the grain method, send the response, pump
        (InvokeWorkItem.Execute → InsideRuntimeClient.Invoke:294-474 →
        OnActivationCompletedRequest → RunMessagePump)."""
        token_a = current_activation.set(activation)
        RequestContext.import_(msg.request_context)
        t0 = time.monotonic()
        lp = self._loop_prof
        ptok = None
        if lp is not None:
            # loop-occupancy attribution: this task's steps are a host
            # grain turn (timer ticks bucket separately — they are loop
            # load the grain's own traffic didn't cause). The label tuple
            # feeds the flight recorder's top-K records; it is only
            # string-joined if this turn actually lands in the top-K, so
            # the per-turn path pays no format.
            ptok = lp.enter(
                "timers" if msg.method_name == "__timer__" else "turns",
                (msg.interface_name, msg.method_name))
        tracer = self.silo.tracer
        tspan = ttoken = None
        t_queue = 0.0
        turn_error = None
        # the observability setup below lives INSIDE the try: its
        # exceptions must run the same finally that pairs lp.exit with
        # the enter above (and resets the activation), not leak the
        # profiler category token for the rest of the task
        try:
            ist = self._istats
            if msg.received_at is not None:
                if ist is not None:
                    # ingest queue-wait stage: fabric hand-off (or
                    # loopback arrival) -> this turn actually starting —
                    # inbound queue + mailbox + task scheduling, the
                    # backpressure signal
                    ist.observe(_QUEUE_WAIT, t0 - msg.received_at)
                    ist.increment(_TURNS)
                trend = self.silo.shed_trend
                if trend is not None:
                    # same signal feeds the load-shed trend (shed on
                    # windowed queue-wait, not instantaneous depth)
                    trend.note(max(0.0, t0 - msg.received_at), t0)
            # server span: header presence == sampled (head-based
            # sampling at the root). Covers queue wait (arrival stamp →
            # turn start) plus execution, recorded separately; the
            # network leg is derived from the sender's wall-clock stamp.
            # Nested sends from inside the turn parent under this span
            # via the current_trace contextvar.
            if tracer is not None:
                hdr = context_from_headers(msg.request_context)
                if hdr is not None:
                    trace_id, parent_id, sent_at = hdr
                    if msg.received_at is not None:
                        t_queue = max(0.0, t0 - msg.received_at)
                        if ist is not None:
                            # OpenMetrics exemplar: the sampled trace id
                            # rides the bucket this turn's queue-wait
                            # landed in, so a slow bucket on the
                            # Prometheus endpoint links straight into
                            # the tail-retained trace
                            ist.histogram(_QUEUE_WAIT).exemplar(
                                t_queue, trace_id)
                    recv_wall = (time.time() - (time.monotonic() - t0)
                                 - t_queue)
                    tracer.record(trace_id, parent_id, "network",
                                  "network", sent_at, recv_wall - sent_at)
                    tspan = tracer.open(
                        f"{msg.interface_name}.{msg.method_name}",
                        "server", trace_id, parent_id)
                    tspan.start = recv_wall
                    ttoken = current_trace.set((trace_id, tspan.span_id))
            result = await self.invoke(activation, msg)
            if msg.direction == Direction.REQUEST:
                resp = make_response(msg, copy_result(result))
                self._attach_txn_joins(resp)
                if tspan is not None:
                    self._stamp_response(resp, tspan)
                self.send_response(msg, resp)
        except asyncio.CancelledError:
            # silo stop/kill abandoned this turn: no response through a
            # fabric that may already be torn down — the caller's pending
            # request is broken by runtime_client.close() instead
            raise
        except BaseException as e:  # noqa: BLE001 — grain errors flow to caller
            turn_error = type(e).__name__
            if msg.direction == Direction.REQUEST:
                resp = make_error_response(msg, e)
                self._attach_txn_joins(resp)
                if tspan is not None:
                    self._stamp_response(resp, tspan)
                self.send_response(msg, resp)
            else:
                log.exception("one-way turn failed on %s.%s",
                              msg.interface_name, msg.method_name)
            # the SLO error-rate objective's bad-event counter (errors
            # are rare — the unconditional increment costs nothing on
            # the clean path, which never reaches here)
            self.silo.stats.increment(_TURN_ERRORS)
            self.silo.catalog.on_invoke_error(activation, e)
        finally:
            # slow-turn detection (TurnWarningLengthThreshold,
            # OrleansTaskScheduler.cs:26). The length histogram is sampled
            # 1-in-8 (plus every long turn) — full-rate observation is a
            # measurable tax on sub-30µs turns, and the p99 estimate is
            # unchanged at this volume.
            elapsed = time.monotonic() - t0
            self._turn_count = n = self._turn_count + 1
            if elapsed > self.silo.config.turn_warning_length:
                self.silo.stats.observe("scheduler.turn_length", elapsed)
                self.silo.stats.increment("scheduler.long_turns")
                log.warning("long turn %.3fs: %s.%s on %s", elapsed,
                            msg.interface_name, msg.method_name,
                            activation.grain_id)
            elif not n & 7:
                self.silo.stats.observe("scheduler.turn_length", elapsed)
            cs = self._call_sites
            if cs is not None:
                # call-site latency/error table (SLO breach drill-down):
                # one dict upsert per turn, only when metrics are on
                cs.note(msg.interface_name, msg.method_name, elapsed,
                        turn_error is not None)
            led = self._ledger
            if led is not None:
                # cost attribution: charge this turn's exec + queue-wait
                # to (interface, method) and the grain's key label —
                # BEFORE RequestContext.clear() below, so the caller's
                # tenant baggage is still readable. System targets keep
                # their (interface, method) row but stay out of the
                # burner sketch: the drill-down names APPLICATION
                # actors, not runtime bookkeeping
                led.charge_turn(
                    msg.interface_name, msg.method_name, elapsed,
                    queue_s=(max(0.0, t0 - msg.received_at)
                             if msg.received_at is not None else 0.0),
                    key=None if activation.grain_id.is_system_target()
                    else f"{activation.grain_class.__name__}"
                         f"/{activation.grain_id.key}")
            if tspan is not None:
                current_trace.reset(ttoken)
                if turn_error is not None:
                    # the error attr is what tail retention keys on for
                    # silo-rooted traces (errored traces always survive)
                    tracer.close(tspan, duration=t_queue + elapsed,
                                 queue_s=t_queue, exec_s=elapsed,
                                 error=turn_error)
                else:
                    tracer.close(tspan, duration=t_queue + elapsed,
                                 queue_s=t_queue, exec_s=elapsed)
            RequestContext.clear()
            current_activation.reset(token_a)
            activation.reset_running(msg)
            if ptok is not None:
                lp.exit(ptok)
            self.run_message_pump(activation)

    @staticmethod
    def _stamp_response(resp: Message, tspan) -> None:
        """Send-side wall stamp on the response envelope (the request-leg
        twin lives in the TRACE_KEY header stamped at client send): the
        caller's receive_response measures stamp → arrival as the
        response-leg network span. Responses of unsampled turns carry no
        header and pay nothing."""
        resp.request_context = {
            TRACE_KEY: (tspan.trace_id, tspan.span_id, time.time())}

    @staticmethod
    def _attach_txn_joins(resp: Message) -> None:
        """Piggyback the turn's transaction participant set on the
        response header, so callee-side joins fold back into the caller's
        TransactionInfo (the reference's TransactionInfo message-header
        round trip; merged in RuntimeClient.receive_response). Error
        responses carry it too — the root's abort must notify every
        participant that joined before the failure."""
        info = RequestContext.get(TXN_KEY)
        if info is not None and getattr(info, "participants", None):
            resp.transaction_info = (info.id, dict(info.participants))

    async def invoke(self, activation: ActivationData, msg: Message):
        """Resolve and call the grain method (Invoke:294-474) through the
        per-class invoker table (runtime.invoker — the codegen method-id
        switch analog); methods outside the precomputed remote surface
        fall back to per-call getattr resolution."""
        if msg.method_name == "__timer__":
            callback, done = msg.body
            try:
                result = callback()
                if asyncio.iscoroutine(result):
                    result = await result
                if done is not None and not done.done():
                    done.set_result(None)
                return None
            except BaseException as e:
                if done is not None and not done.done():
                    done.set_exception(e)
                raise
        if msg.method_name == "on_incoming_call":
            # the filter hook is not a remote method: invoking it directly
            # would run the gate with a caller-controlled context object
            raise AttributeError(
                "on_incoming_call is the grain-level call filter hook, "
                "not a remotely invocable method")
        instance = activation.grain_instance
        entry = self.silo.invokers.entry(activation.grain_class)
        inv = entry.methods.get(msg.method_name)
        if inv is not None and \
                msg.method_name in getattr(instance, "__dict__", ()):
            # an INSTANCE-attached callable (fault injection, test stubs)
            # shadows the class table, exactly as the pre-table getattr
            # resolution honored it
            inv = None
        if inv is not None:
            fn = None
        else:
            fn = getattr(instance, msg.method_name, None)
            if fn is None:
                raise AttributeError(
                    f"{activation.grain_class.__name__} has no method "
                    f"{msg.method_name!r}")
        args, kwargs = maybe_intern_tokens(self.silo, *msg.body)
        # incoming call filter chain (InsideRuntimeClient.cs:362 →
        # GrainMethodInvoker): silo filters first (the table's fused
        # snapshot — entry() already revalidated it against the live
        # list), then the grain's own on_incoming_call (grain-implements-
        # the-filter form) last. Application traffic only — system/ping
        # traffic (membership probes, directory RPCs, reminder ticks)
        # must never be gated by user filters (the reference's filters
        # wrap grain calls, not system-target messages).
        # per-instance lookup stays unconditional: a hook attached to the
        # INSTANCE (not the class) must gate messaging-path calls exactly
        # as before the invoker table existed
        grain_filter = getattr(instance, "on_incoming_call", None)
        if (entry.silo_chain or grain_filter is not None) and \
                msg.category == Category.APPLICATION:
            from .filters import IncomingCallContext, run_call_chain
            chain: tuple = entry.silo_chain
            if grain_filter is not None:
                chain = (*chain, grain_filter)

            async def terminal(c):
                if inv is not None:
                    return await inv.fn(instance, *c.args, **c.kwargs)
                return await fn(*c.args, **c.kwargs)

            return await run_call_chain(IncomingCallContext(
                chain, terminal, grain=instance,
                grain_id=activation.grain_id,
                interface_name=msg.interface_name,
                method_name=msg.method_name, args=args, kwargs=kwargs))
        if inv is not None:
            return await inv.fn(instance, *args, **kwargs)
        return await fn(*args, **kwargs)

    def run_message_pump(self, activation: ActivationData) -> None:
        """Drain the waiting queue as far as the gate allows
        (RunMessagePump:845)."""
        while activation.waiting:
            if activation.state != ActivationState.VALID:
                break
            nxt = activation.waiting[0]
            if not activation.may_accept_request(nxt):
                break
            activation.waiting.popleft()
            if nxt.expires_at is not None and \
                    time.monotonic() > nxt.expires_at:
                continue  # expired while queued: caller gave up already
            self._handle_incoming(activation, nxt)
        if activation.wants_deactivation:
            self.silo.catalog.schedule_deactivation(activation)

    async def run_closed_turn(self, activation: ActivationData, callback) -> None:
        """Run a host callback (timer tick, system work) as a gated turn on
        the activation — preserves single-threaded-turn semantics for
        non-message work (GrainTimer ticks run as turns)."""
        loop = asyncio.get_running_loop()
        done: asyncio.Future = loop.create_future()
        # positional fast factory (timer ticks fire at turn rate on busy
        # grains; the 28-kwarg construction was measurable in the r5
        # attribution)
        from ..core.message import make_request_fast
        msg = make_request_fast(
            Category.SYSTEM, Direction.ONE_WAY,
            None, None, None,                     # sending silo/grain/act
            self.silo.silo_address, activation.grain_id,
            activation.grain_class.__name__, "__timer__",
            (callback, done),
            None, (), False, False,               # expiry, chain, flags
            None, 0,                              # request_context, version
        )
        msg.target_activation = activation.activation_id
        self.receive_request(activation, msg)
        await done

    # ==================================================================
    # Send path
    # ==================================================================
    def send_message(self, msg: Message, grain_class: type | None = None) -> None:
        """AsyncSendMessage:645 — address if needed, then transmit."""
        if msg.target_silo is None:
            # catalog-first addressing (the reference's local activation-
            # table hit before directory work, Dispatcher.cs targeting):
            # a live local activation IS the registered address — the
            # catalog registers in the directory before exposing the
            # activation — so gateway ingress for grains active HERE
            # skips the full locator path (measured +5-15% on host ping
            # depending on machine noise).
            # Interception (vector/GSI) still runs: transmit loops back
            # through receive_message. Guard: the shortcut needs a
            # TTL-VALID cache entry affirmatively naming this silo
            # (placement wrote it; the slow path re-arms it on each
            # expiry). TTL-aware on purpose: a usurped duplicate's own
            # stale entry also names this silo, so an unexpiring check
            # would pin callers to the duplicate forever — expiry forces
            # a periodic re-resolution against the directory, bounding
            # any split-brain to one cache TTL exactly as the
            # pre-shortcut try_locate_sync path did. Popped entries
            # (invalidation) and entries naming another silo fall
            # through the same way
            if self.silo.catalog.by_grain.get(msg.target_grain) and \
                    self.silo.locator.cache.valid_silo(msg.target_grain) \
                    == self.silo.silo_address:
                msg.target_silo = self.silo.silo_address
                self.transmit(msg)
                return
            # sync fast path: cache hits / local-owner placements resolve
            # without an addressing task (the common case by far)
            try:
                target = self.silo.locator.try_locate_sync(msg, grain_class)
            except TransientPlacementError as e:
                self._reject(msg, RejectionType.TRANSIENT, str(e))
                return
            except Exception as e:  # noqa: BLE001 — same contract as async
                log.exception("addressing failed for %s", msg.target_grain)
                if msg.direction == Direction.REQUEST:
                    resp = make_error_response(msg, e)
                    resp.target_silo = msg.sending_silo
                    self.transmit(resp)
                return
            if target is not None:
                msg.target_silo = target
                self.transmit(msg)
                return
            self._track(asyncio.get_running_loop().create_task(
                self._address_and_send(msg, grain_class)))
        else:
            self.transmit(msg)

    async def _address_and_send(self, msg: Message,
                                grain_class: type | None) -> None:
        """AddressMessage:715 — placement director + directory lookup."""
        token = None
        if self.silo.tracer is not None:
            hdr = context_from_headers(msg.request_context)
            if hdr is not None:
                # gateway-addressed ingress has no ambient trace context;
                # adopt the message's so the directory RPC below records
                # as a child "directory" span of the caller's client span
                token = current_trace.set((hdr[0], hdr[1]))
        try:
            target = await self.silo.locator.locate(msg, grain_class)
            msg.target_silo = target
            self.transmit(msg)
        except TransientPlacementError as e:
            self._reject(msg, RejectionType.TRANSIENT, str(e))
        except Exception as e:  # noqa: BLE001
            log.exception("addressing failed for %s", msg.target_grain)
            if msg.direction == Direction.REQUEST:
                resp = make_error_response(msg, e)
                resp.target_silo = msg.sending_silo
                self.transmit(resp)
        finally:
            if token is not None:
                current_trace.reset(token)

    def transmit(self, msg: Message) -> None:
        """Hand to the message center: loopback locally, network otherwise."""
        if _msg_mod._DEBUG_POOL:
            _msg_mod.assert_live(msg, "dispatcher.transmit")
        if msg.target_silo is not None and \
                msg.target_silo == self.silo.silo_address:
            self.receive_message(msg)
        else:
            self.silo.message_center.send_message(msg)

    def send_response(self, request: Message, response: Message) -> None:
        """SendResponse:769 — batched egress joins remote-bound responses
        to the per-destination flush accumulator (runtime.egress), so the
        N responses of one inbound batch ride one fabric hand-off per
        origin; local responses keep the synchronous loopback
        (``transmit`` short-circuits into receive_message) and the
        ``batched_egress=False`` A/B lever restores the per-message path
        bit for bit."""
        if request.direction == Direction.ONE_WAY:
            return
        response.target_silo = request.sending_silo
        eg = self._egress
        if eg is not None and response.category == Category.APPLICATION \
                and response.target_silo is not None and \
                response.target_silo != self.silo.silo_address:
            # APPLICATION responses only: PING/SYSTEM responses
            # (membership probes, directory and management RPCs) are
            # latency-critical and low-volume — the accumulator's
            # end-of-ready-run flush can sit behind a saturated loop's
            # whole callback run, and a probe response delayed past the
            # probe timeout gets a healthy silo voted dead (the same
            # QoS split the reference's category queues exist for)
            eg.add(response.target_silo, response)
            return
        self.transmit(response)

    def send_response_batch(self, items) -> None:
        """Batched SendResponse for one completed batch: ``items`` is an
        iterable of ``(request, response)`` pairs resolved together (a
        ``call_group`` error bounce, a vector-batch schema failure).
        Groups ride the egress accumulator and flush at this
        batch-completion boundary — one ``MessageCenter.send_batch`` per
        destination — instead of waiting for the armed end-of-burst
        flush; without the batcher it degrades to per-message
        ``send_response`` exactly."""
        eg = self._egress
        if eg is None:
            for request, response in items:
                self.send_response(request, response)
            return
        for request, response in items:
            self.send_response(request, response)
        eg.flush()

    # ==================================================================
    # Rejection / forwarding (TryForwardRequest:526)
    # ==================================================================
    def _reject(self, msg: Message, rtype: RejectionType, info: str) -> None:
        if msg.direction == Direction.ONE_WAY:
            return
        tracer = self.silo.tracer
        if tracer is not None:
            hdr = context_from_headers(msg.request_context)
            if hdr is not None:
                # zero-duration annotation parented under the caller's
                # invoke span: a traced call that bounced here shows the
                # rejection in its tree instead of unexplained retry time
                tracer.event(hdr[0], hdr[1], "reject", type=rtype.name,
                             info=info)
        rej = make_rejection(msg, rtype, info)
        rej.target_silo = msg.sending_silo
        self.transmit(rej)

    def _reject_or_forward(self, msg: Message, reason: str) -> None:
        """Misdelivered/raced request: re-address and forward up to
        MaxForwardCount hops, else reject transient (Dispatcher.cs:591-630).

        A system-target request is rejected at once: its id names the silo
        it lives on, so re-addressing resolves to this silo again. Each such
        self-forward also sent a fresh directory request about the id (the
        stale-entry heal and the sender's cache notice), which misses in
        turn on a silo whose targets are gone (stopping, or re-addressed),
        so the fan-out recursed with the forward count reset at every hop."""
        if msg.forward_count < MAX_FORWARD_COUNT and \
                not msg.target_grain.is_system_target():
            msg.forward_count += 1
            msg.target_silo = None
            msg.target_activation = None
            if self.silo.tracer is not None:
                hdr = context_from_headers(msg.request_context)
                if hdr is not None:
                    # annotate the forward hop under the caller's invoke
                    # span (event spans are breakdown-neutral)
                    self.silo.tracer.event(hdr[0], hdr[1], "forward",
                                           hop=msg.forward_count,
                                           reason=reason)
                # the message leaves again: reset the arrival stamp and
                # refresh the header's sent_at so the NEXT silo's queue/
                # network spans measure only their own leg, not ours
                msg.received_at = None
                msg.request_context = restamp_header(msg.request_context)
            self.silo.locator.invalidate_cache(msg.target_grain)
            # invalidation-on-forward, outward half: the SENDER's stale
            # cache routed this message here (e.g. the grain live-migrated
            # away) — without telling it, every subsequent send pays the
            # same forward hop until the sender's TTL expires
            sender = msg.sending_silo
            notify = getattr(self.silo.locator, "notify_cache_invalidate",
                             None)
            if notify is not None and sender is not None and \
                    sender != self.silo.silo_address and \
                    sender in self.silo.locator.alive_set:
                notify(sender, msg.target_grain)
            # hot-path statistics discipline (MessagingStatisticsGroup):
            # forward rate is THE staleness signal the adaptive directory
            # cache exists to suppress — it must be observable
            self.silo.stats.increment("messaging.forwarded")
            self.send_message(msg)
        else:
            self._reject(msg, RejectionType.TRANSIENT,
                         f"forward limit reached: {reason}")
