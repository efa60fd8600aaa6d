"""In-process fabric + external cluster client.

The fabric plays the role of the reference's socket layer for in-process
clusters (Orleans' src/Orleans.Core/Messaging/SocketManager.cs,
Runtime/Messaging/Gateway.cs:17, GatewayAcceptor.cs) and is the fault
injection point for liveness tests (kill = AppDomain unload in
TestingHost/AppDomainSiloHandle.cs:14; here: drop the silo from routing).

The client mirrors OutsideRuntimeClient (Core/Runtime/OutsideRuntimeClient.cs:22)
+ ClientMessageCenter/GatewayManager: gateway selection is round-robin over
alive silos; responses route back via the client's pseudo silo address.

The port's copy of ``orleans_tpu.runtime.cluster``.
"""

from __future__ import annotations

import itertools
import logging
from typing import Any

from ..core.errors import SiloUnavailableError
from ..core.ids import SiloAddress
from ..core.message import Direction, Message
from .hotlane import try_hot_invoke as _hot_invoke
from .references import GrainFactory
from .runtime_client import RuntimeClient

log = logging.getLogger("orleans.fabric")

__all__ = ["InProcFabric", "ClusterClient"]


class InProcFabric:
    """Message routing + liveness simulation for every silo/client sharing
    one event loop."""

    def __init__(self) -> None:
        self.silos: dict[SiloAddress, Any] = {}
        self.clients: dict[SiloAddress, "ClusterClient"] = {}
        self.dead: set[SiloAddress] = set()
        self._alive_cache: list[SiloAddress] | None = None
        self._ports = itertools.count(11111)
        self._generation = itertools.count(1)
        # ordered pairs of endpoints whose traffic is dropped (partition tests)
        self.partitions: set[tuple[str, str]] = set()

    # -- address allocation ---------------------------------------------
    def allocate_address(self, name: str) -> SiloAddress:
        return SiloAddress(name, next(self._ports), next(self._generation))

    def allocate_client_address(self) -> SiloAddress:
        return SiloAddress("client", next(self._ports), next(self._generation))

    # -- membership of the wire (not the cluster oracle) ------------------
    def register_silo(self, silo) -> None:
        self.silos[silo.silo_address] = silo
        self.dead.discard(silo.silo_address)
        self._alive_cache = None
        self._broadcast_membership()

    def unregister_silo(self, silo, dead: bool = False) -> None:
        self.silos.pop(silo.silo_address, None)
        if dead:
            self.dead.add(silo.silo_address)
        self._alive_cache = None
        self._broadcast_membership(dead=[silo.silo_address] if dead else [])

    def invalidate_alive_cache(self) -> None:
        """Called on silo status transitions (e.g. Running→ShuttingDown)
        that change gateway eligibility without (un)registration."""
        self._alive_cache = None

    def _broadcast_membership(self, dead: list[SiloAddress] | None = None) -> None:
        """Fan membership changes to every silo's locator. When a membership
        oracle is installed on the silos, the oracle drives these
        notifications instead (probe/vote protocol) and the fabric only
        carries the wire."""
        alive = self.alive_silos()
        for s in list(self.silos.values()):
            if s.membership is None:
                s.locator.on_membership_change(alive, dead or [])
                if dead:
                    for d in dead:
                        s.runtime_client.break_outstanding_to_dead_silo(d)

    def register_client(self, client: "ClusterClient") -> None:
        self.clients[client.silo_address] = client

    def unregister_client(self, client: "ClusterClient") -> None:
        self.clients.pop(client.silo_address, None)

    def is_dead(self, addr: SiloAddress) -> bool:
        # dead ⊆ unregistered (unregister_silo removes + marks), so one
        # membership test decides
        return not (addr in self.silos or addr in self.clients)

    def alive_silos(self) -> list[SiloAddress]:
        cached = self._alive_cache
        if cached is None:
            cached = self._alive_cache = [
                a for a, s in self.silos.items()
                if s.status in ("Running", "Joining")]
        return cached

    # -- fault injection --------------------------------------------------
    def partition(self, a: SiloAddress, b: SiloAddress) -> None:
        self.partitions.add((a.endpoint, b.endpoint))
        self.partitions.add((b.endpoint, a.endpoint))

    def heal_partition(self, a: SiloAddress, b: SiloAddress) -> None:
        self.partitions.discard((a.endpoint, b.endpoint))
        self.partitions.discard((b.endpoint, a.endpoint))

    # -- the wire ----------------------------------------------------------
    def deliver(self, msg: Message) -> None:
        """Route one message to its target silo or client inbox."""
        target = msg.target_silo
        if target is None:
            log.warning("dropping unaddressed message %s", msg.method_name)
            return
        if msg.sending_silo is not None and \
                (msg.sending_silo.endpoint, target.endpoint) in self.partitions:
            return  # partitioned: silently dropped, like a black-holed link
        client = self.clients.get(target)
        if client is not None:
            client.deliver(msg)
            return
        silo = self.silos.get(target)
        if silo is None or target in self.dead:
            return  # dead silo: dropped; senders learn via membership/timeout
        silo.message_center.deliver(msg)

    def deliver_via_gateway(self, gateway: SiloAddress, msg: Message) -> None:
        """Client ingress: hand to a gateway silo which will address it
        (GatewayAcceptor path)."""
        silo = self.silos.get(gateway)
        if silo is None:
            raise SiloUnavailableError(f"gateway {gateway} unavailable")
        silo.message_center.deliver(msg)

    def deliver_group(self, target: SiloAddress, msgs: list) -> None:
        """Batched outbound hand-off for ONE destination
        (``MessageCenter.send_batch`` — the batched-egress response
        path): a client gets one ``deliver_batch`` correlation pass, a
        silo one ``deliver_batch`` routing hop."""
        if target is None:
            log.warning("dropping %d unaddressed batched messages",
                        len(msgs))
            return
        first = msgs[0]
        if first.sending_silo is not None and \
                (first.sending_silo.endpoint,
                 target.endpoint) in self.partitions:
            return  # one sender, one target: the whole group is cut
        client = self.clients.get(target)
        if client is not None:
            client.deliver_batch(msgs)
            return
        silo = self.silos.get(target)
        if silo is None or target in self.dead:
            return  # dead silo: dropped, like deliver()
        silo.message_center.deliver_batch(msgs)

    def deliver_via_gateway_batch(self, gateway: SiloAddress,
                                  msgs: list) -> None:
        """Batched client ingress (``ClusterClient.transmit_batch``): one
        group → one ``deliver_batch`` routing hop on the gateway silo —
        the in-proc twin of a gateway socket read decoding a whole wire
        batch."""
        silo = self.silos.get(gateway)
        if silo is None:
            raise SiloUnavailableError(f"gateway {gateway} unavailable")
        silo.message_center.deliver_batch(msgs)


class ClusterClient(RuntimeClient):
    """External client (OutsideRuntimeClient.cs:22): N gateway connections →
    here, round-robin gateway pick per request over alive silos."""

    def __init__(self, fabric: InProcFabric, response_timeout: float = 30.0):
        super().__init__(response_timeout=response_timeout)
        self.fabric = fabric
        self._address = fabric.allocate_client_address()
        self.grain_factory = GrainFactory(self)
        self._gateway_rr = 0
        self.connected = False
        # hot-lane locality hint: grain_id → hosting SiloAddress
        # (re-resolved through fabric.silos and re-verified against the
        # silo's catalog on every use, so a stale entry just re-resolves
        # and a dead silo is never pinned; bounded so key-churn workloads
        # can't grow it)
        self._hot_silo_cache: dict = {}
        from .observers import ObserverHost
        self._observer_host = ObserverHost(lambda: self._address)

    # -- RuntimeClient surface --------------------------------------------
    @property
    def silo_address(self) -> SiloAddress:
        return self._address

    def try_hot_invoke(self, grain_id, grain_class: type,
                       interface_name: str, method_name: str,
                       args: tuple, kwargs: dict,
                       is_read_only: bool = False):
        """Hot lane for the in-proc fabric: every silo shares this event
        loop, so a call whose activation lives in ANY registered silo is
        "local" in the hot-lane sense.  Gateway-only semantics that the
        lane would bypass force a fallback: load shedding (queue depth is
        the shed signal) and non-Running silos.  Socket-backed clients
        (multiprocess clusters) never take this path — their fabric holds
        no silo objects."""
        if not self.hot_lane_enabled or not self.connected:
            return None
        cache = self._hot_silo_cache
        addr = cache.get(grain_id)
        # the hint stores the ADDRESS, not the silo object: a killed silo
        # leaves fabric.silos, so a stale hint resolves to None here and
        # can never pin a dead silo's catalog/activations in memory
        silo = self.fabric.silos.get(addr) if addr is not None else None
        if silo is None or silo.status != "Running" or \
                not silo.catalog.by_grain.get(grain_id):
            # a non-gracefully killed silo keeps its catalog populated, so
            # the status is part of hint validity — a dead hint re-resolves
            # (the grain reactivates elsewhere) instead of pinning the
            # fallback path forever
            silo = None
            for s in self.fabric.silos.values():
                if s.status == "Running" and s.catalog.by_grain.get(grain_id):
                    silo = s
                    break
            if silo is None:
                cache.pop(grain_id, None)  # never retain a dead hint
                self.hot_fallbacks += 1
                return None
            if len(cache) >= 65536:
                cache.clear()
            cache[grain_id] = silo.silo_address
        if silo.config.load_shedding_enabled:
            self.hot_fallbacks += 1
            return None
        coro = _hot_invoke(self, silo, grain_id, grain_class,
                           interface_name, method_name,
                           args, kwargs, is_read_only)
        if coro is None:
            self.hot_fallbacks += 1
        else:
            self.hot_hits += 1
        return coro

    def _pick_gateway(self, msg: Message, gateways: list) -> SiloAddress:
        """The ONE affinity rule for both transmit paths: route by
        target-grain hash so one grain's requests keep order through one
        gateway (ClientMessageCenter affinity routing), round-robin for
        untargeted traffic."""
        if msg.target_grain is not None:
            return gateways[msg.target_grain.uniform_hash % len(gateways)]
        self._gateway_rr = (self._gateway_rr + 1) % len(gateways)
        return gateways[self._gateway_rr]

    def transmit(self, msg: Message) -> None:
        msg.sending_silo = self._address
        self._mark_remote_trace(msg)  # client sends always leave the client
        gateways = self.fabric.alive_silos()
        if not gateways:
            raise SiloUnavailableError("no gateways available")
        self.fabric.deliver_via_gateway(self._pick_gateway(msg, gateways),
                                        msg)

    def transmit_batch(self, msgs: list) -> None:
        """Batched transmit (RuntimeClient.call_batch): the group is
        split per gateway by the same affinity rule as ``transmit``
        (shared ``_pick_gateway``) and each gateway's slice rides ONE
        ``deliver_batch`` hop."""
        gateways = self.fabric.alive_silos()
        if not gateways:
            raise SiloUnavailableError("no gateways available")
        groups: dict[SiloAddress, list] = {}
        for msg in msgs:
            msg.sending_silo = self._address
            self._mark_remote_trace(msg)
            groups.setdefault(self._pick_gateway(msg, gateways),
                              []).append(msg)
        for gw, batch in groups.items():
            try:
                self.fabric.deliver_via_gateway_batch(gw, batch)
            except Exception as e:  # noqa: BLE001 — one gateway's slice:
                # earlier slices were already delivered and will execute,
                # so this must NOT raise (the caller would unregister
                # their callbacks too) — fail exactly this slice
                self._fail_transmit(batch, e)

    def deliver(self, msg: Message) -> None:
        """Inbound from the fabric (the client message pump,
        OutsideRuntimeClient.RunClientMessagePump:235)."""
        if msg.direction == Direction.RESPONSE:
            self.receive_response(msg)
        elif self._observer_host.dispatch(msg):
            pass  # grain→client observer notification
        else:
            log.debug("client dropping unexpected message %s",
                      msg.method_name)

    def add_outgoing_call_filter(self, *filters) -> "ClusterClient":
        """AddOutgoingGrainCallFilter, client side (ClientBuilder analog):
        filters wrap every call this client sends."""
        self.outgoing_call_filters.extend(filters)
        return self

    # -- observers (CreateObjectReference / DeleteObjectReference) ---------
    def create_observer(self, obj):
        return self._observer_host.create_observer(obj)

    def delete_observer(self, ref) -> bool:
        return self._observer_host.delete_observer(ref)

    # -- lifecycle ---------------------------------------------------------
    async def connect(self) -> "ClusterClient":
        if not self.fabric.alive_silos():
            raise SiloUnavailableError("no silos to connect to")
        self.fabric.register_client(self)
        self.connected = True
        return self

    async def close_async(self) -> None:
        self.fabric.unregister_client(self)
        self.connected = False
        self.close()

    def get_grain(self, grain_class: type, key, key_ext: str | None = None):
        return self.grain_factory.get_grain(grain_class, key, key_ext)
