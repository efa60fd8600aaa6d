"""Placement directors (reference L7).

Re-design of Orleans' src/Orleans.Runtime/Placement/: directors
``RandomPlacementDirector.cs:8``, ``PreferLocalPlacementDirector.cs:13``,
``HashBasedPlacementDirector.cs:6``, ``ActivationCountPlacementDirector.cs:13``
(+ ``DeploymentLoadPublisher.cs:17`` stats), ``StatelessWorkerDirector.cs:8``
(handled in-catalog as local replicas), managed by
``PlacementDirectorsManager.cs:9``.

Directors run on the directory-owner silo at first-placement time (the
``AddressMessage`` path): given the requesting silo and the current cluster
view, choose the silo that will host the new activation.

The port's copy of ``orleans_tpu.placement.strategies``.
"""

from __future__ import annotations

import random
from typing import Callable, Protocol

from ..core.ids import GrainId, SiloAddress

__all__ = ["PlacementDirector", "PlacementManager",
           "ActivationCountPlacement", "ActivationCountP2CPlacement"]


class PlacementDirector(Protocol):
    def place(self, grain_id: GrainId, requester: SiloAddress,
              silos: list[SiloAddress]) -> SiloAddress: ...


class RandomPlacement:
    """Default strategy (RandomPlacementDirector.cs:8)."""

    def place(self, grain_id, requester, silos):
        return random.choice(silos)


class PreferLocalPlacement:
    """Requesting silo if alive, else random (PreferLocalPlacementDirector)."""

    def place(self, grain_id, requester, silos):
        if requester in silos:
            return requester
        return random.choice(silos)


class HashBasedPlacement:
    """Deterministic by grain hash (HashBasedPlacementDirector.cs:6)."""

    def place(self, grain_id, requester, silos):
        ordered = sorted(silos, key=lambda s: s.uniform_hash)
        return ordered[grain_id.uniform_hash % len(ordered)]


class ActivationCountPlacement:
    """Least-loaded by activation count (ActivationCountPlacementDirector
    + DeploymentLoadPublisher stats). ``load_of`` abstracts the stats feed;
    in-proc fabrics read counts directly, multi-host deployments plug the
    publisher's view in.

    Full scan (the default): every candidate's load is read and the
    minimum wins — the strongest balance, at O(silos) stat reads per
    placement. For large clusters under churn use the power-of-two-choices
    variant (``activation_count_p2c``)."""

    def __init__(self, load_of: Callable[[SiloAddress], int]):
        self.load_of = load_of

    def place(self, grain_id, requester, silos):
        return min(silos, key=self.load_of)


class ActivationCountP2CPlacement(ActivationCountPlacement):
    """Power-of-two-choices variant: sample TWO random silos (plus the
    requester) and take the least loaded — Orleans's own
    ActivationCountPlacementDirector samples rather than scanning, because
    with k=2 random choices the max load is within O(log log n) of optimal
    while stat reads stay O(1) per placement regardless of cluster size."""

    def place(self, grain_id, requester, silos):
        candidates = random.sample(silos, min(2, len(silos)))
        if requester in silos:
            candidates.append(requester)
        return min(candidates, key=self.load_of)


class PlacementManager:
    """Strategy-name → director registry (PlacementDirectorsManager.cs:9)."""

    def __init__(self, load_of: Callable[[SiloAddress], int] | None = None):
        load_of = load_of or (lambda s: 0)
        self.directors: dict[str, PlacementDirector] = {
            "random": RandomPlacement(),
            "prefer_local": PreferLocalPlacement(),
            "hash": HashBasedPlacement(),
            "activation_count": ActivationCountPlacement(load_of),
            "activation_count_p2c": ActivationCountP2CPlacement(load_of),
        }

    def director_by_name(self, name: str | None) -> PlacementDirector:
        if name == "stateless_worker":
            # stateless workers replicate locally; the caller's silo hosts
            return self.directors["prefer_local"]
        return self.directors.get(name or "random", self.directors["random"])

    def director_for(self, grain_class: type | None) -> PlacementDirector:
        name = getattr(grain_class, "__orleans_placement__", None) \
            if grain_class is not None else None
        return self.director_by_name(name)
