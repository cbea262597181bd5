"""Capability negotiation: score registered backends against a StorageSpec.

Following the capability-negotiation framing of *Design Principles of
Dynamic Resource Management for HPC* (2403.17107): the requester states
*what* it needs (`StorageSpec`), every registered `DataManagerBackend`
states what it *can* do, and this module arbitrates — each candidate either
produces a structured rejection reason or a scored `Offer`; the best
feasible offer wins, and a request nobody can serve raises
:class:`NegotiationError` carrying every per-backend rejection so the
caller can see exactly why (and relax the spec deliberately).

Candidate order: the spec's ``managers`` tuple when given (preference with
ordered fallbacks — only those backends are considered), otherwise every
registered backend. Preference rank dominates; among same-rank candidates
(the "any backend" case) the numeric score decides.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

from ..core.scheduler import AllocationError

if TYPE_CHECKING:
    from .backends import BackendRegistry, DataManagerBackend
    from .service import ProvisioningService
    from .spec import StorageSpec


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Why one backend declined a spec — the structured negotiation trace."""

    backend: str
    reason: str

    def __str__(self) -> str:
        return f"{self.backend}: {self.reason}"


@dataclasses.dataclass(frozen=True)
class Offer:
    """A feasible (backend, sizing, QoS) match for a spec."""

    backend: str
    score: float
    n_storage_nodes: int            # dedicated nodes the grant would draw
    provision_time_s: float         # modeled attach/deploy latency (fresh)
    bandwidth: float                # aggregate write B/s the grant delivers
    rejections: tuple[Rejection, ...] = ()   # backends that lost or declined


class NegotiationError(AllocationError):
    """No registered backend can serve the spec; carries every reason."""

    def __init__(self, spec_name: str, rejections: tuple[Rejection, ...]):
        self.spec_name = spec_name
        self.rejections = tuple(rejections)
        detail = "; ".join(str(r) for r in self.rejections) or "no backends registered"
        super().__init__(f"{spec_name!r}: no backend can serve this spec ({detail})")

    def reason_for(self, backend: str) -> Optional[str]:
        for r in self.rejections:
            if r.backend == backend:
                return r.reason
        return None


def negotiate(
    spec: "StorageSpec", service: "ProvisioningService", registry: "BackendRegistry"
) -> Offer:
    """Pick the best feasible backend for ``spec`` or raise NegotiationError."""
    if spec.managers:
        ranked: list[tuple[int, "DataManagerBackend"]] = []
        rejections: list[Rejection] = []
        for rank, name in enumerate(spec.managers):
            backend = registry.get(name)
            if backend is None:
                rejections.append(
                    Rejection(name, f"not registered (have: {registry.names()})")
                )
                continue
            ranked.append((rank, backend))
    else:
        ranked = list(enumerate_same_rank(registry))
        rejections = []

    offers: list[tuple[int, Offer]] = []
    for rank, backend in ranked:
        reason = backend.check(spec, service)
        if reason is not None:
            rejections.append(Rejection(backend.name, reason))
            continue
        offers.append((rank, backend.offer(spec, service)))
    if not offers:
        raise NegotiationError(spec.name, tuple(rejections))
    # preference rank first (spec's ordered fallbacks), then highest score
    rank, best = min(offers, key=lambda ro: (ro[0], -ro[1].score))
    return dataclasses.replace(best, rejections=tuple(rejections))


def enumerate_same_rank(registry: "BackendRegistry"):
    """All registered backends at equal preference: score alone decides."""
    for backend in registry:
        yield 0, backend


class OfferCache:
    """Memoized :func:`negotiate`, keyed by spec *signature* + state epoch.

    Negotiation is name-blind (see :meth:`StorageSpec.signature`), so a
    campaign of 50k jobs sharing a handful of spec shapes scores backends a
    handful of times, not 50k. Staleness is epoch-based: the caller passes
    whatever state its spec's offers can depend on — for EPHEMERAL and
    PERSISTENT specs that is static over a campaign (sizing and QoS are
    checked against the whole inventory), for POOLED specs it is the
    PoolManager epoch, so those re-score exactly when a pool, its lease
    ledger, or the catalog actually changed. Failures are cached as their
    rejection tuple and re-raised under the asking spec's name.
    """

    def __init__(self) -> None:
        # signature -> (epoch, Offer | tuple[Rejection, ...])
        self._results: dict[tuple, tuple] = {}
        self.hits = 0
        self.misses = 0

    def lookup(self, sig: tuple, epoch: tuple):
        """The cached result — an :class:`Offer`, or the rejection tuple of
        a cached failure — iff one exists for this signature at this epoch;
        None otherwise."""
        cached = self._results.get(sig)
        if cached is not None and cached[0] == epoch:
            self.hits += 1
            return cached[1]
        return None

    def store(self, sig: tuple, epoch: tuple, result) -> None:
        self.misses += 1
        self._results[sig] = (epoch, result)
