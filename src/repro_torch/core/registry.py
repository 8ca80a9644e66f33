"""Live provider registry: pluggable slice/provider profiles feeding
the resource catalog at runtime.

The built-in :data:`repro_torch.core.catalog.CATALOG` is the static fleet.
Real multi-cloud advice (the paper's Fig. 1 instance-explosion problem)
needs *providers*: named sources of capacity that come and go, publish
their own prices, and degrade — the shape of the curated provider
profiles in SNIPPETS.md snippet 2 (id / name / service / active /
health), adapted to slice offerings.

A :class:`ProviderProfile` declares what a provider sells (chip
generation × slice size × pod count, with an optional per-chip price
override).  Registering it materializes one catalog
:class:`~repro_torch.core.catalog.SliceType` per offer, **named
``<provider>/<slice>``**, through :func:`repro_torch.core.catalog.
register_slice` — the append-only path that bumps the catalog
generation, so the planner's scored tables extend with just the new
rows (incremental re-scoring) instead of invalidating wholesale.

Health drives availability: marking a provider ``down`` unregisters its
slices (plans stop landing on it); marking it healthy again re-registers
them.  A price update replaces the affected offers (unregister +
re-register with the new :class:`~repro_torch.core.catalog.ChipSpec` price),
which bumps the generation twice and rebuilds downstream tables — the
correct cost: every cached $ column is stale.

Concurrent-mutation guarantee: catalog mutations during an in-flight
:func:`repro_torch.core.explore.explore` sweep are safe — every cell's cache
entry is keyed by the catalog generation observed when *that cell* was
planned (see docs/calibration.md §registry), so a mid-sweep
``register_slice`` can neither alias a stale cached cell to the new
generation nor corrupt the merged frontier.

A copy of the reference package's ``core/registry.py``.  An offer's chip
may also be a card of :data:`repro_torch.core.catalog.CARDS` (the H100):
a provider that sells it registers ``<provider>/h100-1`` and so on, as
it would a TPU slice.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.catalog import (
    CARDS,
    CHIPS,
    SliceType,
    chip_spec,
    find_slice,
    register_slice,
    unregister_slice,
)

HEALTH_STATES = ("unknown", "healthy", "degraded", "down")


@dataclasses.dataclass(frozen=True)
class SliceOffer:
    """One thing a provider sells: a slice of a chip generation, with an
    optional provider-specific $/chip-hour."""

    chip: str                # a generation in CHIPS, or a card in CARDS
    chips_per_pod: int
    num_pods: int = 1
    price_per_chip_hour: Optional[float] = None  # None = catalog price

    def slice_name(self, provider_id: str) -> str:
        base = f"{self.chip}-{self.chips_per_pod}"
        if self.num_pods > 1:
            base = f"{self.num_pods}x{base}"
        return f"{provider_id}/{base}"


@dataclasses.dataclass
class ProviderProfile:
    """A capacity source: identity + offers + liveness (snippet-2 shape:
    id / name / service / active, plus health and slice offers)."""

    id: str
    name: str
    service: str = "tpu"
    offers: Tuple[SliceOffer, ...] = ()
    active: bool = True
    health: str = "unknown"

    def __post_init__(self):
        self.offers = tuple(self.offers)
        if self.health not in HEALTH_STATES:
            raise ValueError(f"unknown health {self.health!r}; "
                             f"expected one of {HEALTH_STATES}")
        for o in self.offers:
            if o.chip not in CHIPS and o.chip not in CARDS:
                raise ValueError(f"offer chip {o.chip!r} not in CHIPS "
                                 f"({sorted(CHIPS)}) or CARDS "
                                 f"({sorted(CARDS)})")

    @property
    def available(self) -> bool:
        """Offers are in the catalog iff the provider is active and not
        down (degraded capacity still schedules — it just drifts, which
        calibration telemetry will surface)."""
        return self.active and self.health != "down"

    def to_doc(self) -> Dict[str, Any]:
        return {"id": self.id, "name": self.name, "service": self.service,
                "active": self.active, "health": self.health,
                "offers": [dataclasses.asdict(o) for o in self.offers]}

    @classmethod
    def from_doc(cls, doc: Mapping[str, Any]) -> "ProviderProfile":
        offers = tuple(SliceOffer(**o) for o in doc.get("offers", ()))
        return cls(id=doc["id"], name=doc.get("name", doc["id"]),
                   service=doc.get("service", "tpu"), offers=offers,
                   active=bool(doc.get("active", True)),
                   health=doc.get("health", "unknown"))


class ProviderRegistry:
    """The live provider set, mutating the catalog through
    ``register_slice``/``unregister_slice`` (and therefore through the
    catalog generation counter the planner's incremental re-scoring
    keys on)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._profiles: Dict[str, ProviderProfile] = {}
        self._registered: Dict[str, List[str]] = {}  # id -> slice names

    # -- catalog wiring --------------------------------------------------
    def _materialize(self, profile: ProviderProfile) -> List[str]:
        names: List[str] = []
        for offer in profile.offers:
            chip = chip_spec(offer.chip)
            if offer.price_per_chip_hour is not None:
                chip = dataclasses.replace(
                    chip, price_per_hour=float(offer.price_per_chip_hour))
            name = offer.slice_name(profile.id)
            register_slice(SliceType(name=name, chip=chip,
                                     chips_per_pod=offer.chips_per_pod,
                                     num_pods=offer.num_pods))
            names.append(name)
        return names

    def _withdraw(self, provider_id: str) -> None:
        for name in self._registered.pop(provider_id, []):
            try:
                unregister_slice(name)
            except KeyError:
                pass

    # -- public API ------------------------------------------------------
    def register(self, profile: ProviderProfile) -> List[SliceType]:
        """Add a provider; its offers join the catalog (append-only →
        one generation bump, incremental re-scoring downstream).
        Returns the materialized slice types."""
        with self._lock:
            if profile.id in self._profiles:
                raise ValueError(f"provider {profile.id!r} already "
                                 f"registered")
            self._profiles[profile.id] = profile
            if profile.available:
                self._registered[profile.id] = self._materialize(profile)
            return [find_slice(n)
                    for n in self._registered.get(profile.id, [])]

    def deregister(self, provider_id: str) -> ProviderProfile:
        """Remove a provider and withdraw its slices from the catalog."""
        with self._lock:
            profile = self._profiles.pop(provider_id, None)
            if profile is None:
                raise KeyError(f"unknown provider {provider_id!r}")
            self._withdraw(provider_id)
            return profile

    def set_health(self, provider_id: str, health: str) -> ProviderProfile:
        """Update liveness.  Transitioning to ``down`` withdraws the
        provider's slices; recovering re-registers them."""
        if health not in HEALTH_STATES:
            raise ValueError(f"unknown health {health!r}; "
                             f"expected one of {HEALTH_STATES}")
        with self._lock:
            profile = self._profiles.get(provider_id)
            if profile is None:
                raise KeyError(f"unknown provider {provider_id!r}")
            was = profile.available
            profile.health = health
            if was and not profile.available:
                self._withdraw(provider_id)
            elif not was and profile.available:
                self._registered[provider_id] = self._materialize(profile)
            return profile

    def set_active(self, provider_id: str, active: bool) -> ProviderProfile:
        with self._lock:
            profile = self._profiles.get(provider_id)
            if profile is None:
                raise KeyError(f"unknown provider {provider_id!r}")
            was = profile.available
            profile.active = bool(active)
            if was and not profile.available:
                self._withdraw(provider_id)
            elif not was and profile.available:
                self._registered[provider_id] = self._materialize(profile)
            return profile

    def update_price(self, provider_id: str, chip: str,
                     price_per_chip_hour: float) -> ProviderProfile:
        """Re-price every offer of one chip generation.  Replaces the
        affected catalog slices (withdraw + re-register) — a non-append
        mutation, so downstream caches rebuild, as they must: every
        memoized $ column is stale."""
        with self._lock:
            profile = self._profiles.get(provider_id)
            if profile is None:
                raise KeyError(f"unknown provider {provider_id!r}")
            if not any(o.chip == chip for o in profile.offers):
                raise KeyError(f"provider {provider_id!r} has no "
                               f"{chip!r} offers")
            profile.offers = tuple(
                dataclasses.replace(
                    o, price_per_chip_hour=float(price_per_chip_hour))
                if o.chip == chip else o
                for o in profile.offers)
            if profile.available:
                self._withdraw(provider_id)
                self._registered[provider_id] = self._materialize(profile)
            return profile

    # -- introspection ---------------------------------------------------
    def profiles(self) -> List[ProviderProfile]:
        with self._lock:
            return [self._profiles[k] for k in sorted(self._profiles)]

    def slice_names(self, provider_id: str) -> List[str]:
        with self._lock:
            return list(self._registered.get(provider_id, []))

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "providers": len(self._profiles),
                "available": sum(1 for p in self._profiles.values()
                                 if p.available),
                "catalog_slices": sum(len(v)
                                      for v in self._registered.values()),
                "by_health": {
                    h: sum(1 for p in self._profiles.values()
                           if p.health == h)
                    for h in HEALTH_STATES
                    if any(p.health == h for p in self._profiles.values())
                },
            }


# The process-wide registry (mirrors catalog.CATALOG's module-level
# convention; tests construct private ProviderRegistry instances).
PROVIDERS = ProviderRegistry()
