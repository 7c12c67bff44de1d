"""Tenant registry: named model variants bound to publish roots (the port's
copy of ``deepfm_tpu/fleet/registry.py``).

One serving pool, N live models.  A member holds three weight slots a
tenant, with every slot's bucket graphs captured at boot
(serve/pool/sharded.py), so a tenant whose model spec matches the pool's
serves through graphs of the same shapes and bodies, and a swap is a
``copy_`` into one of its slots: nothing is captured after boot.  The
registry is the control-plane half of that contract:

* each **tenant** is a name bound to its own publish root
  (``online/publisher.py``, the group-atomic swap's read path), its
  live-traffic split percentage, and optionally a ``shadow_of`` incumbent
  it scores silently against;
* **spec compatibility is enforced, not assumed**: a tenant whose model
  section diverges from the pool's on any executable-spec field
  (``core.config.EXECUTABLE_SPEC_FIELDS``) is refused with the differing
  fields named, at config load (here and ``Config.__post_init__``), at
  stage time against the published artifact's own config
  (``serve/pool/worker.GroupMember.stage``), and by the
  ``audit_multitenant`` contract (analysis/trace_audit.py);
* the registry never names devices, groups or slots: tenants are payload
  streams, and the pool maps them onto whatever topology it has.

Mutations (add, remove) land in the flight recorder (obs/flight.py), so a
fleet incident's timeline shows which tenant changed when.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..core.config import tenant_spec_divergence, validate_tenant_entries
from ..obs import flight as obs_flight
from .split import TrafficSplit

# the implicit tenant of a pool launched without a fleet config: every
# member serves exactly one tenant by this name, and the tenant-less wire
# surface maps onto it
DEFAULT_TENANT = "default"


@dataclass(frozen=True)
class TenantSpec:
    """One tenant binding (the normalized form of a ``fleet.tenants``
    entry): a name, its publish root, its live split share and, for a
    challenger, the incumbent it shadows."""

    name: str
    source: str = ""
    split_percent: float = 0.0
    shadow_of: str = ""
    # executable-neutral model overrides (one touching an executable-spec
    # field is refused: tenant_spec_divergence)
    model: dict = field(default_factory=dict)

    @property
    def is_shadow(self) -> bool:
        return bool(self.shadow_of)

    def to_dict(self) -> dict:
        return {"name": self.name, "source": self.source,
                "split_percent": self.split_percent,
                "shadow_of": self.shadow_of, "model": dict(self.model)}


def parse_tenants(entries) -> tuple[TenantSpec, ...]:
    """JSON text, dicts or TenantSpecs as validated specs (one validation
    path: ``core.config.validate_tenant_entries``)."""
    if entries is None:
        return ()
    if not isinstance(entries, str):
        entries = [e.to_dict() if isinstance(e, TenantSpec) else e for e in entries]
    return tuple(TenantSpec(**e) for e in validate_tenant_entries(entries))


class TenantRegistry:
    """The fleet's tenant table: validated specs, the traffic split over
    the serving arms, the shadow pairs, and each tenant's latest version.

    ``base_model`` (the pool's ``ModelConfig`` as a dict) arms the
    spec-compatibility gate; without it only the structural checks run
    (the config layer already checked divergence at load)."""

    def __init__(self, tenants=(), *, base_model: dict | None = None):
        self._lock = threading.Lock()
        self._base_model = dict(base_model) if base_model else None
        self._tenants: dict[str, TenantSpec] = {}
        for spec in parse_tenants(list(tenants) if tenants else []):
            self._check_spec(spec)
            self._tenants[spec.name] = spec

    # -- spec compatibility -------------------------------------------------
    def _check_spec(self, spec: TenantSpec) -> None:
        if self._base_model is None or not spec.model:
            return
        diff = tenant_spec_divergence(self._base_model, spec.model)
        if diff:
            raise ValueError(
                f"tenant {spec.name!r} diverges from its executable-sharing group on "
                f"{diff}: same-spec tenants must share ONE precompiled executable set "
                f"(core.config.EXECUTABLE_SPEC_FIELDS)")

    # -- the table ----------------------------------------------------------
    def names(self) -> list[str]:
        with self._lock:
            return list(self._tenants)

    def get(self, name: str) -> TenantSpec:
        with self._lock:
            try:
                return self._tenants[name]
            except KeyError:
                raise KeyError(f"unknown tenant {name!r} (have {list(self._tenants)})") \
                    from None

    def serving(self) -> list[TenantSpec]:
        """The live-traffic arms (declared order), shadows excluded."""
        with self._lock:
            return [t for t in self._tenants.values() if not t.is_shadow]

    def shadows(self) -> list[TenantSpec]:
        with self._lock:
            return [t for t in self._tenants.values() if t.is_shadow]

    def add(self, spec) -> TenantSpec:
        (spec,) = parse_tenants([spec])
        self._check_spec(spec)
        with self._lock:
            if spec.name in self._tenants:
                raise ValueError(f"tenant {spec.name!r} already registered")
            self._tenants[spec.name] = spec
        obs_flight.record("tenant_added", subsystem="fleet", tenant=spec.name,
                          source=spec.source, split_percent=spec.split_percent,
                          shadow_of=spec.shadow_of)
        return spec

    def remove(self, name: str) -> TenantSpec:
        with self._lock:
            spec = self._tenants.pop(name, None)
            if spec is None:
                raise KeyError(f"unknown tenant {name!r}")
            orphans = [t.name for t in self._tenants.values() if t.shadow_of == name]
            if orphans:
                self._tenants[name] = spec
                raise ValueError(f"tenant {name!r} is shadowed by {orphans}; remove the "
                                 f"shadow(s) first")
        obs_flight.record("tenant_removed", subsystem="fleet", tenant=name)
        return spec

    # -- routing views ------------------------------------------------------
    def split(self) -> TrafficSplit | None:
        """The router's traffic split over the serving arms; None when no
        percentages are declared (explicit ``X-Tenant`` selection only)."""
        arms = {t.name: t.split_percent for t in self.serving()}
        if not arms or not any(arms.values()):
            return None
        return TrafficSplit(arms)

    def shadow_pairs(self) -> list[tuple[str, str]]:
        """``(challenger, incumbent)`` pairs for the shadow scorer."""
        return [(t.name, t.shadow_of) for t in self.shadows()]

    # -- version resolution -------------------------------------------------
    def latest(self, name: str):
        from ..online.publisher import latest_manifest

        spec = self.get(name)
        return latest_manifest(spec.source) if spec.source else None
