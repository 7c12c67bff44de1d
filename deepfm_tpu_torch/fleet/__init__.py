"""Multi-tenant model fleet: N model variants on one serving pool (the
port's counterpart of ``deepfm_tpu/fleet``).

A pool member holds three weight slots a tenant, every slot's bucket
graphs captured at boot (serve/pool/sharded.py), so selecting a tenant is
a slot pick and swapping one is a ``copy_`` into its slot: nothing is
captured after boot.  This package is the control plane over that fact:
the tenant registry (registry.py), hash-stable traffic splitting
(split.py) and off-response-path shadow scoring (shadow.py).  The serving
pool (serve/pool/) keys its slots, engines, generations and the
group-atomic swap by tenant; the ``audit_multitenant`` contract
(analysis/trace_audit.py) holds the sharing.
"""

from .registry import DEFAULT_TENANT, TenantRegistry, TenantSpec, parse_tenants
from .shadow import ShadowScorer
from .split import (SPACE, TrafficSplit, rendezvous_arm, rendezvous_ranking, sampled,
                    split_point)

__all__ = [
    "DEFAULT_TENANT",
    "SPACE",
    "ShadowScorer",
    "TenantRegistry",
    "TenantSpec",
    "TrafficSplit",
    "parse_tenants",
    "rendezvous_arm",
    "rendezvous_ranking",
    "sampled",
    "split_point",
]
