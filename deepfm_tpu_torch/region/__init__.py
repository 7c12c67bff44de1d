"""Cross-region active-active serving, the region layer (the port's
counterpart of ``deepfm_tpu/region``).

One serving pool and one model store a region: the async
:class:`ManifestReplicator` keeps every region store behind but never torn
(online/publisher.py's marker-last order), and the :class:`RegionFront`
routes each user to a hash-stable home region with staleness-gated,
budgeted failover (the pool routers below it, serve/pool/; the
``TokenBudget`` of serve/control/hedge.py).

Everything here is host-side control plane: no module of this package
imports torch, and no model bytes cross the front
(``analysis/trace_audit.py audit_region_front``).
"""

from .front import RegionFront, make_front_handler, start_front
from .replicator import ManifestReplicator


def run_region_front(cfg):
    """The ``task_type=region-front`` entry point (train/loop.py): the
    manifest replicator over ``cfg.regions``' stores and the front, until
    the process stops."""
    from .__main__ import run_from_config

    return run_from_config(cfg)


__all__ = [
    "ManifestReplicator",
    "RegionFront",
    "make_front_handler",
    "run_region_front",
    "start_front",
]
