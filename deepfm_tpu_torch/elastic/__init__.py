"""Elastic online training with a live N -> M reshard: the port's
counterpart of ``deepfm_tpu/elastic``.

* ``registry``: device availability (scriptable, or polled from a backend:
  the rendezvous store's device board or this process's own card)
* ``plan``: the grid policy and the minimal-traffic plan
* ``controller``: the ElasticTrainer of each rank process: detect ->
  drain -> commit -> replan -> reshard -> resume -> publish
* ``coord``: TTL leases, view consensus, the two-phase barrier, fencing
  tokens (and ``python -m deepfm_tpu_torch.elastic.coord``)
* ``mpmd``: the publisher program (``--task_type publish``)

The controller imports the model stack and ``coord`` runs as a module
(``python -m``), so neither is imported here: import the submodule.
"""

from .plan import Grid, ReshardPlan, choose_mesh, plan_reshard, reshard_state  # noqa: F401
from .registry import (DeviceBoard, LiveDeviceRegistry, RankDevice,  # noqa: F401
                       VirtualDeviceRegistry)
