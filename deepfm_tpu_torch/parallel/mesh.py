"""Process-group setup: counterpart of ``deepfm_tpu/parallel/mesh.py``
(``initialize_distributed``).

The JAX package lays its devices out as a ``[data, model]`` mesh and joins
hosts through ``jax.distributed``.  The port runs the reference's own GPU
strategy, one process per card (Horovod's, here ``torch.distributed``), and
takes the topology from the launcher's environment, as
``python -m torch.distributed.run`` sets it: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and the rendezvous address
(``MASTER_ADDR``/``MASTER_PORT``).

* On the card each process takes card ``LOCAL_RANK`` and joins an NCCL
  group;
* with ``device="cpu"`` the group is gloo;
* with no launcher environment the world is one process and there is no
  group: the same computation as a one-rank group, without the collective;
* a group the caller already started (``init_process_group``) is used as
  it is.

Only the data axis exists: ``mesh.model_parallel > 1`` (row-sharded tables)
is ROADMAP A9, refused by ``MeshConfig``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core.config import MeshConfig
from ..core.platform import resolve_device
from ..data.sharding import WorkerTopology


@dataclass(frozen=True)
class DistContext:
    """This process's place in the data-parallel world.  ``group`` is None
    for a world of one process started without a launcher; ``owns_group``
    says whether :func:`initialize_distributed` started the group (and
    :func:`shutdown` ends it)."""

    world_size: int
    rank: int
    local_rank: int
    local_world_size: int
    device: torch.device
    group: object | None = None
    owns_group: bool = False

    @property
    def topology(self) -> WorkerTopology:
        """Hosts and workers per host as the record sharding reads them
        (ranks host-major, as MPI and Horovod number them)."""
        return WorkerTopology(num_hosts=self.world_size // self.local_world_size,
                              host_rank=self.rank // self.local_world_size,
                              workers_per_host=self.local_world_size,
                              local_rank=self.local_rank)


def _env_int(name: str, default: int | None = None) -> int:
    value = os.environ.get(name)
    if value is None:
        if default is None:
            raise RuntimeError(f"the launcher's environment has no {name}")
        return default
    return int(value)


def initialize_distributed(cfg: MeshConfig, device=None) -> DistContext:
    """Join (or start) the process group this process belongs to, on
    ``device`` (default: the card).  Raises when ``mesh.data_parallel`` is
    neither -1/0 nor the world size, or when ``LOCAL_RANK`` names a card
    this machine does not have."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        local_rank = _env_int("LOCAL_RANK", rank)
        local_world = _env_int("LOCAL_WORLD_SIZE", world)
        ctx = DistContext(world, rank, local_rank, local_world,
                          resolve_device(device), dist.group.WORLD)
    elif "WORLD_SIZE" in os.environ:
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
        local_rank, local_world = _env_int("LOCAL_RANK"), _env_int("LOCAL_WORLD_SIZE")
        want = torch.device("cuda" if device is None else device)
        if want.type == "cuda":
            count = torch.cuda.device_count()
            if local_rank >= count:
                raise RuntimeError(
                    f"LOCAL_RANK {local_rank} has no card: this machine has "
                    f"{count}; start at most one rank a card"
                )
            torch.cuda.set_device(local_rank)
            dev = resolve_device(torch.device("cuda", local_rank))
            dist.init_process_group("nccl", init_method="env://", world_size=world,
                                    rank=rank, device_id=dev)
        else:
            dev = resolve_device(want)
            dist.init_process_group("gloo", init_method="env://", world_size=world,
                                    rank=rank)
        ctx = DistContext(world, rank, local_rank, local_world, dev,
                          dist.group.WORLD, owns_group=True)
    else:
        ctx = DistContext(1, 0, 0, 1, resolve_device(device))
    if cfg.data_parallel > 0 and cfg.data_parallel != ctx.world_size:
        shutdown(ctx)
        raise ValueError(
            f"mesh.data_parallel={cfg.data_parallel} but the launcher started "
            f"{ctx.world_size} ranks; set it to -1 or to the world size"
        )
    return ctx


def shutdown(ctx: DistContext) -> None:
    """End the process group if :func:`initialize_distributed` started it."""
    if ctx.owns_group and dist.is_initialized():
        dist.destroy_process_group()
