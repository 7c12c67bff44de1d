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

The ranks form a ``[data_parallel x model_parallel]`` grid, laid out as
JAX lays its ``[dp, mp]`` device mesh: rank ``r`` sits at data index
``r // mp`` and model index ``r % mp``.  The ``mp`` ranks of one data index
(a model group) hold the row shards of fm_w and fm_v and read the same
batches; the ``dp`` ranks of one model index (a data group) hold the same
shard and average its gradient.  Both kinds of group are made with
``dist.new_group`` (every rank creates every group, in the same order).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core.config import MeshConfig
from ..core.platform import resolve_device
from ..data.sharding import WorkerTopology


@dataclass(frozen=True)
class DistContext:
    """This process's place in the ``[data x model]`` grid.  ``group`` is
    the world's group, None for a world of one process started without a
    launcher; ``data_group`` and ``model_group`` are this rank's data and
    model groups (the data group is the world's at ``model_parallel`` 1;
    None where the axis has one rank of a larger grid, or without a group);
    ``owns_group`` says whether :func:`initialize_distributed` started the
    group (and :func:`shutdown` ends it)."""

    world_size: int
    rank: int
    local_rank: int
    local_world_size: int
    device: torch.device
    group: object | None = None
    owns_group: bool = False
    model_parallel: int = 1
    data_group: object | None = None
    model_group: object | None = None

    @property
    def data_parallel(self) -> int:
        return self.world_size // self.model_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    @property
    def topology(self) -> WorkerTopology:
        """The record sharding's view of this rank: one shard a data index,
        so the ranks of a model group read the same records.  With one
        model shard it is the world's own layout (hosts and workers per
        host, ranks host-major as MPI and Horovod number them); with more,
        one host of ``data_parallel`` workers."""
        if self.model_parallel == 1:
            return WorkerTopology(num_hosts=self.world_size // self.local_world_size,
                                  host_rank=self.rank // self.local_world_size,
                                  workers_per_host=self.local_world_size,
                                  local_rank=self.local_rank)
        return WorkerTopology(num_hosts=1, host_rank=0,
                              workers_per_host=self.data_parallel,
                              local_rank=self.data_index)


def _env_int(name: str, default: int | None = None) -> int:
    value = os.environ.get(name)
    if value is None:
        if default is None:
            raise RuntimeError(f"the launcher's environment has no {name}")
        return default
    return int(value)


def initialize_distributed(cfg: MeshConfig, device=None) -> DistContext:
    """Join (or start) the process group this process belongs to, on
    ``device`` (default: the card), and make the grid's data and model
    groups.  Raises when ``mesh.model_parallel`` does not divide the world
    size, when ``mesh.data_parallel`` is neither -1/0 nor the world size
    over it, or when ``LOCAL_RANK`` names a card this machine does not
    have."""
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
    mp = cfg.model_parallel
    if ctx.world_size % mp:
        shutdown(ctx)
        raise ValueError(
            f"mesh.model_parallel={mp} does not divide the {ctx.world_size} "
            f"ranks the launcher started"
        )
    if cfg.data_parallel > 0 and cfg.data_parallel * mp != ctx.world_size:
        shutdown(ctx)
        raise ValueError(
            f"mesh.data_parallel={cfg.data_parallel} x model_parallel={mp} but "
            f"the launcher started {ctx.world_size} ranks; set data_parallel "
            f"to -1 or to the world size over model_parallel"
        )
    if mp == 1:  # the world is the one data group
        return dataclasses.replace(ctx, data_group=ctx.group)
    return _with_grid(ctx, mp)


def _with_grid(ctx: DistContext, mp: int) -> DistContext:
    """``ctx`` with its model and data groups: every rank creates every
    group, model groups first, in rank order, as ``dist.new_group``
    requires."""
    dp = ctx.world_size // mp
    model_group = data_group = None
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if d == ctx.rank // mp:
            model_group = g
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(dp)]) if dp > 1 else None
        if m == ctx.rank % mp:
            data_group = g
    return dataclasses.replace(ctx, model_parallel=mp, model_group=model_group,
                               data_group=data_group)


def shutdown(ctx: DistContext) -> None:
    """End the process group if :func:`initialize_distributed` started it."""
    if ctx.owns_group and dist.is_initialized():
        dist.destroy_process_group()
