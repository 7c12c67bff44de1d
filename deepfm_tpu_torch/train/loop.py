"""Training loop, on one card or on each rank of a data-parallel run:
counterpart of ``run_train`` and ``run_eval`` in
``deepfm_tpu/train/loop.py``.

``run_train`` joins the process group when a launcher started this
process (parallel/mesh.py; one process and no group otherwise), builds (or
takes, e.g. from ``convert.train_state_from_jax``) the train state, runs
the epoch loop over this rank's shard of the training files through the
synchronous data-parallel step (parallel/spmd.py: the single-card step
without a group), with a metrics line every ``run.log_steps`` steps,
evaluates once over ``data.val_data_dir`` with the streaming AUC, and
exports a servable to ``run.servable_model_dir`` (serve/export.py), which
the port's server loads.  At the end of the loop it logs a ``train_done``
line: world size, steps, global examples, seconds, global examples per
second and the share of the loop spent waiting on the input pipeline.

Every rank runs the same number of steps (the step's has-next flag), and
rank 0 alone logs and exports; the metrics it logs are the cross-rank
means.  Eval reads each validation record once across the ranks and
merges the AUC counts and loss sums in one all-reduce.

Not ported yet (ROADMAP A6): periodic checkpoints, resume, in-training
eval, and the standalone eval/infer/export tasks.
"""

from __future__ import annotations

import time
from typing import Iterator

import torch
from torch import nn

from ..core.config import Config
from ..data.pipeline import Prefetcher, eval_batches, make_input_pipeline
from ..ops.auc import auc_all_reduce, auc_init, auc_value
from ..parallel import spmd
from ..parallel.mesh import DistContext, initialize_distributed, shutdown
from ..serve.export import export_servable
from ..utils.logging import MetricLogger
from .step import TrainState, eval_step


def _tensors(batches: Iterator[dict], pin: bool = False) -> Iterator[dict]:
    """numpy batches -> CPU tensors; ``pin`` puts them in page-locked
    memory, so their copy to the card does not hold the host up."""
    for batch in batches:
        yield {k: torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v)
               for k, v in batch.items()}


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


class _Silent:
    """The logger of ranks other than 0: writes nothing, reads nothing."""

    def step(self, *args, **kwargs) -> None:
        pass

    def event(self, *args, **kwargs) -> None:
        pass


def run_eval(model: nn.Module, cfg: Config, *, log: MetricLogger | None = None,
             data_dir: str | None = None, ctx: DistContext | None = None) -> dict:
    """``{"auc", "loss", "examples"}`` over every record of the validation
    files (the tail batch included), in eval mode, each rank of ``ctx``
    reading its shard.  The loss is the example-weighted mean of the batch
    losses (CE + L2)."""
    dev = model.fm_v.device
    auc_state = auc_init(device=dev)
    loss_sum = torch.zeros((), device=dev)
    count = 0
    topo = ctx.topology if ctx is not None else None
    for batch in _tensors(eval_batches(cfg.data, topo, field_size=cfg.model.field_size,
                                       data_dir=data_dir)):
        auc_state, m = eval_step(model, auc_state, to_device(batch, dev))
        loss_sum = loss_sum + m["loss"] * m["count"]
        count += m["count"]
    loss_total = float(loss_sum)
    if ctx is not None and ctx.group is not None:
        auc_state, (loss_total, count) = auc_all_reduce(auc_state, loss_sum, count,
                                                        group=ctx.group)
        count = int(count)
    result = {
        "auc": float(auc_value(auc_state)),
        "loss": loss_total / count if count else float("nan"),
        "examples": count,
    }
    if log is not None:
        log.event("eval", **result)
    return result


def run_train(cfg: Config, *, device=None, state: TrainState | None = None,
              log: MetricLogger | None = None) -> TrainState:
    """The train task: epoch loop, final eval, export.  Returns the state."""
    ctx = initialize_distributed(cfg.mesh, device)
    try:
        return _train(cfg, ctx, state, log)
    finally:
        shutdown(ctx)


def _train(cfg: Config, ctx: DistContext, state: TrainState | None,
           log: MetricLogger | None) -> TrainState:
    if state is None:
        state = spmd.create_dp_train_state(cfg, ctx)
    dev = state.model.fm_v.device
    if ctx.rank != 0:
        log = _Silent()
    log = log or MetricLogger(log_steps=cfg.run.log_steps)
    host = make_input_pipeline(cfg.data, ctx.topology, field_size=cfg.model.field_size,
                               seed=cfg.run.seed)
    host = _tensors(host, pin=dev.type == "cuda")
    steps = examples = 0
    wait_s = 0.0
    t0 = time.perf_counter()
    with Prefetcher(host, depth=cfg.data.prefetch_batches) as feed:

        def take():
            nonlocal wait_s
            t = time.perf_counter()
            batch = next(feed, None)
            wait_s += time.perf_counter() - t
            return batch

        batch = take()
        while batch is not None:
            # the next batch is taken before this step, so the step can
            # tell the other ranks whether this one goes on
            nxt = take()
            metrics = spmd.train_step(state, to_device(batch, dev), ctx,
                                      has_next=nxt is not None)
            go_on = metrics.pop("all_have_next")
            b = metrics.pop("examples")
            steps += 1
            examples += b
            log.step(state.step, b, metrics)
            batch = nxt if go_on else None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    loop_s = time.perf_counter() - t0
    log.event("train_done", step=state.step, steps=steps, world_size=ctx.world_size,
              examples=examples, seconds=loop_s, examples_per_sec=examples / loop_s,
              input_wait_share=wait_s / loop_s)
    if cfg.data.val_data_dir:
        run_eval(state.model, cfg, log=log, ctx=ctx)
    if cfg.run.servable_model_dir and ctx.rank == 0:
        path = export_servable(cfg.model, state.model.state_dict(),
                               cfg.run.servable_model_dir)
        log.event("export", path=path)
    return state
