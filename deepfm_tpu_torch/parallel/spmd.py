"""Synchronous data-parallel training step: counterpart of the dense path of
``deepfm_tpu/parallel/spmd.py`` (``_pmean_grads``, ``_sync_model_state``,
the per-shard dropout key, ``create_spmd_state``), as the reference's
Horovod path ran it: one process per card, one all-reduce a step, the lr
scaled by the world size when ``optimizer.scale_lr_by_data_parallel`` is
set.

Each rank runs the single-card step's forward and backward on its own
batch (``data.batch_size`` records: the global batch is world x that),
then :func:`pmean_grads` averages across ranks, in ONE ``all_reduce`` over
one flat float32 buffer (Horovod's fusion buffer):

    [every gradient | BN moving statistics | loss, ce, pred_mean, label_mean
     | examples, has-next, stop, eval-now]

The gradients, the batch-norm moving statistics (``_sync_model_state``:
the forward's batch statistics stay local, the moving ones are averaged
after the step) and the four logged metrics are means over the ranks, as
the JAX step ``pmean``s them; the last four entries are sums.  Every rank
then applies the same optimizer update to the same averaged gradient, so
the replicas stay bit-identical.  The weights are drawn from one seed on
every rank and broadcast from rank 0 (:func:`create_dp_train_state`, the
``BroadcastGlobalVariablesHook`` guarantee); the dropout masks differ per
rank, as JAX folds the data index into its key.

Lockstep: a rank that stopped early would hang the others in the
all-reduce.  Each step carries three flags, so that every rank decides the
same thing at the same step: whether the rank holds a next batch (the
loop stops when any rank does not), whether it was asked to stop (a
SIGTERM reaches every rank under ``torch.distributed.run``, but not at the
same step: all stop when any was asked), and, from rank 0 alone, whether
its clock says the in-training eval is due (all evaluate).  Reading them
is one 16-byte device-to-host copy a step, which waits for the step's
all-reduce; the reader thread keeps decoding meanwhile.  At world size 1
they are not read.  :func:`agree` takes the first two once before the
first step.

Lazy embedding updates at world size > 1 are the lazy SPMD step, ROADMAP
A9, and raise.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..train.step import (TrainState, apply_dense, create_train_state, dense_grads,
                          train_step as single_train_step)
from .mesh import DistContext

_METRICS = ("loss", "ce", "pred_mean", "label_mean")
_LAZY_A9 = ("lazy_embedding_updates at world size > 1 is the lazy SPMD step, "
            "not ported yet (ROADMAP A9)")


def _bn_buffers(state: TrainState) -> list[torch.Tensor]:
    return [b for name, b in state.model.named_buffers()
            if name.endswith(("moving_mean", "moving_var"))]


def create_dp_train_state(cfg, ctx: DistContext) -> TrainState:
    """The train state on this rank's device: weights from ``run.seed``
    broadcast from rank 0, lr scaled by the world size when configured,
    and a dropout generator of this rank's own."""
    if cfg.optimizer.lazy_embedding_updates and ctx.world_size > 1:
        raise ValueError(_LAZY_A9)
    state = create_train_state(cfg, ctx.device, data_parallel_size=ctx.world_size)
    if ctx.group is not None:
        tensors = [t.data for t in state.model.state_dict().values()]
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=0, group=ctx.group)
        _unflatten_into(flat, tensors)
    state.generator.manual_seed(state.generator.initial_seed() + ctx.rank)
    return state


def _unflatten_into(flat: torch.Tensor, tensors: list[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def _flags(ctx: DistContext, *, examples: int, has_next: bool, stop: bool,
           eval_now: bool) -> torch.Tensor:
    """This rank's tail of the flat buffer; only rank 0's clock counts."""
    return torch.tensor([float(examples), float(has_next), float(stop),
                         float(eval_now and ctx.rank == 0)], device=ctx.device)


def _read_flags(tail: torch.Tensor, ctx: DistContext) -> dict:
    total, flags, stops, evals = tail.tolist()
    return {"examples": int(total), "all_have_next": flags >= ctx.world_size - 0.5,
            "any_stop": stops > 0.5, "eval_now": evals > 0.5}


def agree(ctx: DistContext, *, has_next: bool, stop: bool) -> tuple[bool, bool]:
    """``(every rank has a batch, some rank was asked to stop)``: one
    all-reduce before the first step, so that no rank steps alone."""
    if ctx.group is None:
        return has_next, stop
    tail = _flags(ctx, examples=0, has_next=has_next, stop=stop, eval_now=False)
    dist.all_reduce(tail, group=ctx.group)
    flags = _read_flags(tail, ctx)
    return flags["all_have_next"], flags["any_stop"]


def pmean_grads(grads: dict, metrics: dict, state: TrainState, ctx: DistContext,
                *, examples: int, has_next: bool, stop: bool = False,
                eval_now: bool = False) -> tuple[dict, dict]:
    """One all-reduce of the flat buffer: returns the cross-rank mean
    gradients and metrics, plus ``examples`` (the global batch),
    ``all_have_next``, ``any_stop`` and ``eval_now`` (host values); writes
    the averaged BN moving statistics back into the model."""
    bn = _bn_buffers(state)
    means = [*grads.values(), *bn, *(metrics[k] for k in _METRICS)]
    tail = _flags(ctx, examples=examples, has_next=has_next, stop=stop,
                  eval_now=eval_now)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in means] + [tail])
    dist.all_reduce(flat, group=ctx.group)
    n_mean = flat.numel() - tail.numel()
    flat[:n_mean] /= ctx.world_size
    out = [torch.empty_like(t) for t in means]
    _unflatten_into(flat[:n_mean], out)
    grads = dict(zip(grads, out))
    with torch.no_grad():
        for b, new in zip(bn, out[len(grads):]):
            b.copy_(new)
    metrics = dict(zip(_METRICS, out[len(grads) + len(bn):]))
    if ctx.world_size == 1:
        metrics.update(examples=examples, all_have_next=has_next, any_stop=stop,
                       eval_now=eval_now)
    else:
        metrics.update(_read_flags(flat[n_mean:], ctx))
    return grads, metrics


def train_step(state: TrainState, batch: dict, ctx: DistContext, *,
               has_next: bool = True, stop: bool = False,
               eval_now: bool = False) -> dict:
    """One synchronous data-parallel step on this rank's ``batch``; returns
    the cross-rank mean metrics, the global ``examples`` and the agreed
    flags: every rank holds a next batch (``all_have_next``), some rank
    was asked to stop (``any_stop``), rank 0 says eval now
    (``eval_now``).  Without a process group it is the single-card step,
    and the flags are this process's own."""
    examples = int(batch["label"].shape[0])
    if state.lazy is not None and ctx.world_size > 1:
        raise ValueError(_LAZY_A9)
    if ctx.group is None or state.lazy is not None:
        return {**single_train_step(state, batch), "examples": examples,
                "all_have_next": has_next, "any_stop": stop, "eval_now": eval_now}
    grads, metrics = dense_grads(state, batch)
    grads, metrics = pmean_grads(grads, metrics, state, ctx, examples=examples,
                                 has_next=has_next, stop=stop, eval_now=eval_now)
    apply_dense(state, grads)
    return metrics
