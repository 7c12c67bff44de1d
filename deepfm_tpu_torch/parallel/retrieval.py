"""Two-tower training on a ``[data x model]`` grid of ranks: counterpart of
``deepfm_tpu/parallel/retrieval.py`` (``_build_init``,
``make_retrieval_context``, ``_local_forward``, the train and eval steps,
``shard_retrieval_batch``), one process per card as parallel/spmd.py runs
the CTR families.

* **Tables.** ``user_embedding`` and ``item_embedding`` are padded to
  :func:`~.spmd.padded_vocab` of their vocabularies at ``model_parallel``
  M (no window multiple: JAX pads the two-tower tables to M alone), their
  pad rows zeroed, and split by rows over each model group; the towers are
  replicated.  Every rank draws the weights from ``run.seed`` and takes
  rank 0's by broadcast.  The lookups assemble their rows through the
  model group (``ShardedTables.rows``, parallel/embedding.py), the L2
  penalty sums the shards.
* **The candidate pool.** Each data index encodes its own slice of the
  global batch; the item encodings are then all-gathered over the data
  group (:class:`GatherItems`, whose backward all-reduces the pool's
  gradient over the group and keeps this index's rows: the transpose JAX
  derives for its all-gather), so every query scores against all B global
  items, its positive at ``data_index·b + arange(b)``.  Softmax rows are
  complete on every rank: the loss is the dense full-batch loss.
* **Gradients** are averaged over the data group in one all-reduce of a
  flat buffer (the replicated part, the loss and metrics, a stop flag,
  then the row shards' gradients), and the ranks of a model group take
  model index 0's replicated part by broadcast, as parallel/spmd.py does.

Without a process group these are the single-card steps of
train/retrieval.py.  :class:`RetrievalSharding` is the state's
``sharding``: ``full_state`` and ``load_full_state`` (parallel/spmd.py)
gather and cut the two tables by it, so a checkpoint or an export holds
them whole.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import Config
from ..models.two_tower import (in_batch_softmax_loss, item_vocab, retrieval_metrics,
                                two_tower_l2_penalty, user_vocab)
from ..train import retrieval as single
from ..train.optimizer import build_optimizer
from ..train.step import TrainState
from .embedding import ModelAxis, ShardedTables, resolve_shard_exchange
from .mesh import DistContext
from .spmd import _broadcast_weights, _unflatten_into, padded_vocab

TABLES = ("user_embedding", "item_embedding")
METRICS = ("loss", "top1_acc", "recall_at_10")


@dataclass
class RetrievalSharding:
    """How a two-tower state lies on the grid: the context, each table's
    true vocabulary and its rows on one shard."""

    ctx: DistContext
    true_vocab: dict
    rows: dict
    zero: bool = False

    @property
    def mp(self) -> int:
        return self.ctx.model_parallel

    @property
    def dp(self) -> int:
        return self.ctx.data_parallel

    def window(self, key: str) -> tuple[int, int]:
        """(first row, rows) of table ``key`` on this rank."""
        return self.ctx.model_index * self.rows[key], self.rows[key]

    def sharded_keys(self, params) -> tuple[str, ...]:
        return tuple(k for k in TABLES if k in params) if self.mp > 1 else ()


def padded_model_config(cfg: Config, model_parallel: int):
    """``cfg.model`` with both vocabularies padded for ``model_parallel``
    shards (JAX ``make_retrieval_context``)."""
    return cfg.model.__class__.from_dict({
        **cfg.model.to_dict(),
        "user_vocab_size": padded_vocab(user_vocab(cfg.model), model_parallel),
        "item_vocab_size": padded_vocab(item_vocab(cfg.model), model_parallel)})


def create_retrieval_dp_state(cfg: Config, ctx: DistContext) -> TrainState:
    """The two-tower train state on this rank (module docstring); lr scaled
    by the data-parallel size where configured."""
    mp = ctx.model_parallel
    true = {"user_embedding": user_vocab(cfg.model), "item_embedding": item_vocab(cfg.model)}
    state = single.create_retrieval_state(cfg, ctx.device,
                                          data_parallel_size=ctx.data_parallel,
                                          model_cfg=padded_model_config(cfg, mp))
    model = state.model
    if ctx.group is not None:
        _broadcast_weights(model, ctx)
    rows = {}
    with torch.no_grad():
        for key in TABLES:
            table = getattr(model, key)
            table[true[key]:] = 0.0
            rows[key] = table.shape[0] // mp
    sharding = RetrievalSharding(ctx, true, rows)
    if mp > 1:
        for key in TABLES:
            lo, n = sharding.window(key)
            setattr(model, key, torch.nn.Parameter(getattr(model, key).detach()[lo:lo + n]
                                                   .clone()))
        exchange = resolve_shard_exchange(cfg, ctx.data_parallel, ctx.device.type)
        model.sharded = ShardedTables(ModelAxis(ctx.model_group, mp, ctx.model_index),
                                      exchange=exchange,
                                      capacity=cfg.model.shard_exchange_capacity,
                                      table_grad=cfg.model.table_grad)
        # the slots at the shards' shapes
        state.optimizer = build_optimizer(cfg.optimizer, dict(model.named_parameters()),
                                          data_parallel_size=ctx.data_parallel)
    state.sharding = sharding
    return state


def local_batch(batch: dict, ctx: DistContext) -> dict:
    """This data index's contiguous slice of a global batch (JAX
    ``shard_retrieval_batch``; the retrieval tasks check the ids of the
    whole ratings file against both vocabularies before the first step)."""
    b = np.asarray(batch["user_ids"]).shape[0]
    dp = ctx.data_parallel
    if b % dp:
        raise ValueError(f"global batch {b} not divisible by data_parallel {dp}")
    n = b // dp
    lo = ctx.data_index * n
    return {k: np.asarray(batch[k])[lo:lo + n] for k in single.RETRIEVAL_BATCH_KEYS}


class GatherItems(torch.autograd.Function):
    """``[b, D]`` on each rank of the data group -> ``[dp·b, D]`` in data
    index order; the backward sums the pool's gradient over the group
    (an all-reduce: gloo has no reduce-scatter) and keeps this rank's
    rows."""

    @staticmethod
    def forward(ctx, items, group, dp: int, index: int):
        ctx.group, ctx.b, ctx.index = group, items.shape[0], index
        out = items.new_empty((dp * items.shape[0],) + tuple(items.shape[1:]))
        dist.all_gather_into_tensor(out, items.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        lo = ctx.index * ctx.b
        return grad[lo:lo + ctx.b], None, None, None


def local_forward(model, batch: dict, ctx: DistContext):
    """Local towers -> the global item pool -> (per-example CE [b], scores
    [b, dp·b], labels [b])."""
    u, i = model(batch["user_ids"], batch["user_vals"], batch["item_ids"], batch["item_vals"])
    b = u.shape[0]
    items = i if ctx.data_parallel == 1 else GatherItems.apply(
        i, ctx.data_group, ctx.data_parallel, ctx.data_index)
    labels = ctx.data_index * b + torch.arange(b, device=u.device)
    ce, scores = in_batch_softmax_loss(u, items, labels, temperature=model.cfg.temperature)
    return ce, scores, labels


def _pmean(state: TrainState, grads: dict, metrics: dict, ctx: DistContext, stop: bool):
    """The data group's mean of the gradients and metrics and whether any
    rank was asked to stop (one all-reduce); the replicated part from model
    index 0 of each model group."""
    keys = state.sharding.sharded_keys(grads)
    order = [k for k in grads if k not in keys] + list(keys)
    dev = state.model.user_embedding.device
    means = [*(grads[k] for k in order[:len(order) - len(keys)]),
             *(metrics[k].reshape(1) for k in METRICS)]
    stop_flag = torch.tensor([float(stop)], device=dev)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in means] + [stop_flag]
                     + [grads[k].reshape(-1) for k in keys])
    n_rep = sum(t.numel() for t in means)
    if ctx.data_group is not None:
        dist.all_reduce(flat, group=ctx.data_group)
    if ctx.model_parallel > 1:
        dist.broadcast(flat[:n_rep + 1], src=ctx.data_index * ctx.model_parallel,
                       group=ctx.model_group)
        dist.all_reduce(flat[n_rep:n_rep + 1], group=ctx.model_group)
    any_stop = float(flat[n_rep]) > 0.5
    flat[:n_rep] /= ctx.data_parallel
    flat[n_rep + 1:] /= ctx.data_parallel
    out = [torch.empty_like(grads[k]) for k in order[:len(order) - len(keys)]]
    out += [torch.empty(1, device=dev) for _ in METRICS]
    _unflatten_into(flat[:n_rep], out)
    tables = [torch.empty_like(grads[k]) for k in keys]
    _unflatten_into(flat[n_rep + 1:], tables)
    averaged = dict(zip(order, out[:len(order) - len(keys)] + tables))
    mean_metrics = {k: t[0] for k, t in zip(METRICS, out[len(order) - len(keys):])}
    return {k: averaged[k] for k in grads}, mean_metrics, any_stop


def train_step(state: TrainState, batch: dict, ctx: DistContext, *,
               stop: bool = False) -> dict:
    """One synchronous step on this data index's slice ``batch`` of the
    global batch: ``loss``, ``top1_acc``, ``recall_at_10`` (means over the
    data indices) and ``any_stop`` (some rank was asked to stop).  Without
    a process group: the single-card step."""
    if ctx.group is None:
        return {**single.train_step(state, batch), "any_stop": stop}
    model = state.model
    batch = single.batch_on(batch, model.user_embedding.device)
    params = dict(model.named_parameters())
    ce, scores, labels = local_forward(model, batch, ctx)
    loss = ce.mean() + two_tower_l2_penalty(model, model.cfg.l2_reg)
    grads = torch.autograd.grad(loss, list(params.values()))
    local = single.step_metrics(loss, scores, labels)
    grads, metrics, any_stop = _pmean(state, dict(zip(params, grads)), local, ctx, stop)
    state.optimizer.step(params, grads)
    state.step += 1
    return {**metrics, "any_stop": any_stop}


@torch.no_grad()
def eval_step(state: TrainState, batch: dict, ctx: DistContext) -> dict:
    """``loss`` (the data indices' mean CE plus the penalty), ``count`` (the
    global batch), ``top1_acc`` and ``recall_at_10`` as floats."""
    model = state.model
    if ctx.group is None:
        return {k: float(v) for k, v in single.eval_step(model, batch).items()}
    batch = single.batch_on(batch, model.user_embedding.device)
    ce, scores, labels = local_forward(model, batch, ctx)
    penalty = two_tower_l2_penalty(model, model.cfg.l2_reg)
    m = retrieval_metrics(scores, labels)
    flat = torch.stack([ce.mean(), m["top1_acc"], m["recall_at_10"]]).to(torch.float32)
    if ctx.data_group is not None:
        dist.all_reduce(flat, group=ctx.data_group)
    flat /= ctx.data_parallel
    loss, top1, recall = flat.tolist()
    return {"loss": loss + float(penalty), "count": float(ce.shape[0] * ctx.data_parallel),
            "top1_acc": top1, "recall_at_10": recall}


def servable_state_dict(state: TrainState) -> dict:
    """The one-card ``state_dict`` (both tables whole, at the padded
    vocabularies of the state's config): a collective on a grid."""
    from .spmd import full_state

    return full_state(state)["model"]


def checkpoint_context(ctx: DistContext) -> DistContext:
    """The context a two-tower checkpoint is written under: the tables are
    gathered whole (``full_state``) and rank 0 writes one file, whatever
    the row split."""
    return dataclasses.replace(ctx, model_parallel=1)
