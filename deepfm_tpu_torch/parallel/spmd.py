"""Synchronous training over a ``[data x model]`` grid of ranks: counterpart
of ``deepfm_tpu/parallel/spmd.py`` (``padded_vocab``, ``create_spmd_state``,
``_sharded_penalty``, ``_sync_model_state``, ``_pmean_grads``, the dense
and lazy local steps, the eval and predict steps at ``model_parallel > 1``)
as the reference's Horovod and parameter-server paths ran it: one process
per card (parallel/mesh.py).

**Data parallel** (``model_parallel`` 1): each rank runs the single-card
step's forward and backward on its own batch (``data.batch_size`` records:
the global batch is dp x that), then :func:`pmean_grads` averages across
ranks in ONE ``all_reduce`` over one flat float32 buffer (Horovod's fusion
buffer):

    [every gradient | BN moving statistics | loss, ce, pred_mean, label_mean
     | examples, has-next, stop, eval-now]

At ``model_parallel`` > 1 the same buffer (the row shards' gradients
last) is all-reduced over the data group; the ranks of a model group then
take model index 0's replicated part by broadcast and sum the flags.
**Row-sharded tables** (``model_parallel`` M > 1): fm_w and fm_v are
padded to :func:`padded_vocab` rows and split by rows over each model
group; the rest of the model is replicated.  The ranks of a model group
read the same batch, assemble its rows through the exchange
(parallel/embedding.py: psum or the deduplicated all-to-all, with the psum
fallback) and run the fused kernels on the compact table.  The L2 penalty
sums the shards over the group.  Gradients: every leaf is averaged over
the data group; a replicated leaf then takes model index 0's value on
every rank of the model group (JAX ``pmean``s identical values over the
model axis).  The metrics are means over the data indices, and the
examples count each data index once.

**ZeRO** (``optimizer.zero_sharding``, on at more than one data index
unless "off"): the optimizer is train/optimizer.py's ``ZeroOptimizer``,
which reduce-scatters the raw gradients itself; the flat buffer then
carries the BN statistics, the metrics and the flags only.

**Lazy Adam** on the tables (:func:`lazy_train_step`, JAX
``_build_lazy_local_step``): ids outside ``[0, feature_size)`` map to the
sentinel ``total_rows`` (they gather zero rows and train none); the rows
are assembled (the exchange at M > 1, a local sort at M 1) as a compact
table, the fused kernels run on it, and the gradient is taken with
respect to the compact rows: one summed gradient per slot.  Each data
index's ``(slot row, gradient / dp)`` pairs are gathered over the data
group (``update_full``) or, under the alltoall exchange at more than one
data index, first packed into at most ``capacity`` distinct rows
(``update_dedup``; a rank whose batch has more distinct ids makes the whole
data group take ``update_full``, agreed with one all-reduce MAX); the
gathered pairs are sorted into distinct rows again and each shard applies
``lazy_adam_update_shard`` to the rows it owns.  The rest of the model
takes the dense (or ZeRO) update.

Every rank draws the weights from ``run.seed`` and takes rank 0's by
broadcast (the ``BroadcastGlobalVariablesHook`` guarantee), then keeps its
rows.  The dropout generator is seeded with the data index, as JAX folds
the data index into its key: the replicas of a model group draw the same
masks and stay bit-identical.

Lockstep: a rank that stopped early would hang the others in a
collective.  Each step carries three flags, so that every rank decides the
same thing at the same step: whether the rank holds a next batch (the
loop stops when any rank does not), whether it was asked to stop (a
SIGTERM reaches every rank under ``torch.distributed.run``, but not at the
same step: all stop when any was asked), and, from rank 0 alone, whether
its clock says the in-training eval is due (all evaluate).  Reading them
is one 16-byte device-to-host copy a step, which waits for the step's
all-reduce; the reader thread keeps decoding meanwhile.  At world size 1
they are not read.  :func:`agree` takes the first two once before the
first step.

:func:`local_state` gives the train state as this rank holds it (its
rows of the tables; ZeRO's moments at their parameters' shapes), and
:func:`split_tables` cuts it into the tables' rows and the replicated
rest: the checkpoint's layout on a grid (checkpoint/ckpt.py), which
:func:`join_tables` and :func:`load_local_state` take back.
:func:`full_state` and :func:`load_full_state` give and take the one-card
layout (tables whole, padded as trained): export, conversion, and the
checkpoints of the grid's first release.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..models.base import get_model
from ..models.deepfm import fm_v_rows, window_multiple
from ..ops.embedding import sort_segments
from ..ops.fused_ctr import fused_ctr_interaction
from ..train.lazy import init_lazy_state, lazy_adam_update_shard
from ..train.optimizer import (ZeroOptimizer, build_optimizer, resolve_zero_sharding,
                               schedule_value)
from ..train.step import (LAZY_TABLE_KEYS, TrainState, _check_lazy, _metrics,
                          apply_dense, dense_grads, graphed_train_step,
                          sigmoid_cross_entropy)
from .embedding import (ModelAxis, exchange_capacity, exchange_rows,
                        resolve_shard_exchange, tables_from_config)
from .mesh import DistContext

_METRICS = ("loss", "ce", "pred_mean", "label_mean")

# the lazy grid step's table updates since import (or since a caller reset
# them): by the unique pack (update_dedup) or by every slot (update_full)
lazy_updates = {"dedup": 0, "full": 0}


def padded_vocab(feature_size: int, model_parallel: int, window_multiple: int = 1) -> int:
    """The next row count divisible by both the shard count and the fused
    kernel's window multiple (JAX's lcm rule)."""
    m = math.lcm(max(1, model_parallel), max(1, window_multiple))
    return -(-feature_size // m) * m


@dataclass
class Sharding:
    """How a train state lies on the grid: the context, the true vocabulary
    (``feature_size``), the table rows over every shard and on this one,
    whether the ZeRO update runs, and the resolved exchange."""

    ctx: DistContext
    true_vocab: int
    total_rows: int
    rows: int
    zero: bool
    exchange: str

    @property
    def mp(self) -> int:
        return self.ctx.model_parallel

    @property
    def dp(self) -> int:
        return self.ctx.data_parallel

    @property
    def offset(self) -> int:
        return self.ctx.model_index * self.rows

    @property
    def axis(self) -> ModelAxis:
        return ModelAxis(self.ctx.model_group, self.mp, self.ctx.model_index)

    def sharded_keys(self, params) -> tuple[str, ...]:
        return tuple(k for k in LAZY_TABLE_KEYS if k in params) if self.mp > 1 else ()


def _bn_buffers(model) -> list[torch.Tensor]:
    return [b for name, b in model.named_buffers()
            if name.endswith(("moving_mean", "moving_var"))]


def _broadcast_weights(model, ctx: DistContext) -> None:
    tensors = [t.data for t in model.state_dict().values()]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=0, group=ctx.group)
    _unflatten_into(flat, tensors)


def sharded_model_config(cfg, model_parallel: int):
    """``cfg`` with ``feature_size`` padded for ``model_parallel`` shards
    (unchanged at one shard)."""
    if model_parallel <= 1:
        return cfg
    pv = padded_vocab(cfg.model.feature_size, model_parallel, window_multiple(cfg.model))
    return cfg.with_overrides(model={"feature_size": pv})


def create_dp_train_state(cfg, ctx: DistContext) -> TrainState:
    """The train state on this rank's device: weights from ``run.seed``
    broadcast from rank 0, at ``model_parallel > 1`` padded, their pad rows
    zeroed and cut to this rank's row shards; the optimizer (ZeRO where it
    runs) and lr scaled by the data-parallel size when configured; and a
    dropout generator seeded with the data index."""
    mp, dp = ctx.model_parallel, ctx.data_parallel
    zero = ctx.group is not None and resolve_zero_sharding(cfg.optimizer, dp)
    pcfg = sharded_model_config(cfg, mp)
    model = get_model(pcfg.model).build(
        pcfg.model, device=ctx.device,
        generator=torch.Generator().manual_seed(cfg.run.seed))
    if ctx.group is not None:
        _broadcast_weights(model, ctx)
    true_vocab = cfg.model.feature_size
    tables = [getattr(model, k) for k in LAZY_TABLE_KEYS if hasattr(model, k)]
    if mp > 1 and len(tables) < len(LAZY_TABLE_KEYS):
        raise ValueError(f"mesh.model_parallel={mp} row-shards {LAZY_TABLE_KEYS}; "
                         f"model {cfg.model.model_name!r} has no such tables")
    rows = min(t.shape[0] for t in tables) // mp if tables else 0
    if mp > 1:
        with torch.no_grad():
            model.fm_w[true_vocab:] = 0.0
            model.fm_v[true_vocab:] = 0.0
        lo = ctx.model_index * rows
        model.fm_w = torch.nn.Parameter(model.fm_w.detach()[lo:lo + rows].clone())
        model.fm_v = torch.nn.Parameter(model.fm_v.detach()[lo:lo + rows].clone())
    exchange = resolve_shard_exchange(cfg, dp, ctx.device.type)
    sharding = Sharding(ctx, true_vocab, rows * mp, rows, zero, exchange)
    if mp > 1:
        model.sharded = tables_from_config(cfg, sharding.axis, dp, ctx.device.type)
    params = dict(model.named_parameters())
    lazy_on = _check_lazy(cfg, params)
    keys = [k for k in LAZY_TABLE_KEYS if k in params] if lazy_on else []
    opt_params = {k: p for k, p in params.items() if k not in keys}
    if zero:
        optimizer = ZeroOptimizer(
            cfg.optimizer, opt_params, dp=dp, data_index=ctx.data_index,
            data_group=ctx.data_group, sharded=sharding.sharded_keys(opt_params), mp=mp,
            model_group=ctx.model_group, model_src=ctx.data_index * mp,
            data_parallel_size=dp)
    else:
        optimizer = build_optimizer(cfg.optimizer, opt_params, data_parallel_size=dp)
    lazy = init_lazy_state({k: params[k].detach() for k in keys}) if lazy_on else None
    model.dropout_generator.manual_seed(model.dropout_generator.initial_seed()
                                        + ctx.data_index)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      generator=model.dropout_generator, lazy=lazy, sharding=sharding)


def _unflatten_into(flat: torch.Tensor, tensors: list[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def _flags(ctx: DistContext, *, examples: int, has_next: bool, stop: bool,
           eval_now: bool, bad_ids=None) -> torch.Tensor:
    """This rank's tail of the flat buffer: only rank 0's clock counts, and
    only one rank of each model group counts its examples; ``bad_ids`` (a
    device scalar) is the dense grid step's out-of-range id count."""
    mine = examples if ctx.model_index == 0 else 0
    tail = torch.tensor([float(mine), float(has_next), float(stop),
                         float(eval_now and ctx.rank == 0), 0.0], device=ctx.device)
    if bad_ids is not None:
        tail[4] = bad_ids
    return tail


def _read_flags(tail: torch.Tensor, ctx: DistContext) -> dict:
    total, flags, stops, evals, bad = tail.tolist()
    return {"examples": int(total), "all_have_next": flags >= ctx.world_size - 0.5,
            "any_stop": stops > 0.5, "eval_now": evals > 0.5, "bad_ids": int(bad)}


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
                eval_now: bool = False, data_keys=(), bad_ids=None) -> tuple[dict, dict]:
    """The mean gradients and metrics over the data indices, plus
    ``examples`` (the global batch), ``all_have_next``, ``any_stop`` and
    ``eval_now`` (host values); writes the averaged BN moving statistics
    back into the model.  One all-reduce of the flat buffer over the data
    group (the world at ``model_parallel`` 1).  On a grid the ranks of a
    model group then take model index 0's replicated part (the gradients
    but ``data_keys``, the row shards, and the BN statistics and metrics)
    by one broadcast, and sum the flags with one small all-reduce: JAX
    ``pmean``s these identical values over the model axis, of which the
    broadcast is the exact form."""
    order = [k for k in grads if k not in data_keys] + [k for k in data_keys]
    bn = _bn_buffers(state.model)
    means = [*(grads[k] for k in order[:len(order) - len(data_keys)]), *bn,
             *(metrics[k] for k in _METRICS), *(grads[k] for k in data_keys)]
    tail = _flags(ctx, examples=examples, has_next=has_next, stop=stop,
                  eval_now=eval_now, bad_ids=bad_ids)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in means] + [tail])
    n_mean = flat.numel() - tail.numel()
    if ctx.data_group is not None:
        dist.all_reduce(flat, group=ctx.data_group)
    if ctx.model_parallel > 1:
        n_rep = n_mean - sum(grads[k].numel() for k in data_keys)
        dist.broadcast(flat[:n_rep], src=ctx.data_index * ctx.model_parallel,
                       group=ctx.model_group)
        dist.all_reduce(flat[n_mean:], group=ctx.model_group)
    flat[:n_mean] /= ctx.data_parallel
    out = [torch.empty_like(t) for t in means]
    _unflatten_into(flat[:n_mean], out)
    n_rep_grads = len(order) - len(data_keys)
    averaged = dict(zip(order[:n_rep_grads], out[:n_rep_grads]))
    averaged.update(zip(data_keys, out[len(out) - len(data_keys):]))
    with torch.no_grad():
        for b, new in zip(bn, out[n_rep_grads:]):
            b.copy_(new)
    metrics = dict(zip(_METRICS, out[n_rep_grads + len(bn):]))
    grads = {k: averaged[k] for k in grads}
    if ctx.world_size == 1:
        metrics.update(examples=examples, all_have_next=has_next, any_stop=stop,
                       eval_now=eval_now)
    else:
        metrics.update(_read_flags(flat[n_mean:], ctx))
        bad = metrics.pop("bad_ids")
        if bad:
            raise ValueError(
                f"feat_ids out of range [0, {state.sharding.true_vocab}) in this "
                f"step's batches (counted {bad} times over the ranks): the dense "
                f"step on row-sharded tables refuses them, as JAX's shard_batch "
                f"does")
    return grads, metrics


def _sync(grads: dict, metrics: dict, state: TrainState, ctx: DistContext,
          **flags) -> tuple[dict, dict]:
    """The step's collectives before its update: the gradients averaged
    (row shards over the data group), or with ZeRO left raw for the
    optimizer while the world's all-reduce carries the rest."""
    sharding = state.sharding
    if sharding is not None and sharding.zero:
        _, metrics = pmean_grads({}, metrics, state, ctx, **flags)
        return grads, metrics
    keys = sharding.sharded_keys(grads) if sharding is not None else ()
    return pmean_grads(grads, metrics, state, ctx, data_keys=keys, **flags)


def train_step(state: TrainState, batch: dict, ctx: DistContext, *,
               has_next: bool = True, stop: bool = False,
               eval_now: bool = False) -> dict:
    """One synchronous step on this rank's ``batch`` (dense or lazy by the
    state); returns the mean metrics over the data indices, the global
    ``examples`` and the agreed flags: every rank holds a next batch
    (``all_have_next``), some rank was asked to stop (``any_stop``), rank
    0 says eval now (``eval_now``).  Without a process group it is the
    single-card step, and the flags are this process's own.  The dense
    step on row-sharded tables refuses ids outside ``[0, feature_size)``
    (JAX's ``shard_batch`` check): every rank raises ValueError at the same
    step, before the update (the lazy step maps them to its sentinel).
    The single-card step is graphed on the card (train/step.py
    ``graphed_train_step``; ``batch`` may then be the pinned host batch);
    the steps of a group stay eager: they read host flags every step (the
    step's flags here, the exchange's overflow flag,
    parallel/embedding.py, and the lazy pack's flag below)."""
    examples = int(batch["label"].shape[0])
    flags = dict(examples=examples, has_next=has_next, stop=stop, eval_now=eval_now)
    if ctx.group is None:
        return {**graphed_train_step(state, batch), "examples": examples,
                "all_have_next": has_next, "any_stop": stop, "eval_now": eval_now}
    if state.lazy is not None:
        return lazy_train_step(state, batch, ctx, **flags)
    sh = state.sharding
    if sh is not None and sh.mp > 1:  # JAX's shard_batch check, agreed in the flags
        ids = batch["feat_ids"]
        flags["bad_ids"] = ((ids < 0) | (ids >= sh.true_vocab)).sum()
    grads, metrics = dense_grads(state, batch)
    grads, metrics = _sync(grads, metrics, state, ctx, **flags)
    apply_dense(state, grads)
    return metrics


def assemble_rows(state: TrainState, mapped: torch.Tensor):
    """The lazy step's compact table ``[n, K+1]`` (fm_v's K columns, then
    fm_w), each lookup's slot and each slot's row (the sentinel
    ``total_rows`` where none): the exchange at M > 1, a sort of the
    local ids at M 1."""
    sh, model = state.sharding, state.model
    fm_w, fm_v = model.fm_w.detach(), model.fm_v.detach()
    if sh.mp > 1:
        ex = exchange_rows((fm_v, fm_w), mapped, sh.axis, exchange=sh.exchange,
                           capacity=model.cfg.shard_exchange_capacity,
                           table_grad=model.cfg.table_grad)
        return ex.compact, ex.slot, ex.slot_row
    order, seg, row_id, valid = sort_segments(mapped)
    live = valid & (row_id < sh.total_rows)
    idx = row_id.clamp(0, sh.rows - 1)
    compact = torch.where(live[:, None], torch.cat([fm_v[idx], fm_w[idx][:, None]], 1), 0.0)
    slot = torch.empty_like(seg).scatter_(0, order, seg).to(torch.int32)
    return compact, slot, torch.where(live, row_id, sh.total_rows)


def _gather_data(t: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """``t`` of every data index, stacked along dim 0 (data index order)."""
    if ctx.data_parallel == 1:
        return t
    out = t.new_empty((ctx.data_parallel * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=ctx.data_group)
    return out


def _segment_sums(rows: torch.Tensor, g: torch.Tensor):
    """``(row_id, summed g, valid)`` of the distinct values of ``rows``."""
    order, seg, row_id, valid = sort_segments(rows)
    return row_id, torch.zeros_like(g).index_add_(0, seg, g[order]), valid


def lazy_train_step(state: TrainState, batch: dict, ctx: DistContext, *,
                    examples: int, has_next: bool, stop: bool = False,
                    eval_now: bool = False) -> dict:
    """One lazy-Adam step on the grid (module docstring; JAX
    ``_build_lazy_local_step``).  The loss is the CE alone."""
    sh, model, opt = state.sharding, state.model, state.optimizer
    model.train()
    ids, vals = model.prepare(batch["feat_ids"], batch["feat_vals"])
    b, f = ids.shape
    k = model.fm_v.shape[1]
    flat = ids.reshape(-1).long()
    mapped = torch.where((flat >= 0) & (flat < sh.true_vocab), flat, sh.total_rows)
    compact, slot, slot_row = assemble_rows(state, mapped)
    c_w = compact[:, k].contiguous().requires_grad_()
    c_v = compact[:, :k].contiguous().requires_grad_()
    logits = model.head(*fused_ctr_interaction(c_w, c_v, slot.view(b, f), vals))
    labels = batch["label"].reshape(-1).to(torch.float32)
    ce = torch.mean(sigmoid_cross_entropy(logits, labels))
    rest = {n: p for n, p in model.named_parameters() if n not in LAZY_TABLE_KEYS}
    grads = torch.autograd.grad(ce, [*rest.values(), c_v, c_w])
    g_rest = dict(zip(rest, grads[:len(rest)]))
    g_rows = torch.cat([grads[-2], grads[-1][:, None]], 1)
    g_rest, metrics = _sync(g_rest, _metrics(ce, ce, logits, batch["label"]), state, ctx,
                            examples=examples, has_next=has_next, stop=stop,
                            eval_now=eval_now)
    opt.step(rest, g_rest)
    # the same length on every rank of the data group, whichever way its
    # model group assembled (the alltoall buffer or the psum fallback)
    width = b * f
    if sh.mp > 1 and sh.exchange == "alltoall":
        cap_x = exchange_capacity(b * f, sh.mp, model.cfg.shard_exchange_capacity)
        width = max(width, sh.mp * cap_x + 1)
    pad = width - compact.shape[0]
    if pad:
        g_rows = torch.cat([g_rows, g_rows.new_zeros(pad, k + 1)])
        slot_row = torch.cat([slot_row, slot_row.new_full((pad,), sh.total_rows)])
    dp = sh.dp
    cap = exchange_capacity(b * f, 1, model.cfg.shard_exchange_capacity or 0.5)
    dedup = sh.exchange == "alltoall" and dp > 1 and cap < b * f
    if dedup:
        row_l, g_l, valid_l = _segment_sums(slot_row, g_rows)
        real = valid_l & (row_l < sh.total_rows)
        n_unique = real.sum() + (mapped == sh.total_rows).any()
        flag = (n_unique > cap).to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=ctx.data_group)
        dedup = not int(flag.item())
    if dedup:  # update_dedup: a pack of at most cap distinct rows
        ids_g = _gather_data(torch.where(real[:cap], row_l[:cap], sh.total_rows), ctx)
        g_g = _gather_data(g_l[:cap], ctx) / dp
    else:      # update_full: every slot of every data index
        ids_g = _gather_data(slot_row, ctx)
        g_g = _gather_data(g_rows, ctx) / dp
    lazy_updates["dedup" if dedup else "full"] += 1
    row_id, gsum, valid = _segment_sums(ids_g, g_g)
    lr = schedule_value(opt.lr, state.step) * opt.multiplier
    for key, table, g in (("fm_v", model.fm_v, gsum[:, :k]), ("fm_w", model.fm_w, gsum[:, k])):
        lazy_adam_update_shard(table.data, state.lazy.m[key], state.lazy.v[key], row_id, g,
                               valid, sh.offset, state.step + 1, opt.cfg,
                               learning_rate=lr, l2_reg=model.cfg.l2_reg)
    state.step += 1
    return metrics


# -- the one-card layout and the rank's rows (checkpoints, export) ------------

def _gather_rows(t: torch.Tensor, sh: Sharding) -> torch.Tensor:
    out = t.new_empty((sh.mp * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=sh.ctx.model_group)
    return out


def table_keys(state: TrainState) -> tuple[str, ...]:
    """The row-sharded leaves of ``state`` (none at ``model_parallel`` 1)."""
    sh = state.sharding
    return sh.sharded_keys(dict(state.model.named_parameters())) if sh is not None else ()


def map_tables(tree: dict, keys, fn) -> dict:
    """``tree`` (the ``{"model", "optimizer", "lazy"}`` layout) with ``fn``
    applied to every leaf of a table in ``keys``: the weights, their
    optimizer slots and their lazy moments."""
    def leaves(d: dict) -> dict:
        return {n: fn(t) if n in keys else t for n, t in d.items()}

    slots = tree["optimizer"]["slots"]
    return {"model": leaves(tree["model"]),
            "optimizer": {"count": tree["optimizer"]["count"], "slots": {
                n: {s: fn(t) for s, t in d.items()} if n in keys else d
                for n, d in slots.items()}},
            "lazy": None if tree["lazy"] is None else {
                m: leaves(d) for m, d in tree["lazy"].items()}}


def split_tables(tree: dict, keys) -> tuple[dict, dict]:
    """``(rest, tables)``: ``tree``'s layout without the leaves of the
    tables in ``keys``, and those leaves alone in the same layout."""
    def part(d: dict, mine: bool) -> dict:
        return {n: t for n, t in d.items() if (n in keys) == mine}

    def layout(mine: bool) -> dict:
        return {"model": part(tree["model"], mine),
                "optimizer": {"count": tree["optimizer"]["count"],
                              "slots": part(tree["optimizer"]["slots"], mine)},
                "lazy": None if tree["lazy"] is None else {
                    m: part(d, mine) for m, d in tree["lazy"].items()}}

    return layout(False), layout(True)


def join_tables(rest: dict, tables: dict) -> dict:
    """The inverse of :func:`split_tables`."""
    return {"model": {**rest["model"], **tables["model"]},
            "optimizer": {"count": rest["optimizer"]["count"],
                          "slots": {**rest["optimizer"]["slots"],
                                    **tables["optimizer"]["slots"]}},
            "lazy": None if rest["lazy"] is None else {
                m: {**d, **tables["lazy"][m]} for m, d in rest["lazy"].items()}}


def local_state(state: TrainState) -> dict:
    """``{"model", "optimizer", "lazy"}`` of this rank: the model's
    ``state_dict`` (a row-sharded table as this rank's rows), the
    optimizer's ``{"count", "slots"}`` with every slot at its parameter's
    shape on this rank (the ZeRO windows gathered over the data group: a
    collective there), the lazy moments (or None).  Live tensors, not
    copies, except the gathered windows."""
    sh = state.sharding
    lazy = None if state.lazy is None else state.lazy.state_dict()
    if sh is not None and sh.zero:
        params = dict(state.model.named_parameters())
        opt_params = {n: p for n, p in params.items() if n in state.optimizer.plans}
        opt = {"count": state.optimizer.count,
               "slots": state.optimizer.full_slots(opt_params)}
    else:
        opt = state.optimizer.state_dict()
    return {"model": state.model.state_dict(), "optimizer": opt, "lazy": lazy}


def full_state(state: TrainState) -> dict:
    """:func:`local_state` in the one-card layout: the row-sharded tables,
    their slots and lazy moments gathered whole (padded as trained) over
    the model group.  A collective on a grid: every rank calls it and
    every rank gets it (export and conversion; a checkpoint writes each
    rank's rows instead, checkpoint/ckpt.py)."""
    local = local_state(state)
    keys = table_keys(state)
    if not keys:
        return local
    return map_tables(local, keys, lambda t: _gather_rows(t, state.sharding))


def load_local_state(state: TrainState, local: dict) -> None:
    """Load :func:`local_state`'s layout into ``state`` in place (the ZeRO
    optimizer takes its windows).  Raises naming the first mismatch."""
    sh = state.sharding
    state.model.load_state_dict(local["model"])
    if sh is not None and sh.zero:
        slots = local["optimizer"]["slots"]
        if slots.keys() != state.optimizer.slots.keys():
            raise ValueError(f"optimizer state holds {sorted(slots)}, expected "
                             f"{sorted(state.optimizer.slots)}")
        state.optimizer.load_full_slots(slots)
        state.optimizer.count = int(local["optimizer"]["count"])
    else:
        state.optimizer.load_state_dict(local["optimizer"])
    if state.lazy is not None:
        state.lazy.load_state_dict(local["lazy"])


def load_full_state(state: TrainState, full: dict) -> None:
    """Load :func:`full_state`'s layout into ``state`` in place: each rank
    takes its rows of the whole tables, then :func:`load_local_state`."""
    sh, keys = state.sharding, table_keys(state)
    if keys:
        full = map_tables(full, keys,
                          lambda t: torch.as_tensor(t)[sh.offset:sh.offset + sh.rows])
    load_local_state(state, full)


def servable_state_dict(state: TrainState, model_cfg) -> dict:
    """The one-card ``state_dict`` for ``model_cfg`` (the true vocabulary):
    the whole tables cut to its rows (a collective on a grid)."""
    sd = full_state(state)["model"] if state.sharding is not None else \
        state.model.state_dict()
    out = dict(sd)
    if "fm_w" in out:
        out["fm_w"] = sd["fm_w"][:model_cfg.feature_size]
        out["fm_v"] = sd["fm_v"][:fm_v_rows(model_cfg)]
    return out
