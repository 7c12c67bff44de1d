"""Train, eval and predict steps: counterpart of ``deepfm_tpu/train/step.py``
(``TrainState``, ``sigmoid_cross_entropy``, ``make_loss_fn``,
``_check_lazy``, ``init_opt_state``, ``make_train_step`` with its lazy
variant, ``make_eval_step``, ``make_predict_step``).

The JAX functions are pure over an explicit state; here the state holds the
model and optimizer, which the train step updates in place, and the eval
and predict steps take the model alone.  A batch is a
dict of tensors on the model's device: ``feat_ids [B, F]`` (int32 or int64),
``feat_vals [B, F]`` float32 and ``label [B]``.

With ``optimizer.lazy_embedding_updates`` the tables fm_w and fm_v train
with lazy Adam (train/lazy.py) and the rest of the parameters with the
dense optimizer and its own count.  The lazy step runs the model on COMPACT
tables: the batch's B·F ids are sorted into segments at a fixed shape
(``sort_segments``), ``fm_v[row_id]`` and ``fm_w[row_id]`` are gathered
into ``[N, K]`` and ``[N]`` tables, and the forward runs through
``fused_ctr_interaction`` with each lookup's segment as its id.  On the
card that launches the forward kernel, and its backward kernel then writes
the per-segment gradient sums, exactly the sums ``segment_rows`` forms, into
``[N, K]`` and ``[N]`` (zero on padding segments): no ``[V, K]`` gradient
exists and no dense pass over the table runs.

Metrics stay on the device, so a step never waits for the card; the caller
reads them (``float(...)``) only where it logs.  The optimizer update runs
under the ``torch.profiler`` label ``train.optimizer`` (the lazy step's
sort, segments and compact gathers under ``train.lazy_segments`` and its
row update under ``train.lazy_rows``), so a profile can tell their kernels
from the rest of the step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.profiler import record_function

from ..core.config import Config
from ..core.platform import resolve_device
from ..models.base import get_model
from ..ops.auc import AUCState, auc_update
from ..ops.embedding import sort_segments
from ..ops.fused_ctr import fused_ctr_interaction
from .lazy import LazyAdamState, init_lazy_state, lazy_adam_rows
from .optimizer import Optimizer, build_optimizer, schedule_value

# tables eligible for lazy updates: the CTR families gather fm_w (1-D) and
# fm_v (2-D) once per lookup
LAZY_TABLE_KEYS = ("fm_w", "fm_v")


@dataclass
class TrainState:
    """What training carries from step to step.  ``step`` counts optimizer
    steps; ``generator`` is the model's dropout generator (the JAX state's
    per-step folded PRNG key).  With lazy embedding updates ``optimizer``
    holds the non-table parameters only and ``lazy`` the tables' moments
    (the JAX ``(rest_opt, LazyAdamState)`` pair); otherwise ``lazy`` is
    None."""

    step: int
    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    lazy: LazyAdamState | None = None


def _lazy_keys(params) -> list[str]:
    return [k for k in LAZY_TABLE_KEYS if k in params]


def _check_lazy(cfg: Config, params) -> bool:
    """Whether the lazy update is on; raises where it cannot run: another
    optimizer than Adam, no CTR table, or ``fused_kernel="on"`` (JAX
    refuses it: the lazy step substitutes its own row lookup)."""
    if not cfg.optimizer.lazy_embedding_updates:
        return False
    if cfg.optimizer.name.lower() != "adam":
        raise ValueError("lazy_embedding_updates supports the Adam optimizer only")
    if not _lazy_keys(params):
        raise ValueError(
            f"lazy_embedding_updates needs at least one of {LAZY_TABLE_KEYS} "
            f"(CTR model families); {cfg.model.model_name!r} has {sorted(params)}"
        )
    if cfg.model.fused_kernel == "on":
        raise ValueError(
            "fused_kernel='on' requires the dense single-table lookup path; "
            "lazy_embedding_updates substitutes its own row lookup: use "
            "fused_kernel='auto' (or 'off') with it"
        )
    return True


def init_opt_state(cfg: Config, params: dict, *, data_parallel_size: int = 1
                   ) -> tuple[Optimizer, LazyAdamState | None]:
    """The optimizer over ``params``, or, with lazy embedding updates, the
    dense optimizer over the non-table parameters and the tables'
    ``LazyAdamState``."""
    if not _check_lazy(cfg, params):
        return build_optimizer(cfg.optimizer, params,
                               data_parallel_size=data_parallel_size), None
    keys = _lazy_keys(params)
    rest = {k: p for k, p in params.items() if k not in keys}
    return (build_optimizer(cfg.optimizer, rest, data_parallel_size=data_parallel_size),
            init_lazy_state({k: params[k].detach() for k in keys}))


def create_train_state(cfg: Config, device=None, *, data_parallel_size: int = 1
                       ) -> TrainState:
    """A fresh model (weights drawn from a generator seeded ``run.seed``) on
    ``device`` (default: the card) and its optimizer state;
    ``data_parallel_size`` scales the lr when
    ``optimizer.scale_lr_by_data_parallel`` is set."""
    device = resolve_device(device)
    model = get_model(cfg.model).build(
        cfg.model, device=device,
        generator=torch.Generator().manual_seed(cfg.run.seed))
    optimizer, lazy = init_opt_state(cfg, dict(model.named_parameters()),
                                     data_parallel_size=data_parallel_size)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      generator=model.dropout_generator, lazy=lazy)


def sigmoid_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise ``tf.nn.sigmoid_cross_entropy_with_logits``."""
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))


def loss_terms(model: nn.Module, logits: torch.Tensor, labels: torch.Tensor):
    """(loss, ce): ce is the mean cross-entropy, loss adds the model
    family's L2 penalty."""
    labels = labels.reshape(-1).to(torch.float32)
    ce = torch.mean(sigmoid_cross_entropy(logits, labels))
    return ce + get_model(model.cfg).l2_penalty(model, model.cfg.l2_reg), ce


def _metrics(loss, ce, logits, labels) -> dict:
    with torch.no_grad():
        return {"loss": loss.detach(), "ce": ce.detach(),
                "pred_mean": torch.sigmoid(logits).mean(),
                "label_mean": labels.to(torch.float32).mean()}


def dense_grads(state: TrainState, batch: dict) -> tuple[dict, dict]:
    """The dense step's forward and backward in train mode (dropout and
    batch statistics): ``({name: gradient}, metrics)``."""
    model = state.model
    model.train()
    params = dict(model.named_parameters())
    logits = model(batch["feat_ids"], batch["feat_vals"])
    loss, ce = loss_terms(model, logits, batch["label"])
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, grads)), _metrics(loss, ce, logits, batch["label"])


def apply_dense(state: TrainState, grads: dict) -> None:
    """The optimizer update of every parameter from ``grads``."""
    with record_function("train.optimizer"):
        state.optimizer.step(dict(state.model.named_parameters()), grads)
    state.step += 1


def train_step(state: TrainState, batch: dict) -> dict:
    """One optimizer step on ``batch`` in train mode, dense or lazy by the
    state; returns ``loss``, ``ce``, ``pred_mean`` and ``label_mean`` as
    device scalars (the lazy step's loss is the CE alone)."""
    if state.lazy is not None:
        return lazy_train_step(state, batch)
    grads, metrics = dense_grads(state, batch)
    apply_dense(state, grads)
    return metrics


def lazy_train_step(state: TrainState, batch: dict) -> dict:
    """One step with lazy Adam on the tables (counterpart of
    ``_make_lazy_train_step``, ``train/step.py:173-270``).

    The ids are clipped to the smallest table's rows (fm_w's: fm_v may carry
    pad rows, which so never train) and sorted into segments; the forward
    and backward run on the compact tables, the loss is the CE alone (the
    table L2 is the ``l2·w`` term of the row update), the non-table
    parameters take a dense step with their own count, and the tables'
    touched rows a lazy-Adam step at lr ``schedule(step) ·
    embedding_lr_multiplier`` with bias correction at ``step + 1``."""
    model, opt = state.model, state.optimizer
    model.train()
    tables = {k: getattr(model, k) for k in _lazy_keys(dict(model.named_parameters()))}
    rest = {k: p for k, p in model.named_parameters() if k not in tables}
    ids, vals = model.prepare(batch["feat_ids"], batch["feat_vals"])
    b, f = ids.shape
    min_rows = min(t.shape[0] for t in tables.values())
    with record_function("train.lazy_segments"):
        order, seg, row_id, valid = sort_segments(ids.reshape(-1).clamp(0, min_rows - 1))
        slot = torch.empty_like(seg).scatter_(0, order, seg).to(torch.int32).view(b, f)
        compact = {k: t.detach()[row_id].requires_grad_() for k, t in tables.items()}
    logits = model.head(*fused_ctr_interaction(compact["fm_w"], compact["fm_v"],
                                               slot, vals))
    ce = torch.mean(sigmoid_cross_entropy(logits, batch["label"].reshape(-1)
                                          .to(torch.float32)))
    grads = torch.autograd.grad(ce, [*rest.values(), *compact.values()])
    with record_function("train.optimizer"):
        opt.step(rest, dict(zip(rest, grads)))
    lr = schedule_value(opt.lr, state.step) * opt.multiplier
    with record_function("train.lazy_rows"):
        for (key, table), gsum in zip(tables.items(), grads[len(rest):]):
            lazy_adam_rows(table, state.lazy.m[key], state.lazy.v[key], row_id, gsum,
                           valid, state.step + 1, opt.cfg, learning_rate=lr,
                           l2_reg=model.cfg.l2_reg, p_r=compact[key].detach())
    state.step += 1
    return _metrics(ce, ce, logits, batch["label"])


@torch.no_grad()
def eval_step(model: nn.Module, auc_state: AUCState, batch: dict
              ) -> tuple[AUCState, dict]:
    """Loss and streaming-AUC accumulation in eval mode."""
    model.eval()
    logits = model(batch["feat_ids"], batch["feat_vals"])
    loss, _ = loss_terms(model, logits, batch["label"])
    labels = batch["label"].reshape(-1)
    return (auc_update(auc_state, labels, torch.sigmoid(logits)),
            {"loss": loss, "count": labels.shape[0]})


@torch.no_grad()
def predict_step(model: nn.Module, batch: dict) -> torch.Tensor:
    """Probabilities [B] in eval mode: the serving path."""
    model.eval()
    return torch.sigmoid(model(batch["feat_ids"], batch["feat_vals"]))
