"""Single-card train and eval steps of the two-tower family: counterpart of
``create_retrieval_state``, ``retrieval_loss``,
``make_retrieval_train_step`` and ``make_retrieval_eval_step`` in
``deepfm_tpu/train/retrieval.py``.

The loss couples the examples of a batch (every query is scored against
every item of the batch, its own item on the diagonal), so the family has
its own steps instead of the CTR steps of train/step.py:

    loss = mean_b CE(softmax(u_b · iᵀ / temperature), b) + L2(tables)

on the port's optimizers (train/optimizer.py), which update the model in
place.  A batch is a dict of ``user_ids``/``user_vals [B, Fu]`` and
``item_ids``/``item_vals [B, Fi]`` (data/ratings.py gives one field a
side).  The metrics are ``loss``, ``top1_acc`` and ``recall_at_10`` (and
the eval step's ``count``), device scalars.  The grid's step, with the
items gathered over the data indices, is parallel/retrieval.py.
"""

from __future__ import annotations

import torch

from ..core.config import Config
from ..core.platform import resolve_device
from ..models.two_tower import (TwoTower, in_batch_softmax_loss, retrieval_metrics,
                                two_tower_l2_penalty)
from .optimizer import build_optimizer
from .step import TrainState

RETRIEVAL_BATCH_KEYS = ("user_ids", "user_vals", "item_ids", "item_vals")


def create_retrieval_state(cfg: Config, device=None, *, data_parallel_size: int = 1,
                           model_cfg=None) -> TrainState:
    """A fresh two-tower model (weights from a generator seeded
    ``run.seed``; ``model_cfg`` replaces ``cfg.model``, e.g. with padded
    vocabularies) on ``device`` (default: the card) and its optimizer.  The
    towers draw no dropout: the state's generator is carried for the
    checkpoint's layout only."""
    device = resolve_device(device)
    model = TwoTower(model_cfg or cfg.model, device=device,
                     generator=torch.Generator().manual_seed(cfg.run.seed))
    optimizer = build_optimizer(cfg.optimizer, dict(model.named_parameters()),
                                data_parallel_size=data_parallel_size)
    generator = torch.Generator(device=device).manual_seed(cfg.run.seed)
    return TrainState(step=0, model=model, optimizer=optimizer, generator=generator)


def batch_on(batch: dict, device: torch.device) -> dict:
    """The batch's four tensors on ``device``."""
    return {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
            for k in RETRIEVAL_BATCH_KEYS}


def retrieval_loss(model: TwoTower, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, scores [B, B]): the full-batch in-batch-softmax loss, positives
    on the diagonal, plus the tables' L2 penalty."""
    u, i = model(batch["user_ids"], batch["user_vals"], batch["item_ids"], batch["item_vals"])
    labels = torch.arange(u.shape[0], device=u.device)
    ce, scores = in_batch_softmax_loss(u, i, labels, temperature=model.cfg.temperature)
    return ce.mean() + two_tower_l2_penalty(model, model.cfg.l2_reg), scores


def step_metrics(loss: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor) -> dict:
    """``loss``, ``top1_acc`` and ``recall_at_10`` as detached device scalars."""
    with torch.no_grad():
        return {"loss": loss.detach(), **retrieval_metrics(scores.detach(), labels)}


def train_step(state: TrainState, batch: dict) -> dict:
    """One optimizer step on ``batch``: ``loss``, ``top1_acc`` and
    ``recall_at_10`` as device scalars."""
    model = state.model
    dev = model.user_embedding.device
    batch = batch_on(batch, dev)
    params = dict(model.named_parameters())
    loss, scores = retrieval_loss(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    state.optimizer.step(params, dict(zip(params, grads)))
    state.step += 1
    return step_metrics(loss, scores, torch.arange(scores.shape[0], device=dev))


@torch.no_grad()
def eval_step(model: TwoTower, batch: dict) -> dict:
    """``loss``, ``count``, ``top1_acc`` and ``recall_at_10`` of ``batch``."""
    dev = model.user_embedding.device
    loss, scores = retrieval_loss(model, batch_on(batch, dev))
    return {**step_metrics(loss, scores, torch.arange(scores.shape[0], device=dev)),
            "count": scores.shape[0]}
