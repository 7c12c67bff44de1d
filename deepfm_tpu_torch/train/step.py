"""Train, eval and predict steps: counterpart of ``deepfm_tpu/train/step.py``
(the dense path: ``TrainState``, ``sigmoid_cross_entropy``,
``make_loss_fn``, ``make_train_step``, ``make_eval_step``,
``make_predict_step``).

The JAX functions are pure over an explicit state; here the state holds the
model and optimizer, which the train step updates in place, and the eval
and predict steps take the model alone.  A batch is a
dict of tensors on the model's device: ``feat_ids [B, F]`` (int32 or int64),
``feat_vals [B, F]`` float32 and ``label [B]``.

Metrics stay on the device, so a step never waits for the card; the caller
reads them (``float(...)``) only where it logs.  The optimizer update runs
under the ``torch.profiler`` label ``train.optimizer``, so a profile can
tell its kernels from the rest of the step.
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
from .optimizer import Optimizer, build_optimizer


@dataclass
class TrainState:
    """What training carries from step to step.  ``step`` counts optimizer
    steps; ``generator`` is the model's dropout generator (the JAX state's
    per-step folded PRNG key)."""

    step: int
    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator


def create_train_state(cfg: Config, device=None) -> TrainState:
    """A fresh model (weights drawn from a generator seeded ``run.seed``) on
    ``device`` (default: the card) and its optimizer."""
    device = resolve_device(device)
    model = get_model(cfg.model).build(
        cfg.model, device=device,
        generator=torch.Generator().manual_seed(cfg.run.seed))
    optimizer = build_optimizer(cfg.optimizer, dict(model.named_parameters()))
    return TrainState(step=0, model=model, optimizer=optimizer,
                      generator=model.dropout_generator)


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


def train_step(state: TrainState, batch: dict) -> dict:
    """One dense optimizer step on ``batch`` in train mode (dropout and
    batch statistics); returns ``loss``, ``ce``, ``pred_mean`` and
    ``label_mean`` as device scalars."""
    model = state.model
    model.train()
    params = dict(model.named_parameters())
    logits = model(batch["feat_ids"], batch["feat_vals"])
    loss, ce = loss_terms(model, logits, batch["label"])
    grads = torch.autograd.grad(loss, list(params.values()))
    with record_function("train.optimizer"):
        state.optimizer.step(params, dict(zip(params, grads)))
    state.step += 1
    with torch.no_grad():
        return {
            "loss": loss.detach(),
            "ce": ce.detach(),
            "pred_mean": torch.sigmoid(logits).mean(),
            "label_mean": batch["label"].to(torch.float32).mean(),
        }


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
