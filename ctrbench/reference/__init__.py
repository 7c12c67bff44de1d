"""The plain reference: each model family in its own module
(``ctrbench/reference/<model_name>.py``: ``TABLES``, ``leaves`` and
``logits``), float32 PyTorch with no kernel, graph or cache, and
:class:`Trainer`, which trains it as the configuration states (dense
Adam, the L2 term, dropout).  It imports nothing of the program."""

from __future__ import annotations

import importlib

import torch

from .common import Adam, Float32, dropout_masks, sigmoid_cross_entropy

# rows a forward and backward takes at once; the gradients of the blocks sum
BLOCK_ROWS = 1024
FAULTS = ("half_batch", "unchanged")


def family(model_name: str):
    """The reference module of a model family."""
    return importlib.import_module(f"{__name__}.{model_name}")


class Trainer:
    """The reference's training of ``params`` (float32 leaves by the
    program's names, updated in place): each step takes one batch, draws
    its dropout masks from a generator seeded ``dropout_seed``, and
    applies Adam to the gradient of ``mean CE + L2`` at the
    configuration's lr.  ``prec`` is the precision its
    forward runs in (``common.Float32`` or ``common.Lowered``); ``fault``
    plants one of :data:`FAULTS` (a control's readings, never a run)."""

    def __init__(self, model: dict, optimizer: dict, params: dict, *, dropout_seed: int,
                 prec=None, fault: str | None = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r} is not one of {FAULTS}")
        self.m = model
        self.fam = family(model["model_name"])
        self.params = params
        self.prec = prec or Float32()
        self.fault = fault
        self.opt = Adam(params, optimizer["learning_rate"], optimizer["adam_b1"],
                        optimizer["adam_b2"], optimizer["adam_eps"])
        dev = next(iter(params.values())).device
        self.gen = torch.Generator(device=dev).manual_seed(dropout_seed)

    def step(self, batch: dict) -> float:
        """One step on one batch; returns its loss (CE + L2)."""
        loss, grads = self._grads(batch, self.gen)
        if self.fault != "unchanged":
            self.opt.step(self.params, grads)
        return loss

    def _grads(self, batch: dict, gen: torch.Generator) -> tuple[float, dict]:
        dev = next(iter(self.params.values())).device
        ids = batch["feat_ids"].to(dev).long()
        vals = batch["feat_vals"].to(dev).float()
        labels = batch["label"].to(dev).float().reshape(-1)
        if self.fault == "half_batch":
            half = ids.shape[0] // 2
            ids, vals, labels = ids[:half], vals[:half], labels[:half]
        b = ids.shape[0]
        masks = dropout_masks(gen, b, self.m["deep_layers"], self.m["dropout_keep"])
        p = {k: v.detach().requires_grad_() for k, v in self.params.items()}
        total = {k: torch.zeros_like(v) for k, v in self.params.items()}
        ce = 0.0
        for lo in range(0, b, BLOCK_ROWS):
            sl = slice(lo, min(b, lo + BLOCK_ROWS))
            lg = self.fam.logits(p, ids[sl], vals[sl], self.m,
                                 [None if mk is None else mk[sl] for mk in masks], self.prec)
            part = sigmoid_cross_entropy(lg, labels[sl]).sum() / b
            for k, g in zip(p, torch.autograd.grad(part, list(p.values()), allow_unused=True)):
                if g is not None:
                    total[k] += g
            ce += float(part.detach())
        l2 = self.m["l2_reg"]
        with torch.no_grad():
            for k in self.fam.TABLES:
                total[k] += l2 * self.params[k]
            penalty = float(l2 * 0.5 * sum(self.params[k].double().square().sum()
                                           for k in self.fam.TABLES))
        return ce + penalty, total

    def grad_norms(self) -> dict:
        """Each leaf's first gradient as Adam holds it after one step
        (``mu / (1 - b1)``): its norm."""
        return {k: float(mu.double().norm()) / (1.0 - self.opt.b1)
                for k, mu in self.opt.mu.items()}
