"""Streaming AUC: counterpart of ``deepfm_tpu/ops/auc.py``.

* the bucketed streaming AUC (``auc_init`` / ``auc_update`` / ``auc_merge``
  / ``auc_value`` over an ``AUCState``), semantics of
  ``tf.metrics.auc(num_thresholds=200)``: a fixed threshold grid with
  ±ε end thresholds, accumulated confusion counts, trapezoid ROC
  integration.  The counts stay on the predictions' device, so an eval
  loop does not wait for the device per batch;
* ``exact_auc``, the rank statistic (Mann-Whitney U) over a full
  prediction set, in numpy: the oracle the bucketed metric is tested
  against.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_KEPSILON = 1e-7


class AUCState(NamedTuple):
    """Confusion counts per threshold: rows are tp, fp, tn, fn."""

    counts: torch.Tensor  # f32 [4, num_thresholds]

    @property
    def num_thresholds(self) -> int:
        return self.counts.shape[1]


def auc_thresholds(num_thresholds: int = 200) -> np.ndarray:
    """The tf.metrics.auc threshold grid: interior points evenly spaced on
    (0,1) plus ``-ε`` and ``1+ε`` end thresholds."""
    inner = [(i + 1) / (num_thresholds - 1) for i in range(num_thresholds - 2)]
    return np.asarray([0.0 - _KEPSILON] + inner + [1.0 + _KEPSILON], dtype=np.float32)


def auc_init(num_thresholds: int = 200, device: torch.device | str = "cpu") -> AUCState:
    return AUCState(torch.zeros((4, num_thresholds), dtype=torch.float32, device=device))


def auc_update(
    state: AUCState,
    labels: torch.Tensor,
    predictions: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> AUCState:
    """Accumulate a batch.  labels: [B] in {0,1}; predictions: [B] in [0,1];
    weights: [B] or None (all 1)."""
    dev = state.counts.device
    thresholds = torch.from_numpy(auc_thresholds(state.num_thresholds)).to(dev)
    labels = labels.reshape(-1).to(dev, torch.float32)
    preds = predictions.reshape(-1).to(dev, torch.float32)
    w = torch.ones_like(preds) if weights is None else weights.reshape(-1).to(dev, torch.float32)
    # [B, T] predicted-positive mask per threshold
    pred_pos = (preds[:, None] > thresholds[None, :]).to(torch.float32)
    pos = (labels * w)[:, None]
    neg = ((1.0 - labels) * w)[:, None]
    tp = torch.sum(pred_pos * pos, dim=0)
    fp = torch.sum(pred_pos * neg, dim=0)
    fn = torch.sum((1.0 - pred_pos) * pos, dim=0)
    tn = torch.sum((1.0 - pred_pos) * neg, dim=0)
    return AUCState(state.counts + torch.stack([tp, fp, tn, fn]))


def auc_merge(a: AUCState, b: AUCState) -> AUCState:
    """Merge two states (the counts add)."""
    return AUCState(a.counts + b.counts)


def auc_value(state: AUCState) -> torch.Tensor:
    """Trapezoidal ROC integration (tf.metrics.auc's default summation)."""
    tp, fp, tn, fn = state.counts
    tpr = (tp + _KEPSILON) / (tp + fn + _KEPSILON)
    fpr = fp / (fp + tn + _KEPSILON)
    # thresholds ascend -> rates descend; integrate x=fpr, y=tpr
    return torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)


def exact_auc(labels: np.ndarray, predictions: np.ndarray) -> float:
    """Exact AUC via the rank statistic, with tie handling (average ranks)."""
    labels = np.asarray(labels).reshape(-1)
    preds = np.asarray(predictions).reshape(-1)
    n_pos = float(np.sum(labels == 1))
    n_neg = float(np.sum(labels == 0))
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(preds, kind="mergesort")
    sorted_preds = preds[order]
    ranks = np.empty_like(sorted_preds, dtype=np.float64)
    i = 0
    n = len(sorted_preds)
    while i < n:
        j = i
        while j < n and sorted_preds[j] == sorted_preds[i]:
            j += 1
        ranks[i:j] = 0.5 * (i + j - 1) + 1.0  # average 1-based rank
        i = j
    pos_rank_sum = float(np.sum(ranks[labels[order] == 1]))
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
