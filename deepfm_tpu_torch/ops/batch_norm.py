"""Infer-mode batch normalization with moving statistics: counterpart of
``deepfm_tpu/ops/batch_norm.py`` with ``train=False``.

TF1 ``contrib.layers.batch_norm`` semantics: eval normalizes by the moving
averages with ``eps = 1e-3``.  Training (batch statistics, moving-average
updates) comes with the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPS = 0.001  # contrib.layers.batch_norm default epsilon


class BNParams(NamedTuple):
    scale: torch.Tensor  # gamma [C]
    bias: torch.Tensor   # beta  [C]


class BNState(NamedTuple):
    moving_mean: torch.Tensor  # [C]
    moving_var: torch.Tensor   # [C]


def bn_init(num_features: int, device: torch.device | str = "cpu") -> tuple[BNParams, BNState]:
    """Unit scale, zero bias, zero mean, unit variance."""
    ones = torch.ones(num_features, device=device)
    zeros = torch.zeros(num_features, device=device)
    return BNParams(ones, zeros.clone()), BNState(zeros, ones.clone())


def batch_norm(
    x: torch.Tensor, params: BNParams, state: BNState, eps: float = EPS
) -> torch.Tensor:
    """x [B, C] normalized by the moving statistics, then scaled and shifted
    (the JAX package's order of operations)."""
    inv = torch.reciprocal(torch.sqrt(state.moving_var + eps))
    return (x - state.moving_mean) * inv * params.scale + params.bias
