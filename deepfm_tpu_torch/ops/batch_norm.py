"""Batch normalization with moving statistics: counterpart of
``deepfm_tpu/ops/batch_norm.py``.

TF1 ``contrib.layers.batch_norm`` semantics, ``eps = 1e-3``:

* train mode normalizes by the batch mean and the biased batch variance and
  returns the moving averages updated with the TF1 decay,
  ``decay * old + (1 - decay) * batch``;
* infer mode normalizes by the moving averages and returns them unchanged.

The function is pure, as in JAX: it returns ``(y, new_state)``.  The
``BatchNorm`` module (models/deepfm.py) writes the new state into its
buffers.
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
    x: torch.Tensor, params: BNParams, state: BNState, *, train: bool = False,
    decay: float = 0.9, eps: float = EPS,
) -> tuple[torch.Tensor, BNState]:
    """x [B, C] normalized, then scaled and shifted (the JAX package's order
    of operations); returns (y, new state).  The new state carries no
    autograd history."""
    if train:
        mean = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
        with torch.no_grad():
            new_state = BNState(
                decay * state.moving_mean + (1.0 - decay) * mean,
                decay * state.moving_var + (1.0 - decay) * var,
            )
    else:
        mean, var = state.moving_mean, state.moving_var
        new_state = state
    inv = torch.reciprocal(torch.sqrt(var + eps))
    return (x - mean) * inv * params.scale + params.bias, new_state
