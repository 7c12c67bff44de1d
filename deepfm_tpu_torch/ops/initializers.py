"""TF1 glorot initializers drawn from a ``torch.Generator``.

Counterpart of ``deepfm_tpu/ops/initializers.py``: ``glorot_normal`` is TF's
``glorot_normal_initializer`` (fan_avg variance scaling, normal truncated to
±2σ with the 0.87962566 stddev correction) and ``glorot_uniform`` TF's
``xavier_initializer``.  Rank-1 shapes use fan_in = fan_out = shape[0], as
TF does for FM_W.  The JAX and torch generators give different numbers for
one seed; the two are held to the same distribution, not the same draws.
"""

from __future__ import annotations

import math

import torch

_TRUNC_CORRECTION = 0.87962566103423978
# standard normal CDF at ±2, the truncation bounds
_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_PHI_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def _fans(shape: tuple[int, ...]) -> tuple[float, float]:
    if len(shape) < 1:
        return 1.0, 1.0
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    receptive = 1
    for d in shape[:-2]:
        receptive *= d
    return float(shape[-2] * receptive), float(shape[-1] * receptive)


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by inverse CDF (float64, then
    cast, so the tails stay inside the bounds after rounding)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float64,
                   device=generator.device)
    p = _PHI_LO + (_PHI_HI - _PHI_LO) * u
    x = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    return x.clamp_(-2.0, 2.0).to(torch.float32)


def glorot_normal(shape: tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """TF ``glorot_normal_initializer`` as a float32 tensor on the
    generator's device."""
    fan_in, fan_out = _fans(tuple(shape))
    stddev = (2.0 / (fan_in + fan_out)) ** 0.5 / _TRUNC_CORRECTION
    return stddev * _truncated_normal(tuple(shape), generator)


def glorot_uniform(shape: tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """TF ``xavier_initializer`` as a float32 tensor."""
    fan_in, fan_out = _fans(tuple(shape))
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (2.0 * u - 1.0) * limit
