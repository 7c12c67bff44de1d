"""Factorization-machine terms: counterpart of ``deepfm_tpu/ops/fm.py``.

The second-order term uses the O(F·K) identity
``0.5 · Σ_k ((Σ_f e)² − Σ_f e²)``.
"""

from __future__ import annotations

import torch


def fm_first_order(feat_weights: torch.Tensor, feat_vals: torch.Tensor) -> torch.Tensor:
    """``y_w = Σ_f w_f · x_f``: [B, F] gathered FM_W rows and [B, F] vals -> [B]."""
    return torch.sum(feat_weights * feat_vals, dim=1)


def fm_second_order(embeddings: torch.Tensor) -> torch.Tensor:
    """``y_v = 0.5 Σ_k ((Σ_f e)² − Σ_f e²)``: [B, F, K] scaled embeddings -> [B]."""
    sum_f = torch.sum(embeddings, dim=1)
    square_sum = torch.sum(torch.square(embeddings), dim=1)
    return 0.5 * torch.sum(torch.square(sum_f) - square_sum, dim=1)
