"""Embedding lookup ops: counterpart of ``deepfm_tpu/ops/embedding.py``
(``narrow_ids``, ``dense_lookup``, ``scaled_embedding``)."""

from __future__ import annotations

import torch

_INT32_MAX_ROWS = 2**31 - 1


def narrow_ids(ids: torch.Tensor, vocab_size: int, enabled: bool = True) -> torch.Tensor:
    """Clip int64 ids to ``[0, vocab_size - 1]``, then cast them to int32.

    The clip comes first: a bare cast of an id >= 2**31 would wrap onto an
    arbitrary in-range row.  Note that the bound is ``vocab_size`` (the
    model's ``feature_size``), not a padded table's row count.  int32 input,
    a vocabulary too large for int32, or ``enabled=False`` pass through."""
    if enabled and ids.dtype == torch.int64 and vocab_size <= _INT32_MAX_ROWS:
        return ids.clamp(0, vocab_size - 1).to(torch.int32)
    return ids


def dense_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows, ids clipped to the table's own ``[0, rows - 1]``:
    table [V] or [V, K], ids [B, F] -> [B, F] or [B, F, K]."""
    return table[ids.clamp(0, table.shape[0] - 1).long()]


def scaled_embedding(
    table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor
) -> torch.Tensor:
    """``e_bf = V[id_bf] * x_bf``: table [V, K], ids/vals [B, F] -> [B, F, K]."""
    return dense_lookup(table, ids) * vals[..., None]
