"""Embedding lookup ops: counterpart of ``deepfm_tpu/ops/embedding.py``
(``narrow_ids``, ``dense_lookup``, ``scaled_embedding``, ``sort_segments``)."""

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


def sort_segments(flat_ids: torch.Tensor):
    """Sort ids and describe the equal-id runs, at a fixed shape.

    ``flat_ids [N]`` -> ``(order, seg, row_id, valid)``, all ``[N]``:
    ``order`` sorts the ids (stable), ``seg[p]`` is the segment of sorted
    position p, ``row_id[s]`` the id shared by segment s (0 on padding
    segments) and ``valid[s]`` whether segment s exists; the U live
    segments come first and the N - U padding segments follow.  Segment
    starts come from neighbour inequality and ``seg`` from their cumulative
    sum.

    Nothing here depends on the number of distinct ids, so nothing waits for
    the device: a ``torch.unique`` would read U back to the host every call,
    stall the step on it and rule out capturing the step in a CUDA graph.
    The JAX version packs (id, position) into one uint32 key for XLA:TPU's
    single-key sort; a stable int64 sort gives the same permutation here."""
    n = flat_ids.shape[0]
    sid, order = torch.sort(flat_ids.long(), stable=True)
    first = torch.ones(n, dtype=torch.bool, device=sid.device)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1
    row_id = torch.zeros_like(sid).scatter_(0, seg, sid)
    valid = torch.arange(n, device=sid.device) < first.sum()
    return order, seg, row_id, valid
