"""Lazy (touched-rows) Adam for the CTR tables: counterpart of
``deepfm_tpu/train/lazy.py`` (``LazyAdamState``, ``init_lazy_state``,
``segment_rows``, ``adam_row_math``, ``lazy_adam_update``,
``lazy_adam_update_shard``, ``shared_segments``).

Dense Adam reads and writes all of fm_v, fm_w and both their moments every
step; a batch touches at most B·F rows.  The lazy update works on those
rows only:

    sort the ids -> one segment per distinct row (ops/embedding.py
    sort_segments) -> the row gradients summed per segment -> gather the
    segments' rows of table, m and v -> Adam on [N, K] -> add the deltas
    back with index_add_

Everything has the fixed shape N = B·F: the N - U padding segments carry
zero deltas, so the step never reads U on the host.  The semantics are the
JAX module's:

- untouched rows keep stale m and v (LazyAdam, not bias-exact Adam); bias
  correction uses the global step;
- table L2 is a gradient term ``l2·w`` on touched rows, once per distinct
  row (the dense path adds ``l2·w`` to every row every step);
- the table, m and v receive the DELTA ``new - old`` (``lazy.py:142-144``),
  not the new value, so the float32 rounding is JAX's.

The train step (train/step.py) takes the per-segment gradients from the
backward kernel run on compact tables, and calls :func:`lazy_adam_rows`
directly; :func:`lazy_adam_update` is the whole update from per-lookup
gradients, as the JAX function takes them.  The sharded lazy step
(parallel/spmd.py) applies the data group's deduplicated rows to the rows
this shard owns with :func:`lazy_adam_update_shard`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import OptimizerConfig
from ..ops.embedding import sort_segments
from .optimizer import adam_bias_corrections, load_slots


class LazyAdamState(NamedTuple):
    m: dict        # per-table first moment, full table shape
    v: dict        # per-table second moment, full table shape

    def state_dict(self) -> dict:
        """``{"m": {table: tensor}, "v": {...}}``, the live tensors."""
        return {"m": self.m, "v": self.v}

    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` into these moments, in place."""
        with torch.no_grad():
            load_slots({"m": self.m, "v": self.v}, state, "lazy")


def init_lazy_state(tables: dict) -> LazyAdamState:
    return LazyAdamState(m={k: torch.zeros_like(t) for k, t in tables.items()},
                         v={k: torch.zeros_like(t) for k, t in tables.items()})


def shared_segments(flat_ids: torch.Tensor):
    """The sort/segment structure, computed once for the tables that share
    the ids: ``ops.embedding.sort_segments``."""
    return sort_segments(flat_ids)


def _segment_sum(grads: torch.Tensor, order: torch.Tensor, seg: torch.Tensor):
    """``grads [N, W]`` summed per segment -> ``[N, W]`` (padding rows 0)."""
    return torch.zeros_like(grads).index_add_(0, seg, grads[order])


def segment_rows(flat_ids: torch.Tensor, flat_grads: torch.Tensor):
    """Dedup row updates: ``(ids [N], grads [N, W])`` -> ``(row_id [N],
    summed [N, W], valid [N])``; the first U entries are the distinct rows,
    the rest zero padding."""
    order, seg, row_id, valid = shared_segments(flat_ids)
    return row_id, _segment_sum(flat_grads, order, seg), valid


def adam_row_math(p_r, m_r, v_r, gsum, bias, cfg: OptimizerConfig, *,
                  learning_rate, l2_reg: float = 0.0):
    """Adam on gathered rows ``[N, W]``: the lazy-L2 fold, the moment
    update, bias correction by ``bias`` (the pair of
    :func:`~.optimizer.adam_bias_corrections` as device scalars) and the parameter step,
    written as the JAX function writes them.  Returns ``(new_p, new_m,
    new_v)`` for the rows."""
    if l2_reg:
        gsum = gsum + l2_reg * p_r
    b1, b2, eps = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps
    m_n = b1 * m_r + (1.0 - b1) * gsum
    v_n = b2 * v_r + (1.0 - b2) * gsum.square()
    m_hat = m_n / bias[0]
    v_hat = v_n / bias[1]
    p_n = p_r - learning_rate * m_hat / (v_hat.sqrt() + eps)
    return p_n, m_n, v_n


@torch.no_grad()
def lazy_adam_rows(table, m, v, row_id, gsum, valid, step,
                   cfg: OptimizerConfig, *, learning_rate,
                   l2_reg: float = 0.0, p_r=None, row_offset: int = 0) -> None:
    """Apply per-segment gradients ``gsum [N, ...]`` (segments ``row_id``,
    live where ``valid``) to ``table``, ``m`` and ``v`` in place.  ``step``
    is the 1-based global step, or its ``adam_bias_corrections`` already
    on the device (the graphed step's scalars, as is ``learning_rate``
    there); from a step they go to the device here, so every path divides
    by a device scalar.  ``p_r``
    is ``table[row_id]`` when the caller already gathered it.  A shard of a
    row-sharded table (``row_offset``: its first global row) takes the
    rows in ``[row_offset, row_offset + rows)`` and drops the rest.

    A dropped or padding segment adds a zero delta, which leaves its target
    row as it was.  Its target is its own position (mod the table's rows),
    not one shared row: thousands of adds into one row would serialize on
    the card.  The JAX update gives such segments distinct out-of-bounds
    ids for the same reason; ``index_add_`` takes in-bounds ids only."""
    rows = table.shape[0]
    width = gsum[0].numel()
    t2, m2, v2 = (x.view(rows, width) for x in (table, m, v))
    g2 = gsum.reshape(-1, width)
    local = row_id - row_offset
    live = valid & (local >= 0) & (local < rows)
    idx = local.clamp(0, rows - 1)
    p_r = t2[idx] if p_r is None else p_r.reshape(-1, width)
    m_r, v_r = m2[idx], v2[idx]
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(adam_bias_corrections(cfg, step), dtype=torch.float32,
                            device=table.device)
    p_n, m_n, v_n = adam_row_math(p_r, m_r, v_r, g2, step, cfg,
                                  learning_rate=learning_rate, l2_reg=l2_reg)
    spread = torch.arange(row_id.shape[0], device=row_id.device) % rows
    target = torch.where(live, idx, spread)
    for dst, new, old in ((t2, p_n, p_r), (m2, m_n, m_r), (v2, v_n, v_r)):
        dst.index_add_(0, target, torch.where(live[:, None], new - old, 0.0))


def lazy_adam_update_shard(local_table, m, v, row_id, gsum, valid, row_offset: int,
                           step: int, cfg: OptimizerConfig, *, learning_rate: float,
                           l2_reg: float = 0.0) -> None:
    """Lazy Adam, in place, on the rows this shard owns of the
    deduplicated global rows ``row_id [N]`` (live where ``valid``) with
    their summed gradients ``gsum [N, ...]`` (JAX's signature);
    ``step`` is the 1-based global step."""
    lazy_adam_rows(local_table, m, v, row_id, gsum, valid, step, cfg,
                   learning_rate=learning_rate, l2_reg=l2_reg, row_offset=row_offset)


def lazy_adam_update(table, m, v, ids, row_grads, step: int, cfg: OptimizerConfig,
                     *, learning_rate: float, l2_reg: float = 0.0,
                     segmented: tuple | None = None) -> None:
    """One lazy-Adam step, in place, on the rows of ``table [V, ...]``
    touched by ``ids``, from per-lookup ``row_grads`` (``ids.shape +
    table.shape[1:]``); ``step`` is the 1-based global step.  ``segmented``
    reuses one :func:`shared_segments` across tables that share the ids."""
    flat_ids = ids.reshape(-1).clamp(0, table.shape[0] - 1)
    order, seg, row_id, valid = (shared_segments(flat_ids) if segmented is None
                                 else segmented)
    grads = row_grads.reshape(flat_ids.shape[0], -1)
    lazy_adam_rows(table, m, v, row_id, _segment_sum(grads, order, seg), valid,
                   step, cfg, learning_rate=learning_rate, l2_reg=l2_reg)
