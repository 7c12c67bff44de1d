"""Slot-space train and predict steps over the hot cache on the card: the
port's counterpart of ``deepfm_tpu/tiered/step.py`` (``PagedHot``,
``PagedState``, ``init_hot``, ``_stage_swap`` as :func:`stage_swap`,
``make_paged_train_step`` as :func:`paged_train_step`, ``make_readback``,
``make_paged_predict``).  JAX's builder jits a step for a config and a
capacity; here the state carries both and its graph, so the step is a
plain function.

The paged step is the lazy step (train/step.py ``lazy_body``, the one
body the resident lazy step runs) on the hot cache ``[capacity + 1, K]``
with slot ids.  The batch arrives with its ids translated to cache slots
(tiered/pager.py), and the pager's staged miss pack is first copied into
the cache by one ``index_copy_`` a tensor (:func:`stage_swap`); the pack's
pad entries all name row ``capacity``, the sink row, which no slot id
reaches.  Then the segments are sorted over slot ids, the compact rows are
gathered from the hot cache, B1 runs forward and B1′ backward on them, and
lazy Adam updates the touched slots of the cache and its moments in place.
On the card the whole of it, swap included, is one CUDA graph
(train/step.py ``StepGraph``), whose only host bytes are the slot ids,
the values, the labels and the stage pack, copied into static buffers
before each replay, and the step's scalars.

It equals the resident lazy step bit for bit (JAX's argument, which
holds here too):

* the translation is a bijection between the batch's distinct rows and
  slots, so the segments over slots group exactly the lookups that the
  segments over rows group, each segment's lookups in the same order;
* the row update is the same function on the same rows;
* records travel through the host and cold tiers as raw float32 bytes.

``tests/test_torch_tiered.py`` holds it to zero tolerance across forced
evictions and a crash and resume.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops.fused_ctr import fused_ctr_interaction
from ..train.optimizer import Optimizer
from ..train.step import StepGraph, _advance, lazy_body, load_scalars, _scalar_buffer
from .store import RecordLayout


class PagedHot(NamedTuple):
    """The hot cache on the card: each table's rows and both lazy-Adam
    moments, ``[capacity + 1(, w)]`` (the last row the sink), so one
    eviction moves the whole record."""

    rows: dict
    m: dict
    v: dict


@dataclass
class PagedState:
    """What the paged step carries: the step count, the model's non-table
    part (a DeepFM whose own fm_w and fm_v are never read: its MLP, fm_b,
    batch norm and dropout generator), the dense optimizer over that part,
    the hot cache and the record layout.  ``scalars`` and ``graph`` as in
    ``train.step.TrainState``."""

    step: int
    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    hot: PagedHot
    layout: RecordLayout
    scalars: torch.Tensor | None = None
    graph: object | None = None

    @property
    def lazy(self) -> PagedHot:
        """The lazy moments (``step_scalars`` reads the lazy step's)."""
        return self.hot


def init_hot(widths: dict[str, int], capacity: int, device) -> PagedHot:
    def zeros():
        return {k: torch.zeros((capacity + 1,) if w == 1 else (capacity + 1, w),
                               dtype=torch.float32, device=device)
                for k, w in widths.items()}
    return PagedHot(rows=zeros(), m=zeros(), v=zeros())


def _parts(hot: PagedHot, layout: RecordLayout):
    """``(hot tensor, record columns)`` of every table's value, m and v."""
    for k in layout.keys:
        for dst, sl in zip((hot.rows[k], hot.m[k], hot.v[k]),
                           (layout.value_slice(k), *layout.moment_slices(k))):
            yield dst, sl


@torch.no_grad()
def stage_swap(hot: PagedHot, layout: RecordLayout, slots: torch.Tensor,
               records: torch.Tensor) -> None:
    """The staged pack into the cache, in place: ``records [P, width]``
    into the slots ``slots [P]`` (pad entries: the sink row)."""
    idx = slots.long()
    for dst, sl in _parts(hot, layout):
        dst.index_copy_(0, idx, records[:, sl].reshape((-1,) + tuple(dst.shape[1:])))


def paged_body(state: PagedState, inputs: dict, scalars: torch.Tensor) -> dict:
    """The paged step's body: the swap, then the lazy step on the cache."""
    hot = state.hot
    stage_swap(hot, state.layout, inputs["stage_slots"], inputs["stage_records"])
    return lazy_body(state.model, state.optimizer, hot.rows, hot, inputs["slot_ids"],
                     inputs["feat_vals"], inputs["label"], scalars)


def paged_train_step(state: PagedState, inputs: dict, pack) -> dict:
    """One paged step (``inputs``: ``slot_ids [B, F]`` int32, ``feat_vals
    [B, F]`` float32, ``label [B]``, and the pack's ``stage_slots`` and
    ``stage_records``); on the card through a
    :class:`~deepfm_tpu_torch.train.step.StepGraph`, on the CPU the same
    body eagerly.  ``pack`` (tiered/pager.py ``StagePack``) gets the event
    after which its memory may be filled again."""
    if state.hot.rows[state.layout.keys[0]].device.type != "cuda":
        scalars = _scalar_buffer(state)
        load_scalars(state, scalars)
        metrics = paged_body(state, inputs, scalars)
    else:
        if state.graph is None:
            state.graph = StepGraph(paged_body, state, inputs)
        metrics = state.graph(state, inputs)
        pack.copied = torch.cuda.Event()
        pack.copied.record()
    _advance(state)
    return metrics


def make_readback(layout: RecordLayout):
    """``readback(hot, slots [P] int32 numpy) -> [P, width]`` records of
    those slots, copied to the host on the current stream (so after every
    step already issued): the designated exit of dirty rows.  Pad entries
    (the sink row) read garbage the caller drops."""

    @torch.no_grad()
    def readback(hot: PagedHot, slots: np.ndarray) -> np.ndarray:
        first = hot.rows[layout.keys[0]]
        idx = torch.from_numpy(np.asarray(slots, np.int64)).to(first.device)
        cols = [dst[idx].reshape(idx.shape[0], -1) for dst, _ in _parts(hot, layout)]
        return torch.cat(cols, 1).cpu().numpy()

    return readback


def make_paged_predict():
    """``predict(model, hot_rows, slot_ids [B, F], vals [B, F]) ->
    probs [B]`` in eval mode: B1 on the cache's values with slot ids,
    then the model's head (the serving gather over a read-only cache)."""

    @torch.no_grad()
    def predict(model: nn.Module, hot_rows: dict, slot_ids: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
        model.eval()
        emb = fused_ctr_interaction(hot_rows["fm_w"], hot_rows["fm_v"], slot_ids, vals)
        return torch.sigmoid(model.head(*emb))

    return predict
