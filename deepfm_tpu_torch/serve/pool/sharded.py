"""A shard-group member's row-sharded predict: counterpart of
``deepfm_tpu/serve/pool/sharded.py``.

JAX row-shards fm_w and fm_v over a serve-group mesh and assembles each
lookup's rows with the grid's exchange inside ``shard_map``.  Here a
member's ``[dp, mp]`` shards all sit on its one card (the card's machine
has one), and the exchange is the grid's compact-table route
(``parallel/embedding.py``) done inside one process:

* :func:`make_serve_context` pads the vocabulary to a multiple of ``mp``
  and the fused kernel's window (``parallel/spmd.py padded_vocab``);
* :func:`stage_sharded_payload` cuts the padded fm_w and fm_v into ``mp``
  row shards and places them, with the rest of the weights, on the card;
* :class:`ShardedDeepFM` clips the ids to the TRUE vocabulary (the
  single-process predict's clip, so the pad rows are never read), splits
  the batch into ``dp`` row slices, assembles each slice's rows from the
  owning shards into a compact table, runs kernel B1 on it with each
  lookup's slot as its id, and runs the MLP head over the whole batch.
  Each row's B1 sums the same values in the same order as on the whole
  table, and the head sees the same batch, so a member's answers equal
  the single-process predict's bit for bit.

Both of JAX's exchanges are kept.  ``psum``: each shard gathers the ids
it owns, zeros elsewhere, and the shards' rows are summed (``[N, K+1]``,
slot ``arange(N)``).  ``alltoall``: the ids are deduplicated
(``exchange_plan``), each owner answers a bucket of ``C`` request slots,
and the compact table is the ``[M·C + 1, K+1]`` response with a zero row.
When some owner's distinct rows overflow ``C`` the lookup falls back to
psum ON THE DEVICE: both tables are built and the slots pick the psum
half with ``torch.where`` on the overflow flag, as JAX's ``lax.cond``
picks its branch inside the executable.  Nothing reads the flag on the
host, so the whole predict of a (slot, bucket) is one CUDA graph
(:class:`ShardedPredictor`, three weight slots: live, staged, and the
previous version a rollback returns to).
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ...core.config import ModelConfig, load_config
from ...core.platform import resolve_device
from ...models.deepfm import window_multiple
from ...ops.embedding import narrow_ids
from ...ops.fused_ctr import fused_ctr_interaction
from ...parallel.embedding import exchange_capacity, exchange_plan, exchange_wire_bytes_est
from ...parallel.spmd import padded_vocab
from ..batcher import DEFAULT_BUCKETS
from ..graphs import GraphedPredictor

# a member's weight slots: live, staged, and the retained previous version
MEMBER_SLOTS = 3
TABLE_KEYS = ("fm_w", "fm_v")


class ServeGroupContext(NamedTuple):
    """A member's static geometry: the padded config, the true vocabulary
    (the id clip bound), the ``[dp, mp]`` split, the card and the resolved
    exchange ("psum" or "alltoall", never "auto")."""

    cfg: ModelConfig           # feature_size padded to the shards' row multiple
    true_feature_size: int
    data_parallel: int
    model_parallel: int
    device: torch.device
    exchange: str
    capacity: float            # model.shard_exchange_capacity (0: ceil(N/M))

    @property
    def rows_local(self) -> int:
        return self.cfg.feature_size // self.model_parallel


def resolve_serve_exchange(cfg: ModelConfig, model_parallel: int,
                           exchange: str | None = None) -> str:
    """JAX's ``resolve_serve_exchange``: one shard has nothing to exchange
    (psum); otherwise ``exchange`` or ``cfg.shard_exchange``.  "auto" is
    psum on every device: a member's shards all sit in its one process, so
    the all-to-all saves no wire and, at the default capacity, also builds
    the psum table for its on-device fallback.  "alltoall" stays the
    explicit option JAX's members take."""
    if model_parallel <= 1:
        return "psum"
    mode = exchange or cfg.shard_exchange
    if mode == "auto":
        return "psum"
    if mode not in ("psum", "alltoall"):
        raise ValueError(f"exchange must resolve to 'psum' or 'alltoall', got {mode!r}")
    return mode


def make_serve_context(cfg: ModelConfig, data_parallel: int = 1, model_parallel: int = 1,
                       *, device=None, exchange: str | None = None) -> ServeGroupContext:
    """The member's padded config and exchange for a ``[dp, mp]`` split."""
    dp, mp = int(data_parallel), int(model_parallel)
    if dp < 1 or mp < 1:
        raise ValueError(f"a member's split needs dp, mp >= 1, got [{dp}, {mp}]")
    if cfg.model_name != "deepfm":
        raise ValueError(f"shard-group members serve DeepFM servables, got "
                         f"{cfg.model_name!r}")
    if cfg.tiered_embeddings:
        raise ValueError("tiered servables page rows through the hot cache "
                         "(tiered/serving.py); a shard-group member serves resident "
                         "row-sharded tables")
    dev = resolve_device(device)
    pv = padded_vocab(cfg.feature_size, mp, window_multiple(cfg))
    return ServeGroupContext(
        cfg=dataclasses.replace(cfg, feature_size=pv), true_feature_size=cfg.feature_size,
        data_parallel=dp, model_parallel=mp, device=dev,
        exchange=resolve_serve_exchange(cfg, mp, exchange),
        capacity=float(cfg.shard_exchange_capacity))


def stage_sharded_payload(ctx: ServeGroupContext, state_dict: dict) -> dict[str, torch.Tensor]:
    """A servable's ``state_dict`` (true vocabulary) as the member's slot
    tree on the card: fm_w and fm_v zero-padded to the padded vocabulary
    and cut into ``mp`` row shards (``fm_w.<j>``, ``fm_v.<j>``), every
    other leaf as it is."""
    r, pv = ctx.rows_local, ctx.cfg.feature_size
    out = {}
    for name, v in state_dict.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        if name in TABLE_KEYS:
            t = t[:ctx.true_feature_size]
            pad = torch.zeros((pv - t.shape[0], *t.shape[1:]), dtype=t.dtype)
            t = torch.cat([t.cpu(), pad])
            for j in range(ctx.model_parallel):
                out[f"{name}.{j}"] = t[j * r:(j + 1) * r].contiguous().to(ctx.device)
        else:
            out[name] = t.to(ctx.device)
    return out


def _gather_owned(w: torch.Tensor, v: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``[n, K+1]``: fm_v's then fm_w's row at each ``local`` id of this
    shard, zeros where it owns none."""
    rows = w.shape[0]
    owned = (local >= 0) & (local < rows)
    idx = local.clamp(0, rows - 1)
    got = torch.cat([v[idx], w[idx][:, None]], dim=1)
    return torch.where(owned[:, None], got, torch.zeros((), dtype=got.dtype,
                                                        device=got.device))


def psum_rows(w_shards, v_shards, flat: torch.Tensor) -> torch.Tensor:
    """The psum exchange in one process: every shard's owned rows, zeros
    elsewhere, summed (one shard owns each in-range id, so the sum is
    exact).  ``[N, K+1]``; a lookup's slot is its position."""
    rows = w_shards[0].shape[0]
    out = None
    for j, (w, v) in enumerate(zip(w_shards, v_shards)):
        got = _gather_owned(w, v, flat - j * rows)
        out = got if out is None else out + got
    return out


def alltoall_rows(w_shards, v_shards, flat: torch.Tensor, cap: int):
    """The deduplicated owned-rows exchange in one process
    (``parallel/embedding.py _alltoall_exchange`` with each owner's
    answer gathered here): ``(compact [M·C + 1, K+1], slot [N], overflow)``,
    the last row zero (the slot of an id no bucket held)."""
    m, rows = len(w_shards), w_shards[0].shape[0]
    n = flat.shape[0]
    plan = exchange_plan(flat, rows, m, cap)
    mc = m * cap
    ok = plan.unique_valid & (plan.slot < cap)
    owner = plan.owner.long()
    scat = torch.where(ok, owner * cap + plan.slot.long(),
                       mc + torch.arange(n, device=flat.device))
    req = torch.full((mc + n,), rows, dtype=torch.long, device=flat.device)
    req.scatter_(0, scat, torch.where(ok, plan.row_id - owner * rows,
                                      torch.full_like(plan.row_id, rows)))
    resp = torch.cat([_gather_owned(w, v, req[j * cap:(j + 1) * cap])
                      for j, (w, v) in enumerate(zip(w_shards, v_shards))])
    compact = torch.cat([resp, resp.new_zeros((1, resp.shape[1]))])
    seg_of_pos = torch.empty_like(plan.seg).scatter_(0, plan.order, plan.seg)
    slot = torch.where(ok, scat, torch.full_like(scat, mc))[seg_of_pos]
    return compact, slot, plan.overflow


class ShardedDeepFM(nn.Module):
    """One weight slot of a member: the DeepFM's head (fm_b, MLP, batch
    norm) and fm_w/fm_v as ``mp`` row shards (``w_shards``, ``v_shards``)
    on ``ctx.device``.  ``forward(ids, vals) -> [B]`` logits."""

    def __init__(self, ctx: ServeGroupContext, state_dict: dict):
        super().__init__()
        self.ctx = ctx
        true_cfg = dataclasses.replace(ctx.cfg, feature_size=ctx.true_feature_size)
        staged = stage_sharded_payload(ctx, state_dict)
        self.head_model = _head_model(true_cfg, state_dict, ctx.device)
        mp = ctx.model_parallel
        self.w_shards = nn.ParameterList(
            [nn.Parameter(staged[f"fm_w.{j}"], requires_grad=False) for j in range(mp)])
        self.v_shards = nn.ParameterList(
            [nn.Parameter(staged[f"fm_v.{j}"], requires_grad=False) for j in range(mp)])
        self.requires_grad_(False)
        self.eval()

    def leaves(self) -> dict[str, torch.Tensor]:
        """The slot's tensors by the names :func:`stage_sharded_payload`
        gives them (the tree a swap ``copy_``s into)."""
        out = dict(self.head_model.state_dict())
        for j, (w, v) in enumerate(zip(self.w_shards, self.v_shards)):
            out[f"fm_w.{j}"], out[f"fm_v.{j}"] = w, v
        return out

    def lookup(self, ids: torch.Tensor, vals: torch.Tensor):
        """``(emb, y_w, y_v)`` of ``[b, F]`` ids (clipped, int32) and vals:
        the slice's rows assembled from the shards, then B1 on the compact
        table with the slots as ids."""
        ctx, k = self.ctx, self.ctx.cfg.embedding_size
        flat = ids.reshape(-1).long()
        w_shards, v_shards = list(self.w_shards), list(self.v_shards)
        if ctx.exchange == "psum":
            compact = psum_rows(w_shards, v_shards, flat)
            slot = torch.arange(flat.shape[0], device=flat.device)
        else:
            n = flat.shape[0]
            cap = exchange_capacity(n, ctx.model_parallel, ctx.capacity)
            compact, slot, overflow = alltoall_rows(w_shards, v_shards, flat, cap)
            # a shard owns at most rows_local rows and a slice has at most n
            # distinct ones: at that capacity no bucket overflows
            if cap < min(n, ctx.rows_local):
                dense = psum_rows(w_shards, v_shards, flat)
                base = compact.shape[0]
                compact = torch.cat([compact, dense])
                slot = torch.where(overflow, base + torch.arange(n, device=flat.device),
                                   slot)
        return fused_ctr_interaction(compact[:, k].contiguous(), compact[:, :k].contiguous(),
                                     slot.to(torch.int32).view(ids.shape), vals)

    def forward(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor) -> torch.Tensor:
        ctx, f = self.ctx, self.ctx.cfg.field_size
        # the single-process predict's clip (DeepFM.prepare), to the TRUE
        # vocabulary: pad rows are never read
        ids = narrow_ids(feat_ids.reshape(-1, f).clamp(0, ctx.true_feature_size - 1),
                         ctx.true_feature_size, ctx.cfg.narrow_ids).contiguous()
        vals = feat_vals.reshape(-1, f).to(torch.float32).contiguous()
        b, dp = ids.shape[0], ctx.data_parallel
        if b % dp:
            raise ValueError(f"a batch of {b} rows does not split over data_parallel={dp}")
        per = b // dp
        parts = [self.lookup(ids[i * per:(i + 1) * per], vals[i * per:(i + 1) * per])
                 for i in range(dp)]
        if dp == 1:
            emb, y_w, y_v = parts[0]
        else:
            emb, y_w, y_v = (torch.cat(x) for x in zip(*parts))
        return self.head_model.head(emb, y_w, y_v)


def _head_model(cfg: ModelConfig, state_dict: dict, device: torch.device):
    """The DeepFM with ``state_dict``'s head weights and no tables: built
    on the CPU, its fm_w and fm_v dropped, then moved to ``device``."""
    from ..export import model_from_state

    model = model_from_state(cfg, state_dict, "cpu")
    del model.fm_w, model.fm_v
    model.to(device)
    model.requires_grad_(False)
    model.eval()
    return model


class ShardedPredictor(GraphedPredictor):
    """A member's predict behind CUDA graphs in ``MEMBER_SLOTS`` weight
    slots on ``ctx.device`` (``"cpu"`` runs eagerly): the
    :class:`~..graphs.GraphedPredictor` over :class:`ShardedDeepFM` slots,
    whose tensors are :func:`stage_sharded_payload`'s tree.  Every bucket
    must divide by ``dp``; B1 runs once a data slice in each replay."""

    def __init__(self, ctx: ServeGroupContext, state_dict: dict, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS):
        bad = [b for b in buckets if int(b) % ctx.data_parallel]
        if bad:
            raise ValueError(
                f"bucket sizes {bad} are not divisible by the group's data_parallel="
                f"{ctx.data_parallel}: every dispatch shape must split evenly over the "
                f"member's data slices")
        self.ctx = ctx
        super().__init__(ctx.cfg, state_dict, device=ctx.device, buckets=buckets,
                         slots=MEMBER_SLOTS)

    def _slot_model(self, state_dict: dict) -> ShardedDeepFM:
        return ShardedDeepFM(self.ctx, state_dict)

    def _leaves(self, slot: int) -> dict[str, torch.Tensor]:
        return self._models[slot].leaves()


def group_wire_bytes_est(ctx: ServeGroupContext, bucket: int) -> int:
    """JAX's estimate of the exchange bytes a ``bucket``-row dispatch moves
    out of one shard (``exchange_wire_bytes_est`` over fm_w's and fm_v's
    widths).  In one process no byte crosses a wire; the number is the
    router's observability figure, kept for a member spread over cards."""
    n_local = max(1, bucket // max(1, ctx.data_parallel)) * ctx.cfg.field_size
    return exchange_wire_bytes_est(n_local, ctx.model_parallel, ctx.capacity,
                                   (1, ctx.cfg.embedding_size), exchange=ctx.exchange)


def load_sharded_servable(directory: str | os.PathLike, data_parallel: int = 1,
                          model_parallel: int = 1, *, device=None, exchange: str | None = None,
                          buckets: Sequence[int] = DEFAULT_BUCKETS):
    """A CTR servable row-sharded for one member: ``(predict, predictor,
    holder, ctx)``, the quartet of ``serve/reload.py
    load_swappable_servable`` (JAX returns ``predict_with`` where the port
    returns the predictor, whose ``predict_with(slot, ...)`` it is):

    * ``predict(ids, vals)``: the live slot from ``holder``, through its
      graphs (what the micro-batcher calls, on its worker thread);
    * ``predictor``: the :class:`ShardedPredictor`;
    * ``holder``: a ``SwappableParams`` whose payload is the live slot;
    * ``ctx``: the :class:`ServeGroupContext`."""
    from ..export import read_params
    from ..reload import SwappableParams

    directory = os.path.abspath(directory)
    cfg = load_config(directory)
    if cfg.model_name == "two_tower":
        raise ValueError("shard-group serving supports CTR servables; two-tower retrieval "
                         "has no sharded predict path")
    ctx = make_serve_context(cfg, data_parallel, model_parallel, device=device,
                             exchange=exchange)
    predictor = ShardedPredictor(ctx, read_params(directory), buckets=buckets)
    holder = SwappableParams(0, version=0)

    def predict(feat_ids, feat_vals) -> np.ndarray:
        slot, gen = holder.acquire()
        try:
            return predictor.predict_with(slot, feat_ids, feat_vals)
        finally:
            holder.release(gen)

    return predict, predictor, holder, ctx
