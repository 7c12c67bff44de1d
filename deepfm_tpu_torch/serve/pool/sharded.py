"""A shard-group member's row-sharded predict: counterpart of
``deepfm_tpu/serve/pool/sharded.py``, for every CTR family (DeepFM,
xDeepFM, DCN-v2).

JAX row-shards the family's tables over a serve-group mesh and assembles
each lookup's rows with the grid's exchange inside ``shard_map``.  Here a
member's ``[dp, mp]`` shards all sit on its one card (the card's machine
has one), and the exchange is the grid's compact-table route
(``parallel/embedding.py``) done inside one process:

* :func:`make_serve_context` pads the vocabulary to a multiple of ``mp``
  and the fused kernel's window (``parallel/spmd.py padded_vocab``);
* :func:`stage_sharded_payload` cuts each of the family's tables
  (``CTRModel.TABLES``: fm_w and fm_v, DCN-v2's fm_v alone) into ``mp``
  row shards and places them, with the rest of the weights, on the card;
* :class:`ShardedCTR` clips the ids to the TRUE vocabulary (the
  single-process predict's clip, so the pad rows are never read), splits
  the batch into ``dp`` row slices, assembles each slice's rows of every
  table from the owning shards into compact tables, and runs the family
  hook ``table_logits`` once over the whole batch on the slices' compact
  tables with each lookup's slot as its id (B1 for DeepFM and xDeepFM).
  Each lookup reads the same row values as on the whole table, and the
  head sees the same batch, so a member's answers equal the
  single-process predict's bit for bit.

Both of JAX's exchanges are kept.  ``psum``: each shard gathers the ids
it owns, zeros elsewhere, and the shards' rows are summed (``[N, W]``,
``W`` the tables' widths side by side, slot ``arange(N)``).
``alltoall``: the ids are deduplicated (``exchange_plan``), each owner
answers a bucket of ``C`` request slots, and the compact table is the
``[M·C + 1, W]`` response with a zero row.  When some owner's distinct
rows overflow ``C`` the lookup falls back to psum ON THE DEVICE: both
tables are built and the slots pick the psum half with ``torch.where`` on
the overflow flag, as JAX's ``lax.cond`` picks its branch inside the
executable.  Nothing reads the flag on the host, so the whole predict of
a (slot, bucket) is one CUDA graph (:class:`ShardedPredictor`, three
weight slots a tenant: live, staged, and the previous version a rollback
returns to).

**Tenants.**  A member of a multi-tenant fleet (fleet/) holds
``MEMBER_SLOTS`` slots for each of its tenants, all of one spec, so of
one family: tenant ``i`` owns slots ``[3i, 3i + 3)``, and every slot's
bucket graphs are captured at boot.  The JAX member serves its tenants
from one executable set with the weights as arguments; here a tenant's
weights live in its own slots, and a stage, commit or rollback of any
tenant is a ``copy_`` into a slot or a repoint, so ``graph_count`` and
B1's captured count never move after boot.  The graphs of every slot
share each bucket's static buffers, so the member replays them one at a
time under one dispatch lock (serve/pool/worker.py).
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
from ...models.deepfm import CTRModel, window_multiple
from ...ops.embedding import narrow_ids
from ...parallel.embedding import exchange_capacity, exchange_plan, exchange_wire_bytes_est
from ...parallel.spmd import padded_vocab
from ...train.step import LAZY_TABLE_KEYS
from ..batcher import DEFAULT_BUCKETS
from ..graphs import GraphedPredictor

# a member's weight slots: live, staged, and the retained previous version
MEMBER_SLOTS = 3


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
    if cfg.model_name == "two_tower":
        raise ValueError("shard-group serving supports CTR servables; two-tower "
                         "retrieval has no sharded predict path yet")
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
    tree on the card: each of the family's tables zero-padded to the
    padded vocabulary and cut into ``mp`` row shards (``fm_w.<j>``,
    ``fm_v.<j>``; DCN-v2 has fm_v's alone), every other leaf as it is."""
    r, pv = ctx.rows_local, ctx.cfg.feature_size
    out = {}
    for name, v in state_dict.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        if name in LAZY_TABLE_KEYS:
            t = t[:ctx.true_feature_size]
            pad = torch.zeros((pv - t.shape[0], *t.shape[1:]), dtype=t.dtype)
            t = torch.cat([t.cpu(), pad])
            for j in range(ctx.model_parallel):
                out[f"{name}.{j}"] = t[j * r:(j + 1) * r].contiguous().to(ctx.device)
        else:
            out[name] = t.to(ctx.device)
    return out


def _gather_owned(tables, local: torch.Tensor) -> torch.Tensor:
    """``[n, W]``: the rows of one shard's ``tables`` at each ``local`` id,
    side by side, zeros where the shard owns none."""
    rows = tables[0].shape[0]
    owned = (local >= 0) & (local < rows)
    idx = local.clamp(0, rows - 1)
    got = torch.cat([t[idx].reshape(idx.shape[0], -1) for t in tables], dim=1)
    return torch.where(owned[:, None], got, torch.zeros((), dtype=got.dtype,
                                                        device=got.device))


def psum_rows(shards, flat: torch.Tensor) -> torch.Tensor:
    """The psum exchange in one process: every shard's owned rows (``shards``:
    each shard's tables), zeros elsewhere, summed (one shard owns each
    in-range id, so the sum is exact).  ``[N, W]``; a lookup's slot is its
    position."""
    rows = shards[0][0].shape[0]
    out = None
    for j, tables in enumerate(shards):
        got = _gather_owned(tables, flat - j * rows)
        out = got if out is None else out + got
    return out


def alltoall_rows(shards, flat: torch.Tensor, cap: int):
    """The deduplicated owned-rows exchange in one process
    (``parallel/embedding.py _alltoall_exchange`` with each owner's
    answer gathered here): ``(compact [M·C + 1, W], slot [N], overflow)``,
    the last row zero (the slot of an id no bucket held)."""
    m, rows = len(shards), shards[0][0].shape[0]
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
    resp = torch.cat([_gather_owned(tables, req[j * cap:(j + 1) * cap])
                      for j, tables in enumerate(shards)])
    compact = torch.cat([resp, resp.new_zeros((1, resp.shape[1]))])
    seg_of_pos = torch.empty_like(plan.seg).scatter_(0, plan.order, plan.seg)
    slot = torch.where(ok, scat, torch.full_like(scat, mc))[seg_of_pos]
    return compact, slot, plan.overflow


class ShardedCTR(nn.Module):
    """One weight slot of a member: the family's head (fm_b, MLP, batch
    norm, CIN or cross; ``head_model``, the model without its tables) and
    each table of the family as ``mp`` row shards (``shards[name]``) on
    ``ctx.device``.  ``forward(ids, vals) -> [B]`` logits.  The JAX
    counterpart is ``build_sharded_predict_with``."""

    def __init__(self, ctx: ServeGroupContext, state_dict: dict):
        super().__init__()
        self.ctx = ctx
        true_cfg = dataclasses.replace(ctx.cfg, feature_size=ctx.true_feature_size)
        staged = stage_sharded_payload(ctx, state_dict)
        self.head_model: CTRModel = _head_model(true_cfg, state_dict, ctx.device)
        self.table_names = self.head_model.TABLES
        # each table's row shape (() for a [V] table, (K,) for [V, K]) and
        # its columns in the compact rows
        shapes = [tuple(staged[f"{name}.0"].shape[1:]) for name in self.table_names]
        self.row_shapes = [(shape, int(np.prod(shape))) for shape in shapes]
        self.shards = nn.ModuleDict({
            name: nn.ParameterList([nn.Parameter(staged[f"{name}.{j}"], requires_grad=False)
                                    for j in range(ctx.model_parallel)])
            for name in self.table_names})
        self.requires_grad_(False)
        self.eval()

    def leaves(self) -> dict[str, torch.Tensor]:
        """The slot's tensors by the names :func:`stage_sharded_payload`
        gives them (the tree a swap ``copy_``s into)."""
        out = dict(self.head_model.state_dict())
        for name, parts in self.shards.items():
            for j, t in enumerate(parts):
                out[f"{name}.{j}"] = t
        return out

    def lookup(self, ids: torch.Tensor):
        """``(compact [n, W], slot [b·F])`` of a slice's ``[b, F]`` ids
        (clipped): its rows of every table assembled from the shards."""
        ctx = self.ctx
        flat = ids.reshape(-1).long()
        shards = [[self.shards[name][j] for name in self.table_names]
                  for j in range(ctx.model_parallel)]
        if ctx.exchange == "psum":
            return psum_rows(shards, flat), torch.arange(flat.shape[0], device=flat.device)
        n = flat.shape[0]
        cap = exchange_capacity(n, ctx.model_parallel, ctx.capacity)
        compact, slot, overflow = alltoall_rows(shards, flat, cap)
        # a shard owns at most rows_local rows and a slice has at most n
        # distinct ones: at that capacity no bucket overflows
        if cap < min(n, ctx.rows_local):
            dense = psum_rows(shards, flat)
            base = compact.shape[0]
            compact = torch.cat([compact, dense])
            slot = torch.where(overflow, base + torch.arange(n, device=flat.device), slot)
        return compact, slot

    def forward(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor) -> torch.Tensor:
        ctx, f = self.ctx, self.ctx.cfg.field_size
        # the single-process predict's clip (CTRModel.prepare), to the TRUE
        # vocabulary: pad rows are never read
        ids = narrow_ids(feat_ids.reshape(-1, f).clamp(0, ctx.true_feature_size - 1),
                         ctx.true_feature_size, ctx.cfg.narrow_ids).contiguous()
        vals = feat_vals.reshape(-1, f).to(torch.float32).contiguous()
        b, dp = ids.shape[0], ctx.data_parallel
        if b % dp:
            raise ValueError(f"a batch of {b} rows does not split over data_parallel={dp}")
        per = b // dp
        compacts, slots, base = [], [], 0
        for i in range(dp):
            compact, slot = self.lookup(ids[i * per:(i + 1) * per])
            compacts.append(compact)
            slots.append(slot + base)
            base += compact.shape[0]
        compact = compacts[0] if dp == 1 else torch.cat(compacts)
        slot = (slots[0] if dp == 1 else torch.cat(slots)).to(torch.int32).view(ids.shape)
        tables, off = {}, 0
        for name, (shape, w) in zip(self.table_names, self.row_shapes):
            tables[name] = compact[:, off:off + w].reshape(-1, *shape).contiguous()
            off += w
        return self.head_model.table_logits(tables, slot, vals)


def _head_model(cfg: ModelConfig, state_dict: dict, device: torch.device) -> CTRModel:
    """The family's model with ``state_dict``'s head weights and no
    tables: built on the CPU, its tables dropped by name, then moved to
    ``device``."""
    from ..export import model_from_state

    model = model_from_state(cfg, state_dict, "cpu")
    for name in model.TABLES:
        delattr(model, name)
    model.to(device)
    model.requires_grad_(False)
    model.eval()
    return model


class ShardedPredictor(GraphedPredictor):
    """A member's predict behind CUDA graphs in ``MEMBER_SLOTS`` weight
    slots a tenant (``tenants`` of them, every slot starting from
    ``state_dict``) on ``ctx.device`` (``"cpu"`` runs eagerly): the
    :class:`~..graphs.GraphedPredictor` over :class:`ShardedCTR` slots,
    whose tensors are :func:`stage_sharded_payload`'s tree.  Every bucket
    must divide by ``dp``; B1 (DeepFM, xDeepFM) runs once in each
    replay."""

    def __init__(self, ctx: ServeGroupContext, state_dict: dict, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, tenants: int = 1):
        bad = [b for b in buckets if int(b) % ctx.data_parallel]
        if bad:
            raise ValueError(
                f"bucket sizes {bad} are not divisible by the group's data_parallel="
                f"{ctx.data_parallel}: every dispatch shape must split evenly over the "
                f"member's data slices")
        self.ctx = ctx
        super().__init__(ctx.cfg, state_dict, device=ctx.device, buckets=buckets,
                         slots=MEMBER_SLOTS * int(tenants))

    def _slot_model(self, state_dict: dict) -> ShardedCTR:
        return ShardedCTR(self.ctx, state_dict)

    def _leaves(self, slot: int) -> dict[str, torch.Tensor]:
        return self._models[slot].leaves()


def group_wire_bytes_est(ctx: ServeGroupContext, bucket: int) -> int:
    """JAX's estimate of the exchange bytes a ``bucket``-row dispatch moves
    out of one shard (``exchange_wire_bytes_est`` over fm_w's and fm_v's
    widths, which JAX counts for every family).  In one process no byte
    crosses a wire; the number is the router's observability figure, kept
    for a member spread over cards."""
    n_local = max(1, bucket // max(1, ctx.data_parallel)) * ctx.cfg.field_size
    return exchange_wire_bytes_est(n_local, ctx.model_parallel, ctx.capacity,
                                   (1, ctx.cfg.embedding_size), exchange=ctx.exchange)


def load_sharded_servable(directory: str | os.PathLike, data_parallel: int = 1,
                          model_parallel: int = 1, *, device=None, exchange: str | None = None,
                          buckets: Sequence[int] = DEFAULT_BUCKETS, tenants: int = 1):
    """A CTR servable row-sharded for one member: ``(predict, predictor,
    holder, ctx)``, the quartet of ``serve/reload.py
    load_swappable_servable`` (JAX returns ``predict_with`` where the port
    returns the predictor, whose ``predict_with(slot, ...)`` it is):

    * ``predict(ids, vals)``: the live slot from ``holder``, through its
      graphs (what the micro-batcher calls, on its worker thread);
    * ``predictor``: the :class:`ShardedPredictor` (``MEMBER_SLOTS`` slots
      for each of ``tenants``);
    * ``holder``: a ``SwappableParams`` whose payload is the first
      tenant's live slot;
    * ``ctx``: the :class:`ServeGroupContext`."""
    from ..export import read_params
    from ..reload import SwappableParams

    directory = os.path.abspath(directory)
    cfg = load_config(directory)
    ctx = make_serve_context(cfg, data_parallel, model_parallel, device=device,
                             exchange=exchange)
    predictor = ShardedPredictor(ctx, read_params(directory), buckets=buckets,
                                 tenants=tenants)
    holder = SwappableParams(0, version=0)

    def predict(feat_ids, feat_vals) -> np.ndarray:
        slot, gen = holder.acquire()
        try:
            return predictor.predict_with(slot, feat_ids, feat_vals)
        finally:
            holder.release(gen)

    return predict, predictor, holder, ctx
