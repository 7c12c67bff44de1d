"""Top-K retrieval index over item-tower embeddings, and the funnel's two
stages: counterpart of ``deepfm_tpu/funnel/index.py``.

The item corpus is encoded once through the two-tower item tower into a
``[N, D]`` embedding matrix (:func:`build_index`).  A query batch is
encoded by the user tower and scored against the index
(:func:`build_retrieve_with`), and each query's K candidates are ranked
through the live DeepFM (:func:`build_rank_topn_with`).

The index is row-sharded over ``model_parallel`` shards, as JAX shards it
over the serve mesh's ``model`` axis: the capacity rounds up to a
multiple of M and shard ``s`` holds the ``capacity/M`` contiguous rows
from ``s·capacity/M``, on the models' device (the CPU in the tests, the
one serving card on the card, in a pool member too: spreading the shards
over several cards waits for a machine with more than one).  Per shard:

    u      = encode_queries(...)            [B, D]  (moved to the shard)
    scores = u @ item_embᵀ                  [B, rows/M]
    s, i   = top K under (-score, row)      [B, K]  (global row s·rows/M + i)

then only the ``[B, K]`` candidate packs (score, global row, item id)
travel to the first shard's device, where one merge by (-score, global
row) keeps K, as JAX's ``lax.sort(num_keys=2)`` over the all-gathered
packs does.  No tensor with a corpus-sized dimension crosses shards.  Ties
break toward the smaller global corpus row, which is what
:func:`brute_force_topk` implements.  With M = 1 the merge is the shard's
own selection.

``retrieval_mode="int8"`` scores each shard's quantized rows with kernel
B2 (``ops/retrieval.py``: the Hopper kernel on the card, its plain version
on the CPU) for a shortlist of ``K·oversample`` rows, rescores the
shortlist exactly in f32 and keeps the shard's K best before the same
merge.  Pad rows ``[items, capacity)`` carry ``item_id = -1`` and score
``-inf``.
"""

from __future__ import annotations

import hashlib
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.config import ModelConfig
from ..models.two_tower import encode_items, encode_queries
from ..ops.retrieval import retrieval_topk
from .quant import quantize_rows, resolve_retrieval_mode
from .recall import topk_lex

# item ids are packed into the float32 lane of the funnel pack ([B, 3, N]:
# ids, rank scores, retrieval scores); f32 holds integers exactly up to 2**24
MAX_INDEX_ID = 1 << 24


class FunnelIndex(NamedTuple):
    """The host-side index artifact: corpus ids + item-tower embeddings."""

    item_ids: np.ndarray   # [N] int32, all >= 0
    item_emb: np.ndarray   # [N, D] float32 (L2-normalized by the tower)


def index_hash(index: FunnelIndex) -> str:
    """Content address of an index (shape, dtype and bytes of both
    arrays); equal to the JAX package's for the same arrays."""
    h = hashlib.sha256()
    for arr in (index.item_ids, index.item_emb):
        a = np.ascontiguousarray(arr)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def build_index(query_model, item_ids: np.ndarray, item_feat_ids: np.ndarray,
                item_feat_vals: np.ndarray, *, chunk: int = 1024) -> FunnelIndex:
    """Encode an item corpus through ``query_model``'s item tower (a
    ``TwoTower`` on its device: the card, or the CPU) into a FunnelIndex.

    ``item_ids [N]`` are the corpus ids returned to clients;
    ``item_feat_ids/vals [N, Fi]`` the items' tower features.  Encoding
    runs in ``chunk``-row batches with a zero-padded tail, as in JAX, so
    every batch has one shape."""
    ids = np.asarray(item_ids)
    if ids.ndim != 1 or ids.size == 0:
        raise ValueError(f"item_ids must be a non-empty [N] vector, got "
                         f"shape {ids.shape}")
    if ids.min() < 0 or ids.max() >= MAX_INDEX_ID:
        raise ValueError(
            f"corpus ids must lie in [0, {MAX_INDEX_ID}) (f32-exact in the "
            f"funnel output pack); got min={ids.min()} max={ids.max()}"
        )
    n = ids.shape[0]
    dev = query_model.item_embedding.device
    fi = torch.from_numpy(np.asarray(item_feat_ids, np.int64).reshape(n, -1)).to(dev)
    fv = torch.from_numpy(np.asarray(item_feat_vals, np.float32).reshape(n, -1)).to(dev)
    out = torch.empty((n, query_model.cfg.tower_dim), dtype=torch.float32, device=dev)
    with torch.inference_mode():
        for lo in range(0, n, chunk):
            ci, cv = fi[lo:lo + chunk], fv[lo:lo + chunk]
            b = ci.shape[0]
            if b < chunk:
                ci = torch.cat([ci, ci.new_zeros((chunk - b, ci.shape[1]))])
                cv = torch.cat([cv, cv.new_zeros((chunk - b, cv.shape[1]))])
            out[lo:lo + b] = encode_items(query_model, ci, cv)[:b]
    return FunnelIndex(item_ids=ids.astype(np.int32), item_emb=out.cpu().numpy())


class FunnelContext(NamedTuple):
    """The funnel's static geometry."""

    query_cfg: ModelConfig     # two-tower config (user tower = query encoder)
    rank_cfg: ModelConfig      # CTR ranker config (the live DeepFM)
    capacity: int              # index rows (items plus pad rows), a multiple of M
    top_k: int                 # candidates retrieved per query
    return_n: int              # ranked items returned per query (<= top_k)
    item_field: int            # rank-row field carrying the candidate id
    user_fields: int           # query tower feature width (Fu)
    rank_fields: int           # ranker feature width (F)
    retrieval_mode: str = "exact"   # resolved: "exact" | "int8"
    oversample: int = 1        # int8 shortlist width = top_k * oversample
    model_parallel: int = 1    # index shards (M)

    @property
    def rows_local(self) -> int:
        """Index rows a shard holds."""
        return self.capacity // self.model_parallel


def make_funnel_context(rank_cfg: ModelConfig, query_cfg: ModelConfig, *,
                        capacity: int, top_k: int, return_n: int = 0,
                        item_field: int | None = None, retrieval: str = "exact",
                        oversample: int = 4, model_parallel: int = 1) -> FunnelContext:
    """Check and fix the funnel geometry, with JAX's rules: ``capacity``
    rounds up to a multiple of ``model_parallel`` (``padded_vocab``), and
    ``top_k`` (under int8 ``top_k·oversample``) must fit one shard.
    ``item_field`` defaults to the ranker's last field; ``retrieval``
    ("exact" | "int8" | "auto") resolves against the padded capacity."""
    from ..parallel.spmd import padded_vocab

    mp = int(model_parallel)
    if mp < 1:
        raise ValueError(f"funnel model_parallel must be >= 1, got {mp}")
    if capacity < 1:
        raise ValueError(f"index capacity must be >= 1, got {capacity}")
    capacity = padded_vocab(int(capacity), mp)
    per_shard = capacity // mp
    top_k = int(top_k)
    return_n = int(return_n) if return_n else top_k
    if top_k < 1:
        raise ValueError(f"funnel top_k must be >= 1, got {top_k}")
    if top_k > per_shard:
        raise ValueError(
            f"funnel top_k={top_k} exceeds the per-shard index rows "
            f"{per_shard} (capacity {capacity} over model_parallel={mp}): a "
            f"shard's selection cannot take more rows than it holds"
        )
    if not 1 <= return_n <= top_k:
        raise ValueError(f"funnel return_n={return_n} must lie in [1, top_k={top_k}]")
    mode = resolve_retrieval_mode(retrieval, capacity)
    oversample = int(oversample) if mode == "int8" else 1
    if oversample < 1:
        raise ValueError(f"funnel oversample must be >= 1, got {oversample}")
    if mode == "int8" and top_k * oversample > per_shard:
        raise ValueError(
            f"funnel oversample={oversample} * top_k={top_k} = "
            f"{top_k * oversample} exceeds the per-shard index rows "
            f"{per_shard} (capacity {capacity} over model_parallel={mp}): "
            f"the int8 shortlist cannot select more rows than a shard "
            f"holds; lower the oversample or the model-parallel width"
        )
    f = rank_cfg.field_size
    item_field = f - 1 if item_field is None else int(item_field)
    if not 0 <= item_field < f:
        raise ValueError(
            f"funnel item_field={item_field} out of the ranker's [0, {f}) field range"
        )
    return FunnelContext(
        query_cfg=query_cfg, rank_cfg=rank_cfg, capacity=capacity,
        top_k=top_k, return_n=return_n, item_field=item_field,
        user_fields=query_cfg.user_field_size, rank_fields=f,
        retrieval_mode=mode, oversample=oversample, model_parallel=mp,
    )


def _lex_topk(scores: torch.Tensor, rows: torch.Tensor, k: int):
    """The first ``k`` of each row of ``scores`` [B, n] under the key
    (-score, row): positions into the second axis.  Two stable sorts:
    by row, then by descending score."""
    by_row = torch.argsort(rows, dim=1, stable=True)
    s = torch.gather(scores, 1, by_row)
    order = torch.argsort(s, dim=1, descending=True, stable=True)
    return torch.gather(by_row, 1, order[:, :k])


# called with the shape of every tensor that crosses between shards (the
# query to each shard, the packs to the merge; None: nobody watches);
# analysis/trace_audit.py audit_funnel holds none of them corpus-sized
exchange_observer: Callable | None = None


def _cross_shard(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    if exchange_observer is not None:
        exchange_observer(tuple(t.shape))
    return t.to(dev, non_blocking=True)


def build_retrieve_with(ctx: FunnelContext) -> Callable:
    """``retrieve_with(payload, user_ids, user_vals) -> (scores, ids)``:
    [B, K] f32 and [B, K] int32 tensors on the first shard's device,
    sorted by (-score, global corpus row).

    Per shard, ``"exact"`` scores ``u @ embᵀ`` and keeps the K best with a
    stable sort (``lax.top_k``'s order); ``"int8"`` selects a shortlist of
    ``K·oversample`` rows with kernel B2 (``retrieval_topk``), rescores it
    exactly in f32 and keeps the K best under (-score, row).  The shards'
    ``[B, K]`` packs then merge by (-score, global row)."""
    k, rows_local = ctx.top_k, ctx.rows_local

    def shard_exact(u, shard):
        emb, iid = shard["item_emb"], shard["item_ids"]            # [R/M, D], [R/M]
        scores = u @ emb.T
        scores = torch.where(iid[None, :] >= 0, scores,
                             torch.full_like(scores, float("-inf")))
        s, li = torch.sort(scores, dim=1, descending=True, stable=True)
        s, li = s[:, :k], li[:, :k]
        return s, li, iid[li]

    def shard_int8(u, shard):
        emb, iid = shard["item_emb"], shard["item_ids"]
        s_a, li = retrieval_topk(u, shard["item_codes"], shard["item_scales"], iid,
                                 k * ctx.oversample)                # [B, K*os]
        # slots whose approximate score is -inf never saw a real row
        valid = s_a > float("-inf")
        li = torch.where(valid, li, torch.zeros_like(li)).long()
        cid = torch.where(valid, iid[li], torch.full_like(li, -1, dtype=iid.dtype))
        # exact f32 rescore of the shortlist rows only: [B, K*os, D]
        s = torch.einsum("bd,bkd->bk", u, emb[li])
        s = torch.where(valid & (cid >= 0), s, torch.full_like(s, float("-inf")))
        pick = _lex_topk(s, li, k)
        return (torch.gather(s, 1, pick), torch.gather(li, 1, pick),
                torch.gather(cid, 1, pick))

    local = shard_int8 if ctx.retrieval_mode == "int8" else shard_exact

    def retrieve_with(payload, user_ids, user_vals):
        u = encode_queries(payload["query"], user_ids, user_vals)   # [B, D]
        shards = payload["shards"]
        if len(shards) == 1:
            s, _, cid = local(u, shards[0])
            return s, cid
        dev = shards[0]["item_ids"].device
        packs = [local(_cross_shard(u, shard["item_ids"].device), shard) for shard in shards]
        # the [B, K] packs only: score, global row, item id
        s_all = torch.cat([_cross_shard(s, dev) for s, _, _ in packs], dim=1)
        g_all = torch.cat([_cross_shard(li + i * rows_local, dev)
                           for i, (_, li, _) in enumerate(packs)], dim=1)
        c_all = torch.cat([_cross_shard(c, dev) for _, _, c in packs], dim=1)
        pick = _lex_topk(s_all, g_all, k)
        return torch.gather(s_all, 1, pick), torch.gather(c_all, 1, pick)

    return retrieve_with


def build_rank_topn_with(ctx: FunnelContext) -> Callable:
    """``rank_with(payload, feat_ids, feat_vals, cand_ids, cand_scores) ->
    [B, 3, N] f32``.

    Each query row's ``[F]`` ranking features fan out to its K candidates
    (the candidate id in ``item_field``, val 1.0) and score through the
    live DeepFM (``payload["rank"]``, kernel B1 on the card).  A sigmoid,
    -inf for pad candidates, then a stable sort by (-probability,
    retrieval order) keeps the top N.  Pack lanes: ``[:, 0]`` item ids (f32-exact),
    ``[:, 1]`` rank probabilities, ``[:, 2]`` retrieval scores."""
    k, n, item_field, f = ctx.top_k, ctx.return_n, ctx.item_field, ctx.rank_fields

    def rank_with(payload, feat_ids, feat_vals, cand_ids, cand_scores):
        model = payload["rank"]
        b = feat_ids.shape[0]
        ids = feat_ids[:, None, :].expand(b, k, f).clone()
        ids[:, :, item_field] = cand_ids.to(ids.dtype)
        vals = feat_vals[:, None, :].expand(b, k, f).clone()
        vals[:, :, item_field] = 1.0
        logits = model(ids.reshape(b * k, f), vals.reshape(b * k, f))
        probs = torch.sigmoid(logits).reshape(b, k)
        # pad candidates (id < 0: the corpus holds fewer than K items)
        # rank last, never first
        probs = torch.where(cand_ids >= 0, probs, torch.full_like(probs, float("-inf")))
        order = torch.argsort(probs, dim=1, descending=True, stable=True)[:, :n]
        return torch.stack([torch.gather(cand_ids, 1, order).to(torch.float32),
                            torch.gather(probs, 1, order),
                            torch.gather(cand_scores, 1, order)], dim=1)

    return rank_with


def check_index(ctx: FunnelContext, index: FunnelIndex) -> None:
    """The guards every staged index passes (JAX ``stage_funnel_payload``):
    the corpus within the capacity, ids in [0, feature_size) and below
    2**24, the tower's dimension."""
    n = index.item_ids.shape[0]
    if n > ctx.capacity:
        raise ValueError(
            f"index holds {n} items, over the funnel capacity "
            f"{ctx.capacity} fixed at boot; redeploy with a larger "
            f"capacity to grow the corpus"
        )
    if n and int(index.item_ids.min()) < 0:
        raise ValueError("corpus item ids must be >= 0 (-1 marks pad rows)")
    if n and int(index.item_ids.max()) >= ctx.rank_cfg.feature_size:
        raise ValueError(
            f"corpus item id {int(index.item_ids.max())} exceeds the "
            f"ranker's feature_size {ctx.rank_cfg.feature_size}: rank rows "
            f"could not address the item's embedding"
        )
    if n and int(index.item_ids.max()) >= MAX_INDEX_ID:
        raise ValueError(
            f"corpus item id {int(index.item_ids.max())} >= "
            f"{MAX_INDEX_ID} is not f32-exact in the funnel output pack"
        )
    d = index.item_emb.shape[1]
    if d != ctx.query_cfg.tower_dim:
        raise ValueError(
            f"index embedding dim {d} != query tower_dim {ctx.query_cfg.tower_dim}"
        )


def index_shards(ctx: FunnelContext, index: FunnelIndex) -> list[dict[str, np.ndarray]]:
    """The index padded to the capacity (pad rows id -1, emb 0) and cut
    into ``model_parallel`` row blocks, as host arrays; in int8 mode with
    the codes and scales quantized from the f32 rows, so they always match
    the rescore source (pad rows quantize to scale 0, zero codes)."""
    check_index(ctx, index)
    n, d = index.item_emb.shape
    ids = np.full((ctx.capacity,), -1, np.int32)
    ids[:n] = index.item_ids
    emb = np.zeros((ctx.capacity, d), np.float32)
    emb[:n] = index.item_emb
    leaves = {"item_ids": ids, "item_emb": emb}
    if ctx.retrieval_mode == "int8":
        leaves["item_codes"], leaves["item_scales"] = quantize_rows(emb)
    r = ctx.rows_local
    return [{name: np.ascontiguousarray(a[i * r:(i + 1) * r]) for name, a in leaves.items()}
            for i in range(ctx.model_parallel)]


def stage_funnel_payload(ctx: FunnelContext, rank_model, query_model,
                         index: FunnelIndex) -> dict:
    """The funnel payload: the ranker (``DeepFM``), the query encoder
    (``TwoTower``) and the index shards (:func:`index_shards`), all on the
    models' device."""
    dev = rank_model.fm_v.device
    return {
        "query": query_model,
        "rank": rank_model,
        "shards": [{name: torch.from_numpy(a).to(dev) for name, a in shard.items()}
                   for shard in index_shards(ctx, index)],
    }


# the candidate-pack lanes that cross shards: (scores f32, global rows,
# item ids i32)
_PACK_LANE_BYTES = (4, 4, 4)


def funnel_wire_bytes_est(ctx: FunnelContext, bucket: int) -> int:
    """Bytes of candidate packs a ``bucket``-row retrieve moves to the
    merge: ``[B, K]`` of each lane from each shard (JAX
    ``funnel_wire_bytes_est`` with one data index)."""
    return sum(_PACK_LANE_BYTES) * max(1, bucket) * ctx.top_k * ctx.model_parallel


def funnel_score_bytes_est(ctx: FunnelContext, bucket: int) -> dict:
    """Bytes the scoring stage reads per dispatch, summed over shards:
    ``exact`` the whole f32 corpus; ``int8`` the codes and scales plus each
    shard's shortlist f32 rescore gather.  ``saved_bytes`` is the
    difference against exact."""
    d = ctx.query_cfg.tower_dim
    exact_read = ctx.capacity * d * 4
    if ctx.retrieval_mode != "int8":
        return {"score_read_bytes": exact_read, "saved_bytes": 0}
    kos = ctx.top_k * ctx.oversample
    read = ctx.capacity * (d + 4) + max(1, bucket) * ctx.model_parallel * kos * d * 4
    return {"score_read_bytes": read, "saved_bytes": max(0, exact_read - read)}


def brute_force_topk(item_emb: np.ndarray, item_ids: np.ndarray,
                     user_emb: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The dense numpy reference: the full ``[B, N]`` score matrix, per
    query the ``k`` best under (-score, corpus row), pad rows (id < 0)
    forced to ``-inf``.  Returns ``(scores [B, k], ids [B, k])``."""
    item_emb = np.asarray(item_emb, np.float32)
    item_ids = np.asarray(item_ids, np.int32)
    user_emb = np.asarray(user_emb, np.float32)
    scores = user_emb @ item_emb.T
    scores[:, item_ids < 0] = -np.inf
    out_s = np.empty((user_emb.shape[0], k), np.float32)
    out_i = np.empty((user_emb.shape[0], k), np.int32)
    for b in range(user_emb.shape[0]):
        order = topk_lex(scores[b], k)
        out_s[b] = scores[b][order]
        out_i[b] = item_ids[order]
    return out_s, out_i
