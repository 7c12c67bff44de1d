"""Two-tower retrieval: counterpart of ``user_vocab``, ``item_vocab``,
``init_two_tower``, ``_apply_tower``, ``encode_tower``,
``in_batch_softmax_loss``, ``retrieval_metrics`` and
``two_tower_l2_penalty`` in ``deepfm_tpu/models/two_tower.py``, and of
``encode_queries`` / ``encode_items`` in
``deepfm_tpu/parallel/retrieval.py``.

    u = normalize(MLP_u(flatten(E_u[user_ids] · user_vals)))   [B, D]
    i = normalize(MLP_i(flatten(E_i[item_ids] · item_vals)))   [B, D]

Each side: ids narrowed (clipped to the side's vocabulary), the lookup
scaled by vals, the tower MLP (relu layers, then ``proj``) in
``compute_dtype``, a cast to float32, and an L2 normalization with a
1e-12 floor.  Parameters stay float32.  Names follow the JAX pytree, so
``convert.two_tower_params_from_jax`` maps one onto the other:
``user_embedding``, ``item_embedding``, ``{user,item}_tower.layer_<i>.
{kernel,bias}`` and ``{user,item}_tower.proj.{kernel,bias}``.

The tower forward exists once: serving, the funnel's index and training
(train/retrieval.py, parallel/retrieval.py) all encode through
:func:`encode_tower`.  A model whose tables are row shards of a grid
(``sharded``, a ``parallel/embedding.py ShardedTables``) looks its rows up
through the model group, and its L2 penalty sums the shards.

Training scores every query against the batch's items (in-batch
negatives): :func:`in_batch_softmax_loss` is the per-example
cross-entropy of ``u·iᵀ / temperature`` at each query's positive, and
:func:`retrieval_metrics` the top-1 accuracy and recall@10 of the
positives in that score matrix.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.platform import resolve_device
from ..ops.embedding import dense_lookup, narrow_ids
from ..ops.initializers import glorot_normal
from .base import register_model
from .deepfm import Dense

SIDES = ("user", "item")


def user_vocab(cfg: ModelConfig) -> int:
    return cfg.user_vocab_size or cfg.feature_size


def item_vocab(cfg: ModelConfig) -> int:
    return cfg.item_vocab_size or cfg.feature_size


def _check_side(side: str) -> None:
    if side not in SIDES:
        raise ValueError(f"side must be 'user' or 'item', got {side!r}")


class Tower(nn.Module):
    """The tower MLP: ``layer_<i>`` with relu, then ``proj`` to
    ``tower_dim``, in ``compute_dtype``; float32 out, L2-normalized."""

    def __init__(self, in_dim: int, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        dims = [in_dim, *cfg.tower_layers]
        self.n_layers = len(cfg.tower_layers)
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"layer_{i}", Dense(d_in, d_out, generator))
        self.proj = Dense(dims[-1], cfg.tower_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.compute_dtype)
        for i in range(self.n_layers):
            h = torch.relu(getattr(self, f"layer_{i}")(h))
        out = self.proj(h).to(torch.float32)
        norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        return out / norm.clamp_min(1e-12)


class TwoTower(nn.Module):
    """Both towers and their tables on ``device`` (default: the card), in
    eval mode.  Weights are drawn from ``generator`` (default: a CPU
    generator seeded 0) with the reference's initializers: glorot normal
    tables, glorot uniform tower kernels, zero biases."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        k = cfg.embedding_size
        self.user_embedding = nn.Parameter(glorot_normal((user_vocab(cfg), k), g))
        self.item_embedding = nn.Parameter(glorot_normal((item_vocab(cfg), k), g))
        self.user_tower = Tower(cfg.user_field_size * k, cfg, g)
        self.item_tower = Tower(cfg.item_field_size * k, cfg, g)
        self.to(device)
        # row-sharded tables (parallel/retrieval.py); None: whole tables
        self.sharded = None
        self.eval()

    def forward(self, user_ids, user_vals, item_ids, item_vals):
        """(u [B, D], i [B, D]), both L2-normalized."""
        return (encode_tower(self, user_ids, user_vals, side="user"),
                encode_tower(self, item_ids, item_vals, side="item"))


def encode_tower(model: TwoTower, ids: torch.Tensor, vals: torch.Tensor, *,
                 side: str) -> torch.Tensor:
    """Encode one side (``"user"`` or ``"item"``): [.., F_side] ids and
    vals -> [B, D] float32, L2-normalized.  Ids clip to the side's
    vocabulary."""
    _check_side(side)
    cfg = model.cfg
    field = cfg.user_field_size if side == "user" else cfg.item_field_size
    vocab = user_vocab(cfg) if side == "user" else item_vocab(cfg)
    ids = narrow_ids(ids.reshape(-1, field), vocab, cfg.narrow_ids)
    vals = vals.reshape(-1, field).to(torch.float32)
    table = getattr(model, f"{side}_embedding")
    rows = (dense_lookup(table, ids) if model.sharded is None
            else model.sharded.rows(table, ids))
    emb = rows * vals[..., None]
    tower = getattr(model, f"{side}_tower")
    return tower(emb.reshape(emb.shape[0], field * cfg.embedding_size))


def encode_queries(model: TwoTower, user_ids, user_vals) -> torch.Tensor:
    """Query users [B, Fu] -> [B, D] (the funnel's retrieval stage)."""
    return encode_tower(model, user_ids, user_vals, side="user")


def encode_items(model: TwoTower, item_ids, item_vals) -> torch.Tensor:
    """Corpus items [B, Fi] -> [B, D] (the funnel's index build)."""
    return encode_tower(model, item_ids, item_vals, side="item")


def in_batch_softmax_loss(user: torch.Tensor, items: torch.Tensor,
                          label_idx: torch.Tensor, *, temperature: float
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax over in-batch negatives: ``user [b, D]`` queries against the
    candidate pool ``items [N, D]`` (N >= b; the grid passes every data
    index's items), ``label_idx [b]`` each query's positive in ``items``.
    Returns (per-example cross-entropy [b], scores [b, N])."""
    scores = (user @ items.T) / temperature
    log_probs = torch.log_softmax(scores, dim=-1)
    ce = -log_probs.gather(1, label_idx[:, None].long())[:, 0]
    return ce, scores


def retrieval_metrics(scores: torch.Tensor, label_idx: torch.Tensor,
                      k: int = 10) -> dict[str, torch.Tensor]:
    """Top-1 accuracy and recall@k of the positives within ``scores``."""
    label_idx = label_idx.long()
    top1 = (torch.argmax(scores, dim=-1) == label_idx).to(torch.float32)
    true_score = scores.gather(1, label_idx[:, None])
    rank = (scores > true_score).sum(dim=-1)
    return {"top1_acc": top1.mean(),
            f"recall_at_{k}": (rank < k).to(torch.float32).mean()}


def two_tower_l2_penalty(model: TwoTower, l2_reg: float) -> torch.Tensor:
    """``l2_reg·½(Σ user_embedding² + Σ item_embedding²)``: both tables,
    tower weights excluded, as in the reference; over every shard of
    row-sharded tables."""
    total = model.user_embedding.square().sum() + model.item_embedding.square().sum()
    if model.sharded is not None:
        total = model.sharded.table_sum(total)
    return l2_reg * 0.5 * total


register_model("two_tower", TwoTower, two_tower_l2_penalty)
