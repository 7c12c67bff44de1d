"""DCN-v2: counterpart of ``init_cross``, ``apply_cross``, ``init_dcnv2``
and ``apply_dcnv2`` in ``deepfm_tpu/models/dcnv2.py`` (parallel deep and
cross network).

    x0      = flatten(e)                     [B, D], D = F·K
    x_{l+1} = x0 ⊙ (W_l x_l + b_l) + x_l      l = 0 .. cross_layers - 1
    logits  = fm_b + w_out · x_L + b_out + MLP(x0)
    e_fk    = V[id_f]_k · x_f

The cross layers run in ``compute_dtype``, float32 out.  The gather is
the plain one JAX's DCN-v2 runs outside Pallas (``scaled_embedding``),
on the model's fm_v or on the compact rows a lazy or grid step
assembled.  DCN-v2 has no first-order table: ``fm_v [feature_size, K]``
(no pad rows) is its only table, the one its L2 penalty and its lazy
update cover.  Parameter names follow the JAX pytree
(``cross.layer_<l>.{kernel,bias}`` ``[D, D]``, ``cross.out``, and
DeepFM's ``mlp``/``bn``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.platform import resolve_device
from ..ops.embedding import scaled_embedding
from ..ops.initializers import glorot_normal
from .base import register_model
from .deepfm import CTRModel, Dense, deepfm_l2_penalty


class Cross(nn.Module):
    """``layer_<l>`` full-rank cross layers and the ``out`` head: x0 [B, D]
    -> [B] float32."""

    def __init__(self, dim: int, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.n_layers = cfg.cross_layers
        for i in range(cfg.cross_layers):
            self.add_module(f"layer_{i}", Dense(dim, dim, generator))
        self.out = Dense(dim, 1, generator)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x0c = x0.to(self.compute_dtype)
        x = x0c
        for i in range(self.n_layers):
            x = x0c * getattr(self, f"layer_{i}")(x) + x
        return self.out(x)[:, 0].to(torch.float32)


class DCNv2(CTRModel):
    """DCN-v2 on ``device`` (default: the card), in eval mode.  Weights
    from ``generator`` (default: a CPU generator seeded 0): zero bias,
    glorot normal fm_v, glorot uniform cross and MLP kernels."""

    TABLES = ("fm_v",)

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        dim = cfg.field_size * cfg.embedding_size
        self.fm_b = nn.Parameter(torch.zeros(1, device=g.device))
        self.fm_v = nn.Parameter(glorot_normal((cfg.feature_size, cfg.embedding_size), g))
        self.cross = Cross(dim, cfg, g)
        self._init_deep(cfg, dim, g)
        self._finish(device, g)

    def head(self, emb: torch.Tensor) -> torch.Tensor:
        x0 = emb.reshape(emb.shape[0], -1)
        return self.fm_b[0] + self.cross(x0) + self.deep(x0)

    def table_logits(self, tables: dict, ids: torch.Tensor, vals: torch.Tensor
                     ) -> torch.Tensor:
        return self.head(scaled_embedding(tables["fm_v"], ids, vals))


register_model("dcnv2", DCNv2, deepfm_l2_penalty)
