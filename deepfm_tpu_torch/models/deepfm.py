"""DeepFM, infer mode: counterpart of ``apply_deepfm(train=False)`` and
``apply_mlp`` in ``deepfm_tpu/models/deepfm.py``.

    logits = fm_b + Σ_f w_f·x_f + 0.5Σ_k((Σ_f e)²−Σ_f e²) + MLP(flatten(e))
    e_fk   = V[id_f]_k · x_f

The gathers and both FM terms always go through
``ops.fused_ctr.fused_ctr_interaction`` (the Hopper kernel on the card).
The MLP follows the JAX dtype flow: input, kernels and biases cast to
``compute_dtype``, the bias added in that dtype after the product, relu
there too, batch norm (when on) in float32, and the head cast back to
float32.  Parameters stay float32.

Parameter names follow the JAX pytree, so ``convert.params_from_jax`` maps
one onto the other: ``fm_b``, ``fm_w``, ``fm_v``,
``mlp.layer_<i>.{kernel,bias}``, ``mlp.out.{kernel,bias}``,
``bn.layer_<i>.{scale,bias,moving_mean,moving_var}``.  Kernels are
``[in, out]``, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.platform import resolve_device
from ..ops.batch_norm import BNParams, BNState, batch_norm
from ..ops.embedding import narrow_ids
from ..ops.fused_ctr import fused_ctr_interaction
from ..ops.initializers import glorot_normal, glorot_uniform
from .base import register_model


def fm_v_rows(cfg: ModelConfig) -> int:
    """Rows of the fm_v table: ``feature_size``, plus zero pad rows up to a
    multiple of 128/K when ``fused_kernel != "off"`` (the JAX init pads on
    the config value, so a checkpoint's shape follows its config)."""
    rows = cfg.feature_size
    if cfg.fused_kernel != "off" and 128 % cfg.embedding_size == 0:
        rows += (-cfg.feature_size) % (128 // cfg.embedding_size)
    return rows


class Dense(nn.Module):
    """``h @ kernel + bias`` with both cast to ``h``'s dtype first."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(glorot_uniform((d_in, d_out), generator))
        self.bias = nn.Parameter(torch.zeros(d_out, device=generator.device))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.kernel.to(h.dtype) + self.bias.to(h.dtype)


class BatchNorm(nn.Module):
    """Infer-mode batch norm over moving statistics (ops/batch_norm.py)."""

    def __init__(self, width: int, device: torch.device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width, device=device))
        self.bias = nn.Parameter(torch.zeros(width, device=device))
        self.register_buffer("moving_mean", torch.zeros(width, device=device))
        self.register_buffer("moving_var", torch.ones(width, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, BNParams(self.scale, self.bias),
                          BNState(self.moving_mean, self.moving_var))


class DeepFM(nn.Module):
    """DeepFM forward on ``device`` (default: the card; ``"cpu"`` runs the
    plain versions of the kernels).  Weights are drawn from ``generator``
    (default: a CPU generator seeded 0) with the reference's initializers:
    zero bias, glorot normal FM_W/FM_V, glorot uniform MLP kernels, zero MLP
    biases."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        fields, k = cfg.field_size, cfg.embedding_size
        self.fm_b = nn.Parameter(torch.zeros(1, device=g.device))
        self.fm_w = nn.Parameter(glorot_normal((cfg.feature_size,), g))
        fm_v = glorot_normal((cfg.feature_size, k), g)
        pad = fm_v_rows(cfg) - cfg.feature_size
        if pad:
            fm_v = torch.cat([fm_v, fm_v.new_zeros(pad, k)])
        self.fm_v = nn.Parameter(fm_v)
        dims = [fields * k, *cfg.deep_layers]
        self.mlp = nn.ModuleDict({
            f"layer_{i}": Dense(d_in, d_out, g)
            for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:]))
        })
        self.mlp["out"] = Dense(dims[-1], 1, g)
        if cfg.batch_norm:
            self.bn = nn.ModuleDict({
                f"layer_{i}": BatchNorm(w, g.device)
                for i, w in enumerate(cfg.deep_layers)
            })
        self.to(device)
        self.eval()

    def prepare(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor):
        """[.., F] ids and vals -> ([B, F] narrowed ids, [B, F] float32 vals)."""
        f = self.cfg.field_size
        ids = narrow_ids(feat_ids.reshape(-1, f), self.cfg.feature_size,
                         self.cfg.narrow_ids)
        return ids.contiguous(), feat_vals.reshape(-1, f).to(torch.float32).contiguous()

    def head(self, emb: torch.Tensor, y_w: torch.Tensor, y_v: torch.Tensor) -> torch.Tensor:
        """The deep tower on flattened ``emb`` plus the FM terms -> [B] logits."""
        n = len(self.cfg.deep_layers)
        h = emb.reshape(emb.shape[0], -1).to(self.compute_dtype)
        for i in range(n):
            h = torch.relu(self.mlp[f"layer_{i}"](h))
            if self.cfg.batch_norm:
                h = self.bn[f"layer_{i}"](h.to(torch.float32)).to(self.compute_dtype)
        y_d = self.mlp["out"](h)[:, 0].to(torch.float32)
        return self.fm_b[0] + y_w + y_v + y_d

    def forward(self, feat_ids: torch.Tensor, feat_vals: torch.Tensor) -> torch.Tensor:
        ids, vals = self.prepare(feat_ids, feat_vals)
        return self.head(*fused_ctr_interaction(self.fm_w, self.fm_v, ids, vals))


register_model("deepfm", DeepFM)
