"""xDeepFM: counterpart of ``init_cin``, ``apply_cin``, ``init_xdeepfm`` and
``apply_xdeepfm`` in ``deepfm_tpu/models/xdeepfm.py``.

    logits = fm_b + Σ_f w_f·x_f + y_cin(e) + MLP(flatten(e))
    e_fk   = V[id_f]_k · x_f

The CIN (Compressed Interaction Network), layer k of ``cfg.cin_layers``:

    Z^k   = outer(X^{k-1}, X^0) along fields       [B, H_{k-1}, F, K]
    X^k_o = Σ_{h,f} W^k_{h,f,o} · Z^k_{h,f}         [B, H_k, K]
    y_cin = w_out · concat_k(Σ_K X^k) + b_out

in ``compute_dtype``, float32 out, as JAX computes it: two einsums a
layer (the outer product, then its contraction against the filter,
one ``[B·K, H·F] × [H·F, H_k]`` product).

The gathers and the first-order term go through
``ops.fused_ctr.fused_ctr_interaction`` (the Hopper kernels B1 and B1′ on
the card): it computes exactly ``emb`` and ``y_w``, and the head drops its
``y_v`` (FM's second-order term, which xDeepFM replaces with the CIN), so
the backward takes a zero cotangent there, a term that adds nothing.
``emb`` is JAX's ``scaled_embedding``; ``y_w`` is its ``fm_first_order``
up to the order of a sum of F terms.

Tables: ``fm_w [feature_size]`` and ``fm_v [feature_size, K]`` without pad
rows (JAX's ``init_xdeepfm``).  Parameter names follow the JAX pytree
(``cin.filter_<k>`` ``[H_prev, F, H_out]``, ``cin.out.{kernel,bias}``, and
DeepFM's ``mlp``/``bn``), so ``convert.params_from_jax`` maps one onto the
other.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.platform import resolve_device
from ..ops.fused_ctr import fused_ctr_interaction
from ..ops.initializers import glorot_normal, glorot_uniform
from .base import register_model
from .deepfm import CTRModel, Dense, deepfm_l2_penalty


class CIN(nn.Module):
    """The CIN filter stack and its output head (``filter_<k>``
    ``[H_{k-1}, F, H_k]``, ``out``): emb [B, F, K] -> [B] float32."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        f = cfg.field_size
        sizes = [f, *cfg.cin_layers]
        self.n_layers = len(cfg.cin_layers)
        for k, (h_prev, h_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            w = glorot_uniform((h_prev * f, h_out), generator).reshape(h_prev, f, h_out)
            self.register_parameter(f"filter_{k}", nn.Parameter(w.contiguous()))
        self.out = Dense(sum(cfg.cin_layers), 1, generator)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        x0 = emb.to(self.compute_dtype)
        xk = x0
        pooled = []
        for k in range(self.n_layers):
            w = getattr(self, f"filter_{k}").to(self.compute_dtype)
            z = xk[:, :, None, :] * x0[:, None, :, :]          # [B, H, F, K]
            xk = torch.einsum("bhfk,hfo->bok", z, w)            # [B, H_out, K]
            pooled.append(xk.sum(dim=2))
        return self.out(torch.cat(pooled, dim=1))[:, 0].to(torch.float32)


class XDeepFM(CTRModel):
    """xDeepFM on ``device`` (default: the card), in eval mode.  Weights
    from ``generator`` (default: a CPU generator seeded 0): zero bias,
    glorot normal fm_w/fm_v, glorot uniform CIN filters and MLP kernels."""

    TABLES = ("fm_w", "fm_v")

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.fm_b = nn.Parameter(torch.zeros(1, device=g.device))
        self.fm_w = nn.Parameter(glorot_normal((cfg.feature_size,), g))
        self.fm_v = nn.Parameter(glorot_normal((cfg.feature_size, cfg.embedding_size), g))
        self.cin = CIN(cfg, g)
        self._init_deep(cfg, cfg.field_size * cfg.embedding_size, g)
        self._finish(device, g)

    def head(self, emb: torch.Tensor, y_w: torch.Tensor, y_v: torch.Tensor) -> torch.Tensor:
        """``fm_b + y_w + y_cin + y_deep`` from B1's outputs; ``y_v`` is not
        part of xDeepFM."""
        y_cin = self.cin(emb)
        y_d = self.deep(emb.reshape(emb.shape[0], -1))
        return self.fm_b[0] + y_w + y_cin + y_d

    def table_logits(self, tables: dict, ids: torch.Tensor, vals: torch.Tensor
                     ) -> torch.Tensor:
        return self.head(*fused_ctr_interaction(tables["fm_w"], tables["fm_v"], ids, vals))


register_model("xdeepfm", XDeepFM, deepfm_l2_penalty)
