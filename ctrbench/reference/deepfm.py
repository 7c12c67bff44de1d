"""DeepFM (Guo et al., IJCAI 2017) as the reference Criteo job writes it,
in plain float32 PyTorch:

    e_fk   = V[id_f]_k · x_f
    logits = b + Σ_f w[id_f]·x_f + ½Σ_k((Σ_f e_fk)² − Σ_f e_fk²) + MLP(flatten(e))

The MLP: ReLU layers with TF1 dropout, one output unit.  The L2 term
covers the two tables (the reference never added its MLP's L2 to the
loss)."""

from __future__ import annotations

import torch

from .common import mlp, mlp_leaves

TABLES = ("fm_w", "fm_v")


def leaves(m: dict) -> list[tuple]:
    """``(name, shape, init, fan_in, fan_out)`` of every parameter."""
    v, f, k = m["feature_size"], m["field_size"], m["embedding_size"]
    return [("fm_b", (1,), "zeros", 0, 0),
            ("fm_w", (v,), "normal", v, 1),
            ("fm_v", (v, k), "normal", v, k),
            *mlp_leaves(f * k, m["deep_layers"])]


def logits(p: dict, ids: torch.Tensor, vals: torch.Tensor, m: dict, masks, prec
           ) -> torch.Tensor:
    """``[B]`` logits of ``ids``/``vals`` ``[B, F]``."""
    e = prec.table(p["fm_v"][ids]) * vals[..., None]                 # [B, F, K]
    y_w = (prec.table(p["fm_w"][ids]) * vals).sum(1)
    s = e.sum(1)
    y_v = 0.5 * (s * s - (e * e).sum(1)).sum(1)
    y_d = mlp(e.reshape(e.shape[0], -1), p, m["deep_layers"], m["dropout_keep"], masks, prec)
    return p["fm_b"][0] + y_w + y_v + y_d
