"""xDeepFM (Lian et al., KDD 2018, arXiv:1803.05170) in plain float32
PyTorch:

    logits = b + Σ_f w[id_f]·x_f + y_cin(e) + MLP(flatten(e))

The CIN, layer k of ``cin_layers``: ``Z = X^{k-1} ⊗ X^0`` along fields
``[B, H_{k-1}, F, K]``, ``X^k_o = Σ_{h,f} W^k_{h,f,o} Z_{h,f}`` ``[B,
H_k, K]``, each layer's ``Σ_K X^k`` concatenated into one output unit
(the paper's §2.3 without its direct-connect split: every layer's
feature maps go both to the output and to the next layer).  No FM
second-order term.  The L2 term covers the two tables."""

from __future__ import annotations

import torch

from .common import dense, mlp, mlp_leaves

TABLES = ("fm_w", "fm_v")


def leaves(m: dict) -> list[tuple]:
    """``(name, shape, init, fan_in, fan_out)`` of every parameter."""
    v, f, k = m["feature_size"], m["field_size"], m["embedding_size"]
    cin = m["cin_layers"]
    out = [("fm_b", (1,), "zeros", 0, 0),
           ("fm_w", (v,), "normal", v, 1),
           ("fm_v", (v, k), "normal", v, k)]
    for i, (h_prev, h_out) in enumerate(zip([f, *cin[:-1]], cin)):
        out.append((f"cin.filter_{i}", (h_prev, f, h_out), "uniform", h_prev * f, h_out))
    out += [("cin.out.kernel", (sum(cin), 1), "uniform", sum(cin), 1),
            ("cin.out.bias", (1,), "zeros", 0, 0),
            *mlp_leaves(f * k, m["deep_layers"])]
    return out


def cin(p: dict, e: torch.Tensor, m: dict, prec) -> torch.Tensor:
    """The CIN on ``e`` ``[B, F, K]`` -> ``[B]``."""
    x0 = prec.mm(e)
    xk = x0
    pooled = []
    for i in range(len(m["cin_layers"])):
        z = prec.mm(xk[:, :, None, :] * x0[:, None, :, :])            # [B, H, F, K]
        xk = prec.mm(torch.einsum("bhfk,hfo->bok", z, prec.mm(p[f"cin.filter_{i}"])))
        pooled.append(xk.sum(2))
    return dense(torch.cat(pooled, 1), p["cin.out.kernel"], p["cin.out.bias"], prec)[:, 0]


def logits(p: dict, ids: torch.Tensor, vals: torch.Tensor, m: dict, masks, prec
           ) -> torch.Tensor:
    """``[B]`` logits of ``ids``/``vals`` ``[B, F]``."""
    e = prec.table(p["fm_v"][ids]) * vals[..., None]                 # [B, F, K]
    y_w = (prec.table(p["fm_w"][ids]) * vals).sum(1)
    y_d = mlp(e.reshape(e.shape[0], -1), p, m["deep_layers"], m["dropout_keep"], masks, prec)
    return p["fm_b"][0] + y_w + cin(p, e, m, prec) + y_d
