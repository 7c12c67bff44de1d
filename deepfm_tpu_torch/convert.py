"""JAX parameter pytree -> the port's ``state_dict``.

The JAX PRNG cannot be reproduced in torch, so parity starts from
parameters copied out of a JAX init or checkpoint.  ``params_from_jax``
takes the pytree as numpy arrays (any array type numpy can read):

    params      = {"fm_b", "fm_w", "fm_v" (padded or not),
                   "mlp": {"layer_<i>": {"kernel", "bias"}, "out": {...}},
                   "bn": {"layer_<i>": BNParams(scale, bias)}}      # batch_norm
    model_state = {"bn": {"layer_<i>": BNState(moving_mean, moving_var)}}

The batch-norm leaves are NamedTuples in JAX and may come back from a
checkpoint as dicts or plain sequences; all three are accepted.  Every
tensor is checked against the shape the config implies.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.config import ModelConfig
from .models.deepfm import fm_v_rows


def _field(obj, name: str, index: int):
    if isinstance(obj, Mapping):
        return obj[name]
    if hasattr(obj, name):
        return getattr(obj, name)
    return obj[index]


def expected_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """``state_dict`` key -> shape for a DeepFM of this config."""
    k = cfg.embedding_size
    shapes = {
        "fm_b": (1,),
        "fm_w": (cfg.feature_size,),
        "fm_v": (fm_v_rows(cfg), k),
    }
    dims = [cfg.field_size * k, *cfg.deep_layers]
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"mlp.layer_{i}.kernel"] = (d_in, d_out)
        shapes[f"mlp.layer_{i}.bias"] = (d_out,)
    shapes["mlp.out.kernel"] = (dims[-1], 1)
    shapes["mlp.out.bias"] = (1,)
    if cfg.batch_norm:
        for i, w in enumerate(cfg.deep_layers):
            for leaf in ("scale", "bias", "moving_mean", "moving_var"):
                shapes[f"bn.layer_{i}.{leaf}"] = (w,)
    return shapes


def params_from_jax(params: Mapping, model_state: Mapping,
                    cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The port's float32 CPU ``state_dict`` for ``DeepFM(cfg)``; raises
    ``ValueError`` on any shape that does not match ``cfg``."""
    flat = {"fm_b": params["fm_b"], "fm_w": params["fm_w"],
            "fm_v": params["fm_v"]}
    mlp = params["mlp"]
    for i in range(len(cfg.deep_layers)):
        for leaf in ("kernel", "bias"):
            flat[f"mlp.layer_{i}.{leaf}"] = mlp[f"layer_{i}"][leaf]
    for leaf in ("kernel", "bias"):
        flat[f"mlp.out.{leaf}"] = mlp["out"][leaf]
    if cfg.batch_norm:
        for i in range(len(cfg.deep_layers)):
            p = params["bn"][f"layer_{i}"]
            s = model_state["bn"][f"layer_{i}"]
            flat[f"bn.layer_{i}.scale"] = _field(p, "scale", 0)
            flat[f"bn.layer_{i}.bias"] = _field(p, "bias", 1)
            flat[f"bn.layer_{i}.moving_mean"] = _field(s, "moving_mean", 0)
            flat[f"bn.layer_{i}.moving_var"] = _field(s, "moving_var", 1)
    out = {}
    for key, want in expected_shapes(cfg).items():
        arr = np.asarray(flat[key], dtype=np.float32)
        if arr.shape != want:
            raise ValueError(
                f"{key}: shape {arr.shape} does not match the config's {want}"
            )
        out[key] = torch.from_numpy(arr.copy())
    return out
