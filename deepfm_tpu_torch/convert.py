"""JAX parameter pytree -> the port's ``state_dict``, and a JAX
``TrainState`` -> the port's train state.

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

``train_state_from_jax`` also carries the step and the optax Adam state
(``ScaleByAdamState`` count/mu/nu, found inside the optimizer's chain
tuples).  The dropout PRNG key does not carry: the port draws from its own
``torch.Generator``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .core.config import Config, ModelConfig
from .models.deepfm import fm_v_rows
from .train.step import create_train_state


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


def _flat_params(params: Mapping, cfg: ModelConfig) -> dict:
    """The trainable leaves of a params-shaped pytree (parameters, or an
    optimizer moment of them) by ``state_dict`` key."""
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
            flat[f"bn.layer_{i}.scale"] = _field(p, "scale", 0)
            flat[f"bn.layer_{i}.bias"] = _field(p, "bias", 1)
    return flat


def _checked(flat: dict, cfg: ModelConfig, what: str) -> dict[str, torch.Tensor]:
    """float32 CPU tensors, each checked against the config's shape."""
    want = expected_shapes(cfg)
    out = {}
    for key, arr in flat.items():
        arr = np.asarray(arr, dtype=np.float32)
        if arr.shape != want[key]:
            raise ValueError(
                f"{what}{key}: shape {arr.shape} does not match the config's "
                f"{want[key]}"
            )
        out[key] = torch.from_numpy(arr.copy())
    return out


def params_from_jax(params: Mapping, model_state: Mapping,
                    cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The port's float32 CPU ``state_dict`` for ``DeepFM(cfg)``; raises
    ``ValueError`` on any shape that does not match ``cfg``."""
    flat = _flat_params(params, cfg)
    if cfg.batch_norm:
        for i in range(len(cfg.deep_layers)):
            s = model_state["bn"][f"layer_{i}"]
            flat[f"bn.layer_{i}.moving_mean"] = _field(s, "moving_mean", 0)
            flat[f"bn.layer_{i}.moving_var"] = _field(s, "moving_var", 1)
    return _checked({k: flat[k] for k in expected_shapes(cfg)}, cfg, "")


def _find_adam_state(tree):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax state: the
    first node, depth first, that has all three fields."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        children = list(tree.values())
    elif all(hasattr(tree, f) for f in ("count", "mu", "nu")):
        return tree
    elif isinstance(tree, (tuple, list)):
        children = list(tree)
    else:
        return None
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def train_state_from_jax(state, cfg: Config, device=None):
    """The port's ``TrainState`` (train/step.py) on ``device`` (default:
    the card) from a JAX ``TrainState`` as numpy (a NamedTuple or a dict of
    step, params, model_state, opt_state): weights, BN statistics, step and
    the Adam moments and count.  Every tensor is shape-checked as in
    :func:`params_from_jax`.  Only Adam state converts so far."""
    if cfg.optimizer.name.lower() != "adam":
        raise ValueError(
            f"train_state_from_jax converts Adam state only, not "
            f"{cfg.optimizer.name!r}"
        )
    adam = _find_adam_state(_field(state, "opt_state", 3))
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the opt_state")
    out = create_train_state(cfg, device)
    out.model.load_state_dict(params_from_jax(
        _field(state, "params", 1), _field(state, "model_state", 2), cfg.model))
    out.step = int(np.asarray(_field(state, "step", 0)))
    out.optimizer.count = int(np.asarray(_field(adam, "count", 0)))
    for slot, index in (("mu", 1), ("nu", 2)):
        moments = _checked(_flat_params(_field(adam, slot, index), cfg.model),
                           cfg.model, f"opt_state {slot} ")
        for name, t in moments.items():
            out.optimizer.slots[name][slot].copy_(t)
    return out
