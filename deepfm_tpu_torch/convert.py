"""JAX parameter pytree -> the port's ``state_dict``, a JAX ``TrainState``
-> the port's train state, and a JAX funnel artifact -> the port's funnel
tree.

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
tuples), or, with lazy embedding updates, the ``(rest_opt,
LazyAdamState)`` pair: the Adam state of the non-table parameters and the
tables' m and v.  The dropout PRNG key does not carry: the port draws from
its own ``torch.Generator``.

``two_tower_params_from_jax`` takes the two-tower pytree
(``{"user_embedding", "item_embedding", "{user,item}_tower": {"layer_<i>":
{"kernel", "bias"}, "proj": {...}}}``), and ``funnel_from_jax`` a JAX
``FunnelArtifact`` (``deepfm_tpu/funnel/publish.py``) with its leaves as
numpy, which it writes as the port's funnel tree.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .core.config import Config, ModelConfig
from .models.deepfm import fm_v_rows
from .models.two_tower import item_vocab, user_vocab
from .train.step import create_train_state


def _field(obj, name: str, index: int):
    if isinstance(obj, Mapping):
        return obj[name]
    if hasattr(obj, name):
        return getattr(obj, name)
    return obj[index]


def expected_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """``state_dict`` key -> shape for a model of this config (DeepFM or
    two-tower, by ``cfg.model_name``)."""
    if cfg.model_name == "two_tower":
        return _two_tower_shapes(cfg)
    if cfg.model_name != "deepfm":
        raise ValueError(f"no state_dict layout for model {cfg.model_name!r}")
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


def _two_tower_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    k = cfg.embedding_size
    shapes = {"user_embedding": (user_vocab(cfg), k),
              "item_embedding": (item_vocab(cfg), k)}
    for side, fields in (("user", cfg.user_field_size), ("item", cfg.item_field_size)):
        dims = [fields * k, *cfg.tower_layers]
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            shapes[f"{side}_tower.layer_{i}.kernel"] = (d_in, d_out)
            shapes[f"{side}_tower.layer_{i}.bias"] = (d_out,)
        shapes[f"{side}_tower.proj.kernel"] = (dims[-1], cfg.tower_dim)
        shapes[f"{side}_tower.proj.bias"] = (cfg.tower_dim,)
    return shapes


def _flat_params(params: Mapping, cfg: ModelConfig) -> dict:
    """The trainable leaves of a params-shaped pytree (parameters, or an
    optimizer moment of them, whose tree may hold the tables alone or lack
    them: the lazy path's two states) by ``state_dict`` key."""
    flat = {k: params[k] for k in ("fm_b", "fm_w", "fm_v") if k in params}
    if "mlp" in params:
        mlp = params["mlp"]
        for i in range(len(cfg.deep_layers)):
            for leaf in ("kernel", "bias"):
                flat[f"mlp.layer_{i}.{leaf}"] = mlp[f"layer_{i}"][leaf]
        for leaf in ("kernel", "bias"):
            flat[f"mlp.out.{leaf}"] = mlp["out"][leaf]
    if cfg.batch_norm and "bn" in params:
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


def two_tower_params_from_jax(params: Mapping, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The port's float32 CPU ``state_dict`` for ``TwoTower(cfg)`` from the
    JAX two-tower pytree; raises ``ValueError`` on any shape that does not
    match ``cfg``."""
    flat = {"user_embedding": params["user_embedding"],
            "item_embedding": params["item_embedding"]}
    for side in ("user", "item"):
        tower = params[f"{side}_tower"]
        for i in range(len(cfg.tower_layers)):
            for leaf in ("kernel", "bias"):
                flat[f"{side}_tower.layer_{i}.{leaf}"] = tower[f"layer_{i}"][leaf]
        for leaf in ("kernel", "bias"):
            flat[f"{side}_tower.proj.{leaf}"] = tower["proj"][leaf]
    return _checked(flat, cfg, "")


def _model_config(cfg) -> ModelConfig:
    """The port's ModelConfig from a JAX ``Config`` (or its ``model``
    section), read field by field: the JAX dataclass is never imported."""
    model = getattr(cfg, "model", cfg)
    if not isinstance(model, Mapping):
        model = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}
    return ModelConfig.from_dict(dict(model))


def funnel_from_jax(artifact, directory) -> str:
    """Write a JAX ``FunnelArtifact`` (``rank_cfg``, ``rank_params``,
    ``rank_state``, ``query_cfg``, ``query_params``, ``index``, ``meta``;
    leaves as numpy) as the port's funnel tree under ``directory``:
    ``rank/`` and ``query/`` in the port's servable format, ``index.npz``
    and ``funnel.json`` as they were.  Returns the directory."""
    from .funnel.index import FunnelIndex
    from .funnel.publish import write_funnel_tree

    rank_cfg = _model_config(artifact.rank_cfg)
    query_cfg = _model_config(artifact.query_cfg)
    if query_cfg.model_name != "two_tower":
        raise ValueError(f"the funnel's query model must be two_tower, "
                         f"got {query_cfg.model_name!r}")
    rank = params_from_jax(artifact.rank_params, artifact.rank_state, rank_cfg)
    query = two_tower_params_from_jax(artifact.query_params, query_cfg)
    index = FunnelIndex(item_ids=np.asarray(artifact.index.item_ids, np.int32),
                        item_emb=np.asarray(artifact.index.item_emb, np.float32))
    return write_funnel_tree(directory, rank_cfg, rank, query_cfg, query, index,
                             dict(artifact.meta))


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
    step, params, model_state, opt_state): weights, BN statistics, step,
    the Adam moments and count, and with lazy embedding updates the
    ``(rest_opt, LazyAdamState)`` pair's.  Every tensor is shape-checked as
    in :func:`params_from_jax`.  Only Adam state converts so far."""
    if cfg.optimizer.name.lower() != "adam":
        raise ValueError(
            f"train_state_from_jax converts Adam state only, not "
            f"{cfg.optimizer.name!r}"
        )
    opt_state = _field(state, "opt_state", 3)
    if cfg.optimizer.lazy_embedding_updates:
        opt_state, lazy = opt_state
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the opt_state")
    out = create_train_state(cfg, device)
    out.model.load_state_dict(params_from_jax(
        _field(state, "params", 1), _field(state, "model_state", 2), cfg.model))
    out.step = int(np.asarray(_field(state, "step", 0)))
    out.optimizer.count = int(np.asarray(_field(adam, "count", 0)))
    for slot, index in (("mu", 1), ("nu", 2)):
        _copy_into({n: s[slot] for n, s in out.optimizer.slots.items()},
                   _field(adam, slot, index), cfg.model, f"opt_state {slot} ")
    if out.lazy is not None:
        for slot, index in (("m", 0), ("v", 1)):
            _copy_into(getattr(out.lazy, slot), _field(lazy, slot, index), cfg.model,
                       f"lazy opt_state {slot} ")
    return out


def _copy_into(dst: dict, tree: Mapping, cfg: ModelConfig, what: str) -> None:
    """Copy a params-shaped pytree into the tensors ``dst`` (by
    ``state_dict`` key), which must name exactly the tree's leaves."""
    moments = _checked(_flat_params(tree, cfg), cfg, what)
    if moments.keys() != dst.keys():
        raise ValueError(f"{what}holds {sorted(moments)}, the port's state "
                         f"{sorted(dst)}")
    for name, t in moments.items():
        dst[name].copy_(t)
