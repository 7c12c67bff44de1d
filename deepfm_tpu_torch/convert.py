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

and for the other CTR families xDeepFM's ``"cin": {"filter_<k>" [H_prev,
F, H_out], "out": {"kernel", "bias"}}`` beside unpadded tables, or
DCN-v2's ``"cross": {"layer_<l>": {"kernel", "bias"}, "out": {...}}``
beside an unpadded fm_v and no fm_w.

The batch-norm leaves are NamedTuples in JAX and may come back from a
checkpoint as dicts or plain sequences; all three are accepted.  Every
tensor is checked against the shape the config implies.

``train_state_from_jax`` also carries the step and the optimizer's state,
found inside the optax chain's tuples: Adam's ``ScaleByAdamState``
count/mu/nu, Adagrad's ``ScaleByRssState``, Momentum's ``TraceState`` or
the JAX package's ``FtrlState``, or, with lazy embedding updates, the
``(rest_opt, LazyAdamState)`` pair: the Adam state of the non-table
parameters and the tables' m and v.  A state of a ``[dp, mp]`` mesh (its
padded tables, and ZeRO's ``ZeroDpState`` with flattened moments) goes
onto the port's grid with ``ctx``.  The dropout PRNG key does not carry:
the port draws from its own ``torch.Generator``.

``params_to_jax`` is the inverse of ``params_from_jax``: the JAX-layout
numpy ``(params, model_state)`` tree of a CTR family's ``state_dict``, which the
publisher hashes (online/publisher.py ``param_tree_hash``).

``online_payload_from_jax`` takes a JAX online commit
(``deepfm_tpu/online/trainer.py OnlinePayload``: step, train, the cursor's
padded segment bytes, length and record, fence_token) with its leaves as
numpy and returns the port's ``OnlinePayload`` with the same cursor and
fencing token; written with ``online/trainer.py commit_payload``, the
online trainer resumes it at the same cursor.

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
from .models.base import CTR_FAMILIES
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
    """``state_dict`` key -> shape for a model of this config (DeepFM,
    xDeepFM, DCN-v2 or two-tower, by ``cfg.model_name``)."""
    if cfg.model_name == "two_tower":
        return _two_tower_shapes(cfg)
    if cfg.model_name not in CTR_FAMILIES:
        raise ValueError(f"no state_dict layout for model {cfg.model_name!r}")
    k = cfg.embedding_size
    dim = cfg.field_size * k
    shapes = {"fm_b": (1,)}
    if cfg.model_name != "dcnv2":
        shapes["fm_w"] = (cfg.feature_size,)
    shapes["fm_v"] = (fm_v_rows(cfg), k)
    if cfg.model_name == "xdeepfm":
        sizes = [cfg.field_size, *cfg.cin_layers]
        for i, (h_prev, h_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            shapes[f"cin.filter_{i}"] = (h_prev, cfg.field_size, h_out)
        shapes["cin.out.kernel"] = (sum(cfg.cin_layers), 1)
        shapes["cin.out.bias"] = (1,)
    if cfg.model_name == "dcnv2":
        for i in range(cfg.cross_layers):
            shapes[f"cross.layer_{i}.kernel"] = (dim, dim)
            shapes[f"cross.layer_{i}.bias"] = (dim,)
        shapes["cross.out.kernel"] = (dim, 1)
        shapes["cross.out.bias"] = (1,)
    dims = [dim, *cfg.deep_layers]
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


def _dense_leaves(tree: Mapping, prefix: str, names) -> dict:
    """``{prefix.name.kernel/bias: leaf}`` of a ``{name: {"kernel", "bias"}}``
    pytree."""
    return {f"{prefix}.{n}.{leaf}": tree[n][leaf] for n in names
            for leaf in ("kernel", "bias")}


def _flat_params(params: Mapping, cfg: ModelConfig) -> dict:
    """The trainable leaves of a params-shaped pytree (parameters, or an
    optimizer moment of them, whose tree may hold the tables alone or lack
    them: the lazy path's two states) by ``state_dict`` key."""
    flat = {k: params[k] for k in ("fm_b", "fm_w", "fm_v") if k in params}
    if "cin" in params:
        cin = params["cin"]
        flat.update({f"cin.filter_{i}": cin[f"filter_{i}"]
                     for i in range(len(cfg.cin_layers))})
        flat.update(_dense_leaves(cin, "cin", ["out"]))
    if "cross" in params:
        flat.update(_dense_leaves(params["cross"], "cross",
                                  [*(f"layer_{i}" for i in range(cfg.cross_layers)), "out"]))
    if "mlp" in params:
        flat.update(_dense_leaves(params["mlp"], "mlp",
                                  [*(f"layer_{i}" for i in range(len(cfg.deep_layers))),
                                   "out"]))
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
    """The port's float32 CPU ``state_dict`` for the config's CTR family
    (``DeepFM``, ``XDeepFM`` or ``DCNv2``); raises ``ValueError`` on any
    shape that does not match ``cfg``."""
    flat = _flat_params(params, cfg)
    if cfg.batch_norm:
        for i in range(len(cfg.deep_layers)):
            s = model_state["bn"][f"layer_{i}"]
            flat[f"bn.layer_{i}.moving_mean"] = _field(s, "moving_mean", 0)
            flat[f"bn.layer_{i}.moving_var"] = _field(s, "moving_var", 1)
    return _checked({k: flat[k] for k in expected_shapes(cfg)}, cfg, "")


def _dense_tree(flat: dict, prefix: str, names) -> dict:
    return {n: {leaf: flat[f"{prefix}.{n}.{leaf}"] for leaf in ("kernel", "bias")}
            for n in names}


def params_to_jax(state_dict: Mapping, cfg: ModelConfig) -> tuple[dict, dict]:
    """The JAX-layout ``(params, model_state)`` of a CTR family's
    ``state_dict`` (tensors or arrays), as float32 numpy: the tree the JAX
    init builds (``init_deepfm``, ``init_xdeepfm`` or ``init_dcnv2``), fm_v
    with its pad rows as the config gives them, Linear kernels ``[in,
    out]`` (the port keeps JAX's layout, so nothing transposes), the
    batch-norm leaves as ``BNParams``/``BNState`` NamedTuples, and
    ``model_state`` ``{}`` without batch norm.  Shapes are checked against
    ``cfg``."""
    from .ops.batch_norm import BNParams, BNState

    if cfg.model_name not in CTR_FAMILIES:
        raise ValueError(f"params_to_jax takes a CTR family's state_dict "
                         f"({'|'.join(CTR_FAMILIES)}), got model {cfg.model_name!r}")
    want = expected_shapes(cfg)
    if set(state_dict) != set(want):
        raise ValueError(
            f"state_dict keys differ from the config's: missing "
            f"{sorted(set(want) - set(state_dict))}, unexpected "
            f"{sorted(set(state_dict) - set(want))}")
    flat = {k: _checked({k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                         else v}, cfg, "")[k].numpy() for k, v in state_dict.items()}
    n = len(cfg.deep_layers)
    params = {k: flat[k] for k in ("fm_b", "fm_w", "fm_v") if k in flat}
    if cfg.model_name == "xdeepfm":
        cin = {f"filter_{i}": flat[f"cin.filter_{i}"] for i in range(len(cfg.cin_layers))}
        params["cin"] = {**cin, **_dense_tree(flat, "cin", ["out"])}
    if cfg.model_name == "dcnv2":
        params["cross"] = _dense_tree(
            flat, "cross", [*(f"layer_{i}" for i in range(cfg.cross_layers)), "out"])
    params["mlp"] = _dense_tree(flat, "mlp", [*(f"layer_{i}" for i in range(n)), "out"])
    model_state: dict = {}
    if cfg.batch_norm:
        params["bn"] = {f"layer_{i}": BNParams(flat[f"bn.layer_{i}.scale"],
                                               flat[f"bn.layer_{i}.bias"]) for i in range(n)}
        model_state["bn"] = {f"layer_{i}": BNState(flat[f"bn.layer_{i}.moving_mean"],
                                                   flat[f"bn.layer_{i}.moving_var"])
                             for i in range(n)}
    return params, model_state


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


def two_tower_params_to_jax(state_dict: Mapping, cfg: ModelConfig) -> dict:
    """The JAX-layout two-tower params of a ``TwoTower`` ``state_dict``
    (tensors or arrays), as float32 numpy: the tree ``init_two_tower``
    builds (``{side}_embedding``, ``{side}_tower.layer_i``/``proj`` with
    ``kernel`` and ``bias``).  Shapes are checked against ``cfg``."""
    want = _two_tower_shapes(cfg)
    if set(state_dict) != set(want):
        raise ValueError(
            f"state_dict keys differ from the config's: missing "
            f"{sorted(set(want) - set(state_dict))}, unexpected "
            f"{sorted(set(state_dict) - set(want))}")
    flat = {k: _checked({k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                         else v}, cfg, "")[k].numpy() for k, v in state_dict.items()}
    params: dict = {f"{side}_embedding": flat[f"{side}_embedding"]
                    for side in ("user", "item")}
    for side in ("user", "item"):
        tower = {f"layer_{i}": {leaf: flat[f"{side}_tower.layer_{i}.{leaf}"]
                                for leaf in ("kernel", "bias")}
                 for i in range(len(cfg.tower_layers))}
        tower["proj"] = {leaf: flat[f"{side}_tower.proj.{leaf}"] for leaf in ("kernel", "bias")}
        params[f"{side}_tower"] = tower
    return params


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


# the optax node holding each optimizer's slots, by its fields (the
# port's slot names are the same): ScaleByAdamState, ScaleByRssState,
# TraceState and the JAX package's FtrlState
OPT_STATE_FIELDS = {"adam": ("mu", "nu"), "adagrad": ("sum_of_squares",),
                    "momentum": ("trace",), "ftrl": ("z", "n")}


def _has_fields(node, fields) -> bool:
    if isinstance(node, Mapping):
        return set(fields) <= set(node)
    if hasattr(node, "_fields"):  # a NamedTuple
        return set(fields) <= set(node._fields)
    if isinstance(node, (tuple, list)):
        return False
    return all(hasattr(node, f) for f in fields)


def _find_state(tree, fields):
    """The first node of an optax state, depth first, that has all of
    ``fields``, or None."""
    if _has_fields(tree, fields):
        return tree
    if isinstance(tree, Mapping):
        children = list(tree.values())
    elif isinstance(tree, (tuple, list)):
        children = list(tree)
    else:
        return None
    for child in children:
        found = _find_state(child, fields)
        if found is not None:
            return found
    return None


def _find_adam_state(tree):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax state."""
    return _find_state(tree, ("count", "mu", "nu"))


def train_state_from_jax(state, cfg: Config, device=None, *, ctx=None):
    """The port's ``TrainState`` (train/step.py) on ``device`` (default:
    the card) from a JAX ``TrainState`` as numpy (a NamedTuple or a dict of
    step, params, model_state, opt_state): weights, BN statistics, step,
    the optimizer's slots (Adam's mu and nu, Adagrad's sum_of_squares,
    Momentum's trace, FTRL's z and n) and count, and with lazy embedding
    updates the ``(rest_opt, LazyAdamState)`` pair's.  The count is
    Adam's own, else the lr schedule's (``ScaleByScheduleState``), else the
    step: without lazy updates every optimizer step is a train step.  Every
    tensor is shape-checked as in :func:`params_from_jax`.

    ``ctx`` (parallel/mesh.py) places the state on this rank of a
    ``[data x model]`` grid (``parallel/spmd.py create_dp_train_state``):
    the JAX state of a ``[dp, mp]`` mesh as ``jax.device_get`` gives it,
    with its padded tables, lazy moments, and the ``ZeroDpState``'s
    flattened moments (cut to their parameters' shapes); each rank keeps
    its rows and windows."""
    from .parallel import spmd

    name = cfg.optimizer.name.lower()
    fields = OPT_STATE_FIELDS[name]
    opt_state = _field(state, "opt_state", 3)
    if cfg.optimizer.lazy_embedding_updates:
        opt_state, lazy = opt_state
    node = _find_state(opt_state, (*fields, "count") if name == "adam" else fields)
    if node is None:
        raise ValueError(f"no {cfg.optimizer.name} state ({', '.join(fields)}) in "
                         f"the opt_state")
    out = (create_train_state(cfg, device) if ctx is None
           else spmd.create_dp_train_state(cfg, ctx))
    mcfg = (cfg if out.sharding is None
            else spmd.sharded_model_config(cfg, out.sharding.mp)).model
    step = int(np.asarray(_field(state, "step", 0)))
    counter = node if name == "adam" else _find_state(opt_state, ("count",))
    count = step if counter is None else int(np.asarray(_field(counter, "count", 0)))
    slots = {n: {} for n in out.optimizer.slots}
    for index, slot in enumerate(fields):
        got = _moments(_field(node, slot, index + (name == "adam")), mcfg,
                       f"opt_state {slot} ", slots.keys())
        for n, t in got.items():
            slots[n][slot] = t
    full = {"model": params_from_jax(_field(state, "params", 1),
                                     _field(state, "model_state", 2), mcfg),
            "optimizer": {"count": count, "slots": slots}, "lazy": None}
    if out.lazy is not None:
        full["lazy"] = {slot: _moments(_field(lazy, slot, index), mcfg,
                                       f"lazy opt_state {slot} ", out.lazy.m.keys())
                        for slot, index in (("m", 0), ("v", 1))}
    spmd.load_full_state(out, full)
    out.step = step
    return out


def _moments(tree: Mapping, cfg: ModelConfig, what: str, names) -> dict:
    """A params-shaped pytree of moments as float32 tensors by
    ``state_dict`` key, which must be exactly ``names``; a ZeRO layout's
    flattened leaf (``ZeroDpState``: the row-major flatten, padded at its
    tail) is cut to its parameter's shape first."""
    shapes = expected_shapes(cfg)
    flat = {}
    for key, arr in _flat_params(tree, cfg).items():
        arr = np.asarray(arr)
        n = int(np.prod(shapes[key]))
        if arr.shape != shapes[key] and arr.ndim == 1 and arr.size >= n:
            arr = arr[:n].reshape(shapes[key])
        flat[key] = arr
    moments = _checked(flat, cfg, what)
    if moments.keys() != set(names):
        raise ValueError(f"{what}holds {sorted(moments)}, the port's state "
                         f"{sorted(names)}")
    return moments


def online_payload_from_jax(payload, cfg: Config, device=None):
    """The port's ``online/trainer.py OnlinePayload`` on ``device``
    (default: the card) from a JAX ``OnlinePayload`` as numpy (a
    NamedTuple or a dict of its fields): the train state through
    :func:`train_state_from_jax`, the cursor's fixed-width arrays and the
    writer's fencing token as they are (``.cursor()`` decodes the cursor)."""
    from .online.trainer import OnlinePayload, cursor_from_arrays

    state = train_state_from_jax(_field(payload, "train", 1), cfg, device)
    cursor = cursor_from_arrays(*(_field(payload, name, i) for i, name in enumerate(
        ("cursor_segment", "cursor_len", "cursor_record"), start=2)))
    return OnlinePayload.wrap(state, cursor,
                              fence_token=int(_field(payload, "fence_token", 5)))
