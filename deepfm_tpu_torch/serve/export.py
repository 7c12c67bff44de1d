"""The port's servable: counterpart of ``deepfm_tpu/serve/export.py``.

    servable/
      config.json   — the JAX schema (``{"model": {...}}``; other sections
                      written by the JAX package are ignored on load)
      params.npz    — float32 arrays keyed by ``state_dict`` name

A DeepFM or a two-tower servable (``model_name`` picks the family); a
recommendation funnel is a tree of two such servables plus its index
(funnel/publish.py).

JAX's Orbax checkpoint is not read here (the card's machine has neither
JAX nor Orbax): convert one with ``convert.params_from_jax`` and write it
with :func:`export_servable`.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from ..convert import expected_shapes
from ..core.config import ModelConfig, load_config
from ..core.platform import resolve_device
from ..models.base import get_model

PARAMS_FILE = "params.npz"


def export_servable(cfg: ModelConfig, state_dict: dict,
                    directory: str | os.PathLike) -> str:
    """Write ``config.json`` and ``params.npz``; returns the directory."""
    directory = os.path.abspath(directory)
    want = expected_shapes(cfg)
    if set(state_dict) != set(want):
        raise ValueError(
            f"state_dict keys differ from the config's: missing "
            f"{sorted(set(want) - set(state_dict))}, unexpected "
            f"{sorted(set(state_dict) - set(want))}"
        )
    arrays = {k: v.detach().to("cpu", torch.float32).numpy()
              if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)
              for k, v in state_dict.items()}
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"model": cfg.to_dict()}, f, indent=2)
    np.savez(os.path.join(directory, PARAMS_FILE), **arrays)
    return directory


def read_params(directory: str | os.PathLike) -> dict[str, np.ndarray]:
    """The servable's ``params.npz`` as float32 arrays by ``state_dict``
    name."""
    path = os.path.join(os.path.abspath(directory), PARAMS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: a JAX servable (Orbax params/) must be "
            f"converted with deepfm_tpu_torch.convert.params_from_jax and "
            f"written with export_servable first"
        )
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def model_from_state(cfg: ModelConfig, state_dict: dict, device=None) -> torch.nn.Module:
    """The config's model (any registered family) on ``device`` (default:
    the card), in eval mode, with ``state_dict``'s weights."""
    model = get_model(cfg).build(cfg, device=resolve_device(device))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    return model


def load_model(directory: str | os.PathLike, device=None) -> torch.nn.Module:
    """The servable's model on ``device`` (default: the card), infer mode."""
    return model_from_state(load_config(directory), read_params(directory), device)


def load_servable(directory: str | os.PathLike,
                  device=None) -> tuple[Callable, ModelConfig]:
    """Load a CTR servable: (predict, config).

    ``predict(feat_ids [B, F] int64 ndarray, feat_vals [B, F] f32 ndarray)
    -> probs [B] f32 ndarray`` runs on ``device`` (default: the card) and
    waits for the result.  It uses CUDA on whichever thread calls it."""
    model = load_model(directory, device)
    if model.cfg.model_name == "two_tower":
        raise ValueError(
            f"{directory} is a two-tower servable: it serves as the query "
            f"encoder of a recommendation funnel (funnel/serve.py), not "
            f"behind :predict"
        )
    dev = model.fm_v.device

    def predict(feat_ids, feat_vals) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(feat_ids, np.int64)).to(dev)
        vals = torch.as_tensor(np.asarray(feat_vals, np.float32)).to(dev)
        with torch.inference_mode():
            probs = torch.sigmoid(model(ids, vals))
        return probs.cpu().numpy()

    return predict, model.cfg
