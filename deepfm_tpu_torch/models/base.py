"""Model registry: counterpart of ``deepfm_tpu/models/base.py``.

A family registers a constructor ``build(cfg, *, device, generator) ->
nn.Module`` whose module maps ``(feat_ids [B, F], feat_vals [B, F])`` to
``[B]`` float32 logits.  Only ``deepfm`` is ported so far.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from ..core.config import ModelConfig


class ModelDef(NamedTuple):
    name: str
    build: Callable


_REGISTRY: dict[str, ModelDef] = {}


def register_model(name: str, build: Callable) -> ModelDef:
    md = ModelDef(name, build)
    _REGISTRY[name] = md
    return md


def get_model(name_or_cfg: str | ModelConfig) -> ModelDef:
    name = name_or_cfg if isinstance(name_or_cfg, str) else name_or_cfg.model_name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None

