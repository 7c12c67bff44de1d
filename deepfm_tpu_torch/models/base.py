"""Model registry: counterpart of ``deepfm_tpu/models/base.py``.

A family registers a constructor ``build(cfg, *, device, generator) ->
nn.Module`` and its regularization penalty ``l2_penalty(module, l2_reg)
-> scalar tensor``, which the training loss adds to its data loss.  A CTR
family's module maps ``(feat_ids [B, F], feat_vals [B, F])`` to ``[B]``
float32 logits (train or eval mode by ``module.train()`` /
``module.eval()``).  Ported so far: ``deepfm`` and the serving half of
``two_tower`` (its encoders, models/two_tower.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from ..core.config import ModelConfig


class ModelDef(NamedTuple):
    name: str
    build: Callable
    # (module, l2_reg) -> scalar penalty; each family declares which of its
    # tables the reference-style L2 applies to
    l2_penalty: Callable


_REGISTRY: dict[str, ModelDef] = {}


def register_model(name: str, build: Callable, l2_penalty: Callable) -> ModelDef:
    md = ModelDef(name, build, l2_penalty)
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
