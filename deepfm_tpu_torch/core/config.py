"""Model configuration for the port: the fields of ``deepfm_tpu``'s
``ModelConfig`` that the DeepFM infer-mode forward reads, with their
validation, and a reader for a servable's ``config.json``.  Training-time
fields (dropout, batch-norm decay, optimizer sections) come with the
training slice.

``config.json`` is written by the JAX package's ``Config.to_dict`` (one
section per config block).  ``load_config`` reads the ``model`` section and
ignores every other section and every model field this copy does not carry,
so servables written by either package load here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Sequence

COMPUTE_DTYPES = ("float32", "bfloat16")


def _strip_list_wrappers(s: str) -> str:
    return s.strip().removeprefix("(").removeprefix("[") \
            .removesuffix(")").removesuffix("]")


def _parse_int_list(s: str | Sequence[int]) -> tuple[int, ...]:
    if isinstance(s, str):
        return tuple(
            int(x) for x in _strip_list_wrappers(s).split(",") if x.strip()
        )
    return tuple(int(x) for x in s)


@dataclass(frozen=True)
class ModelConfig:
    """DeepFM hyperparameters read by the forward pass.  Defaults are the
    JAX package's: the flagship Criteo width."""

    feature_size: int = 117_581       # vocabulary size
    field_size: int = 39              # 13 numeric + 26 categorical fields
    embedding_size: int = 32          # K
    deep_layers: tuple[int, ...] = (256, 128, 64)
    batch_norm: bool = False
    model_name: str = "deepfm"
    # MLP dtype; the gathers and FM sums stay float32
    compute_dtype: str = "bfloat16"
    # clip int64 ids to [0, feature_size-1] and narrow them to int32
    narrow_ids: bool = True
    # "off" | "auto" | "on".  The port always runs its fused kernel; this
    # field is read only for the fm_v table shape: anything but "off" means
    # fm_v carries zero pad rows up to a multiple of 128/K
    # (models/deepfm.py fm_v_rows)
    fused_kernel: str = "off"

    def __post_init__(self):
        object.__setattr__(self, "deep_layers", _parse_int_list(self.deep_layers))
        if self.fused_kernel not in ("off", "auto", "on"):
            raise ValueError(
                f"fused_kernel must be 'off', 'auto' or 'on', "
                f"got {self.fused_kernel!r}"
            )
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                f"got {self.compute_dtype!r}"
            )
        for name in ("feature_size", "field_size", "embedding_size"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        """Build from a ``model`` section, dropping fields this copy does
        not carry (the JAX schema has many more)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in d.items() if k in names
        })

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_config(directory: str | os.PathLike) -> ModelConfig:
    """The ``model`` section of ``<directory>/config.json``."""
    with open(os.path.join(directory, "config.json")) as f:
        return ModelConfig.from_dict(json.load(f).get("model", {}))
