"""Configuration for the port: the sections of ``deepfm_tpu``'s ``Config``
that single-card training and serving read, with their validation.

* ``ModelConfig`` - the DeepFM hyperparameters, train-time fields included
  (dropout keep probabilities, batch-norm decay, table L2);
* ``OptimizerConfig`` - every field of the JAX section but ``zero_sharding``
  (ZeRO waits for data-parallel training, ROADMAP A9);
* ``DataConfig`` - what file mode on one worker reads;
* ``RunConfig`` - task type, paths, logging cadence and seed;
* ``Config`` - the four sections, read from and written to the JAX
  ``config.json`` schema (one dict per section).

``Config.from_dict`` and ``load_config`` drop every section and field this
copy does not carry, so configs and servables written by either package
load here.  ``load_config`` returns the ``model`` section only, which is
all a servable needs.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Sequence

COMPUTE_DTYPES = ("float32", "bfloat16")
OPTIMIZERS = ("adam", "adagrad", "momentum", "ftrl")
LR_SCHEDULES = ("constant", "cosine", "linear")


def _strip_list_wrappers(s: str) -> str:
    return s.strip().removeprefix("(").removeprefix("[") \
            .removesuffix(")").removesuffix("]")


def _parse_int_list(s: str | Sequence[int]) -> tuple[int, ...]:
    if isinstance(s, str):
        return tuple(
            int(x) for x in _strip_list_wrappers(s).split(",") if x.strip()
        )
    return tuple(int(x) for x in s)


def _parse_float_list(s: str | float | Sequence[float]) -> tuple[float, ...]:
    if isinstance(s, str):
        return tuple(
            float(x) for x in _strip_list_wrappers(s).split(",") if x.strip()
        )
    if isinstance(s, (int, float)):
        return (float(s),)
    return tuple(float(x) for x in s)


def _known_fields(cls, d: dict) -> dict:
    """The entries of ``d`` that name a field of ``cls``, lists as tuples."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in d.items() if k in names}


@dataclass(frozen=True)
class ModelConfig:
    """DeepFM hyperparameters.  Defaults are the JAX package's: the flagship
    Criteo width."""

    feature_size: int = 117_581       # vocabulary size
    field_size: int = 39              # 13 numeric + 26 categorical fields
    embedding_size: int = 32          # K
    deep_layers: tuple[int, ...] = (256, 128, 64)
    # TF1 keep probabilities, one per deep layer (0.5 keeps half the units)
    dropout_keep: tuple[float, ...] = (0.5, 0.5, 0.5)
    batch_norm: bool = False
    batch_norm_decay: float = 0.9
    # L2 on fm_w and fm_v only: l2_reg * (½Σfm_w² + ½Σfm_v²)
    l2_reg: float = 0.0001
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
        object.__setattr__(self, "dropout_keep", _parse_float_list(self.dropout_keep))
        if len(self.dropout_keep) < len(self.deep_layers):
            raise ValueError(
                f"dropout_keep has {len(self.dropout_keep)} entries for "
                f"{len(self.deep_layers)} deep layers"
            )
        if not all(0.0 < k <= 1.0 for k in self.dropout_keep):
            raise ValueError(
                f"dropout_keep entries are keep probabilities in (0, 1], "
                f"got {self.dropout_keep}"
            )
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
        return cls(**_known_fields(cls, d))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer selection and hyperparameters, in optax's semantics
    (train/optimizer.py)."""

    name: str = "Adam"                # Adam | Adagrad | Momentum | Ftrl
    learning_rate: float = 0.0005
    # multiply the peak lr by the data-parallel world size (1 on one card)
    scale_lr_by_data_parallel: bool = False
    # constant | cosine | linear, over optimizer steps; cosine and linear
    # need decay_steps (the whole horizon, warmup included) and end at
    # learning_rate * lr_end_fraction
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 0
    lr_end_fraction: float = 0.0
    # fm_w/fm_v updates are scaled by this (an exact lr split for Adam,
    # Adagrad and Momentum; Ftrl rejects it)
    embedding_lr_multiplier: float = 1.0
    # touched-rows-only Adam for the tables: not ported yet (ROADMAP A5)
    lazy_embedding_updates: bool = False
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    adagrad_init_accum: float = 1e-8
    momentum: float = 0.95

    def __post_init__(self):
        if self.name.lower() not in OPTIMIZERS:
            raise ValueError(
                f"unknown optimizer {self.name!r} (Adam|Adagrad|Momentum|Ftrl)"
            )
        if self.lr_schedule.lower() not in LR_SCHEDULES:
            raise ValueError(
                f"unknown lr_schedule {self.lr_schedule!r} (constant|cosine|linear)"
            )
        if self.lazy_embedding_updates:
            raise ValueError(
                "optimizer.lazy_embedding_updates is not ported yet "
                "(ROADMAP A5); the port trains with dense updates"
            )


@dataclass(frozen=True)
class DataConfig:
    """File-mode input on one worker (data/pipeline.py)."""

    training_data_dir: str = ""
    val_data_dir: str = ""
    batch_size: int = 1024
    num_epochs: int = 10
    shuffle_files: bool = True        # shuffle the file list, seeded by run.seed
    drop_remainder: bool = True       # training batches; eval keeps the tail
    # host batches decoded ahead of the train loop by a reader thread
    prefetch_batches: int = 2
    file_patterns: tuple[str, ...] = ("tr", "train")

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")


@dataclass(frozen=True)
class RunConfig:
    """Task dispatch, paths, logging cadence and seed."""

    task_type: str = "train"
    model_dir: str = "./model_dir"
    servable_model_dir: str = "./servable"
    log_steps: int = 100
    seed: int = 0


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def with_overrides(self, **sections: dict[str, Any]) -> "Config":
        """A new Config with per-section field overrides, e.g.
        ``cfg.with_overrides(model={"embedding_size": 64})``.  An unknown
        section or field raises."""
        updates = {}
        for section, fields in sections.items():
            if section not in {f.name for f in dataclasses.fields(self)}:
                raise ValueError(
                    f"unknown config section {section!r}; the port carries "
                    f"{[f.name for f in dataclasses.fields(self)]}"
                )
            updates[section] = dataclasses.replace(getattr(self, section), **fields)
        return dataclasses.replace(self, **updates)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """Build from the ``config.json`` schema, dropping sections and
        fields this copy does not carry."""
        return cls(**{
            f.name: f.default_factory(**_known_fields(f.default_factory,
                                                      d.get(f.name, {})))
            for f in dataclasses.fields(cls)
        })

    @classmethod
    def from_json(cls, path: str | os.PathLike) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def load_config(directory: str | os.PathLike) -> ModelConfig:
    """The ``model`` section of ``<directory>/config.json``."""
    with open(os.path.join(directory, "config.json")) as f:
        return ModelConfig.from_dict(json.load(f).get("model", {}))
