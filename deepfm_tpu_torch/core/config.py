"""Configuration for the port: the sections of ``deepfm_tpu``'s ``Config``
that training (on one card or data parallel) and serving read, with their
validation.

* ``ModelConfig`` - the DeepFM hyperparameters, train-time fields included
  (dropout keep probabilities, batch-norm decay, table L2), and the
  two-tower fields (vocabularies, field counts, tower widths);
* ``OptimizerConfig`` - every field of the JAX section but ``zero_sharding``
  (ZeRO waits for sharded tables, ROADMAP A9), lazy Adam included;
* ``DataConfig`` - what file mode reads, on one process or on each rank of
  a data-parallel run;
* ``MeshConfig`` - the JAX mesh section, as far as data parallelism over
  ``torch.distributed`` honours it;
* ``RunConfig`` - task type, paths, logging cadence and seed;
* ``Config`` - the five sections, read from and written to the JAX
  ``config.json`` schema (one dict per section).

Reading a JAX config (``Config.from_dict``, ``ModelConfig.from_dict`` and
so ``load_config``) goes field by field.  A field this copy carries loads.
A JAX field it does not carry is looked up in ``JAX_ONLY_FIELDS``, the
port's literal copy of those fields' JAX defaults (the port cannot import
the JAX dataclasses; a tier-1 test holds the copy against them):

* at its JAX default it loads (and is dropped);
* at another value it raises, naming the field and the ROADMAP item that
  ports it, where that value would change what a one-card or
  data-parallel job computes (``permute_ids``, ``stream_mode``,
  ``tiered_embeddings``, ...);
* it loads at any value where it cannot change the result (serving,
  fleet, checkpoint cadence, ZeRO at one model shard, ...).

A field neither side knows is dropped with a warning, as the JAX reader
does, so configs and servables written by either package load here.
``load_config`` returns the ``model`` section only, which is all a
servable needs.  ``--set`` overrides go through ``with_overrides``, which
rejects any field this copy does not carry.
"""

from __future__ import annotations

import dataclasses
import json
import logging
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


def _tuples(v: Any) -> Any:
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


# Why a JAX field that changes a job's result raises, by ROADMAP item
_A6 = "not ported yet (ROADMAP A6, the input pipeline's other modes)"
_A7 = ("the launcher's LOCAL_WORLD_SIZE gives the workers a host "
       "(ROADMAP A7, python -m torch.distributed.run)")
_A9 = "not ported yet (ROADMAP A9, sharded tables)"

# Every field of the JAX schema that this copy does not carry, with its JAX
# default (deepfm_tpu/core/config.py) and, where a value other than the
# default changes what a one-card or data-parallel job computes, the ROADMAP
# item that ports it; None marks a field that cannot change the result.
JAX_ONLY_FIELDS: dict[str, dict[str, tuple[Any, str | None]]] = {
    "model": {
        # read by xdeepfm/dcnv2 only (not ported: get_model raises)
        "cin_layers": ((128, 128), None),
        "cross_layers": (3, None),
        # the table gradient's form and the sharded exchange: same sums
        "table_grad": ("scatter", None),
        "shard_exchange": ("auto", None),
        "shard_exchange_capacity": (0.0, None),
        "tiered_embeddings": (False, "not ported yet (ROADMAP A11, tiered store)"),
        # read only with tiered_embeddings on
        "tiered_hot_slots": (0, None),
        "tiered_stage_rows": (0, None),
        "tiered_host_rows": (0, None),
        "tiered_page_rows": (1024, None),
        "tiered_cold_url": ("", None),
    },
    "optimizer": {
        # bit-identical to the replicated update at one model shard
        "zero_sharding": ("auto", None),
    },
    "data": {
        "test_data_dir": ("", _A6),
        "shuffle_buffer": (0, _A6),
        "stream_mode": (False, _A6),
        "multi_path": (False, _A6),
        # stream-mode channels; file mode reads the directories
        "training_channel_name": ("training", None),
        "evaluation_channel_name": ("evaluation", None),
        "eval_max_batches": (0, _A6),
        # the native reader's threads: same batches in the same order
        "parallel_readers": (4, None),
        "permute_ids": (False, _A6),
    },
    "run": {
        "clear_existing_model": (False, None),
        "hosts": (("localhost",), None),
        "current_host": ("localhost", None),
        # the JAX process's shard count per host; here LOCAL_WORLD_SIZE
        "workers_per_host": (1, _A7),
        "steps_per_loop": (1, None),
        "eval_start_delay_secs": (0, None),
        "eval_throttle_secs": (0, None),
        # the port does not checkpoint yet (ROADMAP A6)
        "checkpoint_every_steps": (1000, None),
        "keep_checkpoints": (3, None),
        "profile_dir": ("", None),
        "serve_port": (8501, None),
        "serve_host": ("127.0.0.1", None),
        "serve_item_corpus": ("", None),
        "serve_workers": (1, None),
        "serve_buckets": ("8,32,128,512", None),
        "serve_max_wait_ms": (2.0, None),
        "serve_reload_url": ("", None),
        "serve_reload_interval_secs": (2.0, None),
        "serve_groups": (0, None),
        "serve_group_data_parallel": (1, None),
        "serve_group_model_parallel": (0, None),
        "serve_router_port": (8500, None),
        "serve_retry_limit": (2, None),
        "serve_health_interval_secs": (1.0, None),
        "serve_eject_after": (2, None),
        "funnel_top_k": (0, None),
        "funnel_return_n": (0, None),
        "funnel_retrieval": ("exact", None),
        "funnel_oversample": (4, None),
        "funnel_min_recall": (0.95, None),
        "funnel_pallas": ("auto", None),
        # the online tasks raise (ROADMAP A10)
        "online_publish_every_steps": (100, None),
        "online_max_batches": (0, None),
        "online_idle_timeout_secs": (0.0, None),
        "max_restarts": (0, None),
        "restart_backoff_secs": (5.0, None),
    },
    "elastic": {
        "enabled": (False, "not ported yet (ROADMAP A15, elastic training)"),
        # read only with elastic training on
        "prefer_model_parallel": (0, None),
        "min_devices": (1, None),
        "poll_interval_secs": (0.25, None),
        "wait_for_capacity_secs": (0.0, None),
        "drain_commit": (True, None),
        "coordinator_url": ("", None),
        "lease_ttl_secs": (10.0, None),
        "heartbeat_interval_secs": (1.0, None),
        "registry_debounce_polls": (2, None),
        "publisher_split": (False, None),
        "publish_poll_secs": (0.5, None),
    },
    # serving fleets, SLOs, the feedback flywheel and regions: none of them
    # changes what training computes
    "fleet": {
        "tenants": ((), None),
        "shadow_sample_percent": (100.0, None),
        "shadow_queue_depth": (128, None),
    },
    "slo": {
        "deadline_ms": (0.0, None),
        "hedge_after_pct": (95.0, None),
        "hedge_budget_pct": (5.0, None),
        "retry_budget_pct": (10.0, None),
        "shed_shadow_util": (0.6, None),
        "degrade_util": (0.75, None),
        "shed_predict_util": (0.9, None),
        "degrade_floor_pct": (50.0, None),
        "min_groups": (1, None),
        "max_groups": (4, None),
        "scale_up_util": (0.75, None),
        "scale_down_util": (0.25, None),
        "scale_up_window_secs": (5.0, None),
        "scale_down_window_secs": (30.0, None),
        "cooldown_secs": (10.0, None),
    },
    "flywheel": {
        "enabled": (False, None),
        "impression_log_url": ("", None),
        "click_log_url": ("", None),
        "join_output_url": ("", None),
        "sample_rate": (1.0, None),
        "attribution_window_secs": (1800.0, None),
        "segment_roll_bytes": (1048576, None),
        "segment_roll_age_secs": (10.0, None),
        "join_checkpoint_every_segments": (8, None),
        "queue_depth": (1024, None),
    },
    "regions": {
        "enabled": (False, None),
        "regions": ((), None),
        "home_root": ("", None),
        "front_host": ("127.0.0.1", None),
        "front_port": (8400, None),
        "replication_poll_secs": (1.0, None),
        "probe_interval_secs": (1.0, None),
        "eject_after": (2, None),
        "max_version_skew": (2, None),
        "readmit_version_skew": (0, None),
        "failover_budget_pct": (10.0, None),
        "publish_keep_window": (0, None),
    },
}


def _known_fields(cls, d: dict, section: str) -> dict:
    """The entries of ``d`` that name a field of ``cls``, lists as tuples.
    Every other entry is checked against ``JAX_ONLY_FIELDS[section]``: a
    value that would change the result raises, the rest are dropped."""
    names = {f.name for f in dataclasses.fields(cls)} if cls else set()
    jax_only = JAX_ONLY_FIELDS.get(section, {})
    out = {}
    for k, v in d.items():
        if k in names:
            out[k] = tuple(v) if isinstance(v, list) else v
        elif k in jax_only:
            default, item = jax_only[k]
            if item is not None and _tuples(v) != default:
                raise ValueError(
                    f"{section}.{k}={v!r}: {item}; the port runs only "
                    f"{section}.{k}={default!r}"
                )
        else:
            logging.getLogger(__name__).warning(
                "config: ignoring unknown field %s.%s", section, k)
    return out


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
    model_name: str = "deepfm"        # deepfm | two_tower
    # two-tower retrieval (model_name="two_tower"; ignored by DeepFM):
    # separate user/item vocabularies and field counts, tower MLP widths,
    # output dim, and softmax temperature for in-batch negatives
    user_vocab_size: int = 0          # 0 -> feature_size
    item_vocab_size: int = 0          # 0 -> feature_size
    user_field_size: int = 1
    item_field_size: int = 1
    tower_layers: tuple[int, ...] = (64, 32)
    tower_dim: int = 16
    temperature: float = 0.05
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
        object.__setattr__(self, "tower_layers", _parse_int_list(self.tower_layers))
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
        for name in ("feature_size", "field_size", "embedding_size",
                     "user_field_size", "item_field_size", "tower_dim"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        """Build from a ``model`` section, dropping fields this copy does
        not carry (the JAX schema has many more)."""
        return cls(**_known_fields(cls, d, "model"))

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
    # touched-rows-only Adam for fm_w/fm_v (train/lazy.py); Adam only, one
    # process only (the lazy data-parallel step is ROADMAP A9)
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


@dataclass(frozen=True)
class DataConfig:
    """File-mode input (data/pipeline.py).  ``batch_size`` is per process,
    as in the JAX package (one process a host) and in Horovod (one process
    a GPU): a data-parallel run of N ranks takes N x ``batch_size`` records
    a step.  Each rank reads the records that ``data/sharding.py
    shard_plan`` gives it, round-robin (record i to shard i % n); with
    ``s3_shard`` the files are taken as already split per host."""

    training_data_dir: str = ""
    val_data_dir: str = ""
    batch_size: int = 1024
    num_epochs: int = 10
    shuffle_files: bool = True        # shuffle the file list, seeded by run.seed
    drop_remainder: bool = True       # training batches; eval keeps the tail
    # host batches decoded ahead of the train loop by a reader thread
    prefetch_batches: int = 2
    file_patterns: tuple[str, ...] = ("tr", "train")
    s3_shard: bool = False            # the files are pre-sharded per host

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")


@dataclass(frozen=True)
class MeshConfig:
    """The JAX mesh section, as data-parallel training over
    ``torch.distributed`` honours it (parallel/mesh.py).  The launcher's
    environment (``python -m torch.distributed.run``: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) gives the
    topology, so ``data_parallel`` is -1 or 0 (every rank) or the world
    size, checked when the process group starts, and the ``jax.distributed``
    wiring must stay at its defaults.  Row-sharded tables
    (``model_parallel > 1``) are ROADMAP A9."""

    data_parallel: int = -1
    model_parallel: int = 1
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0

    def __post_init__(self):
        if self.model_parallel > 1:
            raise ValueError(
                f"mesh.model_parallel={self.model_parallel}: {_A9}; the port "
                f"replicates the tables on every rank"
            )
        for name, default in (("coordinator_address", ""), ("num_processes", 1),
                              ("process_id", 0)):
            if getattr(self, name) != default:
                raise ValueError(
                    f"mesh.{name}={getattr(self, name)!r}: the port takes "
                    f"the topology from the launcher's environment "
                    f"(python -m torch.distributed.run), not from "
                    f"jax.distributed's wiring"
                )


@dataclass(frozen=True)
class RunConfig:
    """Task dispatch, paths, logging cadence and seed.  The port does not
    checkpoint yet (ROADMAP A6), so the JAX section's checkpoint cadence,
    retention and ``clear_existing_model`` load and are not read; so do
    ``steps_per_loop``, ``hosts``, ``current_host``, ``profile_dir`` and the
    serving fields (``JAX_ONLY_FIELDS``)."""

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
    mesh: MeshConfig = field(default_factory=MeshConfig)
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
        """Build from the ``config.json`` schema.  A JAX field this copy
        does not carry raises where its value would change the result, and
        is dropped otherwise (``JAX_ONLY_FIELDS``)."""
        sections = {f.name: f.default_factory for f in dataclasses.fields(cls)}
        for name in d.keys() - sections.keys():
            if name in JAX_ONLY_FIELDS:
                _known_fields(None, d[name], name)
            else:
                logging.getLogger(__name__).warning(
                    "config: ignoring unknown section %s", name)
        return cls(**{name: make(**_known_fields(make, d.get(name, {}), name))
                      for name, make in sections.items()})

    @classmethod
    def from_json(cls, path: str | os.PathLike) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def load_config(directory: str | os.PathLike) -> ModelConfig:
    """The ``model`` section of ``<directory>/config.json``."""
    with open(os.path.join(directory, "config.json")) as f:
        return ModelConfig.from_dict(json.load(f).get("model", {}))
