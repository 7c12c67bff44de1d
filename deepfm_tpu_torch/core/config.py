"""Configuration for the port: the sections of ``deepfm_tpu``'s ``Config``
that training (on one card or data parallel) and serving read, with their
validation.

* ``ModelConfig`` - the DeepFM hyperparameters, train-time fields included
  (dropout keep probabilities, batch-norm decay, table L2), and the
  two-tower fields (vocabularies, field counts, tower widths);
* ``OptimizerConfig`` - every field of the JAX section, lazy Adam and the
  ZeRO weight update (``zero_sharding``) included;
* ``DataConfig`` - what file mode and stream (Pipe) mode read, on one
  process or on each rank of a ``[data x model]`` grid, the record
  shuffle and ``permute_ids`` included;
* ``MeshConfig`` - the JAX mesh section: the ``[data_parallel x
  model_parallel]`` grid of ``torch.distributed`` ranks;
* ``RunConfig`` - task type, paths, logging cadence, seed, the train
  task's lifecycle, the serve task's single-process fields and the
  online tasks' cadence;
* ``FlywheelConfig`` - the delayed-label join and ``feedback-train``;
* ``FleetConfig`` - the multi-tenant fleet: tenant bindings, the shadow
  sample and queue (``fleet/``, ``serve/pool/``), with
  ``EXECUTABLE_SPEC_FIELDS``, ``tenant_spec_divergence`` and
  ``validate_tenant_entries``;
* ``RegionsConfig`` - the cross-region front and replicator (``region/``)
  and the publish root's ``publish_keep_window``;
* ``Config`` - the sections, read from and written to the JAX
  ``config.json`` schema (one dict per section), with JAX's cross-section
  checks: ``feedback-train`` names the join's output, the exchange
  capacity fits a record's ids, ``zero_sharding='on'`` at one data shard
  warns, the funnel's top-k fits an index shard and a serve bucket, a
  fleet tenant shares the pool's executable spec, a shadow's sample and
  the flywheel's differ (a warning), the home retention covers the
  staleness SLO (a warning); and
  the port's own: ``fused_kernel='on'`` with row-sharded
  tables raises, as JAX's forward does.

Reading a JAX config (``Config.from_dict``, ``ModelConfig.from_dict`` and
so ``load_config``) goes field by field.  A field this copy carries loads.
A JAX field it does not carry is looked up in ``JAX_ONLY_FIELDS``, the
port's literal copy of those fields' JAX defaults (the port cannot import
the JAX dataclasses; a tier-1 test holds the copy against them):

* at its JAX default it loads (and is dropped);
* at another value it raises, naming the field and the ROADMAP item that
  ports it, where that value would change what a one-card or
  data-parallel job computes (``run.workers_per_host``, ...);
* it loads at any value where it cannot change the result.

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
import math
import os
import warnings
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
_A7 = ("the launcher's LOCAL_WORLD_SIZE gives the workers a host "
       "(ROADMAP A7, python -m torch.distributed.run)")

# Every field of the JAX schema that this copy does not carry, with its JAX
# default (deepfm_tpu/core/config.py) and, where a value other than the
# default changes what a one-card or data-parallel job computes, the ROADMAP
# item that ports it; None marks a field that cannot change the result.
JAX_ONLY_FIELDS: dict[str, dict[str, tuple[Any, str | None]]] = {
    "run": {
        "hosts": (("localhost",), None),
        "current_host": ("localhost", None),
        # the JAX process's shard count per host; here LOCAL_WORLD_SIZE
        "workers_per_host": (1, _A7),
        "steps_per_loop": (1, None),
    },
}


# ---- multi-tenant fleet (fleet/, serve/pool/) -----------------------------

# ModelConfig fields that determine the serving graphs: the slot tree's
# shapes and the captured bucket bodies.  Two tenants share one member's
# graph set iff they agree on all of these (the audit_multitenant contract
# holds it); everything else (learning rate, l2, dropout: training-time
# knobs) is tenant-local and free to differ.  JAX's list, unchanged.
EXECUTABLE_SPEC_FIELDS = (
    "model_name", "feature_size", "field_size", "embedding_size",
    "deep_layers", "cin_layers", "cross_layers", "batch_norm",
    "tower_layers", "tower_dim", "user_vocab_size", "item_vocab_size",
    "user_field_size", "item_field_size", "compute_dtype", "narrow_ids",
    "table_grad", "fused_kernel", "shard_exchange",
    "shard_exchange_capacity", "tiered_embeddings",
)

# keys a fleet tenant entry may carry (one schema for the config and
# fleet/registry.py; a typo'd key raises instead of doing nothing)
TENANT_ENTRY_KEYS = ("name", "source", "split_percent", "shadow_of", "model")


def _spec_norm(v: Any) -> Any:
    return tuple(v) if isinstance(v, list) else v


def tenant_spec_divergence(base_model: dict, overrides: dict) -> list[str]:
    """Executable-spec fields where a tenant's ``model`` overrides diverge
    from the pool's base model section.  Non-empty means the tenant cannot
    share the member's captured graphs (its slot tree or bodies would
    differ): the fleet refuses it at load instead of capturing again
    mid-traffic."""
    return sorted(
        k for k in overrides
        if k in EXECUTABLE_SPEC_FIELDS
        and _spec_norm(overrides[k]) != _spec_norm(base_model.get(k))
    )


def validate_tenant_entries(entries) -> tuple:
    """Normalize and validate a fleet tenant list (dicts or JSON text), as
    JAX does: duplicate names raise, the serving (non-shadow) arms' split
    percentages sum to 100 when any is set, a shadow names an existing
    non-shadow incumbent and takes no split.  Returns the normalized tuple
    of entry dicts.  Spec compatibility against the base model section is
    ``Config.__post_init__``'s (and fleet/registry.py's)."""
    if isinstance(entries, str):
        entries = json.loads(entries) if entries.strip() else []
    norm = []
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise ValueError(
                f"fleet.tenants[{i}] must be an object, got {type(e).__name__}")
        unknown = sorted(set(e) - set(TENANT_ENTRY_KEYS))
        if unknown:
            raise ValueError(f"fleet.tenants[{i}] has unknown key(s) {unknown} "
                             f"(known: {list(TENANT_ENTRY_KEYS)})")
        name = str(e.get("name", "")).strip()
        if not name:
            raise ValueError(f"fleet.tenants[{i}] is missing a name")
        norm.append({
            "name": name,
            "source": str(e.get("source", "")),
            "split_percent": float(e.get("split_percent", 0.0)),
            "shadow_of": str(e.get("shadow_of", "")),
            "model": dict(e.get("model") or {}),
        })
    names = [e["name"] for e in norm]
    dups = sorted({n for n in names if names.count(n) > 1})
    if dups:
        raise ValueError(f"duplicate fleet tenant name(s): {dups}")
    by_name = {e["name"]: e for e in norm}
    serving = [e for e in norm if not e["shadow_of"]]
    for e in norm:
        if e["split_percent"] < 0:
            raise ValueError(f"tenant {e['name']!r}: split_percent must be >= 0, got "
                             f"{e['split_percent']}")
        if e["shadow_of"]:
            ref = by_name.get(e["shadow_of"])
            if ref is None or ref["shadow_of"]:
                raise ValueError(
                    f"shadow tenant {e['name']!r} references {e['shadow_of']!r}, which "
                    f"is not a serving (non-shadow) tenant")
            if e["split_percent"]:
                raise ValueError(
                    f"shadow tenant {e['name']!r} cannot take live split traffic "
                    f"(split_percent={e['split_percent']}); it scores the sampled "
                    f"stream off the response path")
    total = sum(e["split_percent"] for e in serving)
    if any(e["split_percent"] for e in serving) and abs(total - 100.0) > 1e-6:
        raise ValueError(
            f"fleet split percentages must sum to 100, got {total:g} over "
            f"{[e['name'] for e in serving]} — every key must land on exactly one arm")
    return tuple(norm)


def _check_tiered_fields(m) -> None:
    """JAX's checks of the tiered fields on their own."""
    if m.tiered_page_rows < 1:
        raise ValueError(f"tiered_page_rows must be >= 1, got {m.tiered_page_rows}")
    for name in ("tiered_hot_slots", "tiered_stage_rows", "tiered_host_rows"):
        if getattr(m, name) < 0:
            raise ValueError(f"{name} must be >= 0 (0 = auto), got {getattr(m, name)}")
    # the port's paged step runs its hand-written kernels on the cache's
    # compact rows whatever fused_kernel says: the field is kept for JAX
    # compatibility, and a config JAX refuses is refused here too
    if m.tiered_embeddings and m.fused_kernel != "off":
        raise ValueError(
            f"tiered_embeddings with fused_kernel={m.fused_kernel!r}: the JAX "
            f"package refuses this pair, so the port does too (its paged step "
            f"runs the fused CUDA kernels on the hot cache either way); use "
            f"fused_kernel='off'")


def _check_tiered_geometry(m, batch_size: int) -> None:
    """JAX's checks of the tiered cache against one batch's B·F ids."""
    if not m.tiered_embeddings:
        return
    bf = batch_size * m.field_size
    if 0 < m.tiered_hot_slots < bf:
        raise ValueError(f"tiered_hot_slots={m.tiered_hot_slots} cannot hold one "
                         f"batch's id stream (batch_size*field_size={bf})")
    if 0 < m.tiered_stage_rows < bf:
        warnings.warn(
            f"tiered_stage_rows={m.tiered_stage_rows} < batch_size*field_size={bf}: "
            f"a cache-cold batch can miss on every id and overflow the staging "
            f"pack (the pager raises at run time)", stacklevel=3)
    h = m.tiered_host_rows
    if h and h - max(1, h // 16) < bf:
        raise ValueError(f"tiered_host_rows={h} cannot service one batch's miss "
                         f"fetch (window {h - max(1, h // 16)} < "
                         f"batch_size*field_size={bf})")


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
    model_name: str = "deepfm"        # deepfm | xdeepfm | dcnv2 | two_tower
    # xDeepFM's CIN layer sizes and DCN-v2's cross depth (ignored by the
    # other families)
    cin_layers: tuple[int, ...] = (128, 128)
    cross_layers: int = 3
    # two-tower retrieval (model_name="two_tower"; ignored by CTR families):
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
    # field is read for the fm_v table shape (anything but "off" means fm_v
    # carries zero pad rows up to a multiple of 128/K, models/deepfm.py
    # fm_v_rows; row-sharded tables pad both tables to lcm(model_parallel,
    # 128/K), parallel/spmd.py padded_vocab), and "on" is refused where the
    # lookup is the lazy step's or the sharded exchange's, as in JAX
    fused_kernel: str = "off"
    # the owner's gradient scatter of a row-sharded table: "scatter" (one
    # index_add_ per lookup) | "segsum" (sorted into segments first, one
    # add per distinct row); the same sums
    table_grad: str = "scatter"
    # how a row-sharded lookup assembles its rows (parallel/embedding.py):
    # "psum" (owned rows, zeros elsewhere, one all_reduce over the model
    # group) | "alltoall" (deduplicated requests to the owners and their
    # rows back, all_to_all_single; psum when a batch overflows the
    # capacity) | "auto" (alltoall on cards where rows are exchanged, psum
    # on the CPU)
    shard_exchange: str = "auto"
    # alltoall request slots per owner as a fraction of the rank's B·F ids
    # (0 = auto: ceil(N/M)); the lazy step's unique pack takes it too (0 =
    # auto: N/2)
    shard_exchange_capacity: float = 0.0
    # the tiered store (tiered/): fm_w, fm_v and their lazy-Adam moments
    # page through a hot cache on the card, a host tier and a cold tier
    # of row pages instead of living on the card whole
    tiered_embeddings: bool = False
    # hot-cache slots (0 = auto: the next power of two >= 2·B·F); at least
    # one batch's B·F ids
    tiered_hot_slots: int = 0
    # rows of the step's staged miss pack, its fixed shape (0 = auto: B·F)
    tiered_stage_rows: int = 0
    # host-tier rows (0 = auto: 8 x the hot slots)
    tiered_host_rows: int = 0
    # rows a cold-tier page (one read, one overlay write)
    tiered_page_rows: int = 1024
    # the cold tier's root: a local directory or an object-store prefix
    # (http://host:port/bucket/prefix); "" = <model_dir>/cold
    tiered_cold_url: str = ""

    def __post_init__(self):
        object.__setattr__(self, "deep_layers", _parse_int_list(self.deep_layers))
        object.__setattr__(self, "dropout_keep", _parse_float_list(self.dropout_keep))
        object.__setattr__(self, "cin_layers", _parse_int_list(self.cin_layers))
        object.__setattr__(self, "tower_layers", _parse_int_list(self.tower_layers))
        _check_tiered_fields(self)
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
        if self.table_grad not in ("scatter", "segsum"):
            raise ValueError(
                f"table_grad must be 'scatter' or 'segsum', got {self.table_grad!r}"
            )
        if self.shard_exchange not in ("psum", "alltoall", "auto"):
            raise ValueError(
                f"shard_exchange must be 'psum', 'alltoall' or 'auto', "
                f"got {self.shard_exchange!r}"
            )
        if not 0.0 <= self.shard_exchange_capacity <= 1.0:
            raise ValueError(
                f"shard_exchange_capacity must be in [0, 1] (a fraction of "
                f"the local id stream), got {self.shard_exchange_capacity!r}"
            )
        if self.table_grad == "segsum" and self.fused_kernel == "on":
            raise ValueError(
                "table_grad='segsum' is refused with fused_kernel='on', as JAX "
                "refuses it (there it has no effect with fused_kernel='on': the "
                "fused kernel supplies its own backward).  Here segsum orders "
                "the owner's scatter-add of row-sharded tables "
                "(mesh.model_parallel > 1), which fused_kernel='on' refuses: "
                "use fused_kernel='auto' or 'off' with segsum"
            )
        if self.table_grad == "segsum":
            warnings.warn(
                "table_grad='segsum' is ignored whenever the tables are whole "
                "(mesh.model_parallel 1): the fused kernel's backward writes "
                "their gradient under every fused_kernel setting.  On "
                "row-sharded tables it orders the owner's scatter-add of the "
                "exchange's gradient.", stacklevel=2)
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
    # touched-rows-only Adam for fm_w/fm_v (train/lazy.py); Adam only
    lazy_embedding_updates: bool = False
    # the ZeRO weight update over the data group (train/optimizer.py
    # ZeroOptimizer): "off" | "on" | "auto"; on exactly when the grid has
    # more than one data index ("on" at data_parallel 1 warns)
    zero_sharding: str = "auto"
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
        if self.zero_sharding not in ("off", "on", "auto"):
            raise ValueError(
                f"optimizer.zero_sharding must be 'off', 'on' or 'auto', "
                f"got {self.zero_sharding!r}"
            )


@dataclass(frozen=True)
class DataConfig:
    """The input (data/pipeline.py): the training files of a local directory
    or an object-store prefix (file mode), or the Pipe-mode channels
    ``<dir>/<training_channel_name>`` and ``<dir>/<evaluation_channel_name>``
    (``stream_mode``: FIFOs, or objects streamed from a store).
    ``batch_size`` is per process, as in the JAX package (one process a
    host) and in Horovod (one process a GPU): a data-parallel run of N
    ranks takes N x ``batch_size`` records a step.  Each rank reads the
    records that ``data/sharding.py shard_plan`` gives it, round-robin
    (record i to shard i % n); with ``s3_shard`` the files are taken as
    already split per host, with ``multi_path`` each local worker streams
    its own channel (``<channel>-<k>``).  On a ``[data x model]`` grid the
    shards are the data indices: the ``model_parallel`` ranks of one data
    index read the same batches.  ``shuffle_buffer`` > 0 shuffles records
    in windows of that many (``shuffle_batches``), in both modes."""

    training_data_dir: str = ""
    val_data_dir: str = ""
    # the infer task scores te*/test* under it (val_data_dir when empty)
    test_data_dir: str = ""
    batch_size: int = 1024
    num_epochs: int = 10
    shuffle_files: bool = True        # shuffle the file list, seeded by run.seed
    shuffle_buffer: int = 0           # 0: no record shuffle (the reference has none)
    drop_remainder: bool = True       # training batches; eval keeps the tail
    stream_mode: bool = False         # Pipe mode: read the channels, not files
    s3_shard: bool = False            # the files are pre-sharded per host
    multi_path: bool = False          # one stream channel a local worker
    training_channel_name: str = "training"
    evaluation_channel_name: str = "evaluation"
    # stream-mode eval reads the evaluation channel to EOF, or this many
    # batches when > 0 (a live channel may never close)
    eval_max_batches: int = 0
    # host batches decoded ahead of the train loop by a reader thread
    prefetch_batches: int = 2
    file_patterns: tuple[str, ...] = ("tr", "train")
    # C++ readers decoding training files at once (data/parallel_ingest.py):
    # the same batches in the same order
    parallel_readers: int = 4
    # spread Zipf-hot ids over the table shards with a fixed bijective
    # permutation of [0, feature_size) on the host (parallel/embedding.py
    # permute_ids), in every task's batches
    permute_ids: bool = False

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")


@dataclass(frozen=True)
class MeshConfig:
    """The JAX mesh section as a ``[data_parallel x model_parallel]`` grid
    of ``torch.distributed`` ranks (parallel/mesh.py).  The launcher's
    environment (``python -m torch.distributed.run``: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) gives the
    world; ``model_parallel`` (the row shards of fm_w and fm_v) must
    divide it, and ``data_parallel`` is -1 or 0 (the rest) or the world
    size over ``model_parallel``, both checked when the process group
    starts.  The ``jax.distributed`` wiring must stay at its defaults."""

    data_parallel: int = -1
    model_parallel: int = 1
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0

    def __post_init__(self):
        if self.model_parallel < 1:
            raise ValueError(f"mesh.model_parallel must be >= 1, got "
                             f"{self.model_parallel}")
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
    """Task dispatch, paths, logging cadence and seed, and the train task's
    lifecycle (train/loop.py): checkpoints in ``model_dir`` every
    ``checkpoint_every_steps`` steps (0: only at the end), ``keep_checkpoints``
    of them kept, the directory wiped first with ``clear_existing_model``;
    eval during training no sooner than ``eval_start_delay_secs`` and at
    most once per ``eval_throttle_secs`` (0: at the end only); the task
    rerun after a crash up to ``max_restarts`` times, the waits starting at
    ``restart_backoff_secs``; a ``torch.profiler`` trace of the train loop
    written into ``profile_dir`` when it is set.  ``steps_per_loop``,
    ``hosts``, ``current_host`` and the pool's serving fields load and are
    not read (``JAX_ONLY_FIELDS``).  The ``serve_*`` and
    ``funnel_*`` fields here configure the serve task (train/loop.py
    ``run_serve``), validated as JAX validates them (``Config``)."""

    task_type: str = "train"
    model_dir: str = "./model_dir"
    servable_model_dir: str = "./servable"
    log_steps: int = 100
    seed: int = 0
    clear_existing_model: bool = False
    eval_start_delay_secs: int = 0
    eval_throttle_secs: int = 0
    checkpoint_every_steps: int = 1000
    keep_checkpoints: int = 3
    max_restarts: int = 0
    restart_backoff_secs: float = 5.0
    profile_dir: str = ""             # torch.profiler trace of the train loop ("" = off)
    # the serve task (serve/server.py serve_forever): bind address, buckets,
    # batching wait, a two-tower corpus and hot reload from a local publish
    # root.  serve_workers > 1 runs the process pool (serve/server.py
    # serve_pool), serve_groups > 0 the router-fronted shard-group pool
    # (python -m deepfm_tpu_torch.serve.pool) with its own fields below
    serve_port: int = 8501
    serve_host: str = "127.0.0.1"
    serve_item_corpus: str = ""
    serve_workers: int = 1
    serve_buckets: str = "8,32,128,512"
    serve_max_wait_ms: float = 2.0
    serve_reload_url: str = ""
    serve_reload_interval_secs: float = 2.0
    serve_groups: int = 0
    # the shard-group pool: each member's [dp, mp] split (mp 0: 1, all of a
    # member's shards sit on its one card), the router's port, its
    # cross-group retries, probe interval and ejection threshold
    serve_group_data_parallel: int = 1
    serve_group_model_parallel: int = 0
    serve_router_port: int = 8500
    serve_retry_limit: int = 2
    serve_health_interval_secs: float = 1.0
    serve_eject_after: int = 2
    # the serve task over a funnel servable (funnel/serve.py): candidates
    # retrieved and ranked items returned per user, the retrieval tier
    # ("exact" | "int8" | "auto") and its shortlist multiplier.  At their
    # defaults (0, 0, "exact", 4) they defer to the servable's funnel.json.
    # funnel_min_recall gates an int8 publish (funnel/publish.py);
    # funnel_pallas ("on" | "off" | "auto") picks JAX's retrieval kernel and
    # is validated only: the port always runs its own (B2 is exact)
    funnel_top_k: int = 0
    funnel_return_n: int = 0
    funnel_retrieval: str = "exact"
    funnel_oversample: int = 4
    funnel_min_recall: float = 0.95
    funnel_pallas: str = "auto"
    # the online-train and feedback-train tasks (online/trainer.py): a
    # commit and a publish every online_publish_every_steps steps (0: a
    # publish only at the end), a stop after online_max_batches batches (0:
    # none) or online_idle_timeout_secs without a new event (0: never)
    online_publish_every_steps: int = 100
    online_max_batches: int = 0
    online_idle_timeout_secs: float = 0.0


@dataclass(frozen=True)
class SloConfig:
    """The SLO control plane (``serve/control``), with JAX's validation:
    deadline-aware admission at each pool member's micro-batcher, the
    router's hedged tail requests and retry budget, and the shard-group
    autoscaler.  All of it is host policy: ``analysis/trace_audit.py
    audit_control_plane`` holds that none of it enters a graph.

    Graceful degradation is the invariant the knobs parameterize: shed
    the cheapest work first (shadow offers, then funnel width, then
    plain predicts), never fail work already admitted, always converge
    back (hysteresis on every edge)."""

    # request completion SLO in milliseconds — the default deadline for
    # requests that carry no ``X-Deadline-Ms`` header, AND the hedge
    # trigger budget (a group whose live p95 exceeds this is hedge-
    # eligible).  0 disables deadline admission and hedging.
    deadline_ms: float = 0.0
    # hedge delay as a percent of the first-choice group's live p95: the
    # hedge fires only after the primary has already outlived this share
    # of the typical tail (a p95-based adaptive delay — near-zero extra
    # load when the group is healthy)
    hedge_after_pct: float = 95.0
    # hedges may add at most this percent extra load (token bucket over
    # the recent request rate; an exhausted bucket suppresses hedging,
    # never the primary request)
    hedge_budget_pct: float = 5.0
    # cross-group retries share a token bucket accruing at this percent
    # of the recent request rate; beyond it the router fails fast with
    # 503 + Retry-After instead of amplifying a pool-wide brownout
    retry_budget_pct: float = 10.0
    # -- priority shed ladder (cheapest first; utilizations in [0,1] of
    # the admission queue bound, EWMA-smoothed so a single burst does
    # not flip levels) ------------------------------------------------
    # level 1: shed shadow-scoring offers (zero user impact)
    shed_shadow_util: float = 0.60
    # level 2: degrade recommend expand/rank width toward the floor
    degrade_util: float = 0.75
    # level 3: shed plain predicts at admission (503 + Retry-After)
    shed_predict_util: float = 0.90
    # recommend width floor under level-2 degradation, percent of the
    # requested top_k/return_n (100 = never degrade)
    degrade_floor_pct: float = 50.0
    # -- elastic shard-group autoscaling --------------------------------
    min_groups: int = 1
    max_groups: int = 4
    # scale up when utilization stays above this (or p95 stays over
    # deadline_ms) for scale_up_window_secs
    scale_up_util: float = 0.75
    # scale down when utilization stays below this for
    # scale_down_window_secs (strictly below scale_up_util: the gap is
    # the hysteresis band that prevents flapping)
    scale_down_util: float = 0.25
    scale_up_window_secs: float = 5.0
    scale_down_window_secs: float = 30.0
    # minimum seconds between autoscale actions (lets a fresh group's
    # load signal settle before the next decision)
    cooldown_secs: float = 10.0

    def __post_init__(self):
        for name in ("deadline_ms",):
            v = getattr(self, name)
            if not (v >= 0 and math.isfinite(v)):
                raise ValueError(
                    f"slo.{name} must be finite and >= 0, got {v}"
                )
        for name in ("hedge_after_pct", "hedge_budget_pct",
                     "retry_budget_pct", "degrade_floor_pct"):
            v = getattr(self, name)
            if not (0.0 <= v <= 100.0 and math.isfinite(v)):
                raise ValueError(
                    f"slo.{name} must be a percent in [0, 100], got {v}"
                )
        for name in ("shed_shadow_util", "degrade_util",
                     "shed_predict_util", "scale_up_util",
                     "scale_down_util"):
            v = getattr(self, name)
            if not (0.0 < v <= 1.0 and math.isfinite(v)):
                raise ValueError(
                    f"slo.{name} must be a utilization in (0, 1], got {v}"
                )
        if not (self.shed_shadow_util <= self.degrade_util
                <= self.shed_predict_util):
            raise ValueError(
                f"slo shed ladder must be ordered cheapest-first: "
                f"shed_shadow_util={self.shed_shadow_util} <= "
                f"degrade_util={self.degrade_util} <= "
                f"shed_predict_util={self.shed_predict_util} — shedding "
                f"plain predicts before shadow offers inverts graceful "
                f"degradation"
            )
        if self.min_groups < 1:
            raise ValueError(
                f"slo.min_groups must be >= 1, got {self.min_groups}"
            )
        if self.max_groups < self.min_groups:
            raise ValueError(
                f"slo.max_groups={self.max_groups} < min_groups="
                f"{self.min_groups}"
            )
        if self.scale_down_util >= self.scale_up_util:
            raise ValueError(
                f"slo.scale_down_util={self.scale_down_util} must stay "
                f"strictly below scale_up_util={self.scale_up_util}: the "
                f"gap is the hysteresis band — without it the autoscaler "
                f"flaps a group up and down on every load ripple"
            )
        for name in ("scale_up_window_secs", "scale_down_window_secs",
                     "cooldown_secs"):
            v = getattr(self, name)
            if not (v > 0 and math.isfinite(v)):
                raise ValueError(
                    f"slo.{name} must be finite and > 0, got {v}"
                )


@dataclass(frozen=True)
class FlywheelConfig:
    """The data flywheel (``flywheel/``), with JAX's validation: the join
    (``python -m deepfm_tpu_torch.flywheel.join``) matches the click log to
    the impression log inside an attribution window into
    ``join_output_url``, which ``task_type=feedback-train`` trains on.
    ``enabled``, ``queue_depth`` and the segment roll arm the shard-group
    pool's impression logger (flywheel/impressions.py, run by the pool's
    router); the single-process server logs no impressions, as JAX's does
    not."""

    enabled: bool = False
    impression_log_url: str = ""
    click_log_url: str = ""
    join_output_url: str = ""
    # fraction of impression ids kept, hash-stable per id
    # (flywheel/records.py impression_sampled)
    sample_rate: float = 1.0
    # how long after its segment's publish time an impression may still
    # take a click; past it the join emits a negative
    attribution_window_secs: float = 1800.0
    segment_roll_bytes: int = 1 << 20
    segment_roll_age_secs: float = 10.0
    # the join commits {cursors, pending window} after this many segments
    join_checkpoint_every_segments: int = 8
    queue_depth: int = 1024

    def __post_init__(self):
        def finite_positive(name: str, what: str = "") -> None:
            v = getattr(self, name)
            if not (v > 0 and math.isfinite(v)):
                raise ValueError(f"flywheel.{name} must be finite and > 0, got {v}{what}")

        if not (0.0 < self.sample_rate <= 1.0 and math.isfinite(self.sample_rate)):
            raise ValueError(f"flywheel.sample_rate must be in (0, 1], got {self.sample_rate}")
        finite_positive("attribution_window_secs")
        if self.segment_roll_bytes < 1:
            raise ValueError(
                f"flywheel.segment_roll_bytes must be >= 1, got {self.segment_roll_bytes}")
        finite_positive("segment_roll_age_secs", " — an age-less roll strands a trickle "
                        "of impressions in the writer buffer")
        for name in ("join_checkpoint_every_segments", "queue_depth"):
            if getattr(self, name) < 1:
                raise ValueError(f"flywheel.{name} must be >= 1, got {getattr(self, name)}")
        if self.enabled and not self.impression_log_url:
            raise ValueError("flywheel.enabled needs flywheel.impression_log_url — the "
                             "logger has nowhere to publish segments")


@dataclass(frozen=True)
class FleetConfig:
    """The multi-tenant fleet (``fleet/``, ``serve/pool/``), JAX's section
    with JAX's validation: N same-spec model variants on one shard-group
    pool.  Each member holds three weight slots a tenant, every slot's
    bucket graphs captured at boot, so a tenant costs its slots and graphs
    and a swap captures nothing.  The router splits traffic hash-stably
    over the serving tenants, shadow tenants score a sampled slice of the
    live stream off the response path, and each tenant hot-swaps
    group-atomically without touching its neighbours."""

    # tenant bindings: JSON text or a list of entry objects,
    #   [{"name": "prod", "source": "<publish root>", "split_percent": 90},
    #    {"name": "exp",  "source": "...", "split_percent": 10},
    #    {"name": "challenger", "source": "...", "shadow_of": "prod"}]
    # ``model`` may carry executable-neutral overrides; one that touches an
    # executable-spec field is refused at load (Config.__post_init__)
    tenants: tuple = ()
    # percent of the incumbent's live stream the shadow challenger scores
    # (hash-stable per key, like the split)
    shadow_sample_percent: float = 100.0
    # bounded shadow queue: offers beyond this depth are shed (counted)
    shadow_queue_depth: int = 128

    def __post_init__(self):
        object.__setattr__(self, "tenants", validate_tenant_entries(self.tenants))
        if not 0.0 <= self.shadow_sample_percent <= 100.0:
            raise ValueError(f"fleet.shadow_sample_percent must be in [0, 100], got "
                             f"{self.shadow_sample_percent}")
        if self.shadow_queue_depth < 1:
            raise ValueError(f"fleet.shadow_queue_depth must be >= 1, got "
                             f"{self.shadow_queue_depth}")


@dataclass(frozen=True)
class RegionsConfig:
    """Cross-region active-active serving (``region/``), JAX's section with
    JAX's validation: one pool and one model store a region, the manifest
    replicator keeping every region store behind but never torn, and the
    front routing each user to a hash-stable home region with
    staleness-gated failover.  Host-side control plane only
    (``audit_region_front``).  ``publish_keep_window`` also widens a
    publish root's retention (online/publisher.py)."""

    # arm the region layer (task_type=region-front)
    enabled: bool = False
    # region cells: each {"name", "router_url", "store_root"}
    regions: tuple = ()
    # the home publish root the replicator mirrors into the region stores
    home_root: str = ""
    # front bind address
    front_host: str = "127.0.0.1"
    front_port: int = 8400
    # replicator tail cadence over the home root
    replication_poll_secs: float = 1.0
    # whole-region health probe cadence, and consecutive failures (probed
    # or seen in traffic) before ejection
    probe_interval_secs: float = 1.0
    eject_after: int = 2
    # the staleness SLO, in committed versions: a region store further
    # behind the home root drains until it catches up to
    # readmit_version_skew (hysteresis)
    max_version_skew: int = 2
    readmit_version_skew: int = 0
    # cross-region failover token budget, percent of the recent request
    # rate; beyond it the front fails fast (503 + Retry-After)
    failover_budget_pct: float = 10.0
    # retention floor at a publish root: max(keep, publish_keep_window)
    # versions (0 = no widening)
    publish_keep_window: int = 0

    def __post_init__(self):
        if self.enabled:
            if not self.regions:
                raise ValueError("regions.enabled needs at least one region entry")
            if not self.home_root:
                raise ValueError("regions.enabled needs regions.home_root — the "
                                 "replicator has nothing to tail")
        names = []
        for entry in self.regions:
            if not isinstance(entry, dict) or not entry.get("name") \
                    or not entry.get("router_url"):
                raise ValueError(f"each regions.regions entry needs 'name' and "
                                 f"'router_url' (got {entry!r})")
            names.append(entry["name"])
        if len(names) != len(set(names)):
            raise ValueError(f"regions.regions names must be unique, got {names}")
        if self.max_version_skew < 0 or self.readmit_version_skew < 0:
            raise ValueError("regions version-skew bounds must be >= 0")
        if self.readmit_version_skew > self.max_version_skew:
            raise ValueError(
                f"regions.readmit_version_skew={self.readmit_version_skew} must not "
                f"exceed max_version_skew={self.max_version_skew} — the re-admit bar "
                f"cannot be laxer than the drain bar")
        if not (0.0 <= self.failover_budget_pct <= 100.0
                and math.isfinite(self.failover_budget_pct)):
            raise ValueError(f"regions.failover_budget_pct must be a percent in "
                             f"[0, 100], got {self.failover_budget_pct}")
        for name in ("replication_poll_secs", "probe_interval_secs"):
            v = getattr(self, name)
            if not (v > 0 and math.isfinite(v)):
                raise ValueError(f"regions.{name} must be finite and > 0, got {v}")
        if self.eject_after < 1:
            raise ValueError(f"regions.eject_after must be >= 1, got {self.eject_after}")
        if self.publish_keep_window < 0:
            raise ValueError(f"regions.publish_keep_window must be >= 0, got "
                             f"{self.publish_keep_window}")


def _check_funnel(r: RunConfig, m: ModelConfig, mp: int) -> None:
    """JAX's funnel geometry checks (``deepfm_tpu/core/config.py``
    ``Config.__post_init__``, section 4): the retrieval and kernel literals,
    the shortlist multiplier and recall gate, and with ``funnel_top_k`` set:
    return_n <= top_k, top_k (x oversample under int8) within one index
    shard's items, top_k within the largest serve bucket, and a warning
    where top_k pads to a bucket of twice its size or more."""
    modes = ("exact", "int8", "auto")
    if r.funnel_retrieval not in modes:
        raise ValueError(f"run.funnel_retrieval={r.funnel_retrieval!r} is not one "
                         f"of {modes}")
    if r.funnel_pallas not in ("on", "off", "auto"):
        raise ValueError(f"run.funnel_pallas={r.funnel_pallas!r} must be 'on', "
                         f"'off' or 'auto'")
    if r.funnel_oversample < 1:
        raise ValueError(f"run.funnel_oversample={r.funnel_oversample} must be >= 1 "
                         f"(1 = no oversampling, shortlist width == top_k)")
    if not 0.0 < r.funnel_min_recall <= 1.0:
        raise ValueError(f"run.funnel_min_recall={r.funnel_min_recall} must lie in "
                         f"(0, 1] - it gates int8 publishes")
    k = r.funnel_top_k
    if k <= 0:
        return
    if r.funnel_return_n > k:
        raise ValueError(f"funnel_return_n={r.funnel_return_n} exceeds funnel_top_k={k} "
                         f"- cannot return more ranked items than candidates retrieved")
    item_vocab = m.item_vocab_size or m.feature_size
    mp_serve = r.serve_group_model_parallel if r.serve_groups > 0 else mp
    if mp_serve > 0:
        per_shard = -(-item_vocab // mp_serve)
        if k > per_shard:
            raise ValueError(
                f"funnel_top_k={k} exceeds the (padded) per-shard item vocab "
                f"{per_shard} (item vocab {item_vocab} row-sharded over "
                f"model_parallel={mp_serve}) - one shard's top-k cannot select more "
                f"rows than it holds")
        if r.funnel_retrieval == "int8" and k * r.funnel_oversample > per_shard:
            raise ValueError(
                f"funnel_top_k*funnel_oversample = {k}*{r.funnel_oversample} = "
                f"{k * r.funnel_oversample} exceeds the (padded) per-shard item vocab "
                f"{per_shard} - the int8 shortlist cannot select more rows than a "
                f"shard holds; lower funnel_oversample or funnel_top_k")
    buckets = _parse_int_list(r.serve_buckets)
    if not buckets:
        return
    if k > max(buckets):
        raise ValueError(
            f"funnel_top_k={k} exceeds the largest serve bucket {max(buckets)}: one "
            f"user's K ranking rows cannot fit any dispatch (run.serve_buckets="
            f"{r.serve_buckets!r}) - raise the bucket set or lower funnel_top_k")
    fit = min(b for b in buckets if b >= k)
    if fit >= 2 * k:
        warnings.warn(
            f"funnel_top_k={k} pads to serve bucket {fit} (>= 2x): every user's "
            f"candidate set fills under half a rank dispatch - add a ~{k}-row bucket "
            f"to run.serve_buckets or raise funnel_top_k", stacklevel=3)


@dataclass(frozen=True)
class ElasticConfig:
    """Elastic online training (``deepfm_tpu_torch/elastic``), JAX's section
    with JAX's validation: the grid's shape is a runtime variable.  A
    device registry watches availability; on a shrink or grow every rank
    drains its step, commits {weights, optimizer state, stream cursor},
    re-forms its process group on the new grid, restores its row window
    of the commit and resumes the stream exactly once
    (elastic/controller.py)."""

    # run the elastic controller instead of the fixed-mesh online trainer
    # (task_type=online-train only; batch training keeps the stop-the-world
    # restart path in launch/preemption.py + checkpoint/reshard.py)
    enabled: bool = False
    # preferred embedding row-shard width: the planner picks the LARGEST
    # divisor of the live device count <= this (0 = mesh.model_parallel).
    # Keeping mp stable across a shrink keeps the padded vocab — and so the
    # published artifact shapes — identical, which keeps every post-reshard
    # group swap at the serving pool a jit cache hit.
    prefer_model_parallel: int = 0
    # refuse to rebuild on fewer devices than this; wait for capacity
    min_devices: int = 1
    # registry poll cadence while waiting for capacity to return
    poll_interval_secs: float = 0.25
    # max seconds to wait for min_devices after a shrink below it
    # (0 = wait forever — the platform owns the reschedule)
    wait_for_capacity_secs: float = 0.0
    # attempt a drain+commit on the OLD mesh before resharding (virtual
    # registries and advance-notice preemptions); when the commit itself
    # fails (devices already gone) the last periodic commit is the resume
    # point — exactly-once either way, the failed window just replays
    drain_commit: bool = True
    # -- multi-host composition (elastic/coord.py) --------------------------
    # coordination service URL ("" = single-process: no leases, no
    # consensus, one process).  With a coordinator, every training
    # process holds a TTL lease, heartbeats its local registry view, and
    # reshards only through the coordinator's two-phase drain barrier;
    # commits and publishes carry the lease's fencing token, which the
    # checkpoint root and publish root ENFORCE (a stale-token write is
    # refused, not just discouraged).
    coordinator_url: str = ""
    # lease TTL: a process that misses heartbeats for this long is expired
    # from consensus (its devices drop out, its fencing token goes stale).
    # Sent in the acquire request; the coordinator honors it clamped to
    # its own --lease-ttl ceiling, and the granted value drives expiry.
    lease_ttl_secs: float = 10.0
    # heartbeat cadence (must leave headroom under the TTL; transitions
    # and view changes heartbeat immediately regardless)
    heartbeat_interval_secs: float = 1.0
    # LiveDeviceRegistry debounce: consecutive anomalous polls required
    # before a device-set change bumps the epoch (one transient device-
    # query hiccup must not cost a full drain/commit/reshard cycle)
    registry_debounce_polls: int = 2
    # MPMD trainer/publisher split: the trainer only COMMITS payloads;
    # a separate `--task_type publish` process tails the checkpoint root
    # and publishes asynchronously, so a publish-store outage degrades
    # freshness instead of stalling the train step
    publisher_split: bool = False
    # publisher process: cadence for polling the checkpoint root for
    # newly committed payloads
    publish_poll_secs: float = 0.5

    def __post_init__(self):
        if self.min_devices < 1:
            raise ValueError(
                f"elastic.min_devices must be >= 1, got {self.min_devices}"
            )
        if self.prefer_model_parallel < 0:
            raise ValueError(
                f"elastic.prefer_model_parallel must be >= 0 (0 = "
                f"mesh.model_parallel), got {self.prefer_model_parallel}"
            )
        import math

        # NaN slips through plain <= 0 checks and every downstream
        # min/compare — a NaN TTL would mint a never-expiring lease
        if not (self.lease_ttl_secs > 0
                and math.isfinite(self.lease_ttl_secs)):
            raise ValueError(
                f"elastic.lease_ttl_secs must be finite and > 0, got "
                f"{self.lease_ttl_secs}"
            )
        if not (self.heartbeat_interval_secs > 0
                and math.isfinite(self.heartbeat_interval_secs)):
            raise ValueError(
                f"elastic.heartbeat_interval_secs must be finite and > 0, "
                f"got {self.heartbeat_interval_secs}"
            )
        if self.heartbeat_interval_secs >= self.lease_ttl_secs / 2:
            raise ValueError(
                f"elastic.heartbeat_interval_secs="
                f"{self.heartbeat_interval_secs} leaves no headroom under "
                f"lease_ttl_secs={self.lease_ttl_secs}: one delayed "
                f"heartbeat would expire the lease and self-fence the "
                f"trainer — keep the interval under ttl/2"
            )
        if self.registry_debounce_polls < 1:
            raise ValueError(
                f"elastic.registry_debounce_polls must be >= 1, got "
                f"{self.registry_debounce_polls}"
            )
        if self.publish_poll_secs <= 0:
            raise ValueError(
                f"elastic.publish_poll_secs must be > 0, got "
                f"{self.publish_poll_secs}"
            )


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    run: RunConfig = field(default_factory=RunConfig)
    flywheel: FlywheelConfig = field(default_factory=FlywheelConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    regions: RegionsConfig = field(default_factory=RegionsConfig)
    slo: SloConfig = field(default_factory=SloConfig)
    elastic: ElasticConfig = field(default_factory=ElasticConfig)

    def __post_init__(self):
        m, mp = self.model, self.mesh.model_parallel
        if m.fused_kernel == "on" and mp > 1:
            raise ValueError(
                "fused_kernel='on' requires the dense single-table lookup path; "
                "sharded tables (mesh.model_parallel > 1) substitute their own "
                "row lookup: use fused_kernel='auto' (or 'off') with them")
        # an exchange capacity under one record's ids sends every batch to
        # the psum fallback (JAX's check; batch_size is per data index here)
        if m.shard_exchange_capacity > 0 and m.shard_exchange != "psum" and mp > 1:
            n_local = self.data.batch_size * m.field_size
            cap = max(1, min(math.ceil(m.shard_exchange_capacity * n_local), n_local))
            if cap * mp < m.field_size:
                raise ValueError(
                    f"shard_exchange_capacity={m.shard_exchange_capacity} gives "
                    f"{cap} request slots/owner x {mp} owners < field_size="
                    f"{m.field_size}: one example's distinct ids cannot fit, so "
                    f"the overflow psum fallback would engage on every batch - "
                    f"raise the capacity (0 = auto: ceil(N/M))")
            even = -(-n_local // mp)
            if cap < -(-even // 2):
                warnings.warn(
                    f"shard_exchange_capacity={m.shard_exchange_capacity} ({cap} "
                    f"slots/owner) is under half the even-spread requirement "
                    f"ceil(N/M)={even} for N={n_local} local ids on {mp} owners - "
                    f"expect frequent overflow fallback to the dense psum path "
                    f"(parallel/embedding.py)", stacklevel=2)
        if self.optimizer.zero_sharding == "on" and self.mesh.data_parallel == 1:
            warnings.warn(
                "optimizer.zero_sharding='on' with mesh.data_parallel=1 is a "
                "no-op: the weight update shards across the data axis, and "
                "there is only one data shard (train/optimizer.py "
                "ZeroOptimizer)", stacklevel=2)
        _check_tiered_geometry(m, self.data.batch_size)
        _check_funnel(self.run, m, mp)
        # a fleet tenant whose model overrides touch an executable-spec
        # field could not share the member's graphs: refuse at load,
        # naming the fields
        base_model = dataclasses.asdict(m)
        for t in self.fleet.tenants:
            diff = tenant_spec_divergence(base_model, t["model"])
            if diff:
                raise ValueError(
                    f"fleet tenant {t['name']!r} diverges from its executable-sharing "
                    f"group on {diff}: same-spec tenants must share ONE precompiled "
                    f"executable set (EXECUTABLE_SPEC_FIELDS) — serve a divergent spec "
                    f"from its own pool instead")
        # feedback-train is the online trainer on the join's output
        fw = self.flywheel
        if (self.run.task_type in ("feedback-train", "feedback_train")
                and not fw.join_output_url):
            raise ValueError(
                "task_type=feedback-train needs flywheel.join_output_url — the "
                "joined labeled stream the online trainer tails (run `python -m "
                "deepfm_tpu_torch.flywheel.join` to produce it)")
        # a shadow challenger beside the impression log: with other rates
        # the join and the shadow read different slices of traffic
        if fw.enabled and any(t.get("shadow_of") for t in self.fleet.tenants):
            shadow_rate = self.fleet.shadow_sample_percent / 100.0
            if abs(shadow_rate - fw.sample_rate) > 1e-9:
                warnings.warn(
                    f"flywheel.sample_rate={fw.sample_rate} differs from "
                    f"fleet.shadow_sample_percent={self.fleet.shadow_sample_percent} "
                    f"while a shadow challenger is armed: the flywheel join and shadow "
                    f"scoring will read different traffic slices — align the rates if "
                    f"the joined labels should explain the shadow's divergence",
                    stacklevel=2)
        # the home retention must cover the staleness SLO: a region up to
        # max_version_skew behind fetches those versions while catching up
        rg = self.regions
        if rg.enabled:
            window = max(self.run.keep_checkpoints, rg.publish_keep_window)
            if window < rg.max_version_skew + 1:
                warnings.warn(
                    f"regions.publish_keep_window={rg.publish_keep_window} (effective "
                    f"retention {window} with run.keep_checkpoints="
                    f"{self.run.keep_checkpoints}) is under max_version_skew+1="
                    f"{rg.max_version_skew + 1}: home retention can delete a version a "
                    f"lagging-but-inside-SLO region is still catching up to — widen the "
                    f"keep window", stacklevel=2)

    def with_overrides(self, **sections: dict[str, Any]) -> "Config":
        """A new Config with per-section field overrides, e.g.
        ``cfg.with_overrides(model={"embedding_size": 64})``.  An unknown
        section or field raises."""
        updates = {}
        for section, fields in sections.items():
            if section not in {f.name for f in dataclasses.fields(self)}:
                # a JAX-only field at a value that changes the result
                # raises naming its ROADMAP item, as in a config.json
                _known_fields(None, fields, section)
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
