"""Launcher CLI: counterpart of ``deepfm_tpu/launch/cli.py``.

    python -m deepfm_tpu_torch --task_type train|eval|infer|export|serve|\
        online-train|feedback-train \
        --training_data_dir D --val_data_dir E --model_dir M \
        --servable_model_dir S [--test_data_dir T] \
        [--config cfg.json] [--set section.field=value ...] [--device cpu]

A JSON config (the ``config.json`` schema), then the first-class flags and
``--set`` overrides, resolve one ``Config``; the task then runs on the card
(``--device cpu`` runs the kernels' plain versions on the CPU).  The flags
keep the JAX CLI's names for what the port supports.  Every task type but
``publish`` (the elastic publisher, ROADMAP A15, which raises) is ported
(train/loop.py).  ``online-train`` tails the event log in
``--training_data_dir``, commits {weights, cursor} into ``--model_dir`` and
publishes versions into ``--servable_model_dir`` every
``run.online_publish_every_steps`` steps (online/trainer.py), until
SIGTERM/SIGINT (a final commit and publish, exit 0),
``run.online_max_batches`` or ``run.online_idle_timeout_secs``; the same
command again resumes at the committed cursor.  ``feedback-train`` runs it
on ``flywheel.join_output_url``, the output of ``python -m
deepfm_tpu_torch.flywheel.join``.  ``serve`` runs
``serve/server.py serve_forever`` over ``--servable_model_dir`` with the
``run.serve_*`` fields (``--set run.serve_port=8501``,
``run.serve_reload_url=PUB``, ...) and, over a funnel servable, the
``--funnel_*`` flags (``--funnel_top_k 16 --funnel_return_n 4``: a
default defers to the servable's funnel.json).  ``run.serve_workers > 1``
runs the process pool (``serve/server.py serve_pool``) and
``--serve_groups N`` (``run.serve_groups``) the router-fronted
shard-group pool (``python -m deepfm_tpu_torch.serve.pool``, with the
``run.serve_group_*``, ``serve_router_port``, ``serve_retry_limit``,
``serve_eject_after`` and ``serve_health_interval_secs`` fields, and the
router's impression log with ``flywheel.enabled``).

``train`` checkpoints into ``--model_dir`` and resumes from it: run the
same command again after a stop and it goes on from the latest
checkpoint.  A SIGTERM or SIGINT stops it at the next step with a
checkpoint and exit code 0 (the handler is installed before the heavy
imports; a second signal kills the process).  ``--clear_existing_model``
wipes ``--model_dir`` once, before the first attempt; a crash is retried
``run.max_restarts`` times (launch/preemption.py), each attempt resuming.

``--set optimizer.lazy_embedding_updates=true`` trains the tables with lazy
Adam (train/lazy.py).  Under the launcher the same command trains on a
``[data x model]`` grid, one rank a card (NCCL), or one rank a process
with ``--device cpu`` (gloo); ``data.batch_size`` is per data index, and
``--set mesh.model_parallel=M`` row-shards fm_w and fm_v over M ranks
(``model.shard_exchange``, ``optimizer.zero_sharding``; the eval, infer
and export tasks take the same grid):

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m deepfm_tpu_torch --task_type train --set mesh.model_parallel=M ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..core.config import Config

PORTED = ("train", "eval", "infer", "export", "serve", "online-train", "online_train",
          "feedback-train", "feedback_train")
# task types of the JAX CLI that the port does not run yet
NOT_PORTED = {
    "publish": "ROADMAP A15 (elastic trainer/publisher split)",
}

_FLAG_MAP = {
    "task_type": ("run", "task_type"),
    "training_data_dir": ("data", "training_data_dir"),
    "val_data_dir": ("data", "val_data_dir"),
    "test_data_dir": ("data", "test_data_dir"),
    "model_dir": ("run", "model_dir"),
    "servable_model_dir": ("run", "servable_model_dir"),
    "batch_size": ("data", "batch_size"),
    "num_epochs": ("data", "num_epochs"),
    "learning_rate": ("optimizer", "learning_rate"),
    "feature_size": ("model", "feature_size"),
    "field_size": ("model", "field_size"),
    "embedding_size": ("model", "embedding_size"),
    "deep_layers": ("model", "deep_layers"),
    "dropout": ("model", "dropout_keep"),
    "optimizer": ("optimizer", "name"),
    "model_name": ("model", "model_name"),
    "log_steps": ("run", "log_steps"),
    "clear_existing_model": ("run", "clear_existing_model"),
    "checkpoint_every_steps": ("run", "checkpoint_every_steps"),
    "funnel_top_k": ("run", "funnel_top_k"),
    "funnel_return_n": ("run", "funnel_return_n"),
    "funnel_retrieval": ("run", "funnel_retrieval"),
    "funnel_oversample": ("run", "funnel_oversample"),
    "funnel_min_recall": ("run", "funnel_min_recall"),
    "funnel_pallas": ("run", "funnel_pallas"),
    "serve_groups": ("run", "serve_groups"),
    "serve_group_mp": ("run", "serve_group_model_parallel"),
}


def _coerce(value: str):
    try:
        return json.loads(value)
    except json.JSONDecodeError:
        return value


def parse_set_pairs(pairs: list[str], sections: dict[str, dict]) -> dict:
    """``section.key=value`` pairs folded into ``sections`` (values parsed
    as JSON where they parse)."""
    for pair in pairs:
        if "=" not in pair or "." not in pair.split("=", 1)[0]:
            raise SystemExit(
                f"--set expects section.key=value, got {pair!r} "
                f"(sections: model, optimizer, data, mesh, run, flywheel, regions, slo)"
            )
        key, value = pair.split("=", 1)
        section, name = key.split(".", 1)
        sections.setdefault(section, {})[name] = _coerce(value)
    return sections


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deepfm_tpu_torch",
        description="DeepFM training and serving on NVIDIA Hopper cards (PyTorch/CUDA port)",
    )
    p.add_argument("--config", help="JSON config file (Config.to_dict schema)")
    p.add_argument("--task_type", choices=[*PORTED, *NOT_PORTED],
                   help="task dispatch; all but publish are ported")
    p.add_argument("--training_data_dir")
    p.add_argument("--val_data_dir")
    p.add_argument("--test_data_dir", help="te*/test* records for infer")
    p.add_argument("--model_dir")
    p.add_argument("--servable_model_dir")
    p.add_argument("--batch_size", type=int)
    p.add_argument("--num_epochs", type=int)
    p.add_argument("--learning_rate", type=float)
    p.add_argument("--feature_size", type=int)
    p.add_argument("--field_size", type=int)
    p.add_argument("--embedding_size", type=int)
    p.add_argument("--deep_layers", help='e.g. "128,64,32"')
    p.add_argument("--dropout", help='keep probabilities, e.g. "0.5,0.5,0.5"')
    p.add_argument("--optimizer", help="Adam|Adagrad|Momentum|Ftrl")
    p.add_argument("--model_name", help="deepfm")
    p.add_argument("--log_steps", type=int, help="a metrics line every N steps")
    p.add_argument("--clear_existing_model", action="store_true", default=None,
                   help="delete --model_dir before training")
    p.add_argument("--checkpoint_every_steps", type=int,
                   help="a checkpoint every N steps (0: only at the end)")
    p.add_argument("--funnel_top_k", type=int,
                   help="task_type=serve over a funnel servable: candidates retrieved "
                        "per user before ranking (0 = the servable's funnel.json default)")
    p.add_argument("--funnel_return_n", type=int,
                   help="funnel serving: ranked items returned per user "
                        "(0 = the servable's funnel.json default)")
    p.add_argument("--funnel_retrieval", choices=("exact", "int8", "auto"),
                   help="funnel retrieval tier: exact f32 scoring, int8 scoring with an "
                        "exact f32 rescore of the oversampled shortlist, or auto (int8 at "
                        "a large index)")
    p.add_argument("--funnel_oversample", type=int,
                   help="int8 shortlist width multiplier: K*oversample candidates "
                        "survive the quantized pass into the exact rescore")
    p.add_argument("--funnel_min_recall", type=float,
                   help="recall gate of an int8 funnel publish, in (0, 1]")
    p.add_argument("--funnel_pallas", choices=("on", "off", "auto"),
                   help="JAX's retrieval-kernel switch: validated; the port always "
                        "runs its own retrieval kernel")
    p.add_argument("--serve_groups", type=int,
                   help="task_type=serve: run the router-fronted shard-group pool with "
                        "this many groups (serve/pool/: fm_w/fm_v row-sharded in each "
                        "member, group-atomic hot swap)")
    p.add_argument("--serve_group_mp", type=int,
                   help="row shards inside each serve group's member, all on its card "
                        "(0 = 1)")
    p.add_argument("--set", action="append", default=[], metavar="SECTION.KEY=VALUE",
                   help="override any config field, e.g. --set model.batch_norm=true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default, needs a Hopper card) or cpu")
    p.add_argument("--print_config", action="store_true",
                   help="print the resolved config and exit")
    return p


def resolve_config(argv: list[str] | None = None) -> tuple[Config, argparse.Namespace]:
    args = build_parser().parse_args(argv)
    cfg = Config.from_json(args.config) if args.config else Config()
    sections: dict[str, dict] = {}
    for flag, (section, name) in _FLAG_MAP.items():
        value = getattr(args, flag)
        if value is not None:
            sections.setdefault(section, {})[name] = value
    parse_set_pairs(args.set, sections)
    if sections:
        try:
            cfg = cfg.with_overrides(**sections)
        except TypeError as e:
            raise SystemExit(f"bad --set override: {e}") from None
    return cfg, args


def run_task(cfg: Config, *, device=None):
    """Run ``cfg.run.task_type`` once; returns what the task returns (the
    train state for ``train``)."""
    task = cfg.run.task_type
    if task in NOT_PORTED:
        raise NotImplementedError(f"task_type={task!r} is not ported yet: "
                                  f"{NOT_PORTED[task]}")
    from ..train.loop import run_task as run_loop_task

    return run_loop_task(cfg, device=device)


def run(argv: list[str] | None = None):
    """Resolve the config from ``argv`` and run its task under the crash
    supervisor; returns the task's result (``None`` after
    ``--print_config``).  A signalled stop raises ``PreemptedError``."""
    cfg, args = resolve_config(argv)
    if args.print_config:
        print(json.dumps(cfg.to_dict(), indent=2))
        return None
    from .preemption import install_early_handler, run_with_restarts

    train = cfg.run.task_type == "train"
    if train:
        # record a signal that lands during the imports and setup below
        install_early_handler()
    from ..checkpoint import maybe_clear
    from ..utils.logging import MetricLogger

    # once, before the supervisor: a retry resumes from the model_dir, it
    # must not wipe it.  Rank 0 alone, before any rank joins the group;
    # eval, infer and export read the model_dir
    if train and os.environ.get("RANK", "0") == "0":
        maybe_clear(cfg.run.model_dir, cfg.run.clear_existing_model)
    cfg = cfg.with_overrides(run={"clear_existing_model": False})
    return run_with_restarts(
        lambda: run_task(cfg, device=args.device),
        max_restarts=cfg.run.max_restarts, backoff_secs=cfg.run.restart_backoff_secs,
        on_restart=lambda attempt, e: MetricLogger().event(
            "restart", attempt=attempt, error=f"{type(e).__name__}: {e}"[:200]))


def main(argv: list[str] | None = None) -> int:
    """The command line: 0 when the task ended or was stopped by a signal
    (checkpointed, to be resumed by the same command)."""
    from .preemption import PreemptedError

    try:
        run(argv)
    except PreemptedError:
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
