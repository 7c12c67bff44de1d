"""Launcher CLI: counterpart of ``deepfm_tpu/launch/cli.py``.

    python -m deepfm_tpu_torch --task_type train \
        --training_data_dir D --val_data_dir E --servable_model_dir S \
        [--config cfg.json] [--set section.field=value ...] [--device cpu]

A JSON config (the ``config.json`` schema), then the first-class flags and
``--set`` overrides, resolve one ``Config``; the task then runs on the card
(``--device cpu`` runs the kernels' plain versions on the CPU).  The flags
keep the JAX CLI's names for what the port supports.  Only ``train`` is
ported: every other task type raises, naming its ROADMAP item.

``--set optimizer.lazy_embedding_updates=true`` trains the tables with lazy
Adam (train/lazy.py).  Under the launcher the same command trains data
parallel, one rank a card (NCCL), or one rank a process with
``--device cpu`` (gloo); ``data.batch_size`` is per rank:

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m deepfm_tpu_torch --task_type train ...
"""

from __future__ import annotations

import argparse
import json
import sys

from ..core.config import Config

# task types of the JAX CLI that the port does not run yet
NOT_PORTED = {
    "eval": "ROADMAP A6 (standalone eval task)",
    "infer": "ROADMAP A6 (infer task)",
    "export": "ROADMAP A6 (export task); `train` exports at its end",
    "serve": "ROADMAP A8: run `python -m deepfm_tpu_torch.serve.server "
             "--servable DIR` over the servable",
    "online-train": "ROADMAP A10 (online training)",
    "online_train": "ROADMAP A10 (online training)",
    "feedback-train": "ROADMAP A10 (online training over the flywheel's stream)",
    "feedback_train": "ROADMAP A10 (online training over the flywheel's stream)",
    "publish": "ROADMAP A15 (elastic trainer/publisher split)",
}

_FLAG_MAP = {
    "task_type": ("run", "task_type"),
    "training_data_dir": ("data", "training_data_dir"),
    "val_data_dir": ("data", "val_data_dir"),
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
                f"(sections: model, optimizer, data, run)"
            )
        key, value = pair.split("=", 1)
        section, name = key.split(".", 1)
        sections.setdefault(section, {})[name] = _coerce(value)
    return sections


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deepfm_tpu_torch",
        description="DeepFM training on one NVIDIA Hopper card (PyTorch/CUDA port)",
    )
    p.add_argument("--config", help="JSON config file (Config.to_dict schema)")
    p.add_argument("--task_type", choices=["train", *NOT_PORTED],
                   help="task dispatch; only train is ported")
    p.add_argument("--training_data_dir")
    p.add_argument("--val_data_dir")
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
    """Run ``cfg.run.task_type``; returns what the task returns (the train
    state for ``train``)."""
    task = cfg.run.task_type
    if task != "train":
        raise NotImplementedError(
            f"task_type={task!r} is not ported yet: "
            f"{NOT_PORTED.get(task, 'unknown task type')}"
        )
    from ..train.loop import run_train

    return run_train(cfg, device=device)


def run(argv: list[str] | None = None):
    """Resolve the config from ``argv`` and run its task; returns the task's
    result (``None`` after ``--print_config``)."""
    cfg, args = resolve_config(argv)
    if args.print_config:
        print(json.dumps(cfg.to_dict(), indent=2))
        return None
    return run_task(cfg, device=args.device)


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
