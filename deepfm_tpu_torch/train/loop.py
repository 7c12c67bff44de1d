"""Training loop on one card: counterpart of ``run_train`` and
``run_eval`` in ``deepfm_tpu/train/loop.py``.

``run_train`` builds (or takes, e.g. from ``convert.train_state_from_jax``)
the train state, runs the epoch loop over the training files with a
metrics line every ``run.log_steps`` steps, evaluates once over
``data.val_data_dir`` with the streaming AUC, and exports a servable to
``run.servable_model_dir`` (serve/export.py), which the port's server
loads.  At the end of the loop it logs a ``train_done`` line: steps,
examples, seconds, examples per second and the share of the loop spent
waiting on the input pipeline.

Not ported yet (ROADMAP A6): periodic checkpoints, resume, in-training
eval, and the standalone eval/infer/export tasks.
"""

from __future__ import annotations

import time
from typing import Iterator

import torch
from torch import nn

from ..core.config import Config
from ..core.platform import resolve_device
from ..data.pipeline import Prefetcher, eval_batches, make_input_pipeline
from ..ops.auc import auc_init, auc_value
from ..serve.export import export_servable
from ..utils.logging import MetricLogger
from .step import TrainState, create_train_state, eval_step, train_step


def _tensors(batches: Iterator[dict], pin: bool = False) -> Iterator[dict]:
    """numpy batches -> CPU tensors; ``pin`` puts them in page-locked
    memory, so their copy to the card does not hold the host up."""
    for batch in batches:
        yield {k: torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v)
               for k, v in batch.items()}


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def run_eval(model: nn.Module, cfg: Config, *, log: MetricLogger | None = None,
             data_dir: str | None = None) -> dict:
    """``{"auc", "loss", "examples"}`` over every record of the validation
    files (the tail batch included), in eval mode.  The loss is the
    example-weighted mean of the batch losses (CE + L2)."""
    dev = model.fm_v.device
    auc_state = auc_init(device=dev)
    loss_sum = torch.zeros((), device=dev)
    count = 0
    for batch in _tensors(eval_batches(cfg.data, field_size=cfg.model.field_size,
                                       data_dir=data_dir)):
        auc_state, m = eval_step(model, auc_state, to_device(batch, dev))
        loss_sum = loss_sum + m["loss"] * m["count"]
        count += m["count"]
    result = {
        "auc": float(auc_value(auc_state)),
        "loss": float(loss_sum) / count if count else float("nan"),
        "examples": count,
    }
    if log is not None:
        log.event("eval", **result)
    return result


def run_train(cfg: Config, *, device=None, state: TrainState | None = None,
              log: MetricLogger | None = None) -> TrainState:
    """The train task: epoch loop, final eval, export.  Returns the state."""
    if state is None:
        state = create_train_state(cfg, resolve_device(device))
    dev = state.model.fm_v.device
    log = log or MetricLogger(log_steps=cfg.run.log_steps)
    host = make_input_pipeline(cfg.data, field_size=cfg.model.field_size,
                               seed=cfg.run.seed)
    host = _tensors(host, pin=dev.type == "cuda")
    steps = examples = 0
    wait_s = 0.0
    t0 = time.perf_counter()
    with Prefetcher(host, depth=cfg.data.prefetch_batches) as feed:
        while True:
            t = time.perf_counter()
            batch = next(feed, None)
            wait_s += time.perf_counter() - t
            if batch is None:
                break
            b = int(batch["label"].shape[0])
            metrics = train_step(state, to_device(batch, dev))
            steps += 1
            examples += b
            log.step(state.step, b, metrics)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    loop_s = time.perf_counter() - t0
    log.event("train_done", step=state.step, steps=steps, examples=examples,
              seconds=loop_s, examples_per_sec=examples / loop_s,
              input_wait_share=wait_s / loop_s)
    if cfg.data.val_data_dir:
        run_eval(state.model, cfg, log=log)
    if cfg.run.servable_model_dir:
        path = export_servable(cfg.model, state.model.state_dict(),
                               cfg.run.servable_model_dir)
        log.event("export", path=path)
    return state
