"""The train, eval, infer, export, serve, online-train and feedback-train
tasks: counterpart of ``run_train``, ``run_eval``, ``run_infer``,
``run_export``, the serve and online branches and ``run_task`` in
``deepfm_tpu/train/loop.py``, on one card or on each rank of a
data-parallel run (the online tasks on one card: online/trainer.py; the
elastic online trainer on a grid of ranks: elastic/controller.py).
JAX's ``restore_latest`` is ``Checkpointer.restore`` here: a checkpoint of
another row split (``mesh.model_parallel``) takes the cross-topology
reshard (checkpoint/reshard.py) and the train task logs
``resume_reshard``; one of another table shape at the same split raises
with the fused_kernel hint.  ``run.model_dir`` may be an object-store URL
(checkpoint/remote.py) at a world size of 1.

``run_train`` is the train task's whole lifecycle:

* a :class:`PreemptionGuard` is installed before any setup, so a SIGTERM
  or SIGINT during it is caught too;
* the process joins its group when a launcher started it
  (parallel/mesh.py), clears ``run.model_dir`` with
  ``run.clear_existing_model``, builds the train state (weights from
  ``run.seed``, broadcast from rank 0) and, when ``run.model_dir`` holds a
  checkpoint, restores the latest one (a ``resume`` event);
* the epoch loop passes over the ``state.step`` batches the restored run
  already trained on (the resume skip, undecoded), then steps through
  the synchronous data-parallel step (parallel/spmd.py; the single-card
  step without a group), with a metrics line every ``run.log_steps``
  steps, a checkpoint each time the step crosses a multiple of
  ``run.checkpoint_every_steps`` (checkpoint/ckpt.py, written on a
  thread), and an eval over ``data.val_data_dir`` no sooner than
  ``run.eval_start_delay_secs`` after the start and then at most once per
  ``run.eval_throttle_secs`` (0: at the end only);
* after the loop, a ``train_done`` line (world size, steps, global
  examples, seconds, global examples per second, the share of the loop
  spent waiting on the input pipeline) and a final checkpoint;
* stopped by a signal, it logs ``preempted`` and raises
  :class:`PreemptedError` (the next run of the same command resumes);
  else the final eval and the servable export (serve/export.py).

A run is bit-reproducible across a stop and a resume: the checkpoint
holds the weights, the BN statistics, the optimizer's slots and count,
the lazy moments and each rank's dropout generator, and the skip is
counted in steps, never in what the reader thread decoded ahead.  Every
rank runs the same steps and stops, evaluates and saves at the same step
(the flags of the step's all-reduce); rank 0 alone logs, writes
checkpoints and exports, and the metrics it logs are the cross-rank
means.  Eval reads each validation record once across the ranks and
merges the AUC counts and loss sums in one all-reduce.

The ``eval``, ``infer`` and ``export`` tasks restore the latest checkpoint
of ``run.model_dir``: ``eval`` logs the AUC and loss over the validation
files, ``infer`` writes one probability a line of every ``te*``/``test*``
record (else ``va*``/``val*``) under ``data.test_data_dir`` (else
``data.val_data_dir``) to ``pred.txt`` there, and ``export`` writes the
servable.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..checkpoint import make_checkpointer, maybe_clear
from ..core.config import Config
from ..data.object_store import is_url
from ..data.pipeline import (Prefetcher, channel_eval_batches, discover_files,
                             eval_batches, make_input_pipeline)
from ..data.sharding import ShardDecision
from ..launch.preemption import PreemptedError, PreemptionGuard
from ..ops.auc import auc_all_reduce, auc_init, auc_value
from ..parallel import spmd
from ..parallel.mesh import DistContext, initialize_distributed, shutdown
from ..serve.export import export_servable, write_predictions
from ..utils.logging import MetricLogger
from .step import TrainState, eval_step, predict_step


def _tensors(batches: Iterator[dict], pin: bool = False) -> Iterator[dict]:
    """numpy batches -> CPU tensors; ``pin`` puts them in page-locked
    memory, so their copy to the card does not hold the host up."""
    for batch in batches:
        yield {k: torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v)
               for k, v in batch.items()}


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


class _Silent:
    """The logger of ranks other than 0: writes nothing, reads nothing."""

    def step(self, *args, **kwargs) -> None:
        pass

    def seed_step(self, step: int) -> None:
        pass

    def event(self, *args, **kwargs) -> None:
        pass


def _permute_vocab(cfg: Config) -> int:
    """The vocabulary the input's ids are permuted in (``data.permute_ids``),
    0 for none."""
    return cfg.model.feature_size if cfg.data.permute_ids else 0


def _export(state: TrainState, cfg: Config, ctx: DistContext, path: str) -> str:
    """The servable of ``state`` at ``path``, written by rank 0 (every rank
    calls it: a grid's tables are gathered first)."""
    sd = spmd.servable_state_dict(state, cfg.model)
    if ctx.rank == 0:
        path = export_servable(cfg.model, sd, path)
    return path


def _eval_channel_path(cfg: Config) -> str:
    """The stream-mode evaluation channel, ``<dir>/<evaluation_channel_name>``
    (the reference reads eval data from the 'evaluation' channel in Pipe
    mode, hvd:420-424), ``dir`` being ``data.val_data_dir`` or else
    ``data.training_data_dir``."""
    base = cfg.data.val_data_dir or cfg.data.training_data_dir
    return os.path.join(base, cfg.data.evaluation_channel_name)


def _has_eval_source(cfg: Config) -> bool:
    """Whether the train task evaluates: the evaluation channel exists in
    stream mode, ``data.val_data_dir`` is set in file mode."""
    if cfg.data.stream_mode:
        return os.path.exists(_eval_channel_path(cfg))
    return bool(cfg.data.val_data_dir)


def _check_channel_readers(cfg: Config, ctx: DistContext | None, *,
                           evaluation: bool) -> None:
    """Refuse a stream-mode layout in which two processes of one host read
    one FIFO: the kernel hands each reader other chunks of its bytes, so
    records tear and the ranks' counts differ (one fails or stops early
    while the others wait in a collective).  The reference runs one process
    a host.  Under ``torch.distributed.run`` with LOCAL_WORLD_SIZE > 1 a
    local training channel needs ``multi_path`` (each local rank its own
    ``<channel>-<k>``) and one model shard (a model group reads one
    channel); the evaluation channel, which every rank reads, is refused.
    A channel under a URL base is one GET a reader, so it may be shared."""
    if not cfg.data.stream_mode or ctx is None or ctx.local_world_size == 1:
        return
    where = (f"{ctx.local_world_size} processes a host (LOCAL_WORLD_SIZE) would read "
             f"one FIFO")
    if evaluation:
        raise ValueError(f"stream_mode eval: {where}, {_eval_channel_path(cfg)!r}; run "
                         f"one process a host, or evaluate the checkpoint from files")
    if is_url(cfg.data.training_data_dir):
        return
    if not cfg.data.multi_path or ctx.model_parallel > 1:
        raise ValueError(f"stream_mode training: {where}; set data.multi_path (one "
                         f"channel a local rank, model_parallel 1) or run one process "
                         f"a host")


def _eval_batches(cfg: Config, ctx: DistContext | None,
                  data_dir: str | None) -> Iterator[dict]:
    """The evaluation records' batches, read incrementally (host memory of a
    batch, however long the source): the validation files, or in stream
    mode the evaluation channel until its writer closes it, at most
    ``data.eval_max_batches`` batches when that is > 0 (a live channel may
    never close).  Each eval opens the channel anew: its writer fills it
    once a pass, as Pipe mode does.  Across a data group every rank (one a
    host, :func:`_check_channel_readers`) reads its host's channel and
    keeps its data index's records, so each counts once."""
    permute = _permute_vocab(cfg)
    if not cfg.data.stream_mode:
        return eval_batches(cfg.data, ctx.topology if ctx is not None else None,
                            field_size=cfg.model.field_size, data_dir=data_dir,
                            permute_vocab=permute)
    fifo = _eval_channel_path(cfg)
    if not os.path.exists(fifo):
        raise FileNotFoundError(f"stream_mode eval needs the evaluation channel at "
                                f"{fifo!r} (data.evaluation_channel_name)")
    _check_channel_readers(cfg, ctx, evaluation=True)
    decision = (ShardDecision(ctx.data_parallel, ctx.data_index)
                if ctx is not None and ctx.data_group is not None else None)
    return channel_eval_batches(cfg.data, fifo, field_size=cfg.model.field_size,
                                decision=decision, permute_vocab=permute)


def run_eval(model: nn.Module, cfg: Config, *, log: MetricLogger | None = None,
             data_dir: str | None = None, ctx: DistContext | None = None) -> dict:
    """``{"auc", "loss", "examples"}`` over every record of the validation
    files (the tail batch included), or of the evaluation channel in stream
    mode (:func:`_eval_batches`), in eval mode, each rank of ``ctx``
    reading its shard.  The loss is the example-weighted mean of the batch
    losses (CE + L2)."""
    dev = model.fm_v.device
    auc_state = auc_init(device=dev)
    loss_sum = torch.zeros((), device=dev)
    count = 0
    with contextlib.closing(_eval_batches(cfg, ctx, data_dir)) as source:
        for batch in _tensors(source):
            auc_state, m = eval_step(model, auc_state, to_device(batch, dev))
            loss_sum = loss_sum + m["loss"] * m["count"]
            count += m["count"]
    loss_total = float(loss_sum)
    # the ranks of a model group read the same records: merge over the
    # data group, so each record counts once
    if ctx is not None and ctx.data_group is not None:
        auc_state, (loss_total, count) = auc_all_reduce(auc_state, loss_sum, count,
                                                        group=ctx.data_group)
        count = int(count)
    result = {
        "auc": float(auc_value(auc_state)),
        "loss": loss_total / count if count else float("nan"),
        "examples": count,
    }
    if log is not None:
        log.event("eval", **result)
    return result


def run_train(cfg: Config, *, device=None, state: TrainState | None = None,
              log: MetricLogger | None = None) -> TrainState:
    """The train task (module docstring); returns the state.  ``state``
    replaces the fresh one (e.g. ``convert.train_state_from_jax``'s) where
    ``run.model_dir`` holds no checkpoint.  Raises PreemptedError when a
    signal stopped it, after its checkpoint.  With
    ``model.tiered_embeddings`` it is :func:`run_train_tiered`."""
    if cfg.model.tiered_embeddings:
        return run_train_tiered(cfg, device=device, log=log)
    with PreemptionGuard() as guard:
        ctx = initialize_distributed(cfg.mesh, device)
        try:
            return _train(cfg, ctx, state, log, guard)
        finally:
            shutdown(ctx)


def _train(cfg: Config, ctx: DistContext, state: TrainState | None,
           log: MetricLogger | None, guard: PreemptionGuard) -> TrainState:
    if ctx.rank != 0:
        log = _Silent()
    log = log or MetricLogger(log_steps=cfg.run.log_steps)
    if cfg.run.clear_existing_model:
        if ctx.rank == 0:
            maybe_clear(cfg.run.model_dir, True)
        if ctx.group is not None:  # no rank looks for a checkpoint before
            dist.barrier(group=ctx.group)
    ckpt = make_checkpointer(cfg.run.model_dir, max_to_keep=cfg.run.keep_checkpoints,
                             ctx=ctx)
    if state is None:
        state = spmd.create_dp_train_state(cfg, ctx)
    if ckpt.latest_step() is not None:
        ckpt.restore(state)
        if ckpt.last_restore["resharded"]:
            log.event("resume_reshard", step=state.step, grid=ckpt.last_restore["grid"],
                      to=[ctx.data_parallel, ctx.model_parallel])
        log.event("resume", step=state.step)
        log.seed_step(state.step)
    dev = state.model.fm_v.device
    _check_channel_readers(cfg, ctx, evaluation=False)
    if _has_eval_source(cfg):  # refused before training, not after it
        _check_channel_readers(cfg, ctx, evaluation=True)
    host = make_input_pipeline(cfg.data, ctx.topology, field_size=cfg.model.field_size,
                               seed=cfg.run.seed, skip_batches=state.step,
                               permute_vocab=_permute_vocab(cfg))
    host = _tensors(host, pin=dev.type == "cuda")
    every = cfg.run.checkpoint_every_steps
    eval_on = _has_eval_source(cfg) and cfg.run.eval_throttle_secs > 0
    next_eval = time.time() + max(cfg.run.eval_start_delay_secs,
                                  cfg.run.eval_throttle_secs)

    def eval_due() -> bool:
        return eval_on and time.time() >= next_eval

    steps = examples = 0
    wait_s = 0.0
    t0 = time.perf_counter()
    with _profiled(cfg.run.profile_dir, dev), \
            Prefetcher(host, depth=cfg.data.prefetch_batches) as feed:

        def take():
            nonlocal wait_s
            t = time.perf_counter()
            batch = next(feed, None)
            wait_s += time.perf_counter() - t
            return batch

        # a signal during setup skips the loop; the state is still saved
        batch = None if guard.should_stop else take()
        go_on, stop = spmd.agree(ctx, has_next=batch is not None,
                                 stop=guard.should_stop)
        while go_on and not stop:
            # the next batch is taken before this step, so the step can
            # tell the other ranks whether this one goes on
            nxt = take()
            # the single-card step copies the pinned batch into its graph's
            # static buffers itself
            metrics = spmd.train_step(state, batch if ctx.group is None
                                      else to_device(batch, dev), ctx,
                                      has_next=nxt is not None,
                                      stop=guard.should_stop, eval_now=eval_due())
            go_on = metrics.pop("all_have_next")
            stop, eval_now = metrics.pop("any_stop"), metrics.pop("eval_now")
            alone = ctx.world_size == 1  # reads its flags late, as JAX does
            b = metrics.pop("examples")
            steps += 1
            examples += b
            log.step(state.step, b, metrics)
            if every and state.step % every == 0:
                ckpt.save(state)
            if eval_due() if alone else eval_now:
                run_eval(state.model, cfg, log=log, ctx=ctx)
                next_eval = time.time() + cfg.run.eval_throttle_secs
            stop = guard.should_stop if alone else stop
            batch = nxt
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    loop_s = time.perf_counter() - t0
    log.event("train_done", step=state.step, steps=steps, world_size=ctx.world_size,
              examples=examples, seconds=loop_s, examples_per_sec=examples / loop_s,
              input_wait_share=wait_s / loop_s)
    ckpt.save(state)
    if stop:
        log.event("preempted", step=state.step)
        ckpt.close()
        raise PreemptedError(f"preempted at step {state.step}")
    if _has_eval_source(cfg):
        run_eval(state.model, cfg, log=log, ctx=ctx)
    if cfg.run.servable_model_dir:
        path = _export(state, cfg, ctx, cfg.run.servable_model_dir)
        log.event("export", path=path)
    ckpt.close()
    return state


def _profiled(profile_dir: str, dev: torch.device):
    """A ``torch.profiler`` trace of what runs inside, written into
    ``profile_dir`` as a Chrome trace (``*.pt.trace.json``, TensorBoard's
    layout) when it is not empty, where JAX takes ``jax.profiler.trace``;
    the card's kernels are recorded too on a card."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def _observed(batches: Iterator[dict], observer) -> Iterator[dict]:
    for batch in batches:
        observer(batch)
        yield batch


def run_train_tiered(cfg: Config, *, device=None, log: MetricLogger | None = None):
    """The train task with ``model.tiered_embeddings`` (JAX
    ``run_train_tiered``, ``train/loop.py:279-370``): the tables page
    through the hot cache on the card, the host tier and the cold tier
    (tiered/) instead of living on the card.  One process and one card:
    a launcher's group or ``mesh.model_parallel > 1`` raises.

    The resident loop's rhythm: resume from ``<model_dir>/tiered_ckpt``
    or start a virtual table in the cold root (``model.tiered_cold_url``,
    default ``<model_dir>/cold``); the feed passes over the batches the
    checkpoint trained on, its reader thread hands each batch's ids to
    the trainer's cold-to-host prefetch (``observer``) ahead of the step;
    a streaming paged checkpoint every ``run.checkpoint_every_steps`` and
    at the end (a signal stops the loop, saves, logs ``preempted`` and
    raises PreemptedError); then ``publish_tiered`` into
    ``run.servable_model_dir`` when it is set (a ``publish_tiered``
    event), and a ``tiered_done`` event (step, steps, examples/s, the hit
    rate and the paging bytes).  Returns the final paged state."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or cfg.mesh.model_parallel > 1:
        raise RuntimeError(
            "tiered embeddings are single-process, model_parallel=1 (the hot "
            "cache lives on one card); drop the mesh flags or use the resident "
            "row-sharded path")
    from ..tiered import TieredTrainer

    log = log or MetricLogger(log_steps=cfg.run.log_steps)
    maybe_clear(cfg.run.model_dir, cfg.run.clear_existing_model)
    ckpt_dir = os.path.join(cfg.run.model_dir, "tiered_ckpt")
    cold_root = cfg.model.tiered_cold_url or os.path.join(cfg.run.model_dir, "cold")
    with PreemptionGuard() as guard:
        if os.path.exists(os.path.join(ckpt_dir, "tiered_meta.json")):
            trainer = TieredTrainer.restore(cfg, ckpt_dir, virtual=True, device=device)
            log.event("resume", step=trainer.state.step)
        else:
            trainer = TieredTrainer.create_virtual(cfg, cold_root, device=device)
        with trainer:
            step0 = step = trainer.state.step
            log.seed_step(step)
            batches = make_input_pipeline(cfg.data, field_size=cfg.model.field_size,
                                          seed=cfg.run.seed, skip_batches=step,
                                          permute_vocab=_permute_vocab(cfg))
            every = cfg.run.checkpoint_every_steps
            examples = 0
            t0 = time.perf_counter()
            with Prefetcher(_observed(batches, trainer.observer()),
                            depth=cfg.data.prefetch_batches) as feed:
                for batch in feed:
                    if guard.should_stop:
                        break
                    metrics = trainer.train_batch(batch)
                    step = trainer.state.step
                    b = int(batch["label"].shape[0])
                    examples += b
                    log.step(step, b, metrics)
                    if every and step % every == 0:
                        trainer.save(ckpt_dir)
            seconds = time.perf_counter() - t0
            trainer.save(ckpt_dir)
            if guard.should_stop:
                log.event("preempted", step=step)
                raise PreemptedError(f"preempted at step {step}")
            if cfg.run.servable_model_dir:
                from ..online.publisher import ModelPublisher

                manifest = ModelPublisher(
                    cfg.run.servable_model_dir, keep=cfg.run.keep_checkpoints,
                    keep_window=cfg.regions.publish_keep_window,
                ).publish_tiered(cfg, trainer)
                log.event("publish_tiered", version=manifest.version, step=manifest.step)
            pager = trainer.paging_snapshot()["pager"]
            log.event("tiered_done", step=step, steps=step - step0,
                      examples_per_sec=examples / max(seconds, 1e-9),
                      hit_rate=pager["hit_rate"], stage_bytes=pager["stage_bytes"],
                      writeback_bytes=pager["writeback_bytes"])
            return trainer.state


def _restored(cfg: Config, ctx: DistContext) -> TrainState:
    """A fresh train state with the latest checkpoint of ``run.model_dir``
    loaded; raises FileNotFoundError without one."""
    return make_checkpointer(cfg.run.model_dir, ctx=ctx).restore(
        spmd.create_dp_train_state(cfg, ctx))


def run_eval_task(cfg: Config, *, device=None, log: MetricLogger | None = None) -> dict:
    """The eval task: the latest checkpoint's AUC and loss over the
    validation files (an ``eval`` event), on every rank of the group."""
    ctx = initialize_distributed(cfg.mesh, device)
    try:
        state = _restored(cfg, ctx)
        log = log or (MetricLogger() if ctx.rank == 0 else None)
        return run_eval(state.model, cfg, log=log, ctx=ctx)
    finally:
        shutdown(ctx)


def run_infer(cfg: Config, *, device=None, output_path: str | None = None,
              log: MetricLogger | None = None) -> str:
    """The infer task: the latest checkpoint's probability for every
    ``te*``/``test*`` record under ``data.test_data_dir`` (else
    ``data.val_data_dir``), or, where there is none, every ``va*``/``val*``
    record, one a line in file order, to ``output_path`` (default
    ``pred.txt`` in that directory); returns the path.  In a group only
    data index 0's model group scores, every rank of it every record (they
    assemble the rows of each batch together), and rank 0 alone writes, so
    each record is scored once into the file; the other ranks return after
    the restore, the last collective of the whole group."""
    ctx = initialize_distributed(cfg.mesh, device)
    try:
        state = _restored(cfg, ctx)
        base = cfg.data.test_data_dir or cfg.data.val_data_dir
        patterns = ("te", "test")
        if not discover_files(base, patterns, shuffle=False):
            patterns = ("va", "val")
        out = output_path or os.path.join(base, "pred.txt")
        if ctx.data_index != 0:
            return out
        dev = state.model.fm_v.device
        batches = eval_batches(cfg.data, field_size=cfg.model.field_size, data_dir=base,
                               patterns=patterns, permute_vocab=_permute_vocab(cfg))
        probs = (predict_step(state.model, to_device(b, dev)).cpu().numpy()
                 for b in _tensors(batches))
        if ctx.rank != 0:
            for _ in probs:
                pass
            return out
        n = write_predictions(probs, out)
        (log or MetricLogger()).event("infer", path=out, examples=n)
        return out
    finally:
        shutdown(ctx)


def run_export(cfg: Config, *, device=None, log: MetricLogger | None = None) -> str:
    """The export task: the latest checkpoint as a servable in
    ``run.servable_model_dir``; returns its path."""
    ctx = initialize_distributed(cfg.mesh, device)
    try:
        state = _restored(cfg, ctx)
        path = _export(state, cfg, ctx, cfg.run.servable_model_dir)
        if ctx.rank == 0:
            (log or MetricLogger()).event("export", path=path)
        return path
    finally:
        shutdown(ctx)


def pool_argv(cfg: Config, *, device=None) -> list[str]:
    """The shard-group pool's command line for the serve task (JAX
    ``train/loop.py``'s argv for ``serve/pool/__main__.py main``)."""
    r = cfg.run
    argv = ["--servable", r.servable_model_dir, "--router",
            "--groups", str(r.serve_groups),
            "--group-dp", str(r.serve_group_data_parallel),
            "--group-mp", str(r.serve_group_model_parallel),
            "--port", str(r.serve_router_port), "--host", r.serve_host,
            "--buckets", r.serve_buckets, "--max-wait-ms", str(r.serve_max_wait_ms),
            "--retry-limit", str(r.serve_retry_limit),
            "--eject-after", str(r.serve_eject_after),
            "--health-interval", str(r.serve_health_interval_secs),
            "--device", str(device or "cuda")]
    if r.serve_reload_url:
        argv += ["--reload-url", r.serve_reload_url,
                 "--reload-interval", str(r.serve_reload_interval_secs)]
    if cfg.fleet.tenants:
        # the multi-tenant fleet: every member serves every tenant, the
        # router splits traffic and runs the shadow challengers
        argv += ["--tenants", json.dumps(list(cfg.fleet.tenants)),
                 "--shadow-sample", str(cfg.fleet.shadow_sample_percent),
                 "--shadow-queue", str(cfg.fleet.shadow_queue_depth)]
    if r.funnel_top_k:
        argv += ["--funnel-top-k", str(r.funnel_top_k)]
    if r.funnel_return_n:
        argv += ["--funnel-return-n", str(r.funnel_return_n)]
    if r.funnel_retrieval != "exact":
        argv += ["--funnel-retrieval", r.funnel_retrieval]
    if r.funnel_oversample != 4:
        argv += ["--funnel-oversample", str(r.funnel_oversample)]
    if r.funnel_pallas != "auto":
        argv += ["--funnel-pallas", r.funnel_pallas]
    if cfg.flywheel.enabled:
        fw = cfg.flywheel
        argv += ["--flywheel-log", fw.impression_log_url,
                 "--flywheel-sample", str(fw.sample_rate),
                 "--flywheel-roll-bytes", str(fw.segment_roll_bytes),
                 "--flywheel-roll-age", str(fw.segment_roll_age_secs),
                 "--flywheel-queue", str(fw.queue_depth)]
        if fw.join_output_url:
            argv += ["--flywheel-join-out", fw.join_output_url]
    return argv


def run_serve(cfg: Config, *, device=None, ready=None) -> None:
    """The serve task, by JAX's dispatch: ``run.serve_groups > 0`` runs the
    router-fronted shard-group pool (``serve/pool/__main__.py main`` with
    :func:`pool_argv`), ``run.serve_workers > 1`` the process pool
    (``serve/server.py serve_pool``), anything else ``serve_forever`` over
    ``run.servable_model_dir`` with the ``run.serve_*`` fields, until the
    process stops.  Over a funnel servable the ``run.funnel_*`` fields
    that are not at their defaults override its funnel.json (JAX's
    convention: top_k/return_n 0, retrieval "exact" and oversample 4
    defer to it), its index shards over ``mesh.model_parallel``, and
    ``run.serve_reload_url`` hot-swaps ``FunnelPublisher`` versions; on
    another servable a funnel field raises.  ``ready`` as in
    ``serve_forever`` (and ``serve_pool``)."""
    from ..funnel.publish import is_funnel_servable
    from ..serve import server

    r = cfg.run
    if r.serve_groups > 0:
        from ..serve.pool.__main__ import main as pool_main

        pool_main(pool_argv(cfg, device=device))
        return
    funnel = {k: v for k, v, default in (("top_k", r.funnel_top_k, 0),
                                         ("return_n", r.funnel_return_n, 0),
                                         ("retrieval", r.funnel_retrieval, "exact"),
                                         ("oversample", r.funnel_oversample, 4))
              if v != default}
    if is_funnel_servable(r.servable_model_dir) and cfg.mesh.model_parallel > 1:
        # the index shards over the mesh's model axis, as core/config.py
        # _check_funnel validates it
        funnel["model_parallel"] = cfg.mesh.model_parallel
    kw = dict(port=r.serve_port, host=r.serve_host, buckets=r.serve_buckets,
              max_wait_ms=r.serve_max_wait_ms, item_corpus=r.serve_item_corpus or None,
              reload_url=r.serve_reload_url or None,
              reload_interval_secs=r.serve_reload_interval_secs, device=device,
              ready=ready, funnel=funnel or None)
    if r.serve_workers > 1:
        server.serve_pool(r.servable_model_dir, workers=r.serve_workers, **kw)
        return
    server.serve_forever(r.servable_model_dir, **kw)


def run_online(cfg: Config, *, device=None) -> TrainState:
    """The online-train task (``online/trainer.py run_online_train``): tail
    the event log at ``data.training_data_dir``, committing into
    ``run.model_dir`` and publishing versions into
    ``run.servable_model_dir`` for a hot-reloading server; with
    ``elastic.enabled`` the elastic trainer on a grid of ranks
    (``elastic/controller.py run_elastic_train``)."""
    if cfg.elastic.enabled:
        from ..elastic.controller import run_elastic_train

        return run_elastic_train(cfg, device=device)
    from ..online.trainer import run_online_train

    return run_online_train(cfg, device=device)


def run_feedback(cfg: Config, *, device=None) -> TrainState:
    """The feedback-train task: the same online trainer on the flywheel's
    delayed-label join output (``flywheel.join_output_url``, which the
    config requires) instead of a hand-fed event log."""
    return run_online(cfg.with_overrides(data={"training_data_dir": cfg.flywheel.join_output_url},
                                         run={"task_type": "online-train"}), device=device)


def run_publish(cfg: Config, *, device=None):
    """The publish task (``elastic/mpmd.py run_publisher``): tail
    ``run.model_dir``'s committed payloads and publish each into
    ``run.servable_model_dir`` under its own lease and fence.  Host-side:
    it needs no card."""
    from ..elastic.mpmd import run_publisher

    return run_publisher(cfg)


# -- the two-tower family's tasks (JAX train/loop.py:568-738) -------------------

def _retrieval_batches(cfg: Config, sharding, data_dir: str, *, num_epochs: int,
                       shuffle: bool) -> Iterator[dict]:
    """The ratings under ``data_dir`` as global batches of
    ``data.batch_size`` (data/ratings.py ``RatingsDataset``), after JAX's
    checks of the whole file against both vocabularies: the step then
    needs no range check of its own."""
    from ..data.ratings import RatingsDataset

    ds = RatingsDataset.from_path(data_dir)
    true_u, true_i = (sharding.true_vocab[k] for k in ("user_embedding", "item_embedding"))
    max_u, max_i = ds.max_ids()
    if max_u >= true_u or max_i >= true_i:
        raise ValueError(
            f"ratings ids exceed configured vocabs: max user {max_u} vs "
            f"user_vocab_size {true_u}, max item {max_i} vs "
            f"item_vocab_size {true_i} — set model.user_vocab_size/"
            f"model.item_vocab_size")
    min_u, min_i = ds.min_ids()
    if min_u < 0 or min_i < 0:
        raise ValueError(
            f"ratings contain negative ids (min user {min_u}, min item {min_i})")
    return ds.batches(cfg.data.batch_size, num_epochs=num_epochs, shuffle=shuffle,
                      seed=cfg.run.seed)


def _retrieval_checkpointer(cfg: Config, ctx: DistContext, **kw):
    from ..parallel.retrieval import checkpoint_context

    return make_checkpointer(cfg.run.model_dir, ctx=checkpoint_context(ctx), **kw)


def _retrieval_restored(cfg: Config, ctx: DistContext):
    from ..parallel.retrieval import create_retrieval_dp_state

    return _retrieval_checkpointer(cfg, ctx).restore(create_retrieval_dp_state(cfg, ctx))


def run_retrieval_eval(cfg: Config, state: TrainState, ctx: DistContext,
                       log: MetricLogger | None = None) -> dict:
    """The two-tower eval (JAX ``run_retrieval_eval``): the mean
    in-batch-softmax loss, top-1 accuracy and recall@10 over the full
    batches of the validation ratings (the remainder dropped: the candidate
    pool keeps one size); fewer rows than one batch raise."""
    from ..parallel import retrieval

    sums: dict[str, float] = {}
    batches = 0
    for batch in _retrieval_batches(cfg, state.sharding, cfg.data.val_data_dir,
                                    num_epochs=1, shuffle=False):
        m = retrieval.eval_step(state, retrieval.local_batch(batch, ctx), ctx)
        batches += 1
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + v
    if not batches:
        raise ValueError(
            f"validation ratings under {cfg.data.val_data_dir!r} have fewer "
            f"rows than one batch ({cfg.data.batch_size}) — nothing to eval")
    result = {"loss": sums["loss"] / batches, "top1_acc": sums["top1_acc"] / batches,
              "recall_at_10": sums["recall_at_10"] / batches, "examples": sums["count"]}
    if log is not None:
        log.event("eval", **result)
    return result


def _retrieval_export(state: TrainState, ctx: DistContext, path: str) -> str:
    """The two-tower servable at ``path`` (its config with the padded
    vocabularies, as JAX exports its context's), written by rank 0 after
    the tables are gathered."""
    from ..parallel.retrieval import servable_state_dict

    sd = servable_state_dict(state)
    if ctx.rank == 0:
        path = export_servable(state.model.cfg, sd, path)
    return path


def run_retrieval_train(cfg: Config, *, device=None,
                        log: MetricLogger | None = None) -> TrainState:
    """The two-tower train task (JAX ``run_retrieval_train``): ratings in,
    in-batch-softmax steps (parallel/retrieval.py, on each rank of a grid),
    a checkpoint every ``run.checkpoint_every_steps`` and at the end, a
    resume that skips the batches the checkpoint trained on (the ratings
    stream is seed-deterministic), then the eval over ``data.val_data_dir``
    and the export.  A signal saves, logs ``preempted`` and raises
    PreemptedError."""
    with PreemptionGuard() as guard:
        ctx = initialize_distributed(cfg.mesh, device)
        try:
            return _retrieval_train(cfg, ctx, log, guard)
        finally:
            shutdown(ctx)


def _retrieval_train(cfg: Config, ctx: DistContext, log, guard) -> TrainState:
    from ..parallel import retrieval

    log = _Silent() if ctx.rank != 0 else log or MetricLogger(log_steps=cfg.run.log_steps)
    if cfg.run.clear_existing_model:
        if ctx.rank == 0:
            maybe_clear(cfg.run.model_dir, True)
        if ctx.group is not None:
            dist.barrier(group=ctx.group)
    ckpt = _retrieval_checkpointer(cfg, ctx, max_to_keep=cfg.run.keep_checkpoints)
    state = retrieval.create_retrieval_dp_state(cfg, ctx)
    if ckpt.latest_step() is not None:
        ckpt.restore(state)
        log.event("resume", step=state.step)
    log.seed_step(state.step)
    batches = iter(())
    if not guard.should_stop:  # a signal during setup skips loading the ratings
        batches = itertools.islice(
            _retrieval_batches(cfg, state.sharding, cfg.data.training_data_dir,
                               num_epochs=cfg.data.num_epochs, shuffle=True),
            state.step, None)
    every = cfg.run.checkpoint_every_steps
    steps = examples = 0
    stop = False
    dev = state.model.user_embedding.device
    t0 = time.perf_counter()
    for batch in batches:
        metrics = retrieval.train_step(state, retrieval.local_batch(batch, ctx), ctx,
                                       stop=guard.should_stop)
        stop = metrics.pop("any_stop")
        b = int(np.asarray(batch["user_ids"]).shape[0])
        steps += 1
        examples += b
        log.step(state.step, b, metrics)
        if every and state.step % every == 0:
            ckpt.save(state)
        if stop:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    loop_s = time.perf_counter() - t0
    log.event("train_done", step=state.step, steps=steps, world_size=ctx.world_size,
              examples=examples, seconds=loop_s,
              examples_per_sec=examples / loop_s if loop_s > 0 else 0.0)
    ckpt.save(state)
    if stop or guard.should_stop:
        log.event("preempted", step=state.step)
        ckpt.close()
        raise PreemptedError(f"preempted at step {state.step}")
    if cfg.data.val_data_dir:
        run_retrieval_eval(cfg, state, ctx, log)
    if cfg.run.servable_model_dir:
        path = _retrieval_export(state, ctx, cfg.run.servable_model_dir)
        log.event("export", path=path)
    ckpt.close()
    return state


def run_retrieval_task(cfg: Config, *, device=None):
    """Two-tower task dispatch (JAX ``run_retrieval_task``): train, eval or
    export from the latest checkpoint; infer is refused (it has no meaning
    without a candidate corpus to rank: use eval, or load the servable and
    encode corpora)."""
    task = cfg.run.task_type
    if task == "train":
        return run_retrieval_train(cfg, device=device)
    if task not in ("eval", "export"):
        raise ValueError(f"task_type {task!r} unsupported for two_tower (train|eval|export)")
    ctx = initialize_distributed(cfg.mesh, device)
    try:
        state = _retrieval_restored(cfg, ctx)
        if task == "eval":
            return run_retrieval_eval(cfg, state, ctx,
                                      MetricLogger() if ctx.rank == 0 else None)
        path = _retrieval_export(state, ctx, cfg.run.servable_model_dir)
        if ctx.rank == 0:
            MetricLogger().event("export", path=path)
        return path
    finally:
        shutdown(ctx)


def run_region_front(cfg: Config, *, device=None) -> None:
    """The ``region-front`` task (JAX ``train/loop.py``): the manifest
    replicator tailing ``regions.home_root`` into every region store and
    the front (home-region routing, the staleness drain, budgeted
    failover), until the process stops.  Host-only: ``device`` is not
    read; each region's pool is a ``serve`` task of its own."""
    from ..region import run_region_front as run_front

    return run_front(cfg)


TASKS = {"train": run_train, "eval": run_eval_task, "infer": run_infer,
         "export": run_export, "serve": run_serve,
         "online-train": run_online, "online_train": run_online,
         "feedback-train": run_feedback, "feedback_train": run_feedback,
         "publish": run_publish,
         "region-front": run_region_front, "region_front": run_region_front}


# the tasks that dispatch on their own, whatever the family (JAX's run_task
# reaches the two-tower dispatch after them)
NON_MODEL_TASKS = ("serve", "online-train", "online_train", "feedback-train",
                   "feedback_train", "publish", "region-front", "region_front")


def run_task(cfg: Config, *, device=None):
    """Run ``cfg.run.task_type`` (train, eval, infer, export, serve,
    online-train, feedback-train, publish or region-front); returns the task's result: the train
    state, the eval metrics, the pred.txt path or the servable path (serve
    blocks and returns None).  The two-tower family's train, eval and
    export are :func:`run_retrieval_task`'s."""
    task = cfg.run.task_type
    if cfg.model.model_name == "two_tower" and task not in NON_MODEL_TASKS:
        return run_retrieval_task(cfg, device=device)
    if task not in TASKS:
        raise ValueError(f"unknown task_type {task!r} ({'|'.join(TASKS)})")
    return TASKS[task](cfg, device=device)
