"""Rank bodies for tests/test_torch_dist.py, started with
``torch.multiprocessing`` (spawn).  This module imports no JAX: each rank
joins a gloo group over a ``FileStore``, runs the port and writes what it
saw with ``torch.save`` for the parent to compare."""

import io
import os

import torch
import torch.distributed as dist


def _join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


def dp_steps(rank: int, world: int, store: str, out: str, cfg_dict: dict,
             weights: dict, batches: list) -> None:
    """Data-parallel steps on this rank's contiguous slice of each global
    batch, from ``weights``; rank 1 draws its init from another seed, so
    the broadcast is what makes the ranks start equal."""
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.parallel import spmd
    from deepfm_tpu_torch.parallel.mesh import initialize_distributed

    _join(rank, world, store)
    try:
        cfg = Config.from_dict(cfg_dict)
        if rank == 1:
            cfg = cfg.with_overrides(run={"seed": cfg.run.seed + 99})
        ctx = initialize_distributed(cfg.mesh, "cpu")
        state = spmd.create_dp_train_state(cfg, ctx)
        init = {k: v.clone() for k, v in state.model.state_dict().items()}
        state.model.load_state_dict(weights)
        metrics = []
        for batch in batches:
            n = batch["label"].shape[0] // world
            local = {k: torch.from_numpy(v[rank * n:(rank + 1) * n]) for k, v in batch.items()}
            m = spmd.train_step(state, local, ctx)
            metrics.append({k: float(v) for k, v in m.items()})
        lazy_error = None
        try:
            spmd.create_dp_train_state(
                cfg.with_overrides(optimizer={"lazy_embedding_updates": True},
                                   model={"fused_kernel": "auto"}), ctx)
        except ValueError as e:
            lazy_error = str(e)
        torch.save({"init": init, "final": state.model.state_dict(),
                    "slots": state.optimizer.slots, "count": state.optimizer.count,
                    "lr": state.optimizer.lr, "metrics": metrics,
                    "generator_seed": state.generator.initial_seed(),
                    "lazy_error": lazy_error}, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_train_files(rank: int, world: int, store: str, out: str, argv: list) -> None:
    """The CLI's train task through ``run_task`` on this rank, its log (rank
    0's) and final weights saved."""
    from deepfm_tpu_torch.launch.cli import resolve_config
    from deepfm_tpu_torch.train.loop import run_train
    from deepfm_tpu_torch.utils.logging import MetricLogger

    _join(rank, world, store)
    try:
        cfg, _ = resolve_config(argv)
        stream = io.StringIO()
        state = run_train(cfg, device="cpu",
                          log=MetricLogger(log_steps=cfg.run.log_steps, stream=stream))
        torch.save({"log": stream.getvalue(), "final": state.model.state_dict(),
                    "step": state.step}, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _state_tensors(state) -> dict:
    """Every tensor a resume must restore, by name, the generator's too."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for name, slots in state.optimizer.slots.items():
        out.update({f"opt.{name}.{s}": t for s, t in slots.items()})
    out["generator"] = state.generator.get_state()
    return out


def dp_lifecycle(rank: int, world: int, store: str, out: str, argv: list,
                 stop_rank: int, stop_after: int) -> None:
    """The CLI's train task three times in one group: uninterrupted in
    ``<out>/whole``, evaluating after every step by rank 0's clock while
    the other ranks' clocks stand still; then in ``<out>/split``, stopped
    by a SIGTERM that only rank ``stop_rank`` receives, after its step
    ``stop_after``; then the same command again, which resumes.  Saves
    each run's end and how many evals each rank ran."""
    import signal
    import time

    from deepfm_tpu_torch.launch import cli
    from deepfm_tpu_torch.launch.preemption import PreemptedError
    from deepfm_tpu_torch.parallel import spmd
    from deepfm_tpu_torch.train import loop

    real_step, real_eval, real_time = spmd.train_step, loop.run_eval, time.time
    evals = []

    def counted_eval(*a, **kw):
        evals.append(1)
        return real_eval(*a, **kw)

    def step_then_signal(state, *a, **kw):
        metrics = real_step(state, *a, **kw)
        if rank == stop_rank and state.step == stop_after:
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics

    _join(rank, world, store)
    try:
        result = {}
        whole = argv + ["--model_dir", os.path.join(out, "whole"), "--device", "cpu"]
        split = argv + ["--model_dir", os.path.join(out, "split"), "--device", "cpu"]
        loop.run_eval = counted_eval
        if rank != 0:
            time.time = lambda: 0.0
        try:
            result["whole"] = _state_tensors(cli.run(
                whole + ["--set", "run.eval_throttle_secs=1e-9"]))
        finally:
            loop.run_eval, time.time = real_eval, real_time
        result["evals"] = len(evals)
        spmd.train_step = step_then_signal
        try:
            cli.run(split)
            result["preempted"] = None
        except PreemptedError as e:
            result["preempted"] = str(e)
        finally:
            spmd.train_step = real_step
        state = cli.run(split)
        result["resumed"] = _state_tensors(state)
        result["step"] = state.step
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
