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


# -- the [data x model] grid (tests/test_torch_sharded.py, test_torch_zero.py) --

def _grid(cfg):
    """This rank's grid context for ``cfg.mesh`` (new groups each call)."""
    from deepfm_tpu_torch.parallel.mesh import initialize_distributed

    return initialize_distributed(cfg.mesh, "cpu")


def load_weights(state, weights: dict) -> None:
    """Whole (padded) weights into a grid state: each rank its rows."""
    sh = state.sharding
    keys = sh.sharded_keys(weights) if sh is not None else ()
    state.model.load_state_dict({
        n: torch.as_tensor(t)[sh.offset:sh.offset + sh.rows] if n in keys
        else torch.as_tensor(t) for n, t in weights.items()})


def _local_batch(batch: dict, ctx) -> dict:
    """The data index's contiguous slice of a global numpy batch."""
    n = batch["label"].shape[0] // ctx.data_parallel
    lo = ctx.data_index * n
    return {k: torch.from_numpy(v[lo:lo + n]) for k, v in batch.items()}


def grid_exchange(rank: int, world: int, store: str, out: str, jobs: list) -> None:
    """Per job (``mp``, whole ``table``, global ``ids`` and the ``modes``
    as (exchange, table_grad, capacity)): this rank's assembled rows of its
    data index's ids and its shard's gradient of ½Σrows², for the 2-D table
    and its first column as a 1-D table, plus the psum fallbacks taken."""
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.parallel import embedding as E

    _join(rank, world, store)
    try:
        results = []
        for job in jobs:
            ctx = _grid(Config.from_dict({"mesh": {"model_parallel": job["mp"]}}))
            axis = E.ModelAxis(ctx.model_group, ctx.model_parallel, ctx.model_index)
            table = torch.from_numpy(job["table"])
            rows = table.shape[0] // ctx.model_parallel
            n = job["ids"].shape[0] // ctx.data_parallel
            ids = torch.from_numpy(job["ids"][ctx.data_index * n:(ctx.data_index + 1) * n])
            got = {}
            for mode in job["modes"]:
                exchange, table_grad, capacity = mode
                E.reset_counters()
                for name, t in (("v", table), ("w", table[:, 0].contiguous())):
                    local = t[ctx.model_index * rows:(ctx.model_index + 1) * rows]
                    local = local.clone().requires_grad_()
                    out_rows = E.sharded_lookup(local, ids, axis, table_grad=table_grad,
                                                exchange=exchange, capacity=capacity)
                    (g,) = torch.autograd.grad((out_rows * out_rows * 0.5).sum(), [local])
                    got[(mode, name)] = (out_rows.detach(), g)
                got[(mode, "fallbacks")] = E.counters["fallbacks"]
            results.append({"data_index": ctx.data_index, "model_index": ctx.model_index,
                            "rows": rows, "got": got})
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _cloned(tree):
    """A copy of every tensor of a nested dict (``full_state`` hands back
    live tensors, which the next step updates in place)."""
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def grid_steps(rank: int, world: int, store: str, out: str, jobs: list) -> None:
    """Per job (a ``cfg`` dict whose mesh names the grid; whole ``weights``,
    or a JAX train state as numpy to carry over with ``convert``, or
    neither for the state's own; global ``batches``): the grid state,
    ``len(batches)`` steps on this data index's slice, then the metrics,
    the one-card layout (``full_state``) before and after, this rank's
    leaves, optimizer plans and slots, and its exchange counters."""
    from deepfm_tpu_torch.convert import train_state_from_jax
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.parallel import embedding as E
    from deepfm_tpu_torch.parallel import spmd

    _join(rank, world, store)
    try:
        results = []
        for job in jobs:
            cfg = Config.from_dict(job["cfg"])
            ctx = _grid(cfg)
            if job.get("jax_state") is not None:
                state = train_state_from_jax(job["jax_state"], cfg, "cpu", ctx=ctx)
            else:
                state = spmd.create_dp_train_state(cfg, ctx)
            if job.get("weights") is not None:
                load_weights(state, job["weights"])
            carried = _cloned(spmd.full_state(state))
            E.reset_counters()
            spmd.lazy_updates.update(dedup=0, full=0)
            metrics, error = [], None
            try:
                for batch in job["batches"]:
                    m = spmd.train_step(state, _local_batch(batch, ctx), ctx)
                    metrics.append({k: float(v) for k, v in m.items()})
            except ValueError as e:  # every rank refuses at the same step
                error = str(e)
            plans = getattr(state.optimizer, "plans", None)
            results.append({
                "metrics": metrics, "error": error,
                "full": spmd.full_state(state), "carried": carried,
                "local": {k: v.clone() for k, v in state.model.state_dict().items()},
                "counters": dict(E.counters), "lazy_updates": dict(spmd.lazy_updates),
                "step": state.step,
                "exchange": state.sharding.exchange if state.sharding else None,
                "plans": plans, "slots": {n: {s: t.clone() for s, t in d.items()}
                                          for n, d in state.optimizer.slots.items()},
                "grid": [ctx.data_index, ctx.model_index],
                "generator": state.generator.get_state()})
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def grid_eval_infer(rank: int, world: int, store: str, out: str, cfg_dict: dict,
                    weights: dict) -> None:
    """The grid's eval over the validation files and, from a checkpoint of
    the same weights, the infer task: what each rank saw, and how many
    batches it scored."""
    from deepfm_tpu_torch.checkpoint import Checkpointer
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.parallel import spmd
    from deepfm_tpu_torch.train import loop
    from deepfm_tpu_torch.train.loop import run_eval, run_infer

    scored = []
    predict_step = loop.predict_step

    def counted_predict(*a, **kw):
        scored.append(1)
        return predict_step(*a, **kw)

    loop.predict_step = counted_predict
    _join(rank, world, store)
    try:
        cfg = Config.from_dict(cfg_dict)
        ctx = _grid(cfg)
        state = spmd.create_dp_train_state(cfg, ctx)
        load_weights(state, weights)
        ev = run_eval(state.model, cfg, ctx=ctx)
        ckpt = Checkpointer(cfg.run.model_dir, ctx=ctx)
        ckpt.save(state, block=True)
        dist.barrier()
        path = run_infer(cfg, device="cpu", output_path=os.path.join(out, "pred.txt"))
        torch.save({"eval": ev, "pred": path, "data_index": ctx.data_index,
                    "scored": len(scored)}, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _table_rows(tree, found: list, path: str = "") -> None:
    """Append ``(path, rows)`` for every fm_w/fm_v leaf of a nested tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _table_rows(v, found, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _table_rows(v, found, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor) and {"fm_w", "fm_v"} & set(path.split(".")):
        found.append((path, int(tree.shape[0])))


class _Recorder:
    """While active: every table leaf that ``torch.save`` writes or
    ``torch.load`` returns, and the output rows of every all-gather over
    the model group."""

    def __init__(self, model_group):
        self.tables, self.model_gathers = [], []
        self._group = model_group
        self._saved = {}

    def __enter__(self):
        import torch.distributed as d

        originals = {"save": torch.save, "load": torch.load,
                     "agt": d.all_gather_into_tensor, "ag": d.all_gather}
        self._saved = originals

        def save(obj, f, *a, **kw):
            _table_rows(obj, self.tables, "save")
            return originals["save"](obj, f, *a, **kw)

        def load(f, *a, **kw):
            out = originals["load"](f, *a, **kw)
            _table_rows(out, self.tables, "load")
            return out

        def agt(output, input, group=None, **kw):
            if group is self._group:
                self.model_gathers.append(tuple(output.shape))
            return originals["agt"](output, input, group=group, **kw)

        def ag(outputs, input, group=None, **kw):
            if group is self._group:
                self.model_gathers.append(tuple(input.shape))
            return originals["ag"](outputs, input, group=group, **kw)

        torch.save, torch.load = save, load
        d.all_gather_into_tensor, d.all_gather = agt, ag
        return self

    def __exit__(self, *exc):
        import torch.distributed as d

        o = self._saved
        torch.save, torch.load = o["save"], o["load"]
        d.all_gather_into_tensor, d.all_gather = o["agt"], o["ag"]


def _flat(tree, path: str = "") -> dict:
    """Every tensor and number of a nested tree by its path, cloned."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}.{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {path: tree.detach().clone()}
    return {path: tree}


def grid_ckpt(rank: int, world: int, store: str, out: str, jobs: list) -> None:
    """Per job (a ``cfg`` dict whose mesh names the grid, global
    ``batches``, a checkpoint ``dir``, ``legacy`` to write the grid's first
    layout instead, ``drop`` a row file to delete before the restore,
    ``restore_mp`` another model_parallel to restore onto): the steps, a
    save through ``Checkpointer`` under the recorder, a restore into a
    fresh state (another seed) under the recorder, and this rank's state
    before and after, its row file, and the restore's error, if any."""
    from deepfm_tpu_torch.checkpoint import Checkpointer
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.parallel import spmd

    _join(rank, world, store)
    try:
        results = []
        for job in jobs:
            cfg = Config.from_dict(job["cfg"])
            ctx = _grid(cfg)
            state = spmd.create_dp_train_state(cfg, ctx)
            for batch in job["batches"]:
                spmd.train_step(state, _local_batch(batch, ctx), ctx)
            saved = _flat({"state": spmd.local_state(state), "step": state.step,
                           "generator": state.generator.get_state()})
            ckpt = Checkpointer(job["dir"], ctx=ctx)
            with _Recorder(ctx.model_group) as on_save:
                if job.get("legacy"):  # the layout of the grid's first release
                    full = spmd.full_state(state)
                    gens = ckpt._generator_states(state)
                    if rank == 0:
                        os.makedirs(os.path.join(job["dir"], str(state.step)))
                        torch.save({"step": state.step, **full, "generators": gens,
                                    "world_size": world,
                                    "grid": [ctx.data_parallel, ctx.model_parallel]},
                                   os.path.join(job["dir"], str(state.step), "state.pt"))
                else:
                    wrote = ckpt.save(state)
                    ckpt.close()
            dist.barrier()
            step_dir = os.path.join(job["dir"], str(state.step))
            row_file = None
            sh = state.sharding
            if not job.get("legacy") and sh.mp > 1 and ctx.data_index == 0:
                row_file = _flat(torch.load(os.path.join(step_dir, f"rows-{ctx.model_index}.pt"),
                                            weights_only=True))
            files = sorted(os.listdir(step_dir))
            dist.barrier()
            if job.get("drop") and rank == 0:
                os.remove(os.path.join(step_dir, job["drop"]))
            dist.barrier()
            rcfg = cfg.with_overrides(run={"seed": cfg.run.seed + 5})
            if job.get("restore_mp"):
                rcfg = rcfg.with_overrides(mesh={"model_parallel": job["restore_mp"],
                                                 "data_parallel": -1})
                ctx = _grid(rcfg)
            fresh = spmd.create_dp_train_state(rcfg, ctx)
            error = None
            with _Recorder(ctx.model_group) as on_restore:
                try:
                    Checkpointer(job["dir"], ctx=ctx).restore(fresh)
                except (FileNotFoundError, NotImplementedError, ValueError) as e:
                    error = f"{type(e).__name__}: {e}"
            restored = _flat({"state": spmd.local_state(fresh), "step": fresh.step,
                              "generator": fresh.generator.get_state()})
            results.append({
                "grid": [ctx.data_index, ctx.model_index],
                "rows": sh.rows, "offset": sh.offset, "total_rows": sh.total_rows,
                "saved": saved, "restored": restored, "error": error,
                "wrote": None if job.get("legacy") else wrote, "files": files,
                "row_file": row_file,
                "save_tables": on_save.tables, "save_gathers": on_save.model_gathers,
                "restore_tables": on_restore.tables,
                "restore_gathers": on_restore.model_gathers})
            dist.barrier()
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
