"""Rank bodies of the port's elastic tests (tests/test_torch_elastic.py,
tests/test_torch_mpmd.py), started with ``torch.multiprocessing`` (spawn),
and the parent's harness: the rendezvous ``TCPStore``, the coordinator
and the device board in the test process, ``spawn_ranks`` to start and
reap the ranks.  This module imports no JAX.

A rank's ``job``: ``cfg`` (a config dict), ``device_id``, ``store`` and
``coord`` (addresses), ``script`` ({step: [action, ...]} run on this rank
right after that step's ``spmd.train_step``, which the rank wraps:
``("drop", ids)`` takes ids off the board, ``("grow", ids)`` puts them on
and releases the joiners, ``("kill", None)`` ends the process at once,
without notice), ``wait_for`` (a joiner waits for that file before it
starts), ``out`` (the result file)."""

import datetime
import os
import time

import torch


def _connect(addr: str):
    import torch.distributed as dist

    host, port = addr.rsplit(":", 1)
    return dist.TCPStore(host, int(port), is_master=False,
                         timeout=datetime.timedelta(seconds=60))


def _settle(trainer, epoch: int, timeout: float = 60.0) -> None:
    """Poll until this rank's registry left ``epoch`` (the coordinator saw
    the change), so that the next batch's agreement drains every rank."""
    deadline = time.monotonic() + timeout
    while trainer._current_epoch() == epoch:
        if time.monotonic() > deadline:
            raise TimeoutError(f"epoch {epoch} did not move in {timeout} s")
        time.sleep(0.02)


def elastic_rank(index: int, jobs: list) -> None:
    job = jobs[index]
    torch.set_num_threads(1)
    if job.get("wait_for"):
        while not os.path.exists(job["wait_for"]):
            time.sleep(0.02)
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.elastic.controller import ElasticTrainer
    from deepfm_tpu_torch.elastic.registry import DeviceBoard
    from deepfm_tpu_torch.parallel import spmd

    cfg = Config.from_dict(job["cfg"])
    store = _connect(job["store"])
    board = DeviceBoard(store)
    device = job.get("device", "cpu")
    if device == "cuda":
        torch.cuda.set_device(0)
    trainer = ElasticTrainer(cfg, device_id=job["device_id"], device=device, store=store)
    script = {int(k): v for k, v in job.get("script", {}).items()}
    kernel_err = []
    train_step = spmd.train_step

    def scripted_step(state, batch, ctx):
        epoch = int(trainer._m_epoch.value)
        if device == "cuda" and epoch not in {e for e, _ in kernel_err}:
            kernel_err.append((epoch, compact_kernel_errors(state, batch)))
        metrics = train_step(state, batch, ctx)
        for action, ids in script.pop(int(state.step), []):
            if action == "kill":
                os._exit(9)
            epoch = trainer._current_epoch()
            if action == "drop":
                board.remove(*ids)
            else:
                board.add(*ids)
                open(job["release"], "w").close()
            _settle(trainer, epoch)
        return metrics

    spmd.train_step = scripted_step
    result = {"device_id": job["device_id"], "error": None}
    try:
        state = trainer.run(follow=False)
        result.update(step=int(state.step))
    except Exception as e:  # reported to the parent
        import traceback

        result["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    finally:
        release = getattr(trainer.registry, "release", None)
        if release is not None:
            release()
    result.update(reshards=trainer.reshards, left=trainer.left, kernel_err=kernel_err,
                  lineage=[tuple(c) for c in trainer.cursor_lineage],
                  lifecycle=[e["kind"] for e in trainer.lifecycle],
                  metrics=trainer.metrics_snapshot())
    torch.save(result, job["out"])


def compact_kernel_errors(state, batch: dict) -> dict:
    """B1 and B1' on this step's compact rows (the exchange's on a grid)
    against their plain versions: ``(max abs error, largest magnitude)``
    of the forward's emb, y_w, y_v and of the backward's d_fm_w, d_fm_v.  On every rank of the group at once (the exchange is a
    collective)."""
    from deepfm_tpu_torch.ops import fused_ctr

    model = state.model
    with torch.no_grad():
        ids, vals = model.prepare(batch["feat_ids"], batch["feat_vals"])
        w_c, v_c, slot = model.sharded.lookup(model.fm_w, model.fm_v, ids)
    got = fused_ctr.fused_ctr_interaction(w_c, v_c, slot, vals)
    want = fused_ctr.fused_ctr_plain(w_c, v_c, slot, vals)
    g = torch.Generator(device=v_c.device).manual_seed(3)
    b, f = slot.shape
    cot = (torch.randn((b, f, v_c.shape[1]), generator=g, device=v_c.device),
           torch.randn((b,), generator=g, device=v_c.device),
           torch.randn((b,), generator=g, device=v_c.device))
    got_b = fused_ctr.fused_ctr_backward(*cot, w_c, v_c, slot, vals, False)
    want_b = fused_ctr.fused_ctr_backward_plain(*cot, w_c, v_c, slot, vals, False)
    return {key: [(float((a - w).abs().max()), float(w.abs().max())) for a, w in pairs]
            for key, pairs in (("forward", zip(got, want)),
                               ("backward", zip(got_b[:2], want_b[:2])))}


class Harness:
    """The job's shared services in the test process: a ``TCPStore``
    (master), the coordinator over HTTP and the device board."""

    def __init__(self, ids, *, lease_ttl: float = 60.0):
        import torch.distributed as dist

        from deepfm_tpu_torch.elastic.coord import Coordinator, serve_coordinator
        from deepfm_tpu_torch.elastic.registry import DeviceBoard

        self.store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                                   timeout=datetime.timedelta(seconds=60))
        self.store_addr = f"127.0.0.1:{self.store.port}"
        self.server, self.coord_url, self.coord = serve_coordinator(
            Coordinator(lease_ttl_secs=lease_ttl, barrier_timeout_secs=0))
        self.board = DeviceBoard(self.store)
        self.board.write(ids)

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def start_ranks(jobs: list):
    """Start ``elastic_rank`` for every job; :func:`wait_ranks` reaps them."""
    import torch.multiprocessing as mp

    return mp.start_processes(elastic_rank, args=(jobs,), nprocs=len(jobs), join=False,
                              start_method="spawn")


def spawn_ranks(jobs: list, timeout: float = 150.0) -> list:
    """Run ``elastic_rank`` for every job and wait for all; returns each
    job's result (None for a process that wrote none: a killed rank)."""
    return wait_ranks(start_ranks(jobs), jobs, timeout)


def wait_ranks(ctx, jobs: list, timeout: float = 150.0) -> list:
    """Wait for the ranks ``start_ranks`` started (killing them after
    ``timeout``); returns each job's result, None where none was written."""
    import pytest

    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in ctx.processes):
            if time.monotonic() > deadline:
                pytest.fail(f"elastic ranks still running after {timeout} s")
            time.sleep(0.1)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(j["out"], weights_only=False) if os.path.exists(j["out"]) else None
            for j in jobs]


def reshard_save(rank: int, world: int, store: str, out: str, jobs: list) -> None:
    """Per job (``cfg`` whose mesh names the grid, global ``batches``,
    ``dir``, optional ``weights`` to start from): the steps, a save through
    ``Checkpointer``, and rank 0 writes the gathered state to
    ``dir/full.pt``."""
    import torch.distributed as dist

    from _torch_dist_worker import _grid, _join, _local_batch, load_weights
    from deepfm_tpu_torch.checkpoint import Checkpointer
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.parallel import spmd

    _join(rank, world, store)
    try:
        for job in jobs:
            cfg = Config.from_dict(job["cfg"])
            ctx = _grid(cfg)
            state = spmd.create_dp_train_state(cfg, ctx)
            if job.get("weights") is not None:
                load_weights(state, job["weights"])
            for batch in job["batches"]:
                spmd.train_step(state, _local_batch(batch, ctx), ctx)
            ckpt = Checkpointer(job["dir"], ctx=ctx)
            ckpt.save(state, block=True)
            full = spmd.full_state(state)
            if rank == 0:
                torch.save({"full": full, "step": state.step},
                           os.path.join(job["dir"], "full.pt"))
            dist.barrier()
        torch.save({}, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def reshard_restore(rank: int, world: int, store: str, out: str, jobs: list) -> None:
    """Per job (``cfg`` of the new grid, ``dir``): a restore into a fresh
    state (another seed) and this rank's local state, window and the
    slices the reshard copied."""
    import torch.distributed as dist

    from _torch_dist_worker import _grid, _join
    from deepfm_tpu_torch.checkpoint import Checkpointer, reshard
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.parallel import spmd

    _join(rank, world, store)
    try:
        results = []
        for job in jobs:
            cfg = Config.from_dict(job["cfg"])
            ctx = _grid(cfg)
            fresh = spmd.create_dp_train_state(cfg.with_overrides(run={"seed": 99}), ctx)
            ckpt = Checkpointer(job["dir"], ctx=ctx)
            ckpt.restore(fresh)
            sh = fresh.sharding
            results.append({"local": spmd.local_state(fresh), "step": fresh.step,
                            "offset": sh.offset if sh.mp > 1 else 0,
                            "rows": {k: getattr(fresh.model, k).shape[0]
                                     for k in ("fm_w", "fm_v") if hasattr(fresh.model, k)},
                            "resharded": ckpt.last_restore["resharded"],
                            "slices": list(reshard.last_restore["slices"]),
                            "tables": spmd.full_state(fresh)["model"] if job.get("gather")
                            else None})
            dist.barrier()
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
