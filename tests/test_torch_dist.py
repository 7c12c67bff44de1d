"""Data-parallel training in the port (parallel/, train/loop.py) against the
JAX package, on the CPU: ranks are processes started with
``torch.multiprocessing`` (spawn) in a gloo group over a ``FileStore`` in
``tmp_path`` (the rank bodies are in ``_torch_dist_worker.py``), at a
small width (V = 120, F = 6, K = 8, MLP 16/8, dropout off):

* 3 dense steps at world size 2, each rank taking its half of a global
  batch of 32, against JAX ``make_spmd_train_step`` on a ``[2, 1]`` mesh of
  the virtual CPU devices (``tests/conftest.py``), ``zero_sharding="off"``,
  batch norm off and on: the metrics (cross-rank means), the parameters,
  the Adam moments and the BN moving statistics; the ranks bit-identical
  to each other after init and after the steps; the lr scaled by the world
  size; lazy Adam at world size 2 refused;
* the train task over files whose shards differ by a batch ends on both
  ranks, under a timeout of its own, and its eval AUC over 2 ranks equals
  one process's over the whole validation set;
* ``shard_plan`` against JAX's over the whole file-mode matrix;
* ``python -m torch.distributed.run --nproc_per_node 2 -m
  deepfm_tpu_torch --task_type train --device cpu`` end to end.

Tolerances: those of ``tests/test_torch_train.py`` in float32 (metrics
1e-5 relative, parameters and moments 1e-5 absolute).  Rank against rank:
bit-equal.
"""

import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_worker as worker
from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.core.config import MeshConfig as JaxMeshConfig
from deepfm_tpu.data.sharding import WorkerTopology as JaxTopology
from deepfm_tpu.data.sharding import shard_plan as jax_shard_plan
from deepfm_tpu.parallel import build_mesh, create_spmd_state, make_context
from deepfm_tpu.parallel import make_spmd_train_step, shard_batch
from deepfm_tpu_torch.checkpoint import Checkpointer
from deepfm_tpu_torch.convert import _find_adam_state, params_from_jax
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.data.libsvm import generate_synthetic_ctr
from deepfm_tpu_torch.data.sharding import WorkerTopology, shard_plan, shard_records
from deepfm_tpu_torch.models.deepfm import DeepFM
from deepfm_tpu_torch.parallel.mesh import initialize_distributed
from deepfm_tpu_torch.train.loop import run_eval
from deepfm_tpu_torch.train.step import create_train_state

ROOT = Path(__file__).resolve().parent.parent
V, F, K, B, WORLD = 120, 6, 8, 32, 2
TIMEOUT_S = 120


def _spawn(fn, tmp_path, *args):
    """Run ``fn(rank, WORLD, store, out, *args)`` on WORLD spawned ranks;
    fail (and kill them) if they have not all ended within TIMEOUT_S."""
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    store = str(tmp_path / f"store-{fn.__name__}")
    ctx = mp.start_processes(fn, args=(WORLD, store, str(out), *args), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"{fn.__name__}: ranks still running after {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _config(batch_norm, **optimizer):
    return JaxConfig.from_dict({
        "model": dict(feature_size=V, field_size=F, embedding_size=K,
                      deep_layers=(16, 8), dropout_keep=(1.0, 1.0),
                      compute_dtype="float32", batch_norm=batch_norm,
                      fused_kernel="off", l2_reg=1e-3),
        "optimizer": {"zero_sharding": "off", "learning_rate": 1e-3, **optimizer},
        "data": {"batch_size": B // WORLD},
    })


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"feat_ids": rng.integers(0, V, (B, F)).astype(np.int64),
             "feat_vals": rng.random((B, F)).astype(np.float32),
             "label": (rng.random(B) < 0.3).astype(np.float32)} for _ in range(n)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("batch_norm", [False, True], ids=["bn_off", "bn_on"])
def test_dp_steps_match_make_spmd_train_step(tmp_path, batch_norm):
    jcfg = _config(batch_norm, scale_lr_by_data_parallel=True)
    mesh = build_mesh(JaxMeshConfig(data_parallel=WORLD, model_parallel=1),
                      devices=jax.devices()[:WORLD])
    jctx = make_context(jcfg, mesh)
    assert jctx.cfg.model.feature_size == V  # no pad rows at mp = 1
    jstate = create_spmd_state(jctx)
    cfg = Config.from_dict(jcfg.to_dict())
    weights = params_from_jax(_np(jstate.params), _np(jstate.model_state), cfg.model)
    step = make_spmd_train_step(jctx, donate=False)
    batches = _batches(3)
    jmetrics = []
    for batch in batches:
        jstate, jm = step(jstate, shard_batch(jctx, batch))
        jmetrics.append({k: float(jm[k]) for k in ("loss", "ce", "pred_mean",
                                                  "label_mean")})
    ranks = _spawn(worker.dp_steps, tmp_path, cfg.to_dict(), weights, batches)

    r0, r1 = ranks
    for name, t in r0["init"].items():  # rank 1 drew other weights; broadcast
        assert torch.equal(_bits(t), _bits(r1["init"][name])), name
    for name, t in r0["final"].items():
        assert torch.equal(_bits(t), _bits(r1["final"][name])), name
    assert r0["metrics"] == r1["metrics"]
    assert r0["generator_seed"] != r1["generator_seed"]  # dropout differs per rank
    assert r0["lr"] == 2 * 1e-3 and r0["count"] == 3
    assert r0["lazy_error"] is None and r1["lazy_error"] is None  # lazy at world 2 runs
    for got, want in zip(r0["metrics"], jmetrics):
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=1e-5, err_msg=key)
        assert got["examples"] == B
    want = params_from_jax(_np(jstate.params), _np(jstate.model_state), cfg.model)
    for name, w in want.items():
        np.testing.assert_allclose(r0["final"][name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    adam = _find_adam_state(_np(jstate.opt_state))
    for slot in ("mu", "nu"):
        moments = params_from_jax(getattr(adam, slot), _np(jstate.model_state), cfg.model)
        for name in r0["slots"]:
            np.testing.assert_allclose(r0["slots"][name][slot].numpy(),
                                       moments[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"{name} {slot}")


def test_uneven_shards_end_together_and_eval_merges_across_ranks(tmp_path):
    """15 training records, batches of 4: rank 0 holds 8 records (2
    batches), rank 1 holds 7 (1 batch); both ranks stop after 1 step.  The
    validation set (37 records, 19 and 18 a rank) is read once across the
    ranks, and the merged AUC equals one process's."""
    data = tmp_path / "data"
    data.mkdir()
    generate_synthetic_ctr(data / "train-0.tfrecords", num_records=15, feature_size=V,
                           field_size=F, seed=1)
    generate_synthetic_ctr(data / "val-0.tfrecords", num_records=37, feature_size=V,
                           field_size=F, seed=2)
    argv = ["--task_type", "train", "--training_data_dir", str(data),
            "--val_data_dir", str(data), "--servable_model_dir", str(tmp_path / "s"),
            "--model_dir", str(tmp_path / "model"),
            "--feature_size", str(V), "--field_size", str(F), "--embedding_size",
            str(K), "--deep_layers", "16,8", "--batch_size", "4", "--num_epochs", "1",
            "--log_steps", "1"]
    r0, r1 = _spawn(worker.dp_train_files, tmp_path, argv)
    assert r0["step"] == r1["step"] == 1
    lines = [json.loads(x) for x in r0["log"].splitlines()]
    done = next(r for r in lines if r["kind"] == "train_done")
    assert (done["steps"], done["world_size"], done["examples"]) == (1, 2, 8)
    ev = next(r for r in lines if r["kind"] == "eval")
    assert ev["examples"] == 37
    assert [r["kind"] for r in lines].count("export") == 1 and r1["log"] == ""
    cfg = Config.from_dict({"model": {"feature_size": V, "field_size": F,
                                      "embedding_size": K, "deep_layers": (16, 8)},
                            "data": {"batch_size": 4, "val_data_dir": str(data)}})
    model = DeepFM(cfg.model, device="cpu")
    model.load_state_dict(r0["final"])
    one = run_eval(model, cfg, ctx=initialize_distributed(cfg.mesh, "cpu"))
    assert one["examples"] == 37 and one["auc"] == ev["auc"]
    np.testing.assert_allclose(ev["loss"], one["loss"], rtol=1e-6)


FILE_MATRIX = list(itertools.product([1, 2, 3], [0, 2], [1, 4], [0, 3], [False, True]))


def test_shard_plan_matches_jax_over_the_file_mode_matrix():
    for hosts, host_rank, per_host, local, pre in FILE_MATRIX:
        if host_rank >= hosts or local >= per_host:
            continue
        got = shard_plan(WorkerTopology(hosts, host_rank, per_host, local),
                         stream_mode=False, pre_sharded=pre)
        want = jax_shard_plan(JaxTopology(hosts, host_rank, per_host, local),
                              stream_mode=False, pre_sharded=pre)
        assert (got.num_shards, got.shard_index, got.channel_index) == \
            (want.num_shards, want.shard_index, want.channel_index)
    # the world's shards tile the records: no overlap, no gap
    seen = sorted(i for r in range(6) for i in shard_records(
        100, shard_plan(WorkerTopology(2, r // 3, 3, r % 3), stream_mode=False,
                        pre_sharded=False)))
    assert seen == list(range(100))


def test_mesh_options_the_port_cannot_honour(tmp_path):
    sharded = Config.from_dict({"mesh": {"model_parallel": 2}})
    with pytest.raises(ValueError, match="does not divide the 1 ranks"):
        initialize_distributed(sharded.mesh, "cpu")
    with pytest.raises(ValueError, match="fused_kernel='on' requires"):
        Config.from_dict({"model": {"fused_kernel": "on"}, "mesh": {"model_parallel": 2}})
    # a checkpoint of another row split needs the resharding restore (A15)
    small = Config.from_dict({"model": {"feature_size": V, "field_size": F,
                                        "embedding_size": K, "deep_layers": (8,)}})
    state = create_train_state(small, "cpu")
    Checkpointer(tmp_path).save(state, block=True)
    path = tmp_path / "0" / "state.pt"
    payload = torch.load(path, weights_only=True)
    payload["grid"] = [1, 2]
    torch.save(payload, path)
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        Checkpointer(tmp_path).restore(create_train_state(small, "cpu"))
    cfg = Config.from_dict({"mesh": {"data_parallel": 2}})
    with pytest.raises(ValueError, match="launcher started 1 ranks"):
        initialize_distributed(cfg.mesh, "cpu")
    ctx = initialize_distributed(Config().mesh, "cpu")
    assert (ctx.world_size, ctx.rank, ctx.group) == (1, 0, None)


def test_torch_distributed_run_trains_evaluates_and_exports(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        generate_synthetic_ctr(data / f"train-{i}.tfrecords", num_records=64,
                               feature_size=V, field_size=F, seed=i)
    generate_synthetic_ctr(data / "val-0.tfrecords", num_records=30, feature_size=V,
                           field_size=F, seed=9)
    servable = tmp_path / "servable"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "deepfm_tpu_torch", "--task_type", "train",
         "--device", "cpu", "--training_data_dir", str(data), "--val_data_dir",
         str(data), "--servable_model_dir", str(servable), "--model_dir",
         str(tmp_path / "model"), "--feature_size", str(V),
         "--field_size", str(F), "--embedding_size", str(K), "--deep_layers", "16,8",
         "--batch_size", "16", "--log_steps", "2", "--num_epochs", "1",
         "--set", "model.batch_norm=true"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    kinds = [r["kind"] for r in lines]
    assert kinds.count("train_done") == kinds.count("eval") == kinds.count("export") == 1
    done = next(r for r in lines if r["kind"] == "train_done")
    assert (done["world_size"], done["steps"], done["examples"]) == (2, 4, 128)
    train = [r for r in lines if r["kind"] == "train"]
    assert len(train) == 2 and all(np.isfinite(r["loss"]) for r in train)
    ev = next(r for r in lines if r["kind"] == "eval")
    assert ev["examples"] == 30 and 0.0 <= ev["auc"] <= 1.0
    from deepfm_tpu_torch.serve.export import load_servable

    predict, _ = load_servable(servable, device="cpu")
    assert predict(np.ones((3, F), np.int64), np.ones((3, F), np.float32)).shape == (3,)
