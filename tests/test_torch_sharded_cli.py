"""The train, eval, infer and export tasks on a ``[data x model]`` grid
through the CLI, on the CPU (gloo).

* ``python -m torch.distributed.run --nproc_per_node 2 -m deepfm_tpu_torch
  --device cpu --set mesh.model_parallel=2``: the train task, stopped by a
  SIGTERM to the launcher after its first checkpoint (every rank
  saves its part and logs ``preempted``; torchrun hands the signal to each
  rank), the same command again (it logs
  ``resume`` and ends: eval, export), then the infer task on the same
  grid; the exported servable, loaded with ``load_servable(...,
  device="cpu")``, scores every validation record as the grid's infer task
  did (1e-6), and the eval counts every record once;
* in two spawned gloo ranks (``_torch_dist_worker.dp_lifecycle``) at
  ``[1, 2]``, dense and lazy, and lazy at ``[2, 1]`` (the lazy step at
  more than one data index), with batch norm and dropout: stopped by a
  SIGTERM that only rank 1 receives after step 2, resumed, and held bit
  for bit against an uninterrupted run on each rank, evaluating after
  every step by rank 0's clock.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_worker as worker
from deepfm_tpu_torch.data.libsvm import generate_synthetic_ctr
from deepfm_tpu_torch.data.pipeline import eval_batches
from deepfm_tpu_torch.core.config import DataConfig
from deepfm_tpu_torch.serve.export import load_servable

ROOT = Path(__file__).resolve().parent.parent
V, F, K = 301, 6, 8
TIMEOUT_S = 120


def _data(path: Path) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    for i in range(2):
        generate_synthetic_ctr(path / f"train-{i}.tfrecords", num_records=96,
                               feature_size=V, field_size=F, seed=i)
    generate_synthetic_ctr(path / "val-0.tfrecords", num_records=50, feature_size=V,
                           field_size=F, seed=9)
    return path


def _flags(data: Path, *extra: str, mp: int = 2) -> list[str]:
    return ["--training_data_dir", str(data), "--val_data_dir", str(data),
            "--feature_size", str(V), "--field_size", str(F), "--embedding_size", str(K),
            "--deep_layers", "16,8", "--batch_size", "16", "--log_steps", "2",
            "--set", f"mesh.model_parallel={mp}", "--set", "model.fused_kernel=auto", *extra]


def _lines(stdout: str) -> list[dict]:
    return [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]


def _torchrun(args: list[str]) -> list[str]:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "deepfm_tpu_torch", "--device", "cpu", *args]


def test_torch_distributed_run_on_a_grid_stops_resumes_and_exports(tmp_path):
    data = _data(tmp_path / "data")
    model, servable = tmp_path / "model", tmp_path / "servable"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    train = _torchrun(["--task_type", "train", *_flags(data, "--num_epochs", "60",
                                                       "--checkpoint_every_steps", "2"),
                       "--model_dir", str(model), "--servable_model_dir", str(servable)])
    first = subprocess.Popen(train, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, start_new_session=True)
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not (model.is_dir() and any(p.name.isdigit() for p in model.iterdir())):
            assert first.poll() is None, first.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "no checkpoint in time"
            time.sleep(0.05)
        first.send_signal(signal.SIGTERM)  # torchrun hands it to each rank
        out, err = first.communicate(timeout=TIMEOUT_S)
    finally:
        if first.poll() is None:
            os.killpg(first.pid, signal.SIGKILL)
    lines = _lines(out)
    stopped = [r for r in lines if r["kind"] == "preempted"]
    assert len(stopped) == 1, err[-3000:]
    assert not [r for r in lines if r["kind"] == "export"]

    again = subprocess.run(train, cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=TIMEOUT_S)
    assert again.returncode == 0, again.stderr[-3000:]
    lines = _lines(again.stdout)
    kinds = [r["kind"] for r in lines]
    assert kinds.count("resume") == kinds.count("train_done") == kinds.count("export") == 1
    resume = next(r for r in lines if r["kind"] == "resume")
    assert resume["step"] == stopped[0]["step"] > 0
    done = next(r for r in lines if r["kind"] == "train_done")
    assert done["world_size"] == 2 and done["step"] == 60 * 192 // 16
    ev = next(r for r in lines if r["kind"] == "eval")
    assert ev["examples"] == 50 and 0.0 <= ev["auc"] <= 1.0

    infer = subprocess.run(
        _torchrun(["--task_type", "infer", *_flags(data), "--model_dir", str(model)]),
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert infer.returncode == 0, infer.stderr[-3000:]
    pred = np.loadtxt(data / "pred.txt", dtype=np.float64)
    assert pred.shape == (50,)
    predict, cfg = load_servable(servable, device="cpu")
    assert (cfg.feature_size, cfg.field_size) == (V, F)
    batches = list(eval_batches(DataConfig(batch_size=16), field_size=F,
                                data_dir=str(data)))
    probs = np.concatenate([predict(b["feat_ids"], b["feat_vals"]) for b in batches])
    np.testing.assert_allclose(probs, pred, rtol=0, atol=1e-6)


def _assert_bit_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("lazy,shards", [(False, 2), (True, 2), (True, 1)],
                         ids=["dense-1x2", "lazy-1x2", "lazy-2x1"])
def test_a_grid_run_resumes_bit_for_bit(tmp_path, lazy, shards):
    data = _data(tmp_path / "data")
    out = tmp_path / "out"
    out.mkdir()
    argv = ["--task_type", "train", *_flags(
        data, "--num_epochs", "1", "--dropout", "0.5,0.5", "--checkpoint_every_steps", "4",
        "--set", "model.batch_norm=true", "--set", "model.shard_exchange=alltoall",
        "--set", f"optimizer.lazy_embedding_updates={str(lazy).lower()}", mp=shards)]
    ctx = mp.start_processes(worker.dp_lifecycle,
                             args=(2, str(tmp_path / "store"), str(out), argv, 1, 2),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"ranks still running after {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    r0, r1 = (torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2))
    steps = 192 // 16 // (3 - shards)  # 2 data indices at [2, 1]: half the records each
    assert r0["evals"] == r1["evals"] == steps + 1
    assert r0["preempted"] == r1["preempted"] == "preempted at step 3"
    assert r0["step"] == r1["step"] == steps
    for r in (r0, r1):
        _assert_bit_equal(r["resumed"], r["whole"])
    # [1, 2]: one model group, the same dropout stream, other row shards;
    # [2, 1]: two data indices, their own streams, the same tables
    same_stream = torch.equal(r0["whole"]["generator"], r1["whole"]["generator"])
    same_rows = torch.equal(r0["whole"]["model.fm_v"], r1["whole"]["model.fm_v"])
    assert same_stream == (shards == 2) and same_rows == (shards == 1)
