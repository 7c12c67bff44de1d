"""The train task's lifecycle in the port (``train/loop.py``,
``launch/cli.py``), through ``deepfm_tpu_torch.launch.cli`` on the CPU at a
small width (V = 300, F = 6, K = 8, MLP 16/8, batch 32, two files of 96
training records: 6 steps an epoch), as ``tests/test_cli.py`` and
``tests/test_preemption.py`` drive the JAX CLI:

* train, then the same command again resumes and trains no step (JAX
  trains 0 too: ROADMAP C6), then ``--num_epochs`` doubled trains to twice
  the steps; ``--clear_existing_model`` starts over;
* a SIGTERM in the middle of a run: a checkpoint at that step, the
  ``preempted`` event, exit code 0, and the rerun finishes; a crash is
  retried (``run.max_restarts``) and the retry resumes;
* a run stopped and resumed equals the uninterrupted run bit for bit
  (weights, BN statistics, optimizer slots and count, lazy moments, step,
  dropout generator): dense Adam, lazy Adam, and at world size 2 over gloo
  with the SIGTERM sent to rank 1 only;
* the ``eval``, ``infer`` (te* first, else va*) and ``export`` tasks on the
  trained checkpoint, against the train task's own eval and export;
* ``write_predictions`` byte for byte against JAX's;
* the in-training eval cadence (start delay, throttle) on a fake clock.
"""

import contextlib
import io
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
from deepfm_tpu.serve.export import write_predictions as jax_write_predictions
from deepfm_tpu_torch.checkpoint import Checkpointer
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.data.libsvm import generate_synthetic_ctr
from deepfm_tpu_torch.data.pipeline import eval_batches
from deepfm_tpu_torch.launch import cli
from deepfm_tpu_torch.launch.preemption import PreemptedError
from deepfm_tpu_torch.parallel import spmd
from deepfm_tpu_torch.serve.export import load_servable, read_params, write_predictions
from deepfm_tpu_torch.train import loop
from deepfm_tpu_torch.train.step import create_train_state
from deepfm_tpu_torch.utils.logging import MetricLogger

ROOT = Path(__file__).resolve().parent.parent
V, F, K = 300, 6, 8
STEPS = 12  # 2 epochs x 192 records / 32


def _data(path: Path) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    for i in range(2):
        generate_synthetic_ctr(path / f"train-{i}.tfrecords", num_records=96,
                               feature_size=V, field_size=F, seed=i)
    generate_synthetic_ctr(path / "val-0.tfrecords", num_records=50, feature_size=V,
                           field_size=F, seed=9)
    return path


def _flags(data: Path) -> list[str]:
    return ["--task_type", "train", "--training_data_dir", str(data),
            "--val_data_dir", str(data), "--feature_size", str(V), "--field_size", str(F),
            "--embedding_size", str(K), "--deep_layers", "16,8", "--dropout", "0.5,0.5",
            "--batch_size", "32", "--num_epochs", "2", "--log_steps", "2",
            "--checkpoint_every_steps", "4", "--set", "model.batch_norm=true",
            "--set", "model.fused_kernel=auto"]


def _argv(data: Path, model: Path, *extra: str) -> list[str]:
    return [*_flags(data), "--device", "cpu", "--model_dir", str(model), *extra]


def _lines(capsys) -> list[dict]:
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def _kind(lines, kind):
    return [r for r in lines if r["kind"] == kind]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One finished 2-epoch train task: its directories and its log."""
    root = tmp_path_factory.mktemp("trained")
    data = _data(root / "data")
    argv = _argv(data, root / "model", "--servable_model_dir", str(root / "servable"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    return {"root": root, "data": data, "argv": argv, "lines": lines}


def test_rerun_trains_no_step_and_a_longer_plan_resumes(trained, tmp_path, capsys):
    kinds = [r["kind"] for r in trained["lines"]]
    assert "resume" not in kinds and {"train", "train_done", "eval", "export"} <= set(kinds)
    assert Checkpointer(trained["root"] / "model").all_steps() == [4, 8, STEPS]
    # the same command again (C6): resumes at the end, trains nothing
    model = tmp_path / "model"
    data = trained["data"]
    assert cli.main(_argv(data, model)) == 0
    capsys.readouterr()
    assert cli.main(_argv(data, model)) == 0
    lines = _lines(capsys)
    assert _kind(lines, "resume") == [{"kind": "resume", "step": STEPS}]
    assert not _kind(lines, "train") and _kind(lines, "train_done")[0]["steps"] == 0
    # a plan twice as long resumes at 12 and trains to 24
    assert cli.main(_argv(data, model, "--num_epochs", "4")) == 0
    lines = _lines(capsys)
    assert _kind(lines, "resume")[0]["step"] == STEPS
    assert max(r["step"] for r in _kind(lines, "train")) == 2 * STEPS
    assert _kind(lines, "train_done")[0]["steps"] == STEPS
    # --clear_existing_model starts over
    assert cli.main(_argv(data, model, "--clear_existing_model")) == 0
    lines = _lines(capsys)
    assert not _kind(lines, "resume") and _kind(lines, "train_done")[0]["steps"] == STEPS


def test_eval_infer_and_export_tasks(trained, tmp_path, capsys):
    data, root = trained["data"], trained["root"]
    base = trained["argv"][2:]  # all but --task_type train
    final = _kind(trained["lines"], "eval")[-1]
    result = cli.run(["--task_type", "eval", *base])
    assert result["examples"] == final["examples"] == 50
    assert result["auc"] == pytest.approx(final["auc"], abs=1e-6)
    assert result["loss"] == pytest.approx(final["loss"], rel=1e-6)
    # infer: no te* files, so the va* records, one line each, in file order
    path = cli.run(["--task_type", "infer", *base])
    assert path == str(data / "pred.txt")
    probs = np.array([float(x) for x in (data / "pred.txt").read_text().splitlines()])
    assert probs.shape == (50,) and np.all((probs > 0) & (probs < 1))
    predict, _ = load_servable(root / "servable", device="cpu")
    cfg = Config.from_dict({"data": {"batch_size": 64}})
    batch = next(eval_batches(cfg.data, field_size=F, data_dir=str(data)))
    np.testing.assert_allclose(probs, predict(batch["feat_ids"], batch["feat_vals"]),
                               atol=1e-6)
    # te*/test* files win over va*: under --test_data_dir
    test_dir = tmp_path / "test"
    test_dir.mkdir()
    generate_synthetic_ctr(test_dir / "test-0.tfrecords", num_records=37,
                           feature_size=V, field_size=F, seed=4)
    generate_synthetic_ctr(test_dir / "val-0.tfrecords", num_records=5,
                           feature_size=V, field_size=F, seed=5)
    path = cli.run(["--task_type", "infer", *base, "--test_data_dir", str(test_dir)])
    assert len(Path(path).read_text().splitlines()) == 37
    # export: the checkpoint's servable is the train task's, bit for bit
    cli.run(["--task_type", "export", *base, "--servable_model_dir", str(tmp_path / "e")])
    got, want = read_params(tmp_path / "e"), read_params(root / "servable")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a model_dir without a checkpoint
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        cli.run(["--task_type", "eval", *base, "--model_dir", str(tmp_path / "none")])


def test_the_module_runs_every_task(trained, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    base = trained["argv"][2:]
    out = subprocess.run(
        [sys.executable, "-m", "deepfm_tpu_torch", "--task_type", "export", *base,
         "--servable_model_dir", str(tmp_path / "s")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1])["kind"] == "export"
    assert (tmp_path / "s" / "params.npz").exists()


class _SignalAt(MetricLogger):
    """A SIGTERM to this process after step ``AT``, from inside the loop."""

    AT = 5

    def step(self, step, *a, **kw):
        super().step(step, *a, **kw)
        if step == self.AT:
            os.kill(os.getpid(), signal.SIGTERM)


def test_sigterm_mid_run_checkpoints_exits_0_and_the_rerun_finishes(
        tmp_path, capsys, monkeypatch):
    data = _data(tmp_path / "data")
    argv = _argv(data, tmp_path / "model")
    monkeypatch.setattr(loop, "MetricLogger", _SignalAt)
    assert cli.main(argv) == 0
    lines = _lines(capsys)
    assert _kind(lines, "preempted") == [{"kind": "preempted", "step": 5}]
    assert not _kind(lines, "eval") and not _kind(lines, "export")
    assert Checkpointer(tmp_path / "model").all_steps() == [4, 5]
    monkeypatch.setattr(loop, "MetricLogger", MetricLogger)
    assert cli.main(argv) == 0
    lines = _lines(capsys)
    assert _kind(lines, "resume")[0]["step"] == 5
    assert _kind(lines, "train_done")[0]["steps"] == STEPS - 5
    assert Checkpointer(tmp_path / "model").all_steps() == [5, 8, STEPS]


def test_a_crash_is_retried_and_the_retry_resumes(tmp_path, capsys, monkeypatch):
    data = _data(tmp_path / "data")
    real = spmd.train_step
    crashed = []

    def crash_once(state, *a, **kw):
        if state.step == 6 and not crashed:
            crashed.append(state.step)
            raise RuntimeError("transient fault")
        return real(state, *a, **kw)

    monkeypatch.setattr(spmd, "train_step", crash_once)
    state = cli.run(_argv(data, tmp_path / "model", "--set", "run.max_restarts=1",
                          "--set", "run.restart_backoff_secs=0"))
    lines = _lines(capsys)
    assert crashed == [6] and state.step == STEPS
    restart = _kind(lines, "restart")
    assert len(restart) == 1 and "transient fault" in restart[0]["error"]
    assert _kind(lines, "resume")[0]["step"] == 4


def _tensors(state) -> dict:
    return worker._state_tensors(state) | {
        f"lazy.{slot}.{k}": t for slot, tables in
        (state.lazy.state_dict().items() if state.lazy is not None else ())
        for k, t in tables.items()}


def _assert_bit_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
def test_a_resumed_run_equals_the_uninterrupted_one_bit_for_bit(tmp_path, monkeypatch,
                                                                lazy):
    data = _data(tmp_path / "data")
    extra = ("--set", "optimizer.lazy_embedding_updates=true") if lazy else ()
    whole = cli.run(_argv(data, tmp_path / "whole", *extra))
    monkeypatch.setattr(loop, "MetricLogger", _SignalAt)
    with pytest.raises(PreemptedError, match="step 5"):
        cli.run(_argv(data, tmp_path / "split", *extra))
    monkeypatch.setattr(loop, "MetricLogger", MetricLogger)
    resumed = cli.run(_argv(data, tmp_path / "split", *extra))
    assert (resumed.lazy is not None) == lazy
    assert resumed.step == whole.step == STEPS
    assert resumed.optimizer.count == whole.optimizer.count
    _assert_bit_equal(_tensors(resumed), _tensors(whole))


def test_a_resumed_run_equals_the_uninterrupted_one_at_world_size_2(tmp_path):
    """Ranks are processes (spawn) in a gloo group over a FileStore; rank 1
    alone receives the SIGTERM, after step 2; both ranks stop after step 3
    (the flag travels in that step's all-reduce) and the resumed run ends
    equal to the uninterrupted one on each rank.  In the uninterrupted run
    rank 0's clock calls an eval after every step and rank 1's never does:
    both ranks run the same 12 + 1 evals.  The checkpoint then restores in
    one process: weights as rank 0's, the generator left fresh (another
    world size)."""
    data = _data(tmp_path / "data")
    out = tmp_path / "out"
    out.mkdir()
    argv = _flags(data) + ["--batch_size", "16"]  # per rank
    ctx = mp.start_processes(worker.dp_lifecycle,
                             args=(2, str(tmp_path / "store"), str(out), argv, 1, 2),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail("ranks still running after 120 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    r0, r1 = (torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2))
    assert r0["evals"] == r1["evals"] == STEPS + 1
    assert r0["preempted"] == r1["preempted"] == "preempted at step 3"
    assert r0["step"] == r1["step"] == STEPS
    for r in (r0, r1):
        _assert_bit_equal(r["resumed"], r["whole"])
    assert not torch.equal(r0["whole"]["generator"], r1["whole"]["generator"])
    cfg, _ = cli.resolve_config(argv + ["--model_dir", str(out / "split")])
    fresh = create_train_state(cfg, "cpu")
    generator = fresh.generator.get_state()
    Checkpointer(out / "split").restore(fresh)
    assert fresh.step == STEPS and torch.equal(fresh.generator.get_state(), generator)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, r0["whole"][f"model.{k}"]), k


def test_profile_dir_leaves_a_trace_of_the_train_loop(trained, tmp_path):
    """``run.profile_dir`` wraps the train loop in a torch.profiler trace
    written into that directory (JAX: ``jax.profiler.trace``)."""
    prof = tmp_path / "prof"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(_argv(trained["data"], tmp_path / "model", "--num_epochs", "1",
                              "--set", f"run.profile_dir={prof}")) == 0
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_write_predictions_matches_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(0)
    batches = [rng.random(7).astype(np.float32), np.float32(0.5),
               np.array([0.0, 1.0, 1e-7, 0.9999996], np.float32)]
    n = write_predictions(iter(batches), tmp_path / "port.txt")
    assert n == jax_write_predictions(iter(batches), tmp_path / "jax.txt") == 12
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    # to an object-store URL: the same bytes, uploaded
    from deepfm_tpu_torch.data.object_store import get_store
    from deepfm_tpu_torch.utils.dev_object_store import serve

    server, base = serve(str(tmp_path / "store"))
    try:
        assert write_predictions(iter(batches), f"{base}/bucket/pred.txt") == 12
        assert get_store().get(f"{base}/bucket/pred.txt") == (tmp_path / "jax.txt").read_bytes()
    finally:
        server.shutdown()
        server.server_close()


class _Clock(MetricLogger):
    """Counts the steps and records each event with the step it came at."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.now, self.events = 0, []

    def step(self, step, *a, **kw):
        self.now = step
        super().step(step, *a, **kw)

    def event(self, kind, **fields):
        self.events.append((kind, self.now))
        super().event(kind, **fields)


@pytest.mark.parametrize("delay,throttle,at", [
    (0, 0, []), (5, 3, [5, 8, 11]), (0, 4, [4, 8, 12]), (100, 1, [])])
def test_eval_cadence_start_delay_then_throttle(tmp_path, monkeypatch, delay, throttle,
                                                at):
    """The clock reads one second a step: an eval no sooner than
    ``delay``, then at most one per ``throttle``, then the final one."""
    data = _data(tmp_path / "data")
    cfg, _ = cli.resolve_config(_argv(data, tmp_path / "model", "--set",
                                      f"run.eval_start_delay_secs={delay}", "--set",
                                      f"run.eval_throttle_secs={throttle}"))
    log = _Clock(log_steps=1000)
    monkeypatch.setattr(loop.time, "time", lambda: float(log.now))
    loop.run_train(cfg, device="cpu", log=log)
    evals = [step for kind, step in log.events if kind == "eval"]
    assert evals == at + [STEPS]
