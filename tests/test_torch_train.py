"""The port's training slice against the JAX package, on the CPU, at a small
width (V = 300, F = 6, K = 8, MLP 16/8, B = 32):

* 5 dense train steps against ``jax.jit(make_train_step(cfg))`` with
  ``fused_kernel="off"``, from JAX init parameters copied through
  ``params_from_jax``, dropout off (the two RNGs give different bits);
* ``train_state_from_jax`` after 3 JAX steps: 2 more steps on each side;
* dropout by its distribution; the config reader; the data copies against
  the JAX package's generator and codec; the CLI end to end.

Tolerances:
* float32: per-step loss and ce within 1e-5 relative; final parameters,
  Adam moments and batch-norm statistics within 1e-5 absolute (the same
  float32 arithmetic with sums in another order);
* bfloat16 MLP: loss and ce within 1e-2 relative (bf16 keeps 8 bits of
  mantissa, ~4e-3 relative, and torch and XLA round bf16 products at other
  places); parameters within 5e-3 absolute: Adam moves a weight by about
  lr a step, so a near-zero gradient whose sign differs between the two
  moves it by at most 2·lr·5 = 5e-3 over 5 steps.
The steps run at the JAX default lr, 5e-4: Adam's step m̂/(√v̂ + ε) turns
a float32 rounding difference in a near-zero gradient into a difference of
up to lr in the weight, so the parameter tolerance scales with lr.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.data.example_proto import serialize_ctr_example as jax_serialize
from deepfm_tpu.data.libsvm import generate_synthetic_ctr as jax_generate
from deepfm_tpu.data.pipeline import batched_ctr_batches as jax_batches
from deepfm_tpu.data.pipeline import record_stream as jax_record_stream
from deepfm_tpu.train import create_train_state as jax_create_train_state
from deepfm_tpu.train import make_train_step
from deepfm_tpu_torch.convert import (_find_adam_state, params_from_jax,
                                     train_state_from_jax)
from deepfm_tpu_torch.core.config import Config, ModelConfig, load_config
from deepfm_tpu_torch.data.example_proto import serialize_ctr_example
from deepfm_tpu_torch.data.libsvm import generate_synthetic_ctr
from deepfm_tpu_torch.data.pipeline import (batched_ctr_batches, discover_files,
                                            make_input_pipeline, record_stream)
from deepfm_tpu_torch.models.deepfm import DeepFM, dropout
from deepfm_tpu_torch.train.step import create_train_state, train_step

ROOT = Path(__file__).resolve().parent.parent
V, F, K, B = 300, 6, 8, 32


def _config(compute_dtype="float32", batch_norm=False, **optimizer):
    return JaxConfig.from_dict({
        "model": dict(feature_size=V, field_size=F, embedding_size=K,
                      deep_layers=(16, 8), dropout_keep=(1.0, 1.0),
                      compute_dtype=compute_dtype, batch_norm=batch_norm,
                      fused_kernel="off"),
        "optimizer": optimizer,
        "data": {"batch_size": B},
    })


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, V, size=(B, F))
        ids[0, 0], ids[1, 1] = V + 7, -2  # out of range: both sides clip
        vals = rng.random((B, F)).astype(np.float32)
        label = (rng.random(B) < 0.3).astype(np.float32)
        out.append({"feat_ids": ids.astype(np.int64), "feat_vals": vals, "label": label})
    return out


def _port_state(jcfg, jstate):
    cfg = Config.from_dict(jcfg.to_dict())
    state = create_train_state(cfg, "cpu")
    state.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.model_state), cfg.model))
    return cfg, state


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _compare_final(state, jstate, cfg, tol):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                           jax.tree_util.tree_map(np.asarray, jstate.model_state),
                           cfg.model)
    got = state.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol,
                                   err_msg=k)
    adam = _find_adam_state(jstate.opt_state)
    assert state.optimizer.count == int(adam.count)
    for slot in ("mu", "nu"):
        moments = params_from_jax(jax.tree_util.tree_map(np.asarray, getattr(adam, slot)),
                                  {"bn": {}} if not cfg.model.batch_norm else
                                  jax.tree_util.tree_map(np.asarray, jstate.model_state),
                                  cfg.model)
        for name in state.optimizer.slots:
            np.testing.assert_allclose(state.optimizer.slots[name][slot].numpy(),
                                       moments[name].numpy(), rtol=0, atol=tol,
                                       err_msg=f"{name} {slot}")


@pytest.mark.parametrize("compute_dtype,batch_norm", [
    ("float32", False), ("float32", True), ("bfloat16", False)])
def test_train_steps_match_make_train_step(compute_dtype, batch_norm):
    bf16 = compute_dtype == "bfloat16"
    jcfg = _config(compute_dtype, batch_norm)
    jstate = jax_create_train_state(jcfg)
    cfg, state = _port_state(jcfg, jstate)
    step = jax.jit(make_train_step(jcfg))
    loss_tol, param_tol = (1e-2, 5e-3) if bf16 else (1e-5, 1e-5)
    for batch in _batches(5):
        jstate, jm = step(jstate, batch)
        m = train_step(state, _tensors(batch))
        for key in ("loss", "ce", "pred_mean", "label_mean"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=loss_tol,
                                       atol=0 if key != "pred_mean" else loss_tol,
                                       err_msg=key)
    assert state.step == int(jstate.step) == 5
    _compare_final(state, jstate, cfg, param_tol)


def test_train_state_from_jax_continues_the_run():
    jcfg = _config(batch_norm=True, embedding_lr_multiplier=2.0)
    jstate = jax_create_train_state(jcfg)
    step = jax.jit(make_train_step(jcfg))
    batches = _batches(5, seed=4)
    for batch in batches[:3]:
        jstate, _ = step(jstate, batch)
    cfg = Config.from_dict(jcfg.to_dict())
    assert cfg.optimizer.embedding_lr_multiplier == 2.0
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), cfg,
                                 device="cpu")
    assert state.step == 3 and state.optimizer.count == 3
    for batch in batches[3:]:
        jstate, jm = step(jstate, batch)
        m = train_step(state, _tensors(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _compare_final(state, jstate, cfg, 1e-5)


def test_train_state_from_jax_checks_shapes_and_optimizer():
    jcfg = _config()
    jstate = jax.tree_util.tree_map(np.asarray, jax_create_train_state(jcfg))
    cfg = Config.from_dict(jcfg.to_dict())
    wide = cfg.with_overrides(model={"embedding_size": 16})
    with pytest.raises(ValueError, match="fm_v"):
        train_state_from_jax(jstate, wide, device="cpu")
    with pytest.raises(ValueError, match="no Adagrad state"):
        train_state_from_jax(jstate, cfg.with_overrides(optimizer={"name": "Adagrad"}),
                             device="cpu")


def test_dropout_distribution_scaling_and_seed():
    g = torch.Generator().manual_seed(0)
    h = torch.ones((400, 250), dtype=torch.bfloat16)
    for keep in (0.5, 0.8):
        out = dropout(h, keep, g)
        kept = out != 0
        n = kept.numel()
        sigma = (keep * (1 - keep) / n) ** 0.5
        assert abs(float(kept.float().mean()) - keep) < 4 * sigma
        assert out.dtype == torch.bfloat16
        assert torch.all(out[kept] == torch.tensor(1.0 / keep, dtype=torch.bfloat16))
    cfg = ModelConfig(feature_size=V, field_size=F, embedding_size=K,
                      deep_layers=(16, 8), dropout_keep=(0.5, 0.7))
    ids = torch.randint(0, V, (B, F), generator=torch.Generator().manual_seed(1))
    vals = torch.rand((B, F), generator=torch.Generator().manual_seed(2))
    runs = []
    for _ in range(2):
        model = DeepFM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
        model.train()
        runs.append([model(ids, vals) for _ in range(2)])
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][0], runs[0][1])  # the generator advanced
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(ids, vals), model(ids, vals))  # no dropout in eval


def test_config_reads_the_jax_schema():
    jcfg = JaxConfig.from_dict({
        "model": {"feature_size": 500, "dropout_keep": (0.9, 0.8, 0.7),
                  "batch_norm_decay": 0.95, "l2_reg": 0.01, "cin_layers": (4,)},
        "optimizer": {"name": "Momentum", "momentum": 0.9, "zero_sharding": "off"},
        "data": {"batch_size": 64, "stream_mode": False},
        "run": {"log_steps": 7, "seed": 3, "serve_port": 1},
    })
    cfg = Config.from_dict(jcfg.to_dict())
    assert cfg.model.dropout_keep == (0.9, 0.8, 0.7)
    assert (cfg.model.batch_norm_decay, cfg.model.l2_reg) == (0.95, 0.01)
    assert (cfg.optimizer.name, cfg.optimizer.momentum) == ("Momentum", 0.9)
    assert (cfg.data.batch_size, cfg.run.log_steps, cfg.run.seed) == (64, 7, 3)
    assert Config.from_dict(cfg.to_dict()) == cfg
    with pytest.raises(ValueError, match="dropout_keep has 1 entries"):
        ModelConfig(dropout_keep=(0.5,))
    assert cfg.with_overrides(mesh={"model_parallel": 2}).mesh.model_parallel == 2
    with pytest.raises(ValueError, match="fused_kernel='on' requires"):
        cfg.with_overrides(model={"fused_kernel": "on"}, mesh={"model_parallel": 2})
    with pytest.raises(ValueError, match="unknown config section"):
        cfg.with_overrides(fleet={"shadow_queue_depth": 2})
    with pytest.raises(TypeError):
        cfg.with_overrides(model={"no_such_field": 1})


def test_data_copies_match_the_jax_package(tmp_path):
    """The port's generator writes the JAX generator's bytes, and its
    reader and decoder give the JAX pipeline's batches."""
    jax_generate(tmp_path / "train-jax.tfrecords", num_records=70, feature_size=V,
                 field_size=F, seed=5)
    generate_synthetic_ctr(tmp_path / "port.tfrecords", num_records=70, feature_size=V,
                           field_size=F, seed=5)
    assert (tmp_path / "port.tfrecords").read_bytes() == \
        (tmp_path / "train-jax.tfrecords").read_bytes()
    for label, ids, vals in [(1.0, [0, -5, 2**40], [0.5, -1.0, 3.25]),
                             (0.0, [7], [1e-8])]:
        assert serialize_ctr_example(label, ids, vals) == jax_serialize(label, ids, vals)
    src = [str(tmp_path / "train-jax.tfrecords")]
    for drop in (True, False):
        got = list(batched_ctr_batches(record_stream(src, verify_crc=True),
                                       batch_size=32, field_size=F,
                                       drop_remainder=drop))
        want = list(jax_batches(jax_record_stream(src), batch_size=32, field_size=F,
                                drop_remainder=drop))
        assert len(got) == len(want) == (2 if drop else 3)
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype


def test_input_pipeline_epochs_and_file_order(tmp_path):
    for i in range(3):
        generate_synthetic_ctr(tmp_path / f"tr-{i}.tfrecords", num_records=10,
                               feature_size=V, field_size=F, seed=i)
    (tmp_path / "val-0.tfrecords").write_bytes(b"")
    files = discover_files(str(tmp_path), ("tr", "train"), seed=1)
    assert sorted(files) == [str(tmp_path / f"tr-{i}.tfrecords") for i in range(3)]
    assert files == discover_files(str(tmp_path), ("tr", "train"), seed=1)
    cfg = Config.from_dict({"data": {"batch_size": 4, "num_epochs": 2,
                                     "training_data_dir": str(tmp_path)}}).data
    batches = list(make_input_pipeline(cfg, field_size=F, seed=1))
    assert len(batches) == 2 * (30 // 4)  # drop_remainder per epoch
    with pytest.raises(FileNotFoundError):
        list(make_input_pipeline(cfg, field_size=F, data_dir=str(tmp_path / "none")))


def test_cli_trains_on_the_cpu_end_to_end(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        generate_synthetic_ctr(data / f"train-{i}.tfrecords", num_records=96,
                               feature_size=V, field_size=F, seed=i)
    generate_synthetic_ctr(data / "val-0.tfrecords", num_records=50, feature_size=V,
                           field_size=F, seed=9)
    servable = tmp_path / "servable"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "deepfm_tpu_torch", "--task_type", "train",
         "--device", "cpu", "--training_data_dir", str(data), "--val_data_dir",
         str(data), "--servable_model_dir", str(servable), "--model_dir",
         str(tmp_path / "model"), "--feature_size", str(V),
         "--field_size", str(F), "--embedding_size", str(K), "--deep_layers", "16,8",
         "--dropout", "0.5,0.5", "--batch_size", "32", "--num_epochs", "2",
         "--log_steps", "4", "--set", "model.batch_norm=true",
         "--set", "model.fused_kernel=auto"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    train = [r for r in lines if r["kind"] == "train"]
    assert len(train) == 3 and all(np.isfinite(r["loss"]) for r in train)
    done = next(r for r in lines if r["kind"] == "train_done")
    assert done["steps"] == 12 and 0.0 <= done["input_wait_share"] <= 1.0
    ev = next(r for r in lines if r["kind"] == "eval")
    assert 0.0 <= ev["auc"] <= 1.0 and ev["examples"] == 50
    from deepfm_tpu_torch.serve.export import load_servable

    predict, cfg = load_servable(servable, device="cpu")
    assert cfg == load_config(servable) and cfg.batch_norm and cfg.dropout_keep == (0.5, 0.5)
    probs = predict(np.ones((3, F), np.int64), np.ones((3, F), np.float32))
    assert probs.shape == (3,) and np.all((probs > 0) & (probs < 1))


def test_cli_refuses_what_is_not_ported():
    from deepfm_tpu_torch.launch.cli import run

    # the online tasks are ported; the elastic publisher is not
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        run(["--task_type", "publish", "--device", "cpu"])
    # the serve task and both of its pools are ported: the CLI reaches
    # serve_pool with run.serve_workers and the pool's main with
    # --serve_groups; a multi-tenant fleet is not (ROADMAP A18)
    import deepfm_tpu_torch.serve.pool.__main__ as pool_main
    from deepfm_tpu_torch.serve import server

    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(server, "serve_pool", lambda d, **kw: seen.update(workers=kw["workers"]))
        mp.setattr(pool_main, "main", lambda argv: seen.update(groups=argv))
        run(["--task_type", "serve", "--device", "cpu", "--set", "run.serve_workers=2"])
        run(["--task_type", "serve", "--device", "cpu", "--serve_groups", "3",
             "--serve_group_mp", "2"])
    assert seen["workers"] == 2
    argv = seen["groups"]
    assert argv[argv.index("--groups") + 1] == "3" and argv[argv.index("--group-mp") + 1] == "2"
    assert argv[argv.index("--device") + 1] == "cpu"
    with pytest.raises(ValueError, match="fleet.tenants.*A18"):
        run(["--task_type", "serve", "--device", "cpu", "--set",
             'fleet.tenants=[{"name": "exp"}]'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(["--task_type", "train", "--training_data_dir", "/nonexistent"])
        for task in ("online-train", "feedback-train"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                run(["--task_type", task, "--training_data_dir", "/nonexistent",
                     "--set", "flywheel.join_output_url=/nonexistent"])
