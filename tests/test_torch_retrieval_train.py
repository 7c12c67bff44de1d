"""Two-tower training in the port (``deepfm_tpu_torch/train/retrieval.py``,
``parallel/retrieval.py``, ``data/ratings.py`` and the retrieval tasks of
``train/loop.py``) against the JAX package on the CPU, from JAX init
parameters carried by ``convert.two_tower_params_from_jax`` and numpy
inputs made from a seed.  (``test_torch_retrieval.py`` is kernel B2's.)

Small widths: user vocabulary 51, item vocabulary 41 (padded to 52 and 42
on two model shards), K = 8, towers 16 -> 8, two user fields and one item
field, a global batch of 32, temperature 0.5, L2 1e-3, Adam at 5e-4 (the
JAX default: Adam turns a float32 rounding difference in a near-zero
gradient into a step of up to lr, so parity is held at lr-sized steps, as
``tests/test_two_tower.py`` holds JAX's own sharded step to its dense
one at tame settings).

* ``in_batch_softmax_loss`` and ``retrieval_metrics`` against JAX, ties
  included;
* the ratings parser, loader and batch order against JAX's on the same
  files;
* three dense steps against ``make_retrieval_train_step`` and the eval
  step against ``make_retrieval_eval_step``;
* the grid step over gloo ranks at ``[2, 1]``, ``[1, 2]`` and ``[2, 2]``
  (``_torch_dist_worker.retrieval_steps``) against the port's dense
  full-batch step (JAX's invariant) and JAX's ``make_retrieval_spmd_
  train_step`` on the same virtual mesh;
* the CLI's train/eval/export on ratings files with JAX's refusals, the
  resume after a stop at the same batch, and the train task itself (which
  the port once sent down the CTR path).

Tolerances: loss and metrics 1e-5 relative, parameters and moments 1e-5
absolute (float32 with sums in another order); the grid's parameters
against the port's dense step 5e-5 absolute (``TOL_DENSE_PARAMS``): at
``model_parallel`` 2 a table row's gradient is summed over the exchange
in another order than the dense scatter sums it, and Adam turns that
rounding difference in a gradient near zero into a step difference of a
sizeable part of lr (5e-4); JAX's sharded step sums in the grid's order,
so the grid is held to it at 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from _torch_grid import jax_mesh, spawn, to_numpy
from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.data.ratings import RatingsDataset as JaxRatingsDataset
from deepfm_tpu.data.ratings import load_ratings as jax_load_ratings
from deepfm_tpu.data.ratings import parse_ratings_line as jax_parse_ratings_line
from deepfm_tpu.models.two_tower import in_batch_softmax_loss as jax_loss
from deepfm_tpu.models.two_tower import retrieval_metrics as jax_metrics
from deepfm_tpu.parallel.retrieval import (create_retrieval_spmd_state,
                                           make_retrieval_context,
                                           make_retrieval_spmd_train_step,
                                           shard_retrieval_batch)
from deepfm_tpu.train.retrieval import (create_retrieval_state as jax_create_state,
                                        make_retrieval_eval_step, make_retrieval_train_step)
from deepfm_tpu_torch.convert import _find_adam_state, two_tower_params_from_jax
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.data.ratings import RatingsDataset, load_ratings, parse_ratings_line
from deepfm_tpu_torch.models.two_tower import in_batch_softmax_loss, retrieval_metrics
from deepfm_tpu_torch.train import retrieval

NU, NI, K, B = 51, 41, 8, 32
TOL_DENSE_PARAMS = 5e-5
MODEL = dict(model_name="two_tower", user_vocab_size=NU, item_vocab_size=NI, embedding_size=K,
             tower_layers=(16,), tower_dim=8, user_field_size=2, item_field_size=1,
             temperature=0.5, l2_reg=1e-3, compute_dtype="float32")


def _jcfg(dp=1, mp=1, **model) -> JaxConfig:
    return JaxConfig.from_dict({"model": {**MODEL, **model},
                                "optimizer": {"learning_rate": 5e-4},
                                "mesh": {"data_parallel": dp, "model_parallel": mp},
                                "data": {"batch_size": B}})


def _batches(n, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return [{"user_ids": rng.integers(0, NU, (b, 2)).astype(np.int64),
             "user_vals": rng.random((b, 2)).astype(np.float32),
             "item_ids": rng.integers(0, NI, (b, 1)).astype(np.int64),
             "item_vals": np.ones((b, 1), np.float32)} for _ in range(n)]


def _port_state(jcfg, jparams):
    cfg = Config.from_dict(jcfg.to_dict())
    state = retrieval.create_retrieval_state(cfg, "cpu")
    state.model.load_state_dict(two_tower_params_from_jax(to_numpy(jparams), cfg.model))
    return cfg, state


def _moments(opt_state, cfg) -> dict:
    adam = _find_adam_state(to_numpy(opt_state))
    return {slot: two_tower_params_from_jax(getattr(adam, slot), cfg.model)
            for slot in ("mu", "nu")}


# -- the loss and the metrics --------------------------------------------------

def test_loss_and_metrics_match_jax():
    rng = np.random.default_rng(1)
    u = rng.normal(size=(8, 4)).astype(np.float32)
    items = rng.normal(size=(16, 4)).astype(np.float32)
    labels = np.array([0, 3, 5, 7, 8, 9, 15, 2], np.int32)
    ce, scores = in_batch_softmax_loss(torch.from_numpy(u), torch.from_numpy(items),
                                       torch.from_numpy(labels), temperature=0.05)
    jce, jscores = jax_loss(jnp.asarray(u), jnp.asarray(items), jnp.asarray(labels),
                            temperature=0.05)
    np.testing.assert_allclose(ce.numpy(), np.asarray(jce), rtol=1e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-5)
    # ties: a row of equal scores (argmax takes the first, nothing ranks above)
    s = scores.numpy().copy()
    s[1] = 1.0
    s[2, :12] = s[2, 5]
    for k in (1, 3, 10):
        got = retrieval_metrics(torch.from_numpy(s), torch.from_numpy(labels), k)
        want = jax_metrics(jnp.asarray(s), jnp.asarray(labels), k)
        assert got.keys() == want.keys()
        for key in got:
            assert float(got[key]) == float(want[key]), (k, key)


# -- the ratings --------------------------------------------------------------

LINES = ["1::31::2.5::1260759144", "1,31,2.5,1260759144", "1 31 2.5", "7\t9",
         "userId,movieId,rating", "", "# comment", "3,4,", "5,x,1", "2", "8::9"]


def test_ratings_parser_loader_and_batches_match_jax(tmp_path):
    for line in LINES:
        assert parse_ratings_line(line) == jax_parse_ratings_line(line), line
    d = tmp_path / "ratings"
    (d / "sub").mkdir(parents=True)
    rng = np.random.default_rng(2)
    (d / "ratings.csv").write_text("userId,movieId,rating\n" + "".join(
        f"{u},{i},{r}\n" for u, i, r in zip(rng.integers(0, NU, 70), rng.integers(0, NI, 70),
                                            rng.integers(1, 6, 70))))
    (d / "sub" / "train-1.dat").write_text("".join(
        f"{u}::{i}::4::0\n" for u, i in zip(rng.integers(0, NU, 30), rng.integers(0, NI, 30))))
    (d / "interactions.txt").write_text("\n".join(LINES) + "\n")
    (d / "notes.csv").write_text("1,2,3\n")  # not a ratings*/train*/interactions* file
    for min_rating in (None, 3.0):
        got = load_ratings(d, min_rating=min_rating)
        want = jax_load_ratings(d, min_rating=min_rating)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype == np.int64
    (tmp_path / "empty").mkdir()
    for load in (load_ratings, jax_load_ratings):
        with pytest.raises(FileNotFoundError):
            load(tmp_path / "empty")
    ds, jds = RatingsDataset.from_path(d), JaxRatingsDataset.from_path(d)
    assert len(ds) == len(jds) and ds.max_ids() == jds.max_ids() and ds.min_ids() == jds.min_ids()
    for kw in ({}, {"shuffle": False}, {"num_epochs": 3, "seed": 7},
               {"drop_remainder": False, "seed": 1}):
        got = list(ds.batches(16, **kw))
        want = list(jds.batches(16, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype


# -- the single-card steps -----------------------------------------------------

def test_three_dense_steps_and_the_eval_step_match_jax():
    jcfg = _jcfg()
    jstate = jax_create_state(jcfg, jax.random.PRNGKey(0))
    cfg, state = _port_state(jcfg, jstate.params)
    step = jax.jit(make_retrieval_train_step(jcfg))
    for batch in _batches(3, seed=3):
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = retrieval.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "top1_acc", "recall_at_10"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    assert state.step == int(jstate.step) == 3 == state.optimizer.count
    want = two_tower_params_from_jax(to_numpy(jstate.params), cfg.model)
    for k, t in state.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    for slot, moments in _moments(jstate.opt_state, cfg).items():
        for k, t in moments.items():
            np.testing.assert_allclose(state.optimizer.slots[k][slot].numpy(), t.numpy(),
                                       rtol=0, atol=1e-5, err_msg=f"{k} {slot}")
    ev_batch = _batches(1, seed=4, b=64)[0]
    jev = jax.jit(make_retrieval_eval_step(jcfg))(jstate, ev_batch)
    ev = retrieval.eval_step(state.model, ev_batch)
    assert ev["count"] == int(jev["count"]) == 64
    for key in ("loss", "top1_acc", "recall_at_10"):
        np.testing.assert_allclose(float(ev[key]), float(jev[key]), rtol=1e-5, err_msg=key)


# -- the grid --------------------------------------------------------------------

GRIDS = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """Each grid through JAX's sharded step and the port's ranks (one spawn
    a world size), from JAX's padded init; the port's dense full-batch step
    from the same weights."""
    batches = _batches(3, seed=5)
    runs = {}
    for world in (2, 4):
        jobs, keys = [], []
        for dp, mp in [g for g in GRIDS if g[0] * g[1] == world]:
            jcfg = _jcfg(dp, mp)
            ctx = make_retrieval_context(jcfg, jax_mesh(dp, mp))
            jstate = create_retrieval_spmd_state(ctx)
            pcfg = Config.from_dict(ctx.cfg.to_dict())
            weights = two_tower_params_from_jax(to_numpy(jstate.params), pcfg.model)
            step = make_retrieval_spmd_train_step(ctx, donate=False)
            jmetrics = []
            for batch in batches:
                jstate, m = step(jstate, shard_retrieval_batch(ctx, batch))
                jmetrics.append({k: float(v) for k, v in m.items()})
            dense = retrieval.create_retrieval_state(pcfg, "cpu")
            dense.model.load_state_dict(weights)
            dense_metrics = [{k: float(v) for k, v in retrieval.train_step(
                dense, {k: torch.from_numpy(v) for k, v in b.items()}).items()}
                for b in batches]
            port = Config.from_dict(jcfg.to_dict()).to_dict()
            jobs.append({"cfg": port, "weights": weights, "batches": batches})
            keys.append(((dp, mp), {
                "jax": (jmetrics, two_tower_params_from_jax(to_numpy(jstate.params), pcfg.model),
                        _moments(jstate.opt_state, pcfg)),
                "dense": (dense_metrics, dense.model.state_dict(),
                          retrieval.eval_step(dense.model, batches[0]))}))
        ranks = spawn(worker.retrieval_steps, tmp_path_factory.mktemp("retrieval"), world, jobs)
        for j, (grid, ref) in enumerate(keys):
            runs[grid] = {**ref, "ranks": [r[j] for r in ranks]}
    return runs


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{g[0]}x{g[1]}" for g in GRIDS])
def test_grid_step_matches_the_dense_step_and_jax(grid_runs, grid):
    run = grid_runs[grid]
    r0 = run["ranks"][0]
    assert r0["step"] == 3
    jmetrics, jparams, jmoments = run["jax"]
    dmetrics, dparams, deval = run["dense"]
    for got, want, dense in zip(r0["metrics"], jmetrics, dmetrics):
        for key in ("loss", "top1_acc", "recall_at_10"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
            np.testing.assert_allclose(got[key], dense[key], rtol=1e-5, err_msg=key)
    full = r0["full"]
    for k, w in jparams.items():
        np.testing.assert_allclose(full["model"][k].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(full["model"][k].numpy(), dparams[k].numpy(), rtol=0,
                                   atol=TOL_DENSE_PARAMS, err_msg=k)
    for slot, moments in jmoments.items():
        for k, w in moments.items():
            np.testing.assert_allclose(full["optimizer"]["slots"][k][slot].numpy(), w.numpy(),
                                       rtol=0, atol=1e-5, err_msg=f"{k} {slot}")
    for key in ("loss", "top1_acc", "recall_at_10", "count"):
        np.testing.assert_allclose(r0["eval"][key], float(deval[key]), rtol=1e-5, err_msg=key)
    for k, true_v in (("user_embedding", NU), ("item_embedding", NI)):
        assert not full["model"][k][true_v:].any()  # pad rows stay zero
    for r in run["ranks"][1:]:
        assert r["metrics"] == r0["metrics"]
        for k, t in r["full"]["model"].items():
            assert torch.equal(t, full["model"][k]), k


def test_gather_items_backward_sums_over_the_data_group(tmp_path):
    """The pool's gradient reaches each data index's own items summed over
    the group: pinned by the [2, 1] grid equalling the dense step above,
    and here directly on two ranks."""
    ranks = spawn(worker.gather_items_grad, tmp_path, 2)
    g = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    for r, got in enumerate(ranks):
        # both ranks weigh the pool by (rank + 1) · g: the sum is 3g
        np.testing.assert_array_equal(got["pool"], np.concatenate([np.full((2, 3), 0.0),
                                                                   np.full((2, 3), 1.0)]))
        np.testing.assert_allclose(got["grad"], 3 * g[2 * r:2 * r + 2])


# -- the tasks -------------------------------------------------------------------

@pytest.fixture
def ratings_dir(tmp_path):
    """JAX's CLI fixture: user u prefers item u % 50."""
    rng = np.random.default_rng(0)
    train, val = tmp_path / "train", tmp_path / "val"
    train.mkdir()
    val.mkdir()
    lines = [f"{u},{u % 50},5.0\n" for u in rng.integers(0, 80, size=600)]
    (train / "ratings.csv").write_text("userId,movieId,rating\n" + "".join(lines))
    vlines = [f"{u},{u % 50},5.0\n" for u in rng.integers(0, 80, size=128)]
    (val / "ratings.csv").write_text("".join(vlines))
    return tmp_path


def _args(ratings_dir, tmp_path, task="train", *extra):
    return ["--task_type", task, "--device", "cpu",
            "--training_data_dir", str(ratings_dir / "train"),
            "--val_data_dir", str(ratings_dir / "val"),
            "--model_dir", str(tmp_path / "model"), "--model_name", "two_tower",
            "--batch_size", "32", "--num_epochs", "2",
            "--set", "model.user_vocab_size=80", "--set", "model.item_vocab_size=50",
            "--set", "model.embedding_size=8", "--set", 'model.tower_layers="16"',
            "--set", "model.tower_dim=8", "--set", "run.log_steps=8",
            "--set", f"run.servable_model_dir={tmp_path / 'servable'}", *extra]


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def test_cli_train_eval_export(ratings_dir, tmp_path, capsys):
    """The two-tower train task runs the retrieval task (the port once sent
    it down the CTR step and died there), then eval and export restore its
    checkpoint; the servable loads through the two-tower loader and encodes
    as the trained model does."""
    from deepfm_tpu_torch.launch.cli import main
    from deepfm_tpu_torch.serve.export import load_retrieval_servable

    assert main(_args(ratings_dir, tmp_path)) == 0
    lines = _lines(capsys)
    kinds = [x["kind"] for x in lines]
    assert "train" in kinds and "train_done" in kinds and kinds[-2:] == ["eval", "export"]
    done = [x for x in lines if x["kind"] == "train_done"][0]
    assert done["steps"] == 2 * (600 // 32) and done["examples"] == 2 * (600 // 32) * 32
    ev = [x for x in lines if x["kind"] == "eval"][0]
    assert set(ev) >= {"loss", "top1_acc", "recall_at_10", "examples"}
    assert ev["examples"] == 128 and np.isfinite(ev["loss"])
    assert main(_args(ratings_dir, tmp_path, "eval")) == 0
    assert _lines(capsys)[-1] == ev
    os.rename(tmp_path / "servable", tmp_path / "trained")
    assert main(_args(ratings_dir, tmp_path, "export")) == 0
    assert _lines(capsys)[-1]["kind"] == "export"
    encode_user, encode_item, cfg = load_retrieval_servable(tmp_path / "servable", device="cpu")
    assert cfg.model_name == "two_tower" and cfg.user_vocab_size == 80
    state = _restored(ratings_dir, tmp_path)
    assert state.step == done["step"]
    users = np.arange(10, dtype=np.int64)[:, None]
    with torch.no_grad():
        want = state.model(torch.from_numpy(users), torch.ones(10, 1),
                           torch.zeros(10, 1, dtype=torch.int64), torch.ones(10, 1))[0]
    np.testing.assert_array_equal(encode_user(users, np.ones((10, 1), np.float32)),
                                  want.numpy())
    np.testing.assert_allclose(np.linalg.norm(encode_item(users, np.ones((10, 1))), axis=1),
                               1.0, rtol=1e-5)


@pytest.mark.parametrize("case", ["small_vocab", "negative_ids", "infer", "short_val"])
def test_cli_refuses_as_jax_does(ratings_dir, tmp_path, case):
    from deepfm_tpu_torch.launch.cli import main

    args = _args(ratings_dir, tmp_path)
    match = {"small_vocab": "exceed configured vocabs", "negative_ids": "negative ids",
             "infer": "unsupported for two_tower", "short_val": "fewer rows than one batch"}
    if case == "small_vocab":
        args += ["--set", "model.user_vocab_size=10"]
    elif case == "negative_ids":
        with open(ratings_dir / "train" / "ratings.csv", "a") as f:
            f.write("-3,4,5.0\n")
    elif case == "infer":
        args[1] = "infer"
    else:
        (ratings_dir / "val" / "ratings.csv").write_text("1,1,5.0\n")
    with pytest.raises(ValueError, match=match[case]):
        main(args)


def test_resume_after_a_stop_at_the_same_batch(ratings_dir, tmp_path, capsys, monkeypatch):
    """A run stopped after step 7 (its checkpoint written) and the same
    command again end bit-equal to an uninterrupted run: the resume skips
    the batches the checkpoint trained on."""
    from deepfm_tpu_torch.launch.cli import main
    from deepfm_tpu_torch.parallel import retrieval as grid
    from deepfm_tpu_torch.train.loop import run_task

    whole = run_task(Config.from_dict(_cfg_dict(ratings_dir, tmp_path / "whole")), device="cpu")
    real = grid.train_step

    def stop_after_7(state, batch, ctx, *, stop=False):
        out = real(state, batch, ctx, stop=stop or state.step == 6)
        return out

    monkeypatch.setattr(grid, "train_step", stop_after_7)
    args = _args(ratings_dir, tmp_path, "train", "--set", "run.checkpoint_every_steps=5")
    assert main(args) == 0  # preempted: saved, exit 0
    kinds = [x["kind"] for x in _lines(capsys)]
    assert kinds[-1] == "preempted"
    monkeypatch.setattr(grid, "train_step", real)
    assert main(args) == 0
    lines = _lines(capsys)
    assert (lines[0]["kind"], lines[0]["step"]) == ("resume", 7)
    resumed = _restored(ratings_dir, tmp_path)
    assert resumed.step == whole.step == 2 * (600 // 32)
    for k, t in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], t), k


def _cfg_dict(ratings_dir, root):
    return {"model": {"model_name": "two_tower", "user_vocab_size": 80, "item_vocab_size": 50,
                      "embedding_size": 8, "tower_layers": (16,), "tower_dim": 8},
            "data": {"training_data_dir": str(ratings_dir / "train"), "batch_size": 32,
                     "num_epochs": 2},
            "run": {"task_type": "train", "model_dir": str(root / "model"), "log_steps": 8}}


def _restored(ratings_dir, root):
    """The latest checkpoint under ``root/model`` in a fresh state."""
    from deepfm_tpu_torch.checkpoint import Checkpointer
    from deepfm_tpu_torch.parallel.mesh import DistContext
    from deepfm_tpu_torch.parallel.retrieval import create_retrieval_dp_state

    cfg = Config.from_dict(_cfg_dict(ratings_dir, root))
    return Checkpointer(str(root / "model")).restore(
        create_retrieval_dp_state(cfg, DistContext(1, 0, 0, 1, torch.device("cpu"))))
