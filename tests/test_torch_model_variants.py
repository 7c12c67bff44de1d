"""The port's other CTR families, xDeepFM and DCN-v2
(``deepfm_tpu_torch/models/{xdeepfm,dcnv2}.py``), against the JAX package
on the CPU, from JAX init parameters carried by ``convert.params_from_jax``
and numpy inputs made from a seed.

Small widths: V = 301 (not a multiple of the 128/K window: the variants'
tables carry no pad rows), F = 6, K = 8, MLP 16/8, ``cin_layers`` (8, 8),
``cross_layers`` 2, a batch of 32.

* the CIN against ``apply_cin`` and its loop oracle ``apply_cin_reference``;
  the cross stack against ``apply_cross``, its zero-weight identity and a
  single layer computed by hand;
* both forwards against ``apply_xdeepfm`` / ``apply_dcnv2`` in eval mode;
* three dense train steps against ``make_train_step`` (dropout off);
* the lazy step against JAX's lazy step: both tables for xDeepFM, fm_v
  alone for DCN-v2;
* the ``[2, 2]`` and ``[4, 1]`` grid steps over gloo ranks against
  ``make_spmd_train_step`` on the virtual CPU mesh
  (``_torch_dist_worker.grid_steps``, ``_torch_grid.py``);
* the L2 penalty on the sparse tables only, the registry, the config
  round trip, export -> ``load_servable`` -> ``GraphedPredictor`` (eager on
  the CPU), the CLI's train/eval/infer/export.  The tiered, pool, funnel,
  online and elastic paths hold both families to JAX in
  ``tests/test_torch_family_paths.py``, ``test_torch_elastic.py`` and
  ``test_torch_reshard.py``.

Tolerances: float32 1e-5 (the same float32 arithmetic with sums in another
order; torch's einsum may contract the CIN in another order than XLA);
bfloat16 4e-3 on logits (``tests/test_torch_deepfm.py TOL``); train steps
as ``tests/test_torch_train.py`` (loss 1e-5 relative, parameters and
moments 1e-5 absolute); the grid's loss 2e-5 relative
(``tests/test_model_variants.py``), its parameters and moments 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from _torch_grid import (JaxRun, assert_state_close, grid_batches, jax_cfg, port_cfg, spawn,
                         variant_widths)
from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.core.config import ModelConfig as JaxModelConfig
from deepfm_tpu.models import get_model as jax_get_model
from deepfm_tpu.models.dcnv2 import apply_cross, init_cross
from deepfm_tpu.models.xdeepfm import apply_cin, apply_cin_reference, init_cin
from deepfm_tpu.ops.embedding import narrow_ids as jax_narrow_ids
from deepfm_tpu.train import create_train_state as jax_create_train_state
from deepfm_tpu.train import make_train_step
from deepfm_tpu_torch.convert import (_find_adam_state, _flat_params, expected_shapes,
                                      params_from_jax, params_to_jax)
from deepfm_tpu_torch.core.config import Config, ModelConfig, load_config
from deepfm_tpu_torch.models import (CIN, Cross, DCNv2, XDeepFM, get_model,
                                     registered_models)
from deepfm_tpu_torch.train.step import create_train_state, train_step

V, F, K, B = 301, 6, 8, 32
FAMILIES = ("xdeepfm", "dcnv2")
TOL = {"float32": 1e-5, "bfloat16": 4e-3}
WIDTHS = dict(feature_size=V, field_size=F, embedding_size=K, deep_layers=(16, 8),
              dropout_keep=(1.0, 1.0), cin_layers=(8, 8), cross_layers=2, l2_reg=1e-3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jcfg(name, compute_dtype="float32", batch_norm=False, fused_kernel="auto",
          **optimizer) -> JaxConfig:
    return JaxConfig.from_dict({
        "model": dict(WIDTHS, model_name=name, compute_dtype=compute_dtype,
                      batch_norm=batch_norm, fused_kernel=fused_kernel),
        "optimizer": optimizer, "data": {"batch_size": B}})


def _jax_params(jcfg, seed=0):
    """The family's JAX init as numpy, biases and BN leaves perturbed."""
    params, state = _np(jax_get_model(jcfg.model).init(jax.random.PRNGKey(seed), jcfg.model))
    rng = np.random.default_rng(seed)
    params["fm_b"] = rng.normal(size=1).astype(np.float32)

    def perturb(tree):
        for leaf in tree.values():
            if isinstance(leaf, dict) and "bias" in leaf:
                leaf["bias"] = rng.normal(scale=0.1, size=leaf["bias"].shape).astype(np.float32)
            elif isinstance(leaf, dict):
                perturb(leaf)

    perturb({k: v for k, v in params.items() if k in ("cin", "cross", "mlp")})
    if jcfg.model.batch_norm:
        for name, p in params["bn"].items():
            w = p.scale.shape[0]
            params["bn"][name] = p._replace(scale=(1 + 0.2 * rng.normal(size=w)).astype(np.float32))
            state["bn"][name] = state["bn"][name]._replace(
                moving_mean=(0.1 * rng.normal(size=w)).astype(np.float32),
                moving_var=(0.5 + rng.random(w)).astype(np.float32))
    return params, state


def _ids(rng, b=B, hot=40):
    """Repeats from a hot head, a row with one id everywhere, out-of-range and
    negative ids."""
    ids = np.where(rng.random((b, F)) < 0.5, rng.integers(0, hot, (b, F)),
                   rng.integers(0, V, (b, F)))
    ids[2, :] = 7
    ids[0, 0], ids[1, 1], ids[3, 2] = V + 7, -2, V
    return ids.astype(np.int64)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"feat_ids": _ids(rng), "feat_vals": rng.random((B, F)).astype(np.float32),
             "label": (rng.random(B) < 0.3).astype(np.float32)} for _ in range(n)]


def _port_model(jcfg, params, state):
    cfg = ModelConfig.from_dict(jcfg.model.__dict__)
    model = get_model(cfg).build(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, state, cfg))
    return model


# -- the CIN and the cross stack ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cin_matches_apply_cin_and_its_loop_oracle(dtype):
    jm = JaxModelConfig(**dict(WIDTHS, compute_dtype=dtype))
    params = _np(init_cin(jax.random.PRNGKey(1), jm))
    params["out"]["bias"] = np.asarray([0.3], np.float32)
    emb = np.random.default_rng(2).normal(size=(B, F, K)).astype(np.float32)
    cin = CIN(ModelConfig(**dict(WIDTHS, compute_dtype=dtype)), torch.Generator())
    cin.load_state_dict({"filter_0": torch.from_numpy(params["filter_0"]),
                         "filter_1": torch.from_numpy(params["filter_1"]),
                         "out.kernel": torch.from_numpy(params["out"]["kernel"]),
                         "out.bias": torch.from_numpy(params["out"]["bias"])})
    assert cin.filter_1.shape == (8, F, 8)
    got = cin(torch.from_numpy(emb)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (B,)
    want = np.asarray(apply_cin(params, jnp.asarray(emb), cfg=jm))
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    if dtype == "float32":
        oracle = np.asarray(apply_cin_reference(params, jnp.asarray(emb), cfg=jm))
        np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5 * np.abs(oracle).max())


def _cross(dim, layers, dtype="float32"):
    return Cross(dim, ModelConfig(**dict(WIDTHS, cross_layers=layers, compute_dtype=dtype)),
                 torch.Generator())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_matches_apply_cross(dtype):
    dim = F * K
    jm = JaxModelConfig(**dict(WIDTHS, compute_dtype=dtype))
    params = _np(init_cross(jax.random.PRNGKey(3), dim, 2))
    rng = np.random.default_rng(4)
    for leaf in params.values():
        leaf["bias"] = rng.normal(scale=0.1, size=leaf["bias"].shape).astype(np.float32)
    x0 = rng.normal(size=(B, dim)).astype(np.float32)
    cross = _cross(dim, 2, dtype)
    cross.load_state_dict({f"{n}.{leaf}": torch.from_numpy(params[n][leaf])
                           for n in params for leaf in ("kernel", "bias")})
    got = cross(torch.from_numpy(x0)).detach().numpy()
    want = np.asarray(apply_cross(params, jnp.asarray(x0), cfg=jm))
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_cross_zero_weights_is_the_identity_and_one_layer_by_hand():
    dim = 4
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(3, dim)).astype(np.float32)
    w_out = rng.normal(size=(dim, 1)).astype(np.float32)
    # zero cross weights and biases: x_{l+1} = x_l, so y = x0·w_out, as in JAX
    jm = JaxModelConfig(**dict(WIDTHS, cross_layers=3, compute_dtype="float32"))
    zero = {f"layer_{i}": {"kernel": np.zeros((dim, dim), np.float32),
                           "bias": np.zeros(dim, np.float32)} for i in range(3)}
    zero["out"] = {"kernel": w_out, "bias": np.zeros(1, np.float32)}
    cross = _cross(dim, 3)
    cross.load_state_dict({f"{n}.{leaf}": torch.from_numpy(zero[n][leaf])
                           for n in zero for leaf in ("kernel", "bias")})
    got = cross(torch.from_numpy(x0)).detach().numpy()
    np.testing.assert_allclose(got, (x0 @ w_out)[:, 0], rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(apply_cross(zero, jnp.asarray(x0), cfg=jm)),
                               rtol=1e-6)
    # one layer: x1 = x0 ⊙ (W x0 + b) + x0, y = x1·w_out + b_out
    w = rng.normal(size=(dim, dim)).astype(np.float32)
    b = rng.normal(size=dim).astype(np.float32)
    one = _cross(dim, 1)
    one.load_state_dict({"layer_0.kernel": torch.from_numpy(w),
                         "layer_0.bias": torch.from_numpy(b),
                         "out.kernel": torch.from_numpy(w_out),
                         "out.bias": torch.tensor([0.25])})
    x1 = x0.astype(np.float64) * (x0.astype(np.float64) @ w + b) + x0
    want = (x1 @ w_out)[:, 0] + 0.25
    np.testing.assert_allclose(one(torch.from_numpy(x0)).detach().numpy(), want, rtol=1e-5)


# -- the forwards -------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("dtype,batch_norm", [("float32", False), ("float32", True),
                                              ("bfloat16", False)])
def test_forward_matches_jax_in_eval_mode(name, dtype, batch_norm):
    jcfg = _jcfg(name, dtype, batch_norm)
    params, state = _jax_params(jcfg)
    model = _port_model(jcfg, params, state)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        expected_shapes(model.cfg)
    assert model.fm_v.shape == (V, K)  # no pad rows, fused_kernel "auto" or not
    batch = _batches(1, seed=11)[0]
    with torch.no_grad():
        got = model(torch.from_numpy(batch["feat_ids"]),
                    torch.from_numpy(batch["feat_vals"])).numpy()
        got32 = model(torch.from_numpy(batch["feat_ids"]).to(torch.int32),
                      torch.from_numpy(batch["feat_vals"])).numpy()
    want, _ = jax_get_model(jcfg.model).apply(
        params, state, batch["feat_ids"], batch["feat_vals"], cfg=jcfg.model, train=False)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_array_equal(got, got32)
    # the layout round trip through params_to_jax
    back = params_from_jax(*params_to_jax(model.state_dict(), model.cfg), model.cfg)
    for k, t in model.state_dict().items():
        assert torch.equal(back[k], t), k


# -- dense and lazy steps -------------------------------------------------------

def _port_state(jcfg, jstate):
    cfg = Config.from_dict(jcfg.to_dict())
    state = create_train_state(cfg, "cpu")
    state.model.load_state_dict(params_from_jax(_np(jstate.params),
                                                _np(jstate.model_state), cfg.model))
    return cfg, state


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _compare_state(state, jstate, cfg, lazy: bool, tol=1e-5):
    want = params_from_jax(_np(jstate.params), _np(jstate.model_state), cfg.model)
    got = state.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol,
                                   err_msg=k)
    rest_opt, lazy_state = jstate.opt_state if lazy else (jstate.opt_state, None)
    adam = _find_adam_state(_np(rest_opt))
    assert state.optimizer.count == int(adam.count)
    for slot in ("mu", "nu"):
        moments = _flat_params(getattr(adam, slot), cfg.model)
        assert moments.keys() == state.optimizer.slots.keys()
        for name, m in moments.items():
            np.testing.assert_allclose(state.optimizer.slots[name][slot].numpy(), m,
                                       rtol=0, atol=tol, err_msg=f"{name} {slot}")
    if lazy:
        tables = ("fm_w", "fm_v") if cfg.model.model_name == "xdeepfm" else ("fm_v",)
        assert set(state.lazy.m) == set(lazy_state.m) == set(tables)
        for slot in ("m", "v"):
            for key in tables:
                np.testing.assert_allclose(getattr(state.lazy, slot)[key].numpy(),
                                           np.asarray(getattr(lazy_state, slot)[key]),
                                           rtol=0, atol=tol, err_msg=f"lazy {key} {slot}")


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
def test_three_steps_match_make_train_step(name, lazy):
    jcfg = _jcfg(name, lazy_embedding_updates=lazy)
    jstate = jax_create_train_state(jcfg)
    cfg, state = _port_state(jcfg, jstate)
    step = jax.jit(make_train_step(jcfg))
    for batch in _batches(3, seed=21):
        # JAX gets host-narrowed ids, as its input path gives them (C5)
        jstate, jm = step(jstate, {**batch, "feat_ids": jax_narrow_ids(batch["feat_ids"], V)})
        m = train_step(state, _tensors(batch))
        for key in ("loss", "ce", "pred_mean", "label_mean"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                       atol=1e-5 if key == "pred_mean" else 0, err_msg=key)
        if lazy:  # the lazy loss is the CE alone; the L2 moves into the row update
            assert float(m["loss"]) == float(m["ce"])
    assert state.step == int(jstate.step) == 3
    _compare_state(state, jstate, cfg, lazy)


@pytest.mark.parametrize("name", FAMILIES)
def test_l2_penalty_covers_the_sparse_tables_only(name):
    jcfg = _jcfg(name)
    params, state = _jax_params(jcfg)
    model = _port_model(jcfg, params, state)
    want = float(jax_get_model(jcfg.model).l2_penalty(params, 0.5))
    got = float(get_model(model.cfg).l2_penalty(model, 0.5))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    tables = sum(float((t.double() ** 2).sum()) for t in model.tables().values())
    np.testing.assert_allclose(got, 0.25 * tables, rtol=1e-6)
    assert set(model.tables()) == ({"fm_w", "fm_v"} if name == "xdeepfm" else {"fm_v"})


def test_registry_and_config_round_trip(tmp_path):
    assert registered_models() == ["dcnv2", "deepfm", "two_tower", "xdeepfm"]
    assert get_model("xdeepfm").build is XDeepFM and get_model("dcnv2").build is DCNv2
    jcfg = JaxConfig.from_dict({"model": {"model_name": "xdeepfm", "cin_layers": "64,32",
                                          "cross_layers": 5}})
    cfg = Config.from_dict(jcfg.to_dict())
    assert (cfg.model.cin_layers, cfg.model.cross_layers) == ((64, 32), 5)
    assert Config.from_dict(cfg.to_dict()) == cfg
    assert ModelConfig(cin_layers="[16, 4]").cin_layers == (16, 4)
    (tmp_path / "config.json").write_text(json.dumps(jcfg.to_dict()))
    assert load_config(tmp_path).cin_layers == (64, 32)
    for name in FAMILIES:
        a = get_model(name).build(ModelConfig(**WIDTHS, model_name=name), device="cpu",
                                  generator=torch.Generator().manual_seed(3))
        b = get_model(name).build(ModelConfig(**WIDTHS, model_name=name), device="cpu",
                                  generator=torch.Generator().manual_seed(3))
        for k, t in a.state_dict().items():
            assert torch.equal(t, b.state_dict()[k]), k
        assert torch.all(a.fm_b == 0)
        assert hasattr(a, "dropout_generator")


# -- the [data x model] grid ---------------------------------------------------

GRID_JOBS = [(name, grid, mode) for name in FAMILIES for grid in ((2, 2), (4, 1))
             for mode in ("dense", "lazy")]
GRID_MODES = {"dense": ({"shard_exchange": "psum"}, {"zero_sharding": "off"}),
              "lazy": ({"shard_exchange": "alltoall"}, {"lazy_embedding_updates": True})}


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """Every GRID_JOBS entry through JAX's ``make_spmd_train_step`` and the
    port's grid (one spawn of 4 gloo ranks)."""
    batches = grid_batches(3, seed=17)
    jobs, refs = [], []
    for name, (dp, mp_), mode in GRID_JOBS:
        model, opt = GRID_MODES[mode]
        jrun = JaxRun(jax_cfg(dp, mp_, {**variant_widths(name), **model}, opt))
        refs.append((jrun.steps(batches), jrun.params(), jrun.moments(), jrun.pcfg))
        jobs.append({"cfg": port_cfg(jrun.jcfg), "weights": jrun.weights,
                     "batches": batches})
    ranks = spawn(worker.grid_steps, tmp_path_factory.mktemp("variant_grid"), 4, jobs)
    return {key: (ref, [r[j] for r in ranks]) for j, (key, ref) in
            enumerate(zip(GRID_JOBS, refs))}


@pytest.mark.parametrize("name,grid,mode", GRID_JOBS,
                         ids=[f"{n}-{g[0]}x{g[1]}-{m}" for n, g, m in GRID_JOBS])
def test_grid_steps_match_make_spmd_train_step(grid_runs, name, grid, mode):
    (jmetrics, jparams, jmoments, pcfg), ranks = grid_runs[(name, grid, mode)]
    r0 = ranks[0]
    assert r0["error"] is None and r0["step"] == 3
    for got, want in zip(r0["metrics"], jmetrics):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
        for key in ("ce", "pred_mean", "label_mean"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    assert_state_close(r0["full"], jparams, jmoments, 1e-5, f"{name} {grid} {mode}")
    tables = ("fm_w", "fm_v") if name == "xdeepfm" else ("fm_v",)
    pv = pcfg.model.feature_size  # JAX's padded vocab: lcm(mp, 128/K)
    assert {n for n in r0["full"]["model"] if n.startswith("fm_") and n != "fm_b"} == \
        set(tables)
    for n in tables:
        assert r0["full"]["model"][n].shape[0] == pv
        assert not r0["full"]["model"][n][V:].any()  # pad rows stay zero
    if mode == "lazy":
        assert r0["lazy_updates"]["full"] + r0["lazy_updates"]["dedup"] == 3
    for r in ranks[1:]:  # every rank holds the same one-card layout
        for n, t in r["full"]["model"].items():
            assert torch.equal(t, r0["full"]["model"][n]), n


# -- serving ---------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_export_load_servable_and_graphed_predictor(tmp_path, name):
    from deepfm_tpu_torch.serve.export import export_servable, load_servable
    from deepfm_tpu_torch.serve.graphs import GraphedPredictor
    from deepfm_tpu_torch.serve.reload import load_swappable_servable

    jcfg = _jcfg(name, batch_norm=True)
    params, state = _jax_params(jcfg)
    model = _port_model(jcfg, params, state)
    path = export_servable(model.cfg, model.state_dict(), tmp_path / "servable")
    predict, cfg = load_servable(path, device="cpu")
    assert cfg == model.cfg
    batch = _batches(1, seed=31)[0]
    probs = predict(batch["feat_ids"], batch["feat_vals"])
    logits, _ = jax_get_model(jcfg.model).apply(
        params, state, batch["feat_ids"], batch["feat_vals"], cfg=jcfg.model, train=False)
    np.testing.assert_allclose(probs, np.asarray(jax.nn.sigmoid(logits)), rtol=1e-5, atol=1e-6)
    graphed = GraphedPredictor(cfg, model.state_dict(), device="cpu", buckets=(8, 64))
    assert graphed.precompile() == {}  # the CPU runs eagerly
    for slot in range(graphed.slots):
        np.testing.assert_array_equal(
            graphed.predict_with(slot, batch["feat_ids"], batch["feat_vals"]), probs)
    swap_predict, predictor, holder, _ = load_swappable_servable(path, device="cpu")
    np.testing.assert_array_equal(swap_predict(batch["feat_ids"], batch["feat_vals"]), probs)
    # a version with other weights swaps into the idle slot
    other = {k: v * 0.5 for k, v in model.state_dict().items()}
    predictor.load_slot(1, other)
    model.load_state_dict(other)
    with torch.no_grad():
        want = torch.sigmoid(model(torch.from_numpy(batch["feat_ids"]),
                                   torch.from_numpy(batch["feat_vals"]))).numpy()
    np.testing.assert_array_equal(predictor.predict_with(1, batch["feat_ids"],
                                                         batch["feat_vals"]), want)


# -- the CLI ---------------------------------------------------------------------

def _write_data(root, seed=0, n_train=640, n_val=256):
    from deepfm_tpu_torch.data.libsvm import generate_synthetic_ctr

    data = root / "data"
    data.mkdir()
    generate_synthetic_ctr(data / "train-0.tfrecords", num_records=n_train,
                           feature_size=V, field_size=F, seed=seed)
    generate_synthetic_ctr(data / "va-0.tfrecords", num_records=n_val,
                           feature_size=V, field_size=F, seed=seed + 1)
    return data


def _cli(tmp_path, name, task, *extra):
    from deepfm_tpu_torch.launch.cli import main

    data = tmp_path / "data"
    return main(["--task_type", task, "--device", "cpu", "--model_name", name,
                 "--training_data_dir", str(data), "--val_data_dir", str(data),
                 "--model_dir", str(tmp_path / "ckpt"),
                 "--servable_model_dir", str(tmp_path / "servable"),
                 "--feature_size", str(V), "--field_size", str(F),
                 "--embedding_size", str(K), "--deep_layers", "16,8",
                 "--batch_size", "64", "--log_steps", "5",
                 "--set", "model.cin_layers=[8,8]", "--set", "model.cross_layers=2",
                 *extra])


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
def test_cli_train_eval_infer_export(tmp_path, capsys, name, lazy):
    from deepfm_tpu_torch.serve.export import load_servable

    _write_data(tmp_path)
    extra = ("--set", "optimizer.lazy_embedding_updates=true") if lazy else ()
    assert _cli(tmp_path, name, "train", *extra) in (0, None)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    kinds = {x["kind"] for x in lines}
    assert {"train", "train_done", "eval", "export"} <= kinds
    train_eval = [x for x in lines if x["kind"] == "eval"][-1]
    assert 0.0 <= train_eval["auc"] <= 1.0 and np.isfinite(train_eval["loss"])
    assert _cli(tmp_path, name, "eval", *extra) in (0, None)
    ev = [json.loads(x) for x in capsys.readouterr().out.splitlines()
          if x.startswith("{")][-1]
    assert ev["kind"] == "eval" and ev["auc"] == train_eval["auc"]
    assert _cli(tmp_path, name, "infer", *extra) in (0, None)
    preds = np.loadtxt(tmp_path / "data" / "pred.txt")
    assert preds.shape == (256,) and np.all((preds > 0) & (preds < 1))
    os.rename(tmp_path / "servable", tmp_path / "trained_servable")
    assert _cli(tmp_path, name, "export", *extra) in (0, None)
    predict, cfg = load_servable(tmp_path / "servable", device="cpu")
    assert cfg.model_name == name and cfg.cin_layers == (8, 8)
    from deepfm_tpu_torch.data.pipeline import eval_batches
    from deepfm_tpu_torch.core.config import DataConfig

    first = next(iter(eval_batches(DataConfig(batch_size=256), field_size=F,
                                   data_dir=str(tmp_path / "data"))))
    np.testing.assert_allclose(predict(first["feat_ids"], first["feat_vals"]), preds,
                               atol=1e-6)
