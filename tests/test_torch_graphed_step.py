"""The one train-step body (train/step.py) behind the eager and the graphed
step, on the CPU, at a small width (V = 300, F = 6, K = 8, MLP 16/8, B =
32, dropout off):

* ``graphed_train_step`` (the single-card step of the train task; on the
  CPU the body runs eagerly) against JAX's ``jitted_train_step`` (the
  donated jitted step), dense and lazy, float32 and bfloat16 MLP, over 5
  steps: the loss trajectory and the final parameters and moments;
* the step's per-step numbers (``step_scalars``) equal the host
  arithmetic the optimizer and the lazy row update used before they
  moved into the device buffer (optax's float32 bias corrections, the
  schedule at the optimizer's count and at the train step);
* the in-place and dtype contracts (analysis/trace_audit.py) and the
  graphed step's refusal of another batch shape.

Tolerances: those of ``tests/test_torch_train.py`` and
``tests/test_torch_lazy.py`` (float32: loss 1e-5 relative, parameters and
moments 1e-5 absolute; bfloat16 MLP: loss 1e-2 relative, parameters 5e-3
absolute).
"""

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.ops.embedding import narrow_ids as jax_narrow_ids
from deepfm_tpu.train import create_train_state as jax_create_train_state
from deepfm_tpu.train.step import jitted_train_step
from deepfm_tpu_torch.analysis.trace_audit import audit_train_step
from deepfm_tpu_torch.convert import _find_adam_state, _flat_params, params_from_jax
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.train.step import (SCALARS, StepGraph, create_train_state,
                                         graphed_train_step, load_scalars, resident_body,
                                         step_scalars, train_step)

V, F, K, B = 300, 6, 8, 32


def _config(lazy, compute_dtype="float32", **optimizer):
    return JaxConfig.from_dict({
        "model": dict(feature_size=V, field_size=F, embedding_size=K, deep_layers=(16, 8),
                      dropout_keep=(1.0, 1.0), compute_dtype=compute_dtype,
                      fused_kernel="auto"),
        "optimizer": {"lazy_embedding_updates": lazy, **optimizer},
        "data": {"batch_size": B},
    })


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = np.where(rng.random((B, F)) < 0.5, rng.integers(0, 20, (B, F)),
                       rng.integers(0, V, (B, F)))
        out.append({"feat_ids": ids.astype(np.int64),
                    "feat_vals": rng.random((B, F)).astype(np.float32),
                    "label": (rng.random(B) < 0.3).astype(np.float32)})
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_the_graphed_step_matches_jitted_train_step(lazy, compute_dtype):
    bf16 = compute_dtype == "bfloat16"
    loss_tol, tol = (1e-2, 5e-3) if bf16 else (1e-5, 1e-5)
    jcfg = _config(lazy, compute_dtype, warmup_steps=2, learning_rate=1e-3)
    jstate = jax_create_train_state(jcfg)
    cfg = Config.from_dict(jcfg.to_dict())
    state = create_train_state(cfg, "cpu")
    state.model.load_state_dict(params_from_jax(_np(jstate.params),
                                                _np(jstate.model_state), cfg.model))
    step = jitted_train_step(jcfg)
    for batch in _batches(5):
        jm_batch = {**batch, "feat_ids": jax_narrow_ids(batch["feat_ids"], V)}
        jstate, jm = step(jstate, jm_batch)
        m = graphed_train_step(state, _tensors(batch))
        for key in ("loss", "ce", "pred_mean", "label_mean"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=loss_tol,
                                       atol=0 if key != "pred_mean" else loss_tol,
                                       err_msg=key)
    assert state.graph is None  # the CPU runs the body eagerly
    assert state.step == int(jstate.step) == 5
    want = params_from_jax(_np(jstate.params), _np(jstate.model_state), cfg.model)
    got = state.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol,
                                   err_msg=k)
    rest_opt = jstate.opt_state[0] if lazy else jstate.opt_state
    adam = _find_adam_state(_np(rest_opt))
    assert state.optimizer.count == int(adam.count)
    for slot in ("mu", "nu"):
        for name, m_want in _flat_params(getattr(adam, slot), cfg.model).items():
            np.testing.assert_allclose(state.optimizer.slots[name][slot].numpy(), m_want,
                                       rtol=0, atol=tol, err_msg=f"{name} {slot}")
    if lazy:
        jlazy = jstate.opt_state[1]
        for slot in ("m", "v"):
            for key in ("fm_w", "fm_v"):
                np.testing.assert_allclose(getattr(state.lazy, slot)[key].numpy(),
                                           np.asarray(getattr(jlazy, slot)[key]), rtol=0,
                                           atol=tol, err_msg=f"lazy {key} {slot}")


def _bc(decay, count):
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


@pytest.mark.parametrize("optimizer", [
    {},
    {"warmup_steps": 3, "learning_rate": 1e-3, "embedding_lr_multiplier": 2.0},
    {"lr_schedule": "cosine", "warmup_steps": 2, "decay_steps": 6},
], ids=["constant", "warmup_multiplier", "cosine"])
@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
def test_the_scalar_buffer_holds_the_host_values(lazy, optimizer):
    """The buffer a step reads: the dense optimizer's lr at its count and
    optax's bias corrections at count + 1; the lazy rows' lr (schedule at
    the step, times the multiplier) and bias corrections at step + 1."""
    cfg = Config.from_dict(_config(lazy, **optimizer).to_dict())
    state = create_train_state(cfg, "cpu")
    opt, o = state.optimizer, cfg.optimizer
    for batch in _batches(7, seed=3):
        want = [opt.lr(opt.count) if callable(opt.lr) else opt.lr,
                _bc(o.adam_b1, opt.count + 1), _bc(o.adam_b2, opt.count + 1)]
        if lazy:
            lr = opt.lr(state.step) if callable(opt.lr) else opt.lr
            want += [lr * o.embedding_lr_multiplier, _bc(o.adam_b1, state.step + 1),
                     _bc(o.adam_b2, state.step + 1)]
        else:
            want += [0.0, 1.0, 1.0]
        assert step_scalars(state) == pytest.approx(want, rel=0, abs=0)
        buf = torch.zeros(len(SCALARS))
        load_scalars(state, buf)
        assert buf.tolist() == np.asarray(want, np.float32).tolist()
        graphed_train_step(state, _tensors(batch))
        assert torch.equal(state.scalars, buf)  # what the step read
    assert state.step == opt.count == 7


@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
def test_the_step_updates_its_state_in_place_in_float32(lazy):
    assert audit_train_step("cpu", lazy=lazy) == []


def test_the_graphed_step_on_the_cpu_is_the_eager_step():
    cfg = Config.from_dict(_config(False).to_dict())
    a, b = create_train_state(cfg, "cpu"), create_train_state(cfg, "cpu")
    for batch in _batches(3, seed=5):
        ma, mb = graphed_train_step(a, _tensors(batch)), train_step(b, _tensors(batch))
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    assert a.graph is None and a.step == b.step == 3


def test_the_step_graph_takes_one_batch_shape():
    cfg = Config.from_dict(_config(False).to_dict())
    state = create_train_state(cfg, "cpu")
    batch = _tensors(_batches(1)[0])
    graph = StepGraph(resident_body, state, batch)
    with pytest.raises(ValueError, match="shapes are fixed"):
        graph._check({**batch, "label": batch["label"][:-1]})
    with pytest.raises(ValueError, match="takes"):
        graph._check({k: v for k, v in batch.items() if k != "label"})
