"""The port's checkpoints (``deepfm_tpu_torch/checkpoint``) and the
optimizer state they carry, on the CPU at a small width (V = 300, F = 6,
K = 8, MLP 16/8):

* a save and a restore give back, bit for bit, the weights, the BN
  statistics, the optimizer's slots and count (Adam, Adagrad, Momentum,
  FTRL), lazy Adam's moments, the step and the dropout generator, and the
  restored state's next step equals the saved one's bit for bit;
* retention, a step already on disk, no checkpoint, ``maybe_clear``, a
  half-written step, an asynchronous save that the next step cannot tear,
  the shape and lazy mismatches, object-store URLs;
* the cross-load: a JAX ``TrainState`` after two JAX steps, saved by the
  JAX ``Checkpointer`` and restored to numpy, through
  ``convert.train_state_from_jax``; the port's next step then equals JAX's
  (loss 1e-6 relative; parameters and optimizer slots within 1e-5 of
  their largest magnitude: the same float32 arithmetic, summed in another
  order), for each optimizer.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.checkpoint import Checkpointer as JaxCheckpointer
from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.train import make_train_step
from deepfm_tpu.train.step import create_train_state as jax_create_train_state
from deepfm_tpu_torch.checkpoint import Checkpointer, make_checkpointer, maybe_clear
from deepfm_tpu_torch.convert import OPT_STATE_FIELDS, _find_state, params_from_jax
from deepfm_tpu_torch.convert import train_state_from_jax
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.train.step import create_train_state, train_step

V, F, K, B = 300, 6, 8, 32
OPTIMIZERS = ["Adam", "Adagrad", "Momentum", "Ftrl"]


def _cfg(name="Adam", lazy=False, dropout=0.5, **model) -> Config:
    return Config.from_dict({
        "model": {"feature_size": V, "field_size": F, "embedding_size": K,
                  "deep_layers": (16, 8), "dropout_keep": (dropout, dropout),
                  "compute_dtype": "float32", "batch_norm": True,
                  "fused_kernel": "auto", **model},
        "optimizer": {"name": name, "learning_rate": 1e-2,
                      "lazy_embedding_updates": lazy},
        "run": {"seed": 3}})


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"feat_ids": rng.integers(0, V, (B, F)).astype(np.int64),
             "feat_vals": rng.random((B, F)).astype(np.float32),
             "label": (rng.random(B) < 0.3).astype(np.float32)} for _ in range(n)]


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _trained(cfg, n=2):
    state = create_train_state(cfg, "cpu")
    for batch in _batches(n):
        train_step(state, _t(batch))
    return state


def _flat(state) -> dict:
    """Every tensor of the state by name, the generator's included."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for name, slots in state.optimizer.slots.items():
        out.update({f"opt.{name}.{s}": t for s, t in slots.items()})
    if state.lazy is not None:
        for slot, tables in state.lazy.state_dict().items():
            out.update({f"lazy.{slot}.{k}": t for k, t in tables.items()})
    out["generator"] = state.generator.get_state()
    return out


def _assert_bit_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    assert (a.step, a.optimizer.count) == (b.step, b.optimizer.count)


CASES = [("Adam", False), ("Adam", True), ("Adagrad", False), ("Momentum", False),
         ("Ftrl", False)]


@pytest.mark.parametrize("name,lazy", CASES, ids=["adam", "lazy_adam", "adagrad",
                                                  "momentum", "ftrl"])
def test_round_trip_is_bit_exact_and_the_next_step_too(tmp_path, name, lazy):
    cfg = _cfg(name, lazy)
    state = _trained(cfg)
    ckpt = Checkpointer(tmp_path / "m")
    assert ckpt.save(state)
    fresh = create_train_state(cfg.with_overrides(run={"seed": 11}), "cpu")
    ckpt.restore(fresh)
    assert ckpt.latest_step() == 2 and ckpt.all_steps() == [2]
    _assert_bit_equal(fresh, state)
    batch = _t(_batches(3, seed=1)[2])
    want, got = train_step(state, batch), train_step(fresh, batch)
    assert float(got["loss"]) == float(want["loss"])
    _assert_bit_equal(fresh, state)
    ckpt.close()


def test_retention_resave_no_checkpoint_and_clear(tmp_path):
    cfg = _cfg()
    state = create_train_state(cfg, "cpu")
    ckpt = Checkpointer(tmp_path / "m", max_to_keep=3)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ckpt.restore(state)
    assert ckpt.latest_step() is None and ckpt.all_steps() == []
    for batch in _batches(5):
        train_step(state, _t(batch))
        assert ckpt.save(state)
    assert not ckpt.save(state)  # step 5 is on disk: a no-op
    assert ckpt.all_steps() == [3, 4, 5]
    # a half-written step (temporary name) and a directory without its file
    # are not checkpoints
    os.makedirs(tmp_path / "m" / ".tmp-9-1")
    os.makedirs(tmp_path / "m" / "8")
    assert ckpt.latest_step() == 5
    ckpt.restore(state, step=3)
    assert state.step == 3
    maybe_clear(str(tmp_path / "m"), False)
    assert ckpt.all_steps() == [3, 4, 5]
    maybe_clear(str(tmp_path / "m"), True)
    assert not os.path.exists(tmp_path / "m") and ckpt.latest_step() is None
    maybe_clear(str(tmp_path / "m"), True)  # nothing to clear


def test_async_save_is_a_snapshot_the_next_steps_cannot_tear(tmp_path):
    cfg = _cfg()
    state = _trained(cfg)
    snapshot = {k: v.clone() for k, v in _flat(state).items()}
    ckpt = Checkpointer(tmp_path / "m")
    assert ckpt.save(state, block=False)
    for batch in _batches(3, seed=5):  # in place, while the writer runs
        train_step(state, _t(batch))
    ckpt.restore(state)
    assert state.step == 2
    for k, v in _flat(state).items():
        assert torch.equal(v, snapshot[k]), k
    info = ckpt.last_save
    assert info["step"] == 2 and info["bytes"] > 0 and info["write_s"] >= 0.0
    assert ckpt.save(state, block=True) is False  # step 2 again


def test_mismatches_raise_with_their_reason(tmp_path):
    ckpt = Checkpointer(tmp_path / "m")
    ckpt.save(_trained(_cfg()), block=True)
    with pytest.raises(RuntimeError, match="fused_kernel"):
        ckpt.restore(create_train_state(_cfg(fused_kernel="off", feature_size=301), "cpu"))
    with pytest.raises(ValueError, match="lazy_embedding_updates=False"):
        ckpt.restore(create_train_state(_cfg(lazy=True), "cpu"))
    with pytest.raises(ValueError, match="optimizer"):
        ckpt.restore(create_train_state(_cfg("Adagrad"), "cpu"))
    # an object-store model_dir round-trips through the staging mirror
    # (checkpoint/remote.py, against the port's dev store), and
    # clear_existing_model empties it
    from deepfm_tpu_torch.checkpoint import RemoteCheckpointer
    from deepfm_tpu_torch.utils.dev_object_store import serve

    server, base = serve(str(tmp_path / "store"))
    try:
        url = f"{base}/bucket/model"
        remote = make_checkpointer(url, staging_dir=str(tmp_path / "stage"))
        assert isinstance(remote, RemoteCheckpointer)
        state = _trained(_cfg())
        assert remote.save(state, block=True)
        assert remote.all_steps() == [2]
        fresh = create_train_state(_cfg(), "cpu")
        again = make_checkpointer(url, staging_dir=str(tmp_path / "stage2"))
        again.restore(fresh)
        for k, v in state.model.state_dict().items():
            assert torch.equal(fresh.model.state_dict()[k], v), k
        maybe_clear(url, True)
        assert make_checkpointer(url, staging_dir=str(tmp_path / "stage3")).latest_step() is None
    finally:
        server.shutdown()
        server.server_close()


def _jax_config(name, lazy=False):
    return JaxConfig.from_dict({
        "model": dict(feature_size=V, field_size=F, embedding_size=K,
                      deep_layers=(16, 8), dropout_keep=(1.0, 1.0),
                      compute_dtype="float32", batch_norm=True, fused_kernel="off"),
        "optimizer": {"name": name, "learning_rate": 1e-2,
                      "lazy_embedding_updates": lazy},
        "data": {"batch_size": B},
    })


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want: torch.Tensor, what: str):
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * max(scale, 1e-12), err_msg=what)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_a_jax_checkpoint_cross_loads_and_the_next_step_matches(tmp_path, name):
    jcfg = _jax_config(name)
    step = jax.jit(make_train_step(jcfg))
    jstate = jax_create_train_state(jcfg)
    batches = _batches(3, seed=2)
    for batch in batches[:2]:
        jstate, _ = step(jstate, batch)
    jckpt = JaxCheckpointer(str(tmp_path / "jax"))
    jckpt.save(jstate, block=True)
    restored = _np(jckpt.restore(jax_create_train_state(jcfg)))
    jckpt.close()
    cfg = Config.from_dict(jcfg.to_dict())
    state = train_state_from_jax(restored, cfg, device="cpu")
    assert state.step == state.optimizer.count == 2
    jstate, jm = step(jstate, batches[2])
    m = train_step(state, _t(batches[2]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6)
    want = params_from_jax(_np(jstate.params), _np(jstate.model_state), cfg.model)
    for k, v in state.model.state_dict().items():
        _close(v, want[k], k)
    fields = OPT_STATE_FIELDS[name.lower()]
    node = _find_state(_np(jstate.opt_state), fields)
    for slot in fields:
        moments = params_from_jax(getattr(node, slot), _np(jstate.model_state), cfg.model)
        for param, slots in state.optimizer.slots.items():
            _close(slots[slot], moments[param], f"{param} {slot}")
