"""Lazy (touched-rows) Adam in the port against the JAX package, on the CPU,
at a small width (V = 300, F = 6, K = 8, MLP 16/8, B = 32, dropout off):

* 5 lazy steps against ``jax.jit(make_train_step(cfg))`` with
  ``lazy_embedding_updates=True`` and ``fused_kernel="auto"`` (so fm_v
  carries 4 pad rows): the loss trajectory, the final parameters, both
  tables' m and v and the rest optimizer's moments; on batches with
  repeated ids, int64 ids past ``feature_size`` and negative ids; with the
  embedding lr multiplier and a warmup schedule;
* untouched rows' m and v bit-equal to before each step; fm_v's pad rows
  never change;
* ``_check_lazy``'s errors; the fixed-shape ``sort_segments``,
  ``segment_rows`` and ``lazy_adam_update`` against JAX's;
* the JAX fault C5 (ROADMAP §C);
* ``train_state_from_jax`` on the lazy ``(rest_opt, LazyAdamState)`` pair.

The JAX step gets its ids narrowed on the host (``narrow_ids``: int64 ids
clipped to ``[0, feature_size)``, then int32), as the JAX package's own
input path does (``parallel/spmd.py _narrow_id_fields``): with x64 off a
jitted step receives int64 ids as int32 and skips that clip (C5).  The port
gets the raw int64 ids and clips them itself.

Tolerances: those of ``tests/test_torch_train.py`` (float32: loss 1e-5
relative, parameters and moments 1e-5 absolute; bfloat16 MLP: loss 1e-2
relative, parameters 5e-3 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.ops.embedding import narrow_ids as jax_narrow_ids
from deepfm_tpu.ops.embedding import sort_segments as jax_sort_segments
from deepfm_tpu.train import create_train_state as jax_create_train_state
from deepfm_tpu.train import make_train_step
from deepfm_tpu.train.lazy import lazy_adam_update as jax_lazy_adam_update
from deepfm_tpu.train.lazy import segment_rows as jax_segment_rows
from deepfm_tpu_torch.convert import (_find_adam_state, _flat_params, params_from_jax,
                                     train_state_from_jax)
from deepfm_tpu_torch.core.config import Config, OptimizerConfig
from deepfm_tpu_torch.ops.embedding import sort_segments
from deepfm_tpu_torch.train.lazy import lazy_adam_update, segment_rows
from deepfm_tpu_torch.train.step import create_train_state, init_opt_state, train_step

V, F, K, B = 300, 6, 8, 32
PAD = 4  # fused_kernel="auto": fm_v rows up to a multiple of 128/K = 16


def _config(compute_dtype="float32", batch_norm=False, fused_kernel="auto", **optimizer):
    return JaxConfig.from_dict({
        "model": dict(feature_size=V, field_size=F, embedding_size=K,
                      deep_layers=(16, 8), dropout_keep=(1.0, 1.0),
                      compute_dtype=compute_dtype, batch_norm=batch_norm,
                      fused_kernel=fused_kernel),
        "optimizer": {"lazy_embedding_updates": True, **optimizer},
        "data": {"batch_size": B},
    })


def _batches(n, seed=0, hot=40):
    """Zipf-like ids from a ``hot``-row head (repeats within a batch), a
    batch row with one id in every field, int64 ids past feature_size (and
    past 2**31) and negative ids."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = np.where(rng.random((B, F)) < 0.5, rng.integers(0, hot, (B, F)),
                       rng.integers(0, V, (B, F)))
        ids[2, :] = 7
        ids[0, 0], ids[1, 1], ids[3, 2], ids[4, 3] = V + 7, -2, 2**40, V
        out.append({"feat_ids": ids.astype(np.int64),
                    "feat_vals": rng.random((B, F)).astype(np.float32),
                    "label": (rng.random(B) < 0.3).astype(np.float32)})
    return out


def _jax_batch(batch):
    return {**batch, "feat_ids": jax_narrow_ids(batch["feat_ids"], V)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_state(jcfg, jstate):
    cfg = Config.from_dict(jcfg.to_dict())
    state = create_train_state(cfg, "cpu")
    state.model.load_state_dict(params_from_jax(_np(jstate.params),
                                                _np(jstate.model_state), cfg.model))
    return cfg, state


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _compare_final(state, jstate, cfg, tol):
    want = params_from_jax(_np(jstate.params), _np(jstate.model_state), cfg.model)
    got = state.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol,
                                   err_msg=k)
    rest_opt, lazy = jstate.opt_state
    adam = _find_adam_state(_np(rest_opt))
    assert state.optimizer.count == int(adam.count) == state.step
    for slot in ("mu", "nu"):
        moments = _flat_params(getattr(adam, slot), cfg.model)
        assert moments.keys() == state.optimizer.slots.keys()
        for name, want_m in moments.items():
            np.testing.assert_allclose(state.optimizer.slots[name][slot].numpy(),
                                       want_m, rtol=0, atol=tol, err_msg=f"{name} {slot}")
    for slot in ("m", "v"):
        for key in ("fm_w", "fm_v"):
            np.testing.assert_allclose(getattr(state.lazy, slot)[key].numpy(),
                                       np.asarray(getattr(lazy, slot)[key]), rtol=0,
                                       atol=tol, err_msg=f"lazy {key} {slot}")


def _run_both(jcfg, batches, loss_tol, check=None):
    jstate = jax_create_train_state(jcfg)
    cfg, state = _port_state(jcfg, jstate)
    step = jax.jit(make_train_step(jcfg))
    for batch in batches:
        jstate, jm = step(jstate, _jax_batch(batch))
        before = _snapshot(state)
        m = train_step(state, _tensors(batch))
        for key in ("loss", "ce", "pred_mean", "label_mean"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=loss_tol,
                                       atol=0 if key != "pred_mean" else loss_tol,
                                       err_msg=key)
        assert float(m["loss"]) == float(m["ce"])
        if check is not None:
            check(before, state, batch)
    assert state.step == int(jstate.step) == len(batches)
    return cfg, state, jstate


def _snapshot(state):
    return {"fm_w": state.model.fm_w.detach().clone(),
            "fm_v": state.model.fm_v.detach().clone(),
            **{f"{s}.{k}": getattr(state.lazy, s)[k].clone()
               for s in ("m", "v") for k in ("fm_w", "fm_v")}}


def _bits(t):
    return t.contiguous().view(torch.int32)


def _untouched_rows_keep_their_bits(before, state, batch):
    """Rows no lookup of the batch reached keep table, m and v bit for bit;
    fm_v's pad rows never change."""
    touched = np.zeros(V + PAD, bool)
    touched[np.clip(batch["feat_ids"], 0, V - 1).reshape(-1)] = True
    after = _snapshot(state)
    for name, was in before.items():
        rows = torch.from_numpy(~touched[:was.shape[0]])
        assert torch.equal(_bits(after[name][rows]), _bits(was[rows])), name
        if name.endswith("fm_v"):
            assert torch.equal(_bits(after[name][V:]), _bits(torch.zeros(PAD, K))), name
    assert not torch.equal(after["m.fm_v"], before["m.fm_v"])  # the step ran


@pytest.mark.parametrize("compute_dtype,batch_norm", [
    ("float32", False), ("float32", True), ("bfloat16", False)])
def test_lazy_steps_match_make_train_step(compute_dtype, batch_norm):
    bf16 = compute_dtype == "bfloat16"
    loss_tol, param_tol = (1e-2, 5e-3) if bf16 else (1e-5, 1e-5)
    jcfg = _config(compute_dtype, batch_norm)
    cfg, state, jstate = _run_both(jcfg, _batches(5), loss_tol,
                                   check=_untouched_rows_keep_their_bits)
    _compare_final(state, jstate, cfg, param_tol)


@pytest.mark.parametrize("optimizer", [
    {"embedding_lr_multiplier": 2.0},
    {"warmup_steps": 3, "learning_rate": 1e-3},
    {"lr_schedule": "cosine", "warmup_steps": 2, "decay_steps": 6,
     "embedding_lr_multiplier": 0.5},
], ids=["lr_multiplier", "warmup", "cosine_multiplier"])
def test_lazy_steps_with_lr_options(optimizer):
    jcfg = _config(**optimizer)
    cfg, state, jstate = _run_both(jcfg, _batches(5, seed=1, hot=5), 1e-5,
                                   check=_untouched_rows_keep_their_bits)
    _compare_final(state, jstate, cfg, 1e-5)


def test_check_lazy_errors():
    params = {"fm_w": torch.zeros(3), "fm_v": torch.zeros(3, 2)}
    base = Config.from_dict({"optimizer": {"lazy_embedding_updates": True}})
    with pytest.raises(ValueError, match="Adam optimizer only"):
        init_opt_state(base.with_overrides(optimizer={"name": "Adagrad"}), params)
    with pytest.raises(ValueError, match="at least one of"):
        init_opt_state(base, {"mlp.out.kernel": torch.zeros(2, 1)})
    with pytest.raises(ValueError, match="fused_kernel='on'"):
        init_opt_state(base.with_overrides(model={"fused_kernel": "on"}), params)
    opt, lazy = init_opt_state(base, {**params, "fm_b": torch.zeros(1)})
    assert list(opt.slots) == ["fm_b"] and set(lazy.m) == {"fm_w", "fm_v"}
    dense, none = init_opt_state(Config(), params)
    assert none is None and set(dense.slots) == {"fm_w", "fm_v"}


@pytest.mark.parametrize("kind", ["random", "all_equal", "all_distinct", "one"])
def test_sort_segments_matches_jax(kind):
    rng = np.random.default_rng(3)
    n = 1 if kind == "one" else 257
    ids = {"random": rng.integers(0, 40, n), "all_equal": np.full(n, 11),
           "all_distinct": rng.permutation(1000)[:n], "one": np.array([5])}[kind]
    ids = ids.astype(np.int32)
    got = [t.numpy() for t in sort_segments(torch.from_numpy(ids))]
    for bound in (None, 1000):  # the general argsort and the packed sort
        want = [np.asarray(t) for t in jax_sort_segments(jnp.asarray(ids), bound)]
        for g, w, name in zip(got, want, ("order", "seg", "row_id", "valid")):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} bound={bound}")


def test_segment_rows_and_lazy_adam_update_match_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(-3, 60, (B, F))
    grads = rng.standard_normal((B, F, K)).astype(np.float32)
    row_id, summed, valid = jax_segment_rows(jnp.asarray(ids.reshape(-1)),
                                             jnp.asarray(grads.reshape(-1, K)))
    got = segment_rows(torch.from_numpy(ids.reshape(-1)),
                       torch.from_numpy(grads.reshape(-1, K)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(row_id))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(summed), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(valid))
    from deepfm_tpu.core.config import OptimizerConfig as JaxOptimizerConfig

    table = rng.standard_normal((50, K)).astype(np.float32)
    m = rng.standard_normal((50, K)).astype(np.float32) * 1e-2
    v = rng.random((50, K)).astype(np.float32) * 1e-3
    want = jax_lazy_adam_update(jnp.asarray(table), jnp.asarray(m), jnp.asarray(v),
                                jnp.asarray(ids), jnp.asarray(grads), jnp.int32(4),
                                JaxOptimizerConfig(), learning_rate=0.01, l2_reg=1e-3)
    t, mm, vv = (torch.from_numpy(x.copy()) for x in (table, m, v))
    lazy_adam_update(t, mm, vv, torch.from_numpy(ids), torch.from_numpy(grads), 4,
                     OptimizerConfig(), learning_rate=0.01, l2_reg=1e-3)
    for g, w, name in zip((t, mm, vv), want, ("table", "m", "v")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6,
                                   err_msg=name)
    untouched = np.setdiff1d(np.arange(50), np.clip(ids, 0, 49))
    for g, w in zip((t, mm, vv), (table, m, v)):
        np.testing.assert_array_equal(g.numpy()[untouched], w[untouched])


def test_c5_jax_lazy_step_reads_a_pad_row_and_updates_another():
    """ROADMAP C5, a JAX fault.  With int32 ids in [feature_size, padded
    fm_v rows) the JAX lazy step reads fm_v's zero pad row in the forward
    (``dense_lookup`` clips per table) and applies that lookup's gradient
    to row feature_size - 1 (the update clips to fm_w's rows).  The port
    clips both to fm_w's rows: its step is the step on the ids clipped to
    feature_size - 1."""
    jcfg = _config()
    batch = _batches(1, seed=5)[0]
    clipped = np.clip(batch["feat_ids"], 0, V - 1).astype(np.int32)
    clipped[5, :] = V - 1
    # pad rows of fm_v, past fm_w's rows, where the clipped ids are V - 1
    past = np.where(clipped == V - 1, V + 1 + np.arange(F) % 3, clipped).astype(np.int32)
    assert past.max() < V + PAD
    out = {}
    for name, ids in (("clipped", clipped), ("past", past)):
        jstate = jax_create_train_state(jcfg)
        cfg, state = _port_state(jcfg, jstate)
        jstate, jm = jax.jit(make_train_step(jcfg))(jstate, {**batch, "feat_ids": ids})
        m = train_step(state, _tensors({**batch, "feat_ids": ids}))
        out[name] = (float(jm["loss"]), _np(jstate.params)["fm_v"][V - 1],
                     float(m["loss"]), state.model.fm_v[V - 1].detach().numpy())
    j_clip, j_row_clip, p_clip, p_row_clip = out["clipped"]
    j_past, j_row_past, p_past, p_row_past = out["past"]
    # the port: past-the-vocabulary ids are the clipped ids, bit for bit
    assert p_past == p_clip and np.array_equal(p_row_past, p_row_clip)
    np.testing.assert_allclose(p_clip, j_clip, rtol=1e-5)
    # JAX: the forward read zeros for those lookups, so the loss moved ...
    assert abs(j_past - j_clip) > 1e-4
    # ... and row feature_size - 1 still trained on a gradient of that forward
    assert not np.allclose(j_row_past, j_row_clip, rtol=0, atol=1e-7)


def test_train_state_from_jax_continues_a_lazy_run():
    jcfg = _config(batch_norm=True, embedding_lr_multiplier=2.0)
    jstate = jax_create_train_state(jcfg)
    step = jax.jit(make_train_step(jcfg))
    batches = _batches(5, seed=6)
    for batch in batches[:3]:
        jstate, _ = step(jstate, _jax_batch(batch))
    cfg = Config.from_dict(jcfg.to_dict())
    state = train_state_from_jax(_np(jstate), cfg, device="cpu")
    assert state.step == 3 and state.optimizer.count == 3 and state.lazy is not None
    for batch in batches[3:]:
        jstate, jm = step(jstate, _jax_batch(batch))
        m = train_step(state, _tensors(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _compare_final(state, jstate, cfg, 1e-5)
    dense = cfg.with_overrides(optimizer={"lazy_embedding_updates": False})
    with pytest.raises(ValueError, match="holds"):
        train_state_from_jax(_np(jstate._replace(opt_state=jstate.opt_state[0])),
                             dense, device="cpu")
