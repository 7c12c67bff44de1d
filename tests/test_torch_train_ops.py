"""The port's training ops against the JAX package, on the CPU:

* the backward of the fused gather + FM (``fused_ctr_backward_plain``, the
  plain version of the B1′ kernel, and autograd through
  ``fused_ctr_interaction``) against ``jax.vjp`` of the JAX
  ``fused_ctr_interaction`` (Pallas interpret mode, eagerly, never under
  ``jit``: an interpret-mode kernel under ``jit`` takes minutes to compile)
  on in-range ids, and against ``jax.vjp`` of the plain JAX chain
  (``scaled_embedding`` + ``fm_first_order`` + ``fm_second_order`` over
  ``dense_lookup``) on every id, out-of-range, negative and padded-row ids
  included;
* train-mode batch norm against ``deepfm_tpu.ops.batch_norm``;
* the streaming AUC against ``deepfm_tpu.ops.auc``.

Tolerances: gradients 1e-5 relative to each output's largest magnitude
(float32 sums of up to a few hundred terms taken in another order: the JAX
kernel's VJP segment-sums by unique row, the port adds in index order; a
hot row's sum is ~100x its terms, so its rounding is ~100x theirs); batch
norm 1e-5 (batch mean and variance
summed in another order); AUC counts exact (sums of 0/1 weights), AUC
value 1e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.ops import auc as jax_auc
from deepfm_tpu.ops.embedding import dense_lookup as jax_dense_lookup
from deepfm_tpu.ops.embedding import scaled_embedding as jax_scaled_embedding
from deepfm_tpu.ops.fm import fm_first_order as jax_fm_first_order
from deepfm_tpu.ops.fm import fm_second_order as jax_fm_second_order
from deepfm_tpu.ops.pallas_ctr import fused_ctr_interaction as jax_fused
from deepfm_tpu_torch.ops import auc, fused_ctr
from deepfm_tpu_torch.ops.batch_norm import BNParams, BNState, batch_norm
from deepfm_tpu_torch.ops.fused_ctr import (fused_ctr_backward_plain,
                                            fused_ctr_interaction, fused_ctr_plain)

jax_bn = importlib.import_module("deepfm_tpu.ops.batch_norm")
TOL = 1e-5


def _problem(batch=32, v=300, f=6, k=8, seed=0, pad_rows=0, ids=None):
    rng = np.random.default_rng(seed)
    fm_w = rng.normal(size=(v,)).astype(np.float32)
    fm_v = rng.normal(size=(v, k)).astype(np.float32)
    if pad_rows:
        fm_v = np.concatenate([fm_v, np.zeros((pad_rows, k), np.float32)])
    if ids is None:
        ids = rng.integers(0, v, size=(batch, f)).astype(np.int32)
    vals = rng.normal(size=ids.shape).astype(np.float32)
    b, f = ids.shape
    cot = (rng.normal(size=(b, f, fm_v.shape[1])).astype(np.float32),
           rng.normal(size=(b,)).astype(np.float32),
           rng.normal(size=(b,)).astype(np.float32))
    return fm_w, fm_v, ids, vals, cot


def _chain(ids):
    """The plain JAX chain: each table clips ids to its own rows."""
    def fn(w, v, x):
        emb = jax_scaled_embedding(v, ids, x)
        return emb, jax_fm_first_order(jax_dense_lookup(w, ids), x), jax_fm_second_order(emb)
    return fn


def _jax_vjp(fn, fm_w, fm_v, vals, cot):
    _, vjp = jax.vjp(fn, jnp.asarray(fm_w), jnp.asarray(fm_v), jnp.asarray(vals))
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cot))]


def _port_bwd(fm_w, fm_v, ids, vals, cot):
    t = torch.from_numpy
    out = fused_ctr_backward_plain(t(cot[0]), t(cot[1]), t(cot[2]), t(fm_w), t(fm_v),
                                   t(ids), t(vals))
    return [o.numpy() for o in out]


def _assert_grads(got, want):
    for g, w, name in zip(got, want, ("d_fm_w", "d_fm_v", "d_vals")):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("batch", [32, 5, 1])
def test_backward_matches_jax_kernel_vjp_and_chain(batch):
    fm_w, fm_v, ids, vals, cot = _problem(batch=batch)
    got = _port_bwd(fm_w, fm_v, ids, vals, cot)
    kernel = lambda w, v, x: jax_fused(w, v, jnp.asarray(ids), x, True)  # noqa: E731
    _assert_grads(got, _jax_vjp(kernel, fm_w, fm_v, vals, cot))
    _assert_grads(got, _jax_vjp(_chain(jnp.asarray(ids)), fm_w, fm_v, vals, cot))


def test_backward_heavy_duplicates():
    """Zipf ids plus the 13 fixed numeric ids of every Criteo record: hot
    rows take one gradient term per batch row."""
    rng = np.random.default_rng(7)
    ids = (rng.zipf(1.3, size=(64, 20)) % 300).astype(np.int32)
    ids[:, :13] = np.arange(1, 14)
    fm_w, fm_v, ids, vals, cot = _problem(ids=ids, seed=7)
    got = _port_bwd(fm_w, fm_v, ids, vals, cot)
    kernel = lambda w, v, x: jax_fused(w, v, jnp.asarray(ids), x, True)  # noqa: E731
    _assert_grads(got, _jax_vjp(kernel, fm_w, fm_v, vals, cot))
    _assert_grads(got, _jax_vjp(_chain(jnp.asarray(ids)), fm_w, fm_v, vals, cot))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_backward_out_of_range_negative_and_padded_rows(dtype):
    """Against the plain JAX chain on every id, with fm_v padded: ids in
    [feature_size, padded rows) reach fm_v's zero pad rows for d_fm_v and
    the last fm_w row for d_fm_w; ids past the pad clip to the last pad
    row; negative ids to row 0."""
    v, pad = 300, 4
    fm_w, fm_v, ids, vals, cot = _problem(v=v, pad_rows=pad)
    ids = ids.astype(dtype)
    ids[0, :4] = [v, v + 2, v + pad + 50, -3]
    ids[1, 0] = 10_000_000
    if dtype == np.int64:
        ids[2, 2] = 2**40 + 5  # clips, never wraps
    got = _port_bwd(fm_w, fm_v, ids, vals, cot)
    # JAX runs with x64 off: hand it the ids already clipped into int32
    clipped = np.clip(ids, -1, v + pad).astype(np.int32)
    want = _jax_vjp(_chain(jnp.asarray(clipped)), fm_w, fm_v, vals, cot)
    _assert_grads(got, want)
    assert np.any(got[1][v:] != 0)  # the pad rows took their gradient


def test_jax_fused_backward_fault_on_padded_rows():
    """ROADMAP section C: the JAX `_fused_bwd` (pallas_ctr.py:338-342)
    drops the fm_w gradient of an int32 id in [feature_size, padded rows)
    and gives NaN d_vals there; the port follows the plain chain."""
    v, pad = 300, 4
    fm_w, fm_v, ids, vals, cot = _problem(v=v, pad_rows=pad)
    ids[0, 0] = v + 1
    kernel = lambda w, v_, x: jax_fused(w, v_, jnp.asarray(ids), x, True)  # noqa: E731
    d_w, _, d_vals = _jax_vjp(kernel, fm_w, fm_v, vals, cot)
    want = _jax_vjp(_chain(jnp.asarray(ids)), fm_w, fm_v, vals, cot)
    assert np.isnan(d_vals[0, 0]) and np.isfinite(np.delete(d_vals.ravel(), 0)).all()
    # the last fm_w row misses exactly the dropped term g_yw[0] * vals[0, 0]
    np.testing.assert_allclose(want[0][v - 1] - d_w[v - 1], cot[1][0] * vals[0, 0],
                               rtol=TOL, atol=TOL)
    _assert_grads(_port_bwd(fm_w, fm_v, ids, vals, cot), want)


def test_autograd_through_fused_ctr_is_the_plain_backward():
    """On CPU tensors FusedCTR's backward is fused_ctr_backward_plain; it
    equals autograd of the plain forward, and launches no kernel."""
    fm_w, fm_v, ids, vals, cot = _problem(pad_rows=4)
    ids[0, 0] = 301  # a pad row
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (fm_w, fm_v, vals)]
    ref = [torch.from_numpy(a).requires_grad_(True) for a in (fm_w, fm_v, vals)]
    t_ids = torch.from_numpy(ids)
    before = (fused_ctr.launches, fused_ctr.backward_launches)
    out = fused_ctr_interaction(leaves[0], leaves[1], t_ids, leaves[2])
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cot])
    out = fused_ctr_plain(ref[0], ref[1], t_ids, ref[2])
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cot])
    _assert_grads([a.grad.numpy() for a in leaves], [b.grad.numpy() for b in ref])
    assert (fused_ctr.launches, fused_ctr.backward_launches) == before


def test_autograd_with_an_unused_output():
    """An output left out of the loss gets a zero cotangent."""
    fm_w, fm_v, ids, vals, _ = _problem()
    got = torch.from_numpy(fm_v).requires_grad_(True)
    want = torch.from_numpy(fm_v).requires_grad_(True)
    t = torch.from_numpy
    fused_ctr_interaction(t(fm_w), got, t(ids), t(vals))[2].sum().backward()
    fused_ctr_plain(t(fm_w), want, t(ids), t(vals))[2].sum().backward()
    _assert_grads([got.grad.numpy()], [want.grad.numpy()])


def test_backward_skips_d_vals_when_vals_take_no_grad():
    fm_w, fm_v, ids, vals, cot = _problem()
    w = torch.from_numpy(fm_w).requires_grad_(True)
    v = torch.from_numpy(fm_v).requires_grad_(True)
    x = torch.from_numpy(vals)
    emb, y_w, y_v = fused_ctr_interaction(w, v, torch.from_numpy(ids), x)
    (emb.sum() + y_w.sum() + y_v.sum()).backward()
    assert x.grad is None and w.grad is not None and v.grad is not None
    t = torch.from_numpy
    d = fused_ctr_backward_plain(torch.ones_like(emb), torch.ones_like(y_w),
                                 torch.ones_like(y_v), t(fm_w), t(fm_v), t(ids), x,
                                 want_vals=False)
    assert d[2] is None
    np.testing.assert_allclose(v.grad.numpy(), d[1].numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax(train):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(12, 6)) * 2 + 1).astype(np.float32)
    scale, bias, mean = (rng.normal(size=6).astype(np.float32) for _ in range(3))
    var = (0.5 + rng.random(6)).astype(np.float32)
    got, got_state = batch_norm(
        torch.from_numpy(x), BNParams(torch.from_numpy(scale), torch.from_numpy(bias)),
        BNState(torch.from_numpy(mean), torch.from_numpy(var)), train=train, decay=0.8)
    want, want_state = jax_bn.batch_norm(
        jnp.asarray(x), jax_bn.BNParams(jnp.asarray(scale), jnp.asarray(bias)),
        jax_bn.BNState(jnp.asarray(mean), jnp.asarray(var)), train=train, decay=0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for g, w in zip(got_state, want_state):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_batch_norm_module_updates_buffers_in_train_mode_only():
    from deepfm_tpu_torch.models.deepfm import BatchNorm

    bn = BatchNorm(4, torch.device("cpu"), decay=0.5)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    bn.eval()
    bn(x)
    assert torch.equal(bn.moving_mean, torch.zeros(4))
    bn.train()
    bn(x)
    torch.testing.assert_close(bn.moving_mean, 0.5 * x.mean(0))
    torch.testing.assert_close(bn.moving_var, 0.5 + 0.5 * x.var(0, unbiased=False))


def test_auc_matches_jax():
    rng = np.random.default_rng(5)
    labels = (rng.random(500) < 0.3).astype(np.float32)
    preds = np.clip(0.3 * labels + 0.7 * rng.random(500), 0, 1).astype(np.float32)
    weights = rng.random(500).astype(np.float32)
    np.testing.assert_array_equal(auc.auc_thresholds(50), jax_auc.auc_thresholds(50))
    t = torch.from_numpy
    state = auc.auc_update(auc.auc_init(), t(labels[:300]), t(preds[:300]))
    state = auc.auc_merge(state, auc.auc_update(auc.auc_init(), t(labels[300:]),
                                                t(preds[300:])))
    jstate = jax_auc.auc_update(jax_auc.auc_init(), jnp.asarray(labels), jnp.asarray(preds))
    np.testing.assert_array_equal(state.counts.numpy(), np.asarray(jstate.counts))
    np.testing.assert_allclose(float(auc.auc_value(state)),
                               float(jax_auc.auc_value(jstate)), rtol=1e-6, atol=1e-6)
    weighted = auc.auc_update(auc.auc_init(), t(labels), t(preds), t(weights))
    jweighted = jax_auc.auc_update(jax_auc.auc_init(), jnp.asarray(labels),
                                   jnp.asarray(preds), jnp.asarray(weights))
    np.testing.assert_allclose(weighted.counts.numpy(), np.asarray(jweighted.counts),
                               rtol=1e-6, atol=1e-4)
    # the bucketed value is close to the exact rank statistic
    exact = auc.exact_auc(labels, preds)
    assert exact == jax_auc.exact_auc(labels, preds)
    assert abs(float(auc.auc_value(state)) - exact) < 1e-2
    assert np.isnan(auc.exact_auc(np.ones(3), np.ones(3)))


@pytest.mark.parametrize("batch", [32, 5])
def test_backward_every_lookup_one_row(batch):
    """Every lookup on row 7 (in range, fm_v unpadded): the whole batch's
    gradient lands on one row, the case the card's kernel sums in registers
    and in a shared-memory table before it reaches d_fm_v."""
    ids = np.full((batch, 6), 7, np.int32)
    fm_w, fm_v, ids, vals, cot = _problem(ids=ids, seed=11)
    got = _port_bwd(fm_w, fm_v, ids, vals, cot)
    kernel = lambda w, v, x: jax_fused(w, v, jnp.asarray(ids), x, True)  # noqa: E731
    _assert_grads(got, _jax_vjp(kernel, fm_w, fm_v, vals, cot))
    assert np.count_nonzero(np.abs(got[1]).sum(axis=1)) == 1
