"""The port's plain ops (deepfm_tpu_torch/ops) against their JAX twins in
deepfm_tpu/ops, on the same numpy inputs.

Tolerances: gathers and products are exact (same float32 arithmetic);
reductions 1e-6 to 1e-5 (float32 sums taken in another order).  Glorot
draws come from different generators, so they are checked as
distributions.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.ops import embedding as jax_emb
from deepfm_tpu.ops import fm as jax_fm
from deepfm_tpu_torch.ops.batch_norm import BNParams, BNState, batch_norm, bn_init
from deepfm_tpu_torch.ops.embedding import dense_lookup, narrow_ids, scaled_embedding
from deepfm_tpu_torch.ops.fm import fm_first_order, fm_second_order
from deepfm_tpu_torch.ops.initializers import glorot_normal, glorot_uniform

# the package re-exports a function under the module's name
jax_bn = importlib.import_module("deepfm_tpu.ops.batch_norm")


@pytest.mark.parametrize("batch", [1, 16])
def test_fm_terms_match_jax(batch):
    rng = np.random.default_rng(batch)
    w = rng.normal(size=(batch, 9)).astype(np.float32)
    x = rng.normal(size=(batch, 9)).astype(np.float32)
    e = rng.normal(size=(batch, 9, 8)).astype(np.float32)
    np.testing.assert_allclose(
        fm_first_order(torch.from_numpy(w), torch.from_numpy(x)).numpy(),
        np.asarray(jax_fm.fm_first_order(jnp.asarray(w), jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        fm_second_order(torch.from_numpy(e)).numpy(),
        np.asarray(jax_fm.fm_second_order(jnp.asarray(e))), rtol=1e-5, atol=1e-5)
    # and the identity against the explicit pairwise form
    np.testing.assert_allclose(
        fm_second_order(torch.from_numpy(e)).numpy(),
        np.asarray(jax_fm.fm_second_order_pairwise(jnp.asarray(e))),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ids", [
    np.array([[0, 5, 99], [-4, 100, 2**31 + 7]], np.int64),
    np.array([[0, 5, 99], [-4, 100, 3]], np.int32),
], ids=["int64", "int32"])
@pytest.mark.parametrize("vocab", [100, 120])
def test_narrow_ids_matches_jax(ids, vocab):
    got = narrow_ids(torch.from_numpy(ids), vocab)
    want = jax_emb.narrow_ids(ids, vocab)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_narrow_ids_disabled_and_wide_vocab_pass_through():
    ids = torch.tensor([[2**40, -1]], dtype=torch.int64)
    assert narrow_ids(ids, 10, enabled=False) is ids
    assert narrow_ids(ids, 2**31 + 1) is ids


@pytest.mark.parametrize("rank", [1, 2])
def test_dense_lookup_and_scaled_embedding_match_jax(rank):
    rng = np.random.default_rng(rank)
    table = rng.normal(size=(50,) if rank == 1 else (50, 4)).astype(np.float32)
    ids = np.array([[0, 49, 50, 1000], [-1, -50, 7, 3]], np.int32)
    vals = rng.normal(size=ids.shape).astype(np.float32)
    np.testing.assert_array_equal(
        dense_lookup(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
        np.asarray(jax_emb.dense_lookup(jnp.asarray(table), jnp.asarray(ids))))
    if rank == 2:
        np.testing.assert_array_equal(
            scaled_embedding(torch.from_numpy(table), torch.from_numpy(ids),
                             torch.from_numpy(vals)).numpy(),
            np.asarray(jax_emb.scaled_embedding(jnp.asarray(table), jnp.asarray(ids),
                                                jnp.asarray(vals))))


def test_batch_norm_infer_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(12, 6)).astype(np.float32)
    scale, bias, mean = (rng.normal(size=6).astype(np.float32) for _ in range(3))
    var = rng.random(6).astype(np.float32)
    got, _ = batch_norm(torch.from_numpy(x),
                        BNParams(torch.from_numpy(scale), torch.from_numpy(bias)),
                        BNState(torch.from_numpy(mean), torch.from_numpy(var)))
    want, _ = jax_bn.batch_norm(
        jnp.asarray(x), jax_bn.BNParams(jnp.asarray(scale), jnp.asarray(bias)),
        jax_bn.BNState(jnp.asarray(mean), jnp.asarray(var)), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_bn_init_matches_jax():
    params, state = bn_init(5)
    jp, js = jax_bn.bn_init(5)
    for got, want in zip((*params, *state), (*jp, *js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_glorot_normal_distribution():
    """Truncated at ±2σ with TF's correction: the sample std is
    sqrt(2 / (fan_in + fan_out)) to within 2%, the mean is ~0, and nothing
    lies past the truncation bound."""
    g = torch.Generator().manual_seed(0)
    shape = (2000, 100)
    x = glorot_normal(shape, g)
    target = (2.0 / sum(shape)) ** 0.5
    bound = 2.0 * target / 0.87962566103423978
    assert x.dtype == torch.float32 and tuple(x.shape) == shape
    assert abs(float(x.mean())) < 0.01 * target
    assert abs(float(x.std()) / target - 1.0) < 0.02
    assert float(x.abs().max()) <= bound * (1 + 1e-6)
    # rank 1 (FM_W): fan_in = fan_out = shape[0]
    w = glorot_normal((20000,), g)
    assert abs(float(w.std()) / (1.0 / 20000) ** 0.5 - 1.0) < 0.03


def test_glorot_uniform_distribution():
    g = torch.Generator().manual_seed(1)
    shape = (300, 200)
    x = glorot_uniform(shape, g)
    limit = (6.0 / sum(shape)) ** 0.5
    assert float(x.abs().max()) <= limit
    assert abs(float(x.mean())) < 0.01 * limit
    # uniform on [-l, l] has std l / sqrt(3)
    assert abs(float(x.std()) / (limit / 3 ** 0.5) - 1.0) < 0.02


def test_initializers_are_seeded():
    a = glorot_normal((10, 4), torch.Generator().manual_seed(5))
    b = glorot_normal((10, 4), torch.Generator().manual_seed(5))
    c = glorot_normal((10, 4), torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
