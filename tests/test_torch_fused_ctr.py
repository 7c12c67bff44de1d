"""The port's fused gather + FM (deepfm_tpu_torch/ops/fused_ctr.py) against
the JAX package's ``fused_ctr_interaction`` (Pallas, interpret mode on the
CPU) and its plain-JAX oracle, as tests/test_pallas_ctr.py runs them.

On the CPU the wrapper runs its plain version; the CUDA kernel itself is
held against that plain version on the card, in tests/test_torch_cuda.py
and chip_smoke.py.

Tolerances as in tests/test_pallas_ctr.py: emb 1e-6 (the same float32
product), y_w 1e-5 and y_v 1e-4 (sums taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.ops.embedding import dense_lookup as jax_dense_lookup
from deepfm_tpu.ops.embedding import scaled_embedding as jax_scaled_embedding
from deepfm_tpu.ops.fm import fm_first_order as jax_fm_first_order
from deepfm_tpu.ops.fm import fm_second_order as jax_fm_second_order
from deepfm_tpu.ops.pallas_ctr import fused_ctr_interaction as jax_fused
from deepfm_tpu_torch.core.platform import resolve_device
from deepfm_tpu_torch.ops import fused_ctr
from deepfm_tpu_torch.ops.fused_ctr import fused_ctr_interaction, fused_ctr_plain

TOL = {"emb": 1e-6, "y_w": 1e-5, "y_v": 1e-4}


def _problem(batch=48, v=257, f=7, k=8, seed=0, pad_rows=0, ids=None):
    rng = np.random.default_rng(seed)
    fm_w = rng.normal(size=(v,)).astype(np.float32)
    fm_v = rng.normal(size=(v, k)).astype(np.float32)
    if pad_rows:
        fm_v = np.concatenate([fm_v, np.zeros((pad_rows, k), np.float32)])
    if ids is None:
        ids = rng.integers(0, v, size=(batch, f)).astype(np.int32)
    vals = rng.normal(size=ids.shape).astype(np.float32)
    return fm_w, fm_v, ids, vals


def _oracle(fm_w, fm_v, ids, vals):
    """The plain-JAX reference path (take mode='clip' on each table)."""
    emb = jax_scaled_embedding(jnp.asarray(fm_v), jnp.asarray(ids), jnp.asarray(vals))
    y_w = jax_fm_first_order(jax_dense_lookup(jnp.asarray(fm_w), jnp.asarray(ids)),
                             jnp.asarray(vals))
    return emb, y_w, jax_fm_second_order(emb)


def _port(fm_w, fm_v, ids, vals):
    return fused_ctr_interaction(torch.from_numpy(fm_w), torch.from_numpy(fm_v),
                                 torch.from_numpy(ids), torch.from_numpy(vals))


def _assert_close(got, want, names=("emb", "y_w", "y_v")):
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=TOL[name],
                                   atol=TOL[name], err_msg=name)


@pytest.mark.parametrize("batch", [48, 10, 1])
def test_matches_jax_kernel_and_oracle(batch):
    fm_w, fm_v, ids, vals = _problem(batch=batch)
    got = _port(fm_w, fm_v, ids, vals)
    _assert_close(got, jax_fused(jnp.asarray(fm_w), jnp.asarray(fm_v),
                                 jnp.asarray(ids), jnp.asarray(vals), True))
    _assert_close(got, _oracle(fm_w, fm_v, ids, vals))
    assert [tuple(t.shape) for t in got] == [(batch, 7, 8), (batch,), (batch,)]
    assert all(t.dtype == torch.float32 for t in got)


@pytest.mark.parametrize("k", [4, 16, 32, 64, 128])
@pytest.mark.parametrize("f", [39, 40])
def test_matches_jax_at_kernel_layout_widths(k, f):
    """The widths the CUDA kernel's float4 layout covers (a row on 1 to 32
    lanes), at the flagship's 39 fields and at 40, with out-of-range and
    negative ids."""
    fm_w, fm_v, ids, vals = _problem(batch=13, v=300, f=f, k=k, seed=k + f)
    ids[0, 0], ids[1, 1], ids[2, 2] = 10_000, -4, 299
    got = _port(fm_w, fm_v, ids, vals)
    clipped = np.clip(ids, 0, 299)
    _assert_close(got, jax_fused(jnp.asarray(fm_w), jnp.asarray(fm_v),
                                 jnp.asarray(clipped), jnp.asarray(vals), True))
    _assert_close(got, _oracle(fm_w, fm_v, ids, vals))
    assert tuple(got[0].shape) == (13, f, k)


def test_heavy_duplicates():
    rng = np.random.default_rng(7)
    ids = (rng.zipf(1.3, size=(64, 11)) % 300).astype(np.int32)
    fm_w, fm_v, ids, vals = _problem(v=300, f=11, ids=ids, seed=7)
    got = _port(fm_w, fm_v, ids, vals)
    _assert_close(got, jax_fused(jnp.asarray(fm_w), jnp.asarray(fm_v),
                                 jnp.asarray(ids), jnp.asarray(vals), True))
    _assert_close(got, _oracle(fm_w, fm_v, ids, vals))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_out_of_range_and_negative_ids(dtype):
    fm_w, fm_v, ids, vals = _problem()
    ids = ids.astype(dtype)
    ids[0, 0], ids[1, 1], ids[2, 2] = 10_000_000, -3, 257
    if dtype == np.int64:
        ids[3, 3] = 2**40 + 5  # must clip, not wrap, when narrowed
    got = _port(fm_w, fm_v, ids, vals)
    clipped = np.clip(ids, 0, 256).astype(np.int32)
    _assert_close(got, _oracle(fm_w, fm_v, clipped, vals))
    _assert_close(got, jax_fused(jnp.asarray(fm_w), jnp.asarray(fm_v),
                                 jnp.asarray(clipped), jnp.asarray(vals), True))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_padded_fm_v(dtype):
    """fm_v with zero pad rows (fused_kernel != "off"): ids past the true
    vocabulary reach a zero row for emb, while the fm_w term clips to the
    last real fm_w row (fm_w is never padded)."""
    v, pad = 257, 7
    fm_w, fm_v, ids, vals = _problem(v=v, pad_rows=pad)
    ids = ids.astype(dtype)
    ids[0, :3] = [v, v + 3, v + pad + 50]  # pad rows and past them
    ids[1, 0] = -1
    emb, y_w, y_v = got = _port(fm_w, fm_v, ids, vals)
    assert torch.all(emb[0, :3] == 0)
    _assert_close(got, _oracle(fm_w, fm_v, ids.astype(np.int32), vals))
    jax_out = jax_fused(jnp.asarray(fm_w), jnp.asarray(fm_v),
                        jnp.asarray(ids.astype(np.int32)), jnp.asarray(vals), True)
    _assert_close((emb, y_v), (jax_out[0], jax_out[2]), names=("emb", "y_v"))
    # The JAX kernel gathers fm_w with jnp.take's default fill mode after
    # clipping to fm_v's padded rows, so its y_w is NaN on rows holding an
    # id in [feature_size, padded rows) (ROADMAP.md section C); the port
    # clips to fm_w's rows there and agrees with the oracle (checked above)
    # and with the JAX kernel on every other row.
    jax_yw = np.asarray(jax_out[1])
    assert np.isnan(jax_yw[0]) and np.isfinite(jax_yw[1:]).all()
    np.testing.assert_allclose(y_w.numpy()[1:], jax_yw[1:], rtol=1e-5, atol=1e-5)


def test_plain_version_is_the_cpu_path_and_counts_no_launch():
    fm_w, fm_v, ids, vals = _problem(batch=5)
    before = fused_ctr.launches
    got = _port(fm_w, fm_v, ids, vals)
    want = fused_ctr_plain(*map(torch.from_numpy, (fm_w, fm_v, ids, vals)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fused_ctr.launches == before


def test_rejects_other_devices():
    t = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_ctr_interaction(torch.empty(4, device="meta"), t,
                              torch.zeros((1, 2), dtype=torch.int32, device="meta"),
                              torch.zeros((1, 2), device="meta"))


def test_device_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
