"""The port's two-tower encoders (``deepfm_tpu_torch/models/two_tower.py``)
against ``deepfm_tpu/models/two_tower.py`` on the CPU, from parameters
drawn by the JAX init and converted with ``two_tower_params_from_jax``.

Tolerances: float32, 1e-6 on the L2-normalized outputs (the same
arithmetic, sums in another order).  bfloat16: 2e-2, because each tower
layer rounds its product and bias to bf16 (8 significant bits, a relative
step of 2**-8 = 3.9e-3), XLA and PyTorch round at different points of the
MLP, and two layers of such differences on unit vectors stay under 2e-2.
"""

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.core.config import ModelConfig as JaxModelConfig
from deepfm_tpu.models.two_tower import encode_tower as jax_encode_tower
from deepfm_tpu.models.two_tower import init_two_tower
from deepfm_tpu.parallel.retrieval import encode_items as jax_encode_items
from deepfm_tpu.parallel.retrieval import encode_queries as jax_encode_queries
from deepfm_tpu_torch.convert import expected_shapes, two_tower_params_from_jax
from deepfm_tpu_torch.core.config import ModelConfig, load_config
from deepfm_tpu_torch.models import TwoTower, encode_items, encode_queries, encode_tower
from deepfm_tpu_torch.serve.export import export_servable, load_model, load_servable

USER_VOCAB, ITEM_VOCAB, FU, FI = 50, 40, 3, 2
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _cfg_dict(dtype):
    return {"model_name": "two_tower", "user_vocab_size": USER_VOCAB,
            "item_vocab_size": ITEM_VOCAB, "user_field_size": FU,
            "item_field_size": FI, "tower_layers": (16, 12), "tower_dim": 8,
            "embedding_size": 4, "compute_dtype": dtype}


def _pair(dtype, seed=3):
    jcfg = JaxModelConfig(**_cfg_dict(dtype))
    params, _ = init_two_tower(jax.random.PRNGKey(seed), jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg = ModelConfig(**_cfg_dict(dtype))
    model = TwoTower(cfg, device="cpu")
    model.load_state_dict(two_tower_params_from_jax(params, cfg))
    return jcfg, params, cfg, model


def _features(rng, n, fields, vocab, huge=True):
    """Ids in range plus some out of range and negative (they clip).  The
    jitted JAX encoders receive int64 ids as int32 (x64 off), so an id
    past 2**31 wraps there before any clip (ROADMAP.md section C): their
    test leaves it out (``huge=False``)."""
    ids = rng.integers(0, vocab, (n, fields))
    ids[0, 0] = vocab + 7
    ids[1, -1] = -3
    if huge:
        ids[2, 0] = 2**40
    return ids.astype(np.int64), rng.random((n, fields)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", ["user", "item"])
def test_encode_tower_matches_jax(dtype, side):
    jcfg, params, cfg, model = _pair(dtype)
    rng = np.random.default_rng(0)
    fields, vocab = (FU, USER_VOCAB) if side == "user" else (FI, ITEM_VOCAB)
    ids, vals = _features(rng, 33, fields, vocab)
    want = np.asarray(jax_encode_tower(params, ids, vals, cfg=jcfg, side=side))
    with torch.inference_mode():
        got = encode_tower(model, torch.from_numpy(ids), torch.from_numpy(vals),
                           side=side).numpy()
    assert got.dtype == np.float32 and got.shape == (33, 8)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_encode_queries_and_items_match_jax():
    jcfg, params, cfg, model = _pair("float32", seed=5)
    rng = np.random.default_rng(1)
    uids, uvals = _features(rng, 9, FU, USER_VOCAB, huge=False)
    iids, ivals = _features(rng, 9, FI, ITEM_VOCAB, huge=False)
    with torch.inference_mode():
        u = encode_queries(model, torch.from_numpy(uids), torch.from_numpy(uvals))
        i = encode_items(model, torch.from_numpy(iids), torch.from_numpy(ivals))
        pu, pi = model(torch.from_numpy(uids), torch.from_numpy(uvals),
                       torch.from_numpy(iids), torch.from_numpy(ivals))
    np.testing.assert_allclose(u.numpy(), np.asarray(
        jax_encode_queries(params, uids, uvals, cfg=jcfg)), atol=TOL["float32"], rtol=0)
    np.testing.assert_allclose(i.numpy(), np.asarray(
        jax_encode_items(params, iids, ivals, cfg=jcfg)), atol=TOL["float32"], rtol=0)
    assert torch.equal(pu, u) and torch.equal(pi, i)


def test_out_of_range_ids_clip_to_the_vocabulary():
    _, _, cfg, model = _pair("float32")
    vals = torch.ones((4, FU))
    far = torch.tensor([[USER_VOCAB + 5, -9, 2**40]] * 4)
    edge = torch.tensor([[USER_VOCAB - 1, 0, USER_VOCAB - 1]] * 4)
    with torch.inference_mode():
        assert torch.equal(encode_tower(model, far, vals, side="user"),
                           encode_tower(model, edge, vals, side="user"))


def test_converter_raises_on_a_wrong_shape():
    _, params, cfg, _ = _pair("float32")
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad["user_tower"]["proj"]["kernel"] = np.zeros((12, 9), np.float32)
    with pytest.raises(ValueError, match="user_tower.proj.kernel"):
        two_tower_params_from_jax(bad, cfg)
    bad = dict(params, item_embedding=np.zeros((ITEM_VOCAB + 1, 4), np.float32))
    with pytest.raises(ValueError, match="item_embedding"):
        two_tower_params_from_jax(bad, cfg)


def test_config_keeps_two_tower_fields_and_servable_round_trips(tmp_path):
    """A two-tower config.json loads as a two-tower shape (the fields are
    carried, not dropped), and the servable reloads the same encoder."""
    _, params, cfg, model = _pair("float32")
    export_servable(cfg, two_tower_params_from_jax(params, cfg), tmp_path)
    loaded_cfg = load_config(tmp_path)
    assert loaded_cfg == cfg and loaded_cfg.tower_layers == (16, 12)
    assert set(expected_shapes(cfg)) == set(model.state_dict())
    back = load_model(tmp_path, device="cpu")
    assert isinstance(back, TwoTower)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)
    with pytest.raises(ValueError, match="two-tower servable"):
        load_servable(tmp_path, device="cpu")
