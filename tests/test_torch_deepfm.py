"""The port's DeepFM forward (deepfm_tpu_torch/models/deepfm.py) against
JAX ``apply_deepfm(train=False)``: JAX ``init_deepfm`` parameters (biases
and batch-norm leaves perturbed so no term is trivially zero) go through
``convert.params_from_jax`` into the port, and both score the same numpy
batch, including out-of-range and negative ids.

Tolerances on the logits:
* float32 MLP: 1e-5 — the same float32 arithmetic with sums in another
  order;
* bfloat16 MLP: 4e-3 — torch and XLA:CPU may round bf16 products at other
  places; the bf16 head output is rounded to 2**-8 relative, about 2e-3 at
  these logits, so one ulp of it is allowed (on this CPU the two agreed to
  about 1e-8).
"""

import jax
import numpy as np
import pytest
import torch

from deepfm_tpu.core.config import ModelConfig as JaxModelConfig
from deepfm_tpu.models.deepfm import apply_deepfm, init_deepfm
from deepfm_tpu_torch.convert import expected_shapes, params_from_jax
from deepfm_tpu_torch.core.config import ModelConfig
from deepfm_tpu_torch.models import DeepFM, fm_v_rows, get_model

SMALL = dict(feature_size=1000, field_size=5, embedding_size=8, deep_layers=(16, 8))
JAX_ONLY = dict(dropout_keep=(1.0, 1.0))  # read at train time only
TOL = {"float32": 1e-5, "bfloat16": 4e-3}


def _jax_params(jcfg, seed=0):
    """JAX init, as numpy, with biases and BN leaves perturbed."""
    params, state = init_deepfm(jax.random.PRNGKey(seed), jcfg)
    params, state = jax.tree_util.tree_map(np.asarray, (params, state))
    rng = np.random.default_rng(seed)
    params["fm_b"] = rng.normal(size=1).astype(np.float32)
    for layer in params["mlp"].values():
        layer["bias"] = rng.normal(scale=0.1, size=layer["bias"].shape).astype(np.float32)
    if jcfg.batch_norm:
        for name, p in params["bn"].items():
            w = p.scale.shape[0]
            params["bn"][name] = p._replace(
                scale=(1 + 0.2 * rng.normal(size=w)).astype(np.float32),
                bias=(0.1 * rng.normal(size=w)).astype(np.float32))
            state["bn"][name] = state["bn"][name]._replace(
                moving_mean=(0.1 * rng.normal(size=w)).astype(np.float32),
                moving_var=(0.5 + rng.random(w)).astype(np.float32))
    return params, state


def _batch(id_dtype, b=24, f=5, vocab=1000, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, f))
    ids[0, 0], ids[1, 1], ids[2, 2] = -7, vocab, vocab + 5  # out of range
    if id_dtype == np.int64:
        ids[3, 3] = 2**40  # clips before it narrows
    return ids.astype(id_dtype), rng.random((b, f)).astype(np.float32)


@pytest.mark.parametrize("id_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused_kernel", ["off", "auto"])
def test_forward_matches_apply_deepfm(fused_kernel, compute_dtype, batch_norm, id_dtype):
    fields = dict(SMALL, fused_kernel=fused_kernel, compute_dtype=compute_dtype,
                  batch_norm=batch_norm)
    jcfg, cfg = JaxModelConfig(**fields, **JAX_ONLY), ModelConfig(**fields)
    params, state = _jax_params(jcfg)
    assert params["fm_v"].shape == (fm_v_rows(cfg), 8)
    assert fm_v_rows(cfg) == (1008 if fused_kernel == "auto" else 1000)
    model = DeepFM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, state, cfg))
    ids, vals = _batch(id_dtype)
    want, _ = apply_deepfm(params, state, ids, vals, cfg=jcfg, train=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(vals))
    assert got.dtype == torch.float32 and tuple(got.shape) == (24,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL[compute_dtype], atol=TOL[compute_dtype])


def test_convert_accepts_dict_batch_norm_leaves():
    """Orbax may restore the BN NamedTuples as dicts."""
    cfg = ModelConfig(**dict(SMALL, batch_norm=True))
    params, state = _jax_params(JaxModelConfig(**SMALL, **JAX_ONLY, batch_norm=True))
    as_dicts = {k: (v._asdict() if hasattr(v, "_asdict") else v)
                for k, v in params["bn"].items()}
    st = {k: v._asdict() for k, v in state["bn"].items()}
    a = params_from_jax(params, state, cfg)
    b = params_from_jax({**params, "bn": as_dicts}, {"bn": st}, cfg)
    assert a.keys() == b.keys() == expected_shapes(cfg).keys()
    for k in a:
        assert torch.equal(a[k], b[k])


def test_convert_rejects_shape_mismatch():
    params, state = _jax_params(JaxModelConfig(**SMALL, **JAX_ONLY))
    with pytest.raises(ValueError, match="fm_v"):
        # unpadded table against a config that pads it
        params_from_jax(params, state, ModelConfig(**dict(SMALL, fused_kernel="auto")))
    with pytest.raises(ValueError, match="mlp.layer_0.kernel"):
        params_from_jax(params, state, ModelConfig(**dict(SMALL, deep_layers=(32, 8))))


def test_registry_and_init():
    assert get_model(ModelConfig()).build is DeepFM
    with pytest.raises(ValueError, match="unknown model"):
        get_model("fibinet")
    cfg = ModelConfig(**dict(SMALL, fused_kernel="auto"))
    a = DeepFM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = DeepFM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    assert {k: tuple(v.shape) for k, v in a.state_dict().items()} == expected_shapes(cfg)
    # pad rows are zero; biases start at zero, as in the JAX init
    assert torch.all(a.fm_v[1000:] == 0) and torch.all(a.fm_b == 0)


def test_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeepFM(ModelConfig(**SMALL))


def test_config_validation_and_json_schema(tmp_path):
    import json

    with pytest.raises(ValueError, match="fused_kernel"):
        ModelConfig(fused_kernel="maybe")
    with pytest.raises(ValueError, match="compute_dtype"):
        ModelConfig(compute_dtype="float16")
    with pytest.raises(ValueError, match="embedding_size"):
        ModelConfig(embedding_size=0)
    assert ModelConfig(deep_layers="(16, 8)").deep_layers == (16, 8)
    # config.json as the JAX package writes it: extra sections and fields
    from deepfm_tpu.core.config import Config
    from deepfm_tpu_torch.core.config import load_config

    jcfg = Config.from_dict({"model": dict(SMALL, **JAX_ONLY, fused_kernel="auto",
                                           cin_layers=(4,))})
    (tmp_path / "config.json").write_text(json.dumps(jcfg.to_dict()))
    got = load_config(tmp_path)
    assert got == ModelConfig(**dict(SMALL, **JAX_ONLY, fused_kernel="auto",
                                     cin_layers=(4,)))
