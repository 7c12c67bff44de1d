"""The port's publisher (deepfm_tpu_torch/online/publisher.py) and
``convert.params_to_jax`` against the JAX package's: the same weights hash
to the same ``param_hash`` (batch norm off and on, fm_v padded),
``Manifest.to_json`` is byte-equal, a JAX publish root reads unchanged,
and the port's own publishes commit marker-last with retention."""

import json
import os

import jax
import numpy as np
import pytest

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.online.publisher import Manifest as JaxManifest
from deepfm_tpu.online.publisher import ModelPublisher as JaxPublisher
from deepfm_tpu.online.publisher import param_tree_hash as jax_hash
from deepfm_tpu.online.publisher import version_location as jax_location
from deepfm_tpu.train import create_train_state
from deepfm_tpu_torch.convert import params_from_jax, params_to_jax
from deepfm_tpu_torch.core.config import ModelConfig, load_config
from deepfm_tpu_torch.online import publisher as pub
from deepfm_tpu_torch.serve.export import load_servable, read_params

# fm_v of 300 rows at K = 8 pads to 304 rows (fused_kernel "auto")
MODEL = {"feature_size": 300, "field_size": 6, "embedding_size": 8,
         "deep_layers": (16, 8), "dropout_keep": (1.0, 1.0),
         "compute_dtype": "float32", "fused_kernel": "auto"}


def _jax_state(batch_norm: bool, seed: int = 0):
    cfg = JaxConfig.from_dict({"model": {**MODEL, "batch_norm": batch_norm},
                               "run": {"seed": seed}})
    state = create_train_state(cfg)
    if seed:  # other weights: a few leaves moved from the init
        rng = np.random.default_rng(seed)
        params = dict(state.params)
        params["fm_v"] = params["fm_v"] + rng.normal(size=params["fm_v"].shape).astype(np.float32)
        params["fm_b"] = params["fm_b"] + 0.25
        state = state._replace(params=params)
    return cfg, state


def _port(cfg, state):
    pcfg = ModelConfig.from_dict(cfg.model.__dict__)
    return pcfg, params_from_jax(jax.device_get(state.params),
                                 jax.device_get(state.model_state), pcfg)


@pytest.mark.parametrize("batch_norm", [False, True], ids=["bn_off", "bn_on"])
def test_param_tree_hash_matches_jax(batch_norm):
    cfg, state = _jax_state(batch_norm, seed=3)
    pcfg, sd = _port(cfg, state)
    assert sd["fm_v"].shape == (304, 8)
    params, model_state = params_to_jax(sd, pcfg)
    assert pub.param_tree_hash(params, model_state) == jax_hash(state.params, state.model_state)
    # tensors hash as their numpy values; one changed bit changes the hash
    assert pub.param_tree_hash(*params_to_jax({k: v.numpy() for k, v in sd.items()}, pcfg)) \
        == pub.param_tree_hash(params, model_state)
    sd["mlp.out.bias"][0] += 1e-6
    assert pub.param_tree_hash(*params_to_jax(sd, pcfg)) != pub.param_tree_hash(params, model_state)


@pytest.mark.parametrize("batch_norm", [False, True], ids=["bn_off", "bn_on"])
def test_params_to_jax_inverts_params_from_jax(batch_norm):
    cfg, state = _jax_state(batch_norm, seed=5)
    pcfg, sd = _port(cfg, state)
    params, model_state = params_to_jax(sd, pcfg)
    # the same leaves at the same JAX paths (the NamedTuples are each
    # package's own classes, with the same fields)
    want = jax.tree_util.tree_flatten_with_path(
        jax.device_get((state.params, state.model_state)))[0]
    got = jax.tree_util.tree_flatten_with_path((params, model_state))[0]
    assert ([jax.tree_util.keystr(p) for p, _ in got]
            == [jax.tree_util.keystr(p) for p, _ in want])
    for (_, a), (_, b) in zip(want, got):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a), b)
    back = params_from_jax(params, model_state, pcfg)
    assert all(np.array_equal(back[k].numpy(), sd[k].numpy()) for k in sd)
    with pytest.raises(ValueError, match="missing"):
        params_to_jax({k: v for k, v in sd.items() if k != "fm_b"}, pcfg)


MANIFESTS = [
    dict(version=1, step=0, param_hash="0" * 64, field_size=39, feature_size=117581,
         model_name="deepfm", created_unix=1790000000.123456),
    dict(version=12, step=4096, param_hash="ab" * 32, field_size=6, feature_size=300,
         model_name="deepfm", created_unix=1.5, cursor={"segment": "seg-00000003", "record": 17},
         watermark=1790000000.25, extra={"fence_token": 4, "note": "ünïcode"},
         index={"items": 10, "dim": 32, "sha256": "cd" * 32}),
]


@pytest.mark.parametrize("fields", MANIFESTS, ids=["plain", "full"])
def test_manifest_to_json_is_byte_equal(fields):
    text = pub.Manifest(**fields).to_json()
    assert text == JaxManifest(**fields).to_json()
    assert pub.Manifest.from_json(text) == pub.Manifest(**fields)
    assert pub.Manifest.from_json(json.dumps({**json.loads(text), "future": 1})) \
        == pub.Manifest(**fields)


def test_port_reads_a_jax_publish_root(tmp_path):
    root = str(tmp_path / "jax_root")
    jpub = JaxPublisher(root, keep=2)
    made = []
    for seed in (1, 2, 3):
        cfg, state = _jax_state(False, seed=seed)
        made.append(jpub.publish(cfg, state, cursor={"segment": seed}, watermark=float(seed)))
    assert pub.list_versions(root) == [2, 3]
    latest = pub.latest_manifest(root)
    assert latest.to_json() == made[-1].to_json()
    assert pub.read_manifest(root, 2).to_json() == made[1].to_json()
    assert pub.version_location(root, 3) == jax_location(root, 3)
    assert pub.fetch_version(root, 3, str(tmp_path / "staging")) == jax_location(root, 3)
    # the same weights published by the port carry the JAX hash
    cfg, state = _jax_state(False, seed=3)
    pcfg, sd = _port(cfg, state)
    mine = pub.ModelPublisher(str(tmp_path / "port_root")).publish(pcfg, sd, step=9)
    assert mine.param_hash == made[-1].param_hash and mine.step == 9


def test_publisher_commits_marker_last_and_retains(tmp_path):
    root = str(tmp_path / "root")
    cfg, state = _jax_state(True, seed=1)
    pcfg, sd = _port(cfg, state)
    p = pub.ModelPublisher(root, keep=2)
    assert pub.latest_manifest(root) is None and p.next_version() == 1
    for step in (10, 20, 30):
        m = p.publish(pcfg, sd, step=step, extra={"by": "test"})
    assert m.version == 3 and pub.list_versions(root) == [2, 3]
    assert not os.path.exists(pub.version_location(root, 1))
    # a version tree without its manifest (a crash mid-publish) is invisible,
    # and the next publish of that number overwrites it
    orphan = pub.version_location(root, 4)
    os.makedirs(orphan)
    open(os.path.join(orphan, "junk"), "w").close()
    assert pub.latest_manifest(root).version == 3
    m4 = p.publish(pcfg, sd, step=40)
    assert m4.version == 4 and not os.path.exists(os.path.join(orphan, "junk"))
    assert not any(n.endswith(".tmp") for n in os.listdir(root))
    # each version is a port servable with the published weights
    loc = pub.version_location(root, 4)
    assert load_config(loc) == pcfg
    assert all(np.array_equal(read_params(loc)[k], sd[k].numpy()) for k in sd)
    predict, _ = load_servable(loc, device="cpu")
    assert predict(np.ones((2, 6), np.int64), np.ones((2, 6), np.float32)).shape == (2,)
    assert m4.param_hash == pub.param_tree_hash(*params_to_jax(read_params(loc), pcfg))


def test_object_store_roots_raise(tmp_path):
    """A URL publish root (the port's dev store): versions, manifests,
    retention, orphan cleaning and fetch work as on a directory, and JAX's
    readers read the port's URL manifests."""
    from deepfm_tpu.online.publisher import latest_manifest as jax_latest
    from deepfm_tpu.online.publisher import list_versions as jax_versions
    from deepfm_tpu_torch.data.object_store import get_store
    from deepfm_tpu_torch.utils.dev_object_store import serve

    server, base = serve(str(tmp_path / "store"), max_keys=3)
    try:
        root = f"{base}/bucket/publish"
        cfg, sd = _port(*_jax_state(False, seed=3))
        p = pub.ModelPublisher(root, keep=2)
        for step in (1, 2, 3):
            p.publish(cfg, sd, step=step, cursor={"segment": "s", "record": step})
        assert pub.list_versions(root) == jax_versions(root) == [2, 3]
        m = pub.latest_manifest(root)
        j = jax_latest(root)
        assert (m.version, m.step, m.param_hash, m.cursor) == \
            (j.version, j.step, j.param_hash, j.cursor)
        assert (m.version, m.step, m.feature_size) == (3, 3, 300)
        local = pub.fetch_version(root, 3, str(tmp_path / "staging"))
        got = read_params(local)
        assert all(np.array_equal(got[k], sd[k].numpy()) for k in sd)
        get_store().put(f"{root}/versions/00000009/config.json", b"{}")
        assert p.clean_orphans() == [9]
    finally:
        server.shutdown()
        server.server_close()
    with pytest.raises(ValueError, match="keep"):
        pub.ModelPublisher(str(tmp_path), keep=0)
