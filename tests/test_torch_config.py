"""The port's config reader against the JAX schema: a JAX field the port does
not carry raises where its value would change what a job computes, and
loads where it cannot; the port's literal copy of the JAX defaults
(``JAX_ONLY_FIELDS``) and its own sections' defaults are held against
``deepfm_tpu.core.config``, so a drift on either side fails here."""

import json

import pytest

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.core.config import ModelConfig as JaxModelConfig
from deepfm_tpu_torch.core.config import (JAX_ONLY_FIELDS, Config, MeshConfig,
                                          ModelConfig, load_config)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


def test_the_jax_defaults_copy_matches_the_jax_package():
    jax = JaxConfig().to_dict()
    port = Config().to_dict()
    assert set(JAX_ONLY_FIELDS) | set(port) == set(jax)
    for section, fields in jax.items():
        carried = set(port.get(section, {}))
        copied = set(JAX_ONLY_FIELDS.get(section, {}))
        assert not carried & copied, section
        assert carried | copied == set(fields), section
        for name, value in fields.items():
            want = _tuples(value)
            if name in carried:
                assert _tuples(port[section][name]) == want, f"{section}.{name}"
            else:
                assert JAX_ONLY_FIELDS[section][name][0] == want, f"{section}.{name}"


# each field that changes the result, a value other than its default, and
# the ROADMAP item the error names
RAISING = [
    ("data", "permute_ids", True, "A6"),
    ("data", "shuffle_buffer", 4096, "A6"),
    ("data", "stream_mode", True, "A6"),
    ("data", "multi_path", True, "A6"),
    ("data", "eval_max_batches", 8, "A6"),
    ("data", "test_data_dir", "/data/test", "A6"),
    ("model", "tiered_embeddings", True, "A11"),
    ("elastic", "enabled", True, "A15"),
    ("run", "workers_per_host", 2, "A7"),
    ("mesh", "model_parallel", 2, "A9"),
    ("mesh", "coordinator_address", "10.0.0.1:1234", "torch.distributed.run"),
    ("mesh", "num_processes", 2, "torch.distributed.run"),
    ("mesh", "process_id", 1, "torch.distributed.run"),
]


@pytest.mark.parametrize("section,name,value,item", RAISING,
                         ids=[f"{s}.{n}" for s, n, _, _ in RAISING])
def test_a_field_that_changes_the_result_raises(section, name, value, item):
    d = JaxConfig().to_dict()
    d[section][name] = value
    json.dumps(d)  # as a config.json would hold it
    with pytest.raises(ValueError, match=rf"{section}\.{name}.*{item}"
                       if section != "mesh" else item) as e:
        Config.from_dict(d)
    assert name in str(e.value)


def test_the_model_section_alone_checks_too(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(
        {"model": {**JaxModelConfig().__dict__, "tiered_embeddings": True}},
        default=list))
    with pytest.raises(ValueError, match="tiered_embeddings.*A11"):
        load_config(tmp_path)


INERT = {
    "model": {"table_grad": "segsum", "shard_exchange": "alltoall",
              "shard_exchange_capacity": 1.5, "cin_layers": [64], "cross_layers": 2,
              "tiered_hot_slots": 4096},
    "optimizer": {"zero_sharding": "on"},
    "data": {"parallel_readers": 1, "training_channel_name": "train",
             "evaluation_channel_name": "eval"},
    "run": {"steps_per_loop": 8, "hosts": ["algo-1", "algo-2"], "current_host": "algo-2",
            "profile_dir": "/tmp/prof", "checkpoint_every_steps": 5,
            "keep_checkpoints": 1, "clear_existing_model": True, "serve_port": 9000,
            "serve_workers": 4, "funnel_top_k": 32, "funnel_retrieval": "int8",
            "online_max_batches": 3, "max_restarts": 2},
    "elastic": {"prefer_model_parallel": 4},
    "fleet": {"shadow_sample_percent": 5.0},
    "slo": {"deadline_ms": 50.0},
    "flywheel": {"enabled": True, "sample_rate": 0.5},
    "regions": {"enabled": True, "front_port": 9400},
}


def test_a_full_jax_config_and_the_inert_fields_load():
    assert Config.from_dict(JaxConfig().to_dict()) == Config()
    d = JaxConfig().to_dict()
    for section, fields in INERT.items():
        d[section].update(fields)
    d["model"]["feature_size"] = 500
    d["mesh"]["data_parallel"] = 4
    d["data"]["s3_shard"] = True
    cfg = Config.from_dict(json.loads(json.dumps(d)))
    assert cfg.model.feature_size == 500 and cfg.data.s3_shard
    assert cfg.mesh == MeshConfig(data_parallel=4)
    assert Config.from_dict(cfg.to_dict()) == cfg


def test_unknown_fields_are_dropped_with_a_warning(caplog):
    with caplog.at_level("WARNING"):
        cfg = Config.from_dict({"model": {"feature_size": 7, "from_the_future": 1},
                                "new_section": {"x": 1}})
    assert cfg.model == ModelConfig(feature_size=7)
    assert "model.from_the_future" in caplog.text and "new_section" in caplog.text


def test_set_overrides_still_reject_what_is_not_carried():
    with pytest.raises(TypeError):
        Config().with_overrides(data={"permute_ids": True})
    assert Config().with_overrides(mesh={"data_parallel": 2}).mesh.data_parallel == 2


def test_servable_configs_of_both_packages_load(tmp_path):
    """A JAX servable's config.json is the whole Config of the job that
    wrote it (deepfm_tpu/serve/export.py), stream-mode and permuted-id jobs
    included; ``load_config`` reads its model section only."""
    jcfg = JaxConfig.from_dict({
        "model": {"feature_size": 300, "field_size": 6, "embedding_size": 8,
                  "deep_layers": (16, 8), "dropout_keep": (1.0, 1.0)},
        "data": {"permute_ids": True, "stream_mode": True},
    })
    (tmp_path / "config.json").write_text(json.dumps(jcfg.to_dict()))
    got = load_config(tmp_path)
    assert (got.feature_size, got.deep_layers) == (300, (16, 8))
    port = tmp_path / "port"
    port.mkdir()
    (port / "config.json").write_text(json.dumps({"model": got.to_dict()}))
    assert load_config(port) == got
