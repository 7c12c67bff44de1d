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
    ("data", "shuffle_buffer", 4096, "A6"),
    ("data", "stream_mode", True, "A6"),
    ("data", "multi_path", True, "A6"),
    ("data", "eval_max_batches", 8, "A6"),
    ("model", "tiered_cold_url", "http://store:9000/bucket/cold", "A15"),
    ("elastic", "enabled", True, "A15"),
    ("run", "workers_per_host", 2, "A7"),
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


# the row-sharded grid's fields, carried with JAX's validation, and the
# port's refusal of the fused_kernel='on' lookup on sharded tables; each
# case: the sections it sets and the error it must raise
GRID_FIELDS = [
    ({"model": {"shard_exchange_capacity": 1.5}}, "shard_exchange_capacity must be in"),
    ({"model": {"table_grad": "dense"}}, "table_grad must be"),
    ({"model": {"shard_exchange": "ring"}}, "shard_exchange must be"),
    ({"optimizer": {"zero_sharding": "maybe"}}, "zero_sharding must be"),
    ({"model": {"table_grad": "segsum", "fused_kernel": "on"}}, "no effect with fused"),
    ({"model": {"fused_kernel": "on"}, "mesh": {"model_parallel": 2}},
     "fused_kernel='on' requires the dense"),
    ({"model": {"shard_exchange_capacity": 0.001, "field_size": 39},
      "data": {"batch_size": 8}, "mesh": {"model_parallel": 2}}, "one example's distinct"),
]


@pytest.mark.parametrize("sections,error", GRID_FIELDS,
                         ids=[e.split()[0] for _, e in GRID_FIELDS])
def test_the_grid_fields_keep_jax_validation(sections, error):
    d = JaxConfig().to_dict()
    for section, fields in sections.items():
        d[section].update(fields)
    with pytest.raises(ValueError, match=error):
        Config.from_dict(d)


def test_the_grid_fields_warn_where_jax_warns():
    with pytest.warns(UserWarning, match="no-op"):
        Config.from_dict({"optimizer": {"zero_sharding": "on"},
                          "mesh": {"data_parallel": 1}})
    with pytest.warns(UserWarning, match="ignored whenever"):
        Config.from_dict({"model": {"table_grad": "segsum", "fused_kernel": "auto"}})
    with pytest.warns(UserWarning, match="frequent overflow"):
        Config.from_dict({"model": {"shard_exchange_capacity": 0.1, "field_size": 4},
                          "data": {"batch_size": 8}, "mesh": {"model_parallel": 2}})


def test_the_model_section_alone_checks_too(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(
        {"model": {**JaxModelConfig().__dict__, "tiered_embeddings": True,
                   "tiered_cold_url": "s3://bucket/cold"}},
        default=list))
    with pytest.raises(ValueError, match="tiered_cold_url.*A15"):
        load_config(tmp_path)


INERT = {
    "model": {"cin_layers": [64], "cross_layers": 2, "tiered_hot_slots": 4096},
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
    # carried since the online tasks were ported; a filled-in section loads
    "flywheel": {"enabled": True, "sample_rate": 0.5, "impression_log_url": "/tmp/imps"},
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
    # the row-sharded grid's fields are carried, at JAX's values
    d["model"].update(table_grad="segsum", shard_exchange="alltoall",
                      shard_exchange_capacity=0.5)
    d["optimizer"]["zero_sharding"] = "on"
    d["data"]["permute_ids"] = True
    d["mesh"]["model_parallel"] = 2
    cfg = Config.from_dict(json.loads(json.dumps(d)))
    assert cfg.model.feature_size == 500 and cfg.data.s3_shard
    assert cfg.mesh == MeshConfig(data_parallel=4, model_parallel=2)
    assert (cfg.model.table_grad, cfg.model.shard_exchange,
            cfg.model.shard_exchange_capacity) == ("segsum", "alltoall", 0.5)
    assert cfg.optimizer.zero_sharding == "on" and cfg.data.permute_ids
    assert Config.from_dict(cfg.to_dict()) == cfg


def test_unknown_fields_are_dropped_with_a_warning(caplog):
    with caplog.at_level("WARNING"):
        cfg = Config.from_dict({"model": {"feature_size": 7, "from_the_future": 1},
                                "new_section": {"x": 1}})
    assert cfg.model == ModelConfig(feature_size=7)
    assert "model.from_the_future" in caplog.text and "new_section" in caplog.text


def test_set_overrides_still_reject_what_is_not_carried():
    with pytest.raises(TypeError):
        Config().with_overrides(data={"shuffle_buffer": 4096})
    assert Config().with_overrides(data={"permute_ids": True}).data.permute_ids
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


SERVE_FIELDS = {"serve_port": 9001, "serve_host": "0.0.0.0", "serve_item_corpus": "c.jsonl",
                "serve_workers": 1, "serve_buckets": "4,16", "serve_max_wait_ms": 0.5,
                "serve_reload_url": "/pub", "serve_reload_interval_secs": 0.3,
                "serve_groups": 0}
POOL_FIELDS = {"serve_group_data_parallel": 2, "serve_group_model_parallel": 2,
               "serve_router_port": 8600, "serve_retry_limit": 3,
               "serve_health_interval_secs": 0.5, "serve_eject_after": 4}


def test_the_serve_task_fields_are_carried_and_the_pools_raise(monkeypatch):
    """The run.serve_* fields, the shard-group pool's included, are the
    port's own and load at JAX's values.  The serve task takes both pools
    (serve_workers > 1: serve/server.py serve_pool; serve_groups > 0: the
    pool's main with JAX's argv, --device added), and a fleet.tenants
    value raises naming ROADMAP A18."""
    import deepfm_tpu.serve.pool.__main__ as jax_pool_main
    import deepfm_tpu.serve.server as jax_server
    from deepfm_tpu.train.loop import run_task as jax_run_task
    from deepfm_tpu_torch.serve import server
    from deepfm_tpu_torch.serve.pool import __main__ as pool_main
    from deepfm_tpu_torch.train.loop import run_serve

    assert not (set(SERVE_FIELDS) | set(POOL_FIELDS)) & set(JAX_ONLY_FIELDS["run"])
    d = JaxConfig().to_dict()
    d["run"].update(SERVE_FIELDS, **POOL_FIELDS)
    cfg = Config.from_dict(json.loads(json.dumps(d)))
    assert {k: getattr(cfg.run, k) for k in SERVE_FIELDS} == SERVE_FIELDS
    assert {k: getattr(cfg.run, k) for k in POOL_FIELDS} == POOL_FIELDS
    seen = {}
    monkeypatch.setattr(server, "serve_pool", lambda d, **kw: seen.update(pool=(d, kw)))
    monkeypatch.setattr(pool_main, "main", lambda argv: seen.update(groups=argv))
    monkeypatch.setattr(jax_pool_main, "main", lambda argv: seen.update(jax_groups=argv))
    monkeypatch.setattr(jax_server, "serve_pool", lambda d, **kw: seen.update(jax_pool=kw))
    run_serve(cfg.with_overrides(run={"serve_workers": 2}), device="cpu")
    assert seen["pool"][0] == cfg.run.servable_model_dir
    assert seen["pool"][1]["workers"] == 2 and seen["pool"][1]["device"] == "cpu"
    assert seen["pool"][1]["reload_url"] == "/pub" and seen["pool"][1]["buckets"] == "4,16"
    groups = {"serve_groups": 2, "task_type": "serve"}
    run_serve(cfg.with_overrides(run=groups), device="cpu")
    jcfg = JaxConfig.from_dict(d).with_overrides(run=groups)
    jax_run_task(jcfg)
    assert _without_device(seen["groups"]) == seen["jax_groups"]
    assert "--reload-url" in seen["jax_groups"] and "--device" not in seen["jax_groups"]
    d["fleet"]["tenants"] = [{"name": "exp", "source": "/pub"}]
    with pytest.raises(ValueError, match="fleet.tenants.*A18"):
        Config.from_dict(json.loads(json.dumps(d)))


def _without_device(argv: list[str]) -> list[str]:
    i = argv.index("--device")
    return argv[:i] + argv[i + 2:]


ONLINE_FIELDS = {"run": {"online_publish_every_steps": 8, "online_max_batches": 3,
                         "online_idle_timeout_secs": 2.5},
                 "regions": {"publish_keep_window": 6},
                 "flywheel": {"join_output_url": "/j", "click_log_url": "/c",
                              "attribution_window_secs": 60.0,
                              "join_checkpoint_every_segments": 2}}


def test_the_online_fields_are_carried_not_dropped():
    """run.online_*, regions.publish_keep_window and the flywheel section
    change what the online tasks do, so the port carries them (a JAX value
    loads as itself) and they left JAX_ONLY_FIELDS; the rest of regions
    stays JAX-only."""
    assert "flywheel" not in JAX_ONLY_FIELDS
    assert not set(ONLINE_FIELDS["run"]) & set(JAX_ONLY_FIELDS["run"])
    assert "publish_keep_window" not in JAX_ONLY_FIELDS["regions"]
    assert {"enabled", "max_version_skew"} <= set(JAX_ONLY_FIELDS["regions"])
    d = JaxConfig().to_dict()
    for section, fields in ONLINE_FIELDS.items():
        d[section].update(fields)
    cfg = Config.from_dict(json.loads(json.dumps(d)))
    for section, fields in ONLINE_FIELDS.items():
        assert {k: getattr(getattr(cfg, section), k) for k in fields} == fields
    assert Config.from_dict(cfg.to_dict()) == cfg


# the cases of tests/test_funnel.py::TestFunnelConfigValidation, and the
# literal checks of the same JAX section: (config, what it must do: an
# error or warning type and its match, or None to load silently)
FUNNEL_CASES = {
    "pigeonhole-over-largest-bucket": ({"run": {"funnel_top_k": 1024}},
                                       (ValueError, "largest serve bucket")),
    "top-k-over-per-shard-vocab": ({"model": {"item_vocab_size": 40},
                                    "mesh": {"model_parallel": 4},
                                    "run": {"funnel_top_k": 16}},
                                   (ValueError, "per-shard item vocab")),
    "pool-topology-uses-group-mp": ({"model": {"item_vocab_size": 64},
                                     "run": {"funnel_top_k": 32, "serve_groups": 2,
                                             "serve_group_model_parallel": 4}},
                                    (ValueError, "per-shard item vocab")),
    "return-n-over-top-k": ({"run": {"funnel_top_k": 8, "funnel_return_n": 9}},
                            (ValueError, "funnel_return_n")),
    "int8-shortlist-over-shard": ({"model": {"item_vocab_size": 64},
                                   "mesh": {"model_parallel": 2},
                                   "run": {"funnel_top_k": 16, "funnel_retrieval": "int8"}},
                                  (ValueError, "funnel_oversample")),
    "bad-retrieval": ({"run": {"funnel_retrieval": "int4"}},
                      (ValueError, "funnel_retrieval")),
    "bad-pallas": ({"run": {"funnel_pallas": "maybe"}}, (ValueError, "funnel_pallas")),
    "oversample-zero": ({"run": {"funnel_oversample": 0}},
                        (ValueError, "funnel_oversample")),
    "min-recall-zero": ({"run": {"funnel_min_recall": 0.0}},
                        (ValueError, "funnel_min_recall")),
    "min-recall-over-one": ({"run": {"funnel_min_recall": 1.5}},
                            (ValueError, "funnel_min_recall")),
    "wasteful-padding-warns": ({"run": {"funnel_top_k": 9}},
                               (UserWarning, "pads to serve bucket")),
    "exact-bucket-fit-is-silent": ({"run": {"funnel_top_k": 128}}, None),
    "a-full-override-loads": ({"run": {"funnel_top_k": 16, "funnel_return_n": 4,
                                       "funnel_retrieval": "int8", "funnel_oversample": 2,
                                       "funnel_min_recall": 0.5, "funnel_pallas": "off",
                                       "serve_buckets": "8,16"}}, None),
}

FUNNEL_FIELDS = ("funnel_top_k", "funnel_return_n", "funnel_retrieval", "funnel_oversample",
                 "funnel_min_recall", "funnel_pallas", "serve_group_model_parallel")


@pytest.mark.parametrize("case", FUNNEL_CASES, ids=list(FUNNEL_CASES))
def test_the_funnel_fields_validate_as_in_jax(case):
    import warnings

    d, want = FUNNEL_CASES[case]
    if want is None:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            jcfg, cfg = JaxConfig.from_dict(d), Config.from_dict(d)
        assert {f: getattr(cfg.run, f) for f in FUNNEL_FIELDS} == \
            {f: getattr(jcfg.run, f) for f in FUNNEL_FIELDS}
        return
    kind, match = want
    for load in (JaxConfig.from_dict, Config.from_dict):
        if kind is UserWarning:
            with pytest.warns(UserWarning, match=match):
                load(d)
        else:
            with pytest.raises(kind, match=match):
                load(d)


def test_the_funnel_flags_land_in_the_run_section():
    from deepfm_tpu_torch.launch.cli import resolve_config

    cfg, _ = resolve_config(["--task_type", "serve", "--funnel_top_k", "16",
                             "--funnel_return_n", "4", "--funnel_retrieval", "int8",
                             "--funnel_oversample", "2", "--funnel_min_recall", "0.5",
                             "--funnel_pallas", "off"])
    assert (cfg.run.funnel_top_k, cfg.run.funnel_return_n, cfg.run.funnel_retrieval,
            cfg.run.funnel_oversample, cfg.run.funnel_min_recall,
            cfg.run.funnel_pallas) == (16, 4, "int8", 2, 0.5, "off")
    assert not set(FUNNEL_FIELDS) & set(JAX_ONLY_FIELDS["run"])
    with pytest.raises(ValueError, match="funnel_return_n"):
        resolve_config(["--funnel_top_k", "8", "--funnel_return_n", "9"])
    with pytest.raises(SystemExit):  # argparse refuses an unknown tier
        resolve_config(["--funnel_retrieval", "int4"])


def _small_funnel(root, top_k=6, return_n=2):
    """A CPU funnel servable of the port's own models: 40 items of 64,
    a ranker of 5 fields."""
    import numpy as np
    import torch

    from deepfm_tpu_torch.funnel import build_index, export_funnel_servable
    from deepfm_tpu_torch.models import DeepFM, TwoTower

    torch.manual_seed(0)
    rcfg = ModelConfig(feature_size=64, field_size=5, embedding_size=4, deep_layers=(8,),
                       dropout_keep=(1.0,), compute_dtype="float32")
    qcfg = ModelConfig(model_name="two_tower", user_vocab_size=50, item_vocab_size=64,
                       user_field_size=2, item_field_size=2, tower_layers=(16,), tower_dim=8,
                       embedding_size=4, compute_dtype="float32")
    rank, tower = DeepFM(rcfg, device="cpu"), TwoTower(qcfg, device="cpu")
    rng = np.random.default_rng(0)
    items = rng.permutation(64)[:40]
    index = build_index(tower, items, rng.integers(0, 64, (40, 2)),
                        np.ones((40, 2), np.float32))
    return export_funnel_servable(str(root), rcfg, rank.state_dict(), qcfg,
                                  tower.state_dict(), index, top_k=top_k, return_n=return_n)


def test_the_serve_task_passes_the_funnel_fields(tmp_path):
    """``run_serve`` with funnel_top_k=16, funnel_return_n=4 over a servable
    stamped 6 -> 2 answers 4 items, those of FunnelScorer(top_k=16,
    return_n=4); at the defaults it answers the servable's 2."""
    import threading
    import urllib.request

    import numpy as np

    from deepfm_tpu_torch.funnel.serve import FunnelScorer
    from deepfm_tpu_torch.train.loop import run_serve

    servable = _small_funnel(tmp_path / "funnel")
    rng = np.random.default_rng(3)
    inst = [{"user_ids": rng.integers(0, 50, 2).tolist(), "user_vals": [1.0, 0.5],
             "feat_ids": rng.integers(0, 64, 5).tolist(),
             "feat_vals": rng.random(5).round(3).tolist()} for _ in range(3)]
    base = Config().with_overrides(run={"task_type": "serve", "servable_model_dir": servable,
                                        "serve_port": 0, "serve_buckets": "8,16",
                                        "serve_max_wait_ms": 0.0})
    for run, n in (({"funnel_top_k": 16, "funnel_return_n": 4}, 4), ({}, 2)):
        ready = threading.Event()
        thread = threading.Thread(target=run_serve, args=(base.with_overrides(run=run),),
                                  kwargs={"device": "cpu", "ready": ready}, daemon=True)
        thread.start()
        assert ready.wait(120)
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{ready.port}/v1/recommend",
                data=json.dumps({"instances": inst}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                got = json.load(r)
            assert ready.scorer.ctx.top_k == (16 if run else 6)
        finally:
            ready.server.shutdown()
            thread.join(30)
        assert [len(x) for x in got["items"]] == [n] * 3
        want_scorer = FunnelScorer(servable, device="cpu", top_k=run.get("funnel_top_k", 0),
                                   return_n=run.get("funnel_return_n", 0), buckets=(8, 16),
                                   max_wait_ms=0.0)
        try:
            want = want_scorer.recommend_instances(inst)
        finally:
            want_scorer.close()
        assert got["items"] == want["items"]
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-6)
    # a funnel field on a CTR servable raises, nothing is dropped
    ctr = tmp_path / "ctr"
    from deepfm_tpu_torch.models import DeepFM
    from deepfm_tpu_torch.serve.export import export_servable

    mcfg = ModelConfig(feature_size=64, field_size=5, embedding_size=4, deep_layers=(8,),
                       dropout_keep=(1.0,))
    export_servable(mcfg, DeepFM(mcfg, device="cpu").state_dict(), str(ctr))
    with pytest.raises(ValueError, match="funnel options"):
        run_serve(base.with_overrides(run={"servable_model_dir": str(ctr),
                                           "funnel_top_k": 16}), device="cpu")
