"""The port's hot reload (deepfm_tpu_torch/serve/reload.py over
serve/graphs.py's weight slots) against the JAX package's: on the CPU the
slots run eagerly, so this holds the swap protocol, its refusals, its
status and metrics, and the served probabilities across a swap under
concurrent traffic (within 1e-4 of JAX's prediction for the old or the
new weights).  The graphs themselves are held on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import json
import os
import shutil
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.models.base import get_model
from deepfm_tpu.online.publisher import ModelPublisher as JaxPublisher
from deepfm_tpu.serve import export_servable as jax_export_servable
from deepfm_tpu.serve.reload import HotSwapper as JaxSwapper
from deepfm_tpu.serve.reload import build_predict_with as jax_build_predict_with
from deepfm_tpu.serve.reload import load_swappable_servable as jax_load_swappable
from deepfm_tpu.train import create_train_state
from deepfm_tpu_torch.convert import params_from_jax
from deepfm_tpu_torch.core.config import ModelConfig
from deepfm_tpu_torch.online.publisher import ModelPublisher, version_location
from deepfm_tpu_torch.serve.export import export_servable, load_servable
from deepfm_tpu_torch.serve.reload import (HotSwapper, SwappableParams,
                                           load_swappable_servable)
from deepfm_tpu_torch.serve.server import serve_forever

FEATURE, FIELD = 300, 6
MODEL = {"feature_size": FEATURE, "field_size": FIELD, "embedding_size": 8,
         "deep_layers": (16, 8), "dropout_keep": (1.0, 1.0), "batch_norm": True,
         "compute_dtype": "float32", "fused_kernel": "auto"}
TOL = 1e-4


def _jax_cfg(**model):
    return JaxConfig.from_dict({"model": {**MODEL, **model}})


def _jax_state(seed: int, **model):
    cfg = _jax_cfg(**model)
    return cfg, create_train_state(cfg, jax.random.PRNGKey(seed))


def _port(cfg, state):
    pcfg = ModelConfig.from_dict(cfg.model.__dict__)
    return pcfg, params_from_jax(jax.device_get(state.params),
                                 jax.device_get(state.model_state), pcfg)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, FEATURE, (n, FIELD)).astype(np.int64),
            rng.random((n, FIELD), dtype=np.float32))


@pytest.fixture(scope="module")
def versions():
    """JAX states v0..v2 (distinct weights) and JAX's prediction function
    for each, the port's servable of v0 and its config."""
    states = [_jax_state(seed) for seed in (10, 11, 12)]
    cfg = states[0][0]
    predict_with = jax_build_predict_with(get_model(cfg.model), cfg)

    def jax_predict(state):
        payload = {"params": state.params, "model_state": state.model_state}
        return lambda ids, vals: np.asarray(predict_with(payload, ids, vals))

    return {"states": states, "jax": [jax_predict(s) for _, s in states],
            "port": [_port(c, s) for c, s in states]}


@pytest.fixture
def servable(versions, tmp_path):
    pcfg, sd = versions["port"][0]
    return export_servable(pcfg, sd, tmp_path / "v0")


def _publish(root, versions, idx, **kw):
    pcfg, sd = versions["port"][idx]
    return ModelPublisher(str(root)).publish(pcfg, sd, **kw)


def test_swappable_servable_matches_eager_and_jax(versions, servable):
    predict, predictor, holder, cfg = load_swappable_servable(servable, device="cpu")
    eager, _ = load_servable(servable, device="cpu")
    ids, vals = _rows(9, seed=1)
    got = predict(ids, vals)
    np.testing.assert_array_equal(got, eager(ids, vals))
    np.testing.assert_allclose(got, versions["jax"][0](ids, vals), rtol=TOL, atol=TOL)
    assert holder.get() == 0 and holder.version == 0
    assert predictor.precompile() == {} and predictor.graph_count == 0  # CPU: eager
    np.testing.assert_array_equal(predictor.predict_with(1, ids, vals), got)


def test_swappable_params_drain_waits_for_inflight():
    holder = SwappableParams(0, version=0)
    payload, gen = holder.acquire()
    done = []
    t = threading.Thread(target=lambda: done.append(
        holder.swap(1, version=1, drain_timeout_secs=10.0)))
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive(), "swap returned before the in-flight dispatch drained"
    assert holder.get() == 1  # new dispatches already take the new slot
    holder.release(gen)
    t.join(timeout=10)
    assert done == [True] and holder.version == 1 and not t.is_alive()
    _p, g2 = holder.acquire()
    assert holder.swap(0, version=2, drain_timeout_secs=0.05) is False
    holder.release(g2)


def test_swap_uploads_into_the_idle_slot(versions, servable, tmp_path):
    predict, predictor, holder, cfg = load_swappable_servable(servable, device="cpu")
    root = tmp_path / "publish"
    m1 = _publish(root, versions, 1, step=5)
    jobs = []

    def run(job):  # stands in for the batcher's worker thread
        jobs.append(job)
        return job()

    swapper = HotSwapper(holder, predictor, str(root), cfg, run=run,
                         staging_dir=str(tmp_path / "staging"))
    assert swapper.poll_once() is True and len(jobs) == 2  # upload, canary
    assert holder.get() == 1 and holder.version == 1 and holder.manifest == m1
    for k, v in predictor.slot_state(1).items():
        np.testing.assert_array_equal(v.numpy(), versions["port"][1][1][k].numpy())
    for k, v in predictor.slot_state(0).items():  # the old slot is untouched
        np.testing.assert_array_equal(v.numpy(), versions["port"][0][1][k].numpy())
    ids, vals = _rows(5, seed=2)
    np.testing.assert_allclose(predict(ids, vals), versions["jax"][1](ids, vals),
                               rtol=TOL, atol=TOL)
    assert swapper.poll_once() is False  # nothing newer
    _publish(root, versions, 2)
    assert swapper.poll_once() is True and holder.get() == 0 and holder.version == 2
    np.testing.assert_allclose(predict(ids, vals), versions["jax"][2](ids, vals),
                               rtol=TOL, atol=TOL)
    st = swapper.status()
    assert st["swaps_total"] == 2 and st["rollbacks_total"] == 0 and st["live_slot"] == 0
    assert st["model_step"] == 0 and st["weight_staleness_secs"] >= 0
    assert min(st["last_stage_ms"], st["last_canary_ms"], st["last_swap_ms"]) >= 0


def test_canary_rolls_back_nan_weights(versions, servable, tmp_path):
    predict, predictor, holder, cfg = load_swappable_servable(servable, device="cpu")
    pcfg, sd = versions["port"][1]
    bad = dict(sd)
    bad["fm_v"] = sd["fm_v"].clone().fill_(float("nan"))
    ModelPublisher(str(tmp_path / "publish")).publish(pcfg, bad)
    swapper = HotSwapper(holder, predictor, str(tmp_path / "publish"), cfg,
                         staging_dir=str(tmp_path / "staging"))
    assert swapper.poll_once() is False
    st = swapper.status()
    assert st["rollbacks_total"] == 1 and "non-finite" in st["last_error"]
    assert holder.get() == 0 and holder.version == 0  # live weights untouched
    assert np.isnan(predictor.slot_state(1)["fm_v"].numpy()).all()  # the canary's slot
    ids, vals = _rows(4, seed=4)
    np.testing.assert_allclose(predict(ids, vals), versions["jax"][0](ids, vals),
                               rtol=TOL, atol=TOL)


def test_hash_mismatch_is_refused_and_purged(versions, servable, tmp_path):
    predict, predictor, holder, cfg = load_swappable_servable(servable, device="cpu")
    root = tmp_path / "publish"
    m = _publish(root, versions, 1)
    path = root / f"MANIFEST-{m.version:08d}.json"
    doc = json.loads(path.read_text())
    doc["param_hash"] = "0" * 64  # stands in for a torn or corrupted artifact
    path.write_text(json.dumps(doc))
    staging = tmp_path / "staging"
    swapper = HotSwapper(holder, predictor, str(root), cfg, staging_dir=str(staging))
    assert swapper.poll_once() is False
    assert "hash mismatch" in swapper.status()["last_error"] and holder.version == 0
    # the version is read in place from a local root and stays; a copy
    # staged under the staging directory is purged
    assert os.path.isdir(version_location(str(root), 1))
    staged = staging / "00000001"
    shutil.copytree(version_location(str(root), 1), staged)
    bad = type(m)(**{**m.__dict__, "param_hash": "0" * 64})
    with pytest.raises(ValueError, match="hash mismatch"):
        swapper._stage(bad, str(staged))
    assert not staged.exists()


@pytest.mark.parametrize("change,match", [({"embedding_size": 4}, "re-capture"),
                                          ({"field_size": 5}, "field_size")],
                         ids=["tree", "field_size"])
def test_incompatible_version_is_refused(versions, servable, tmp_path, change, match):
    predict, predictor, holder, cfg = load_swappable_servable(servable, device="cpu")
    pcfg, sd = _port(*_jax_state(3, **change))
    ModelPublisher(str(tmp_path / "publish")).publish(pcfg, sd)
    swapper = HotSwapper(holder, predictor, str(tmp_path / "publish"), cfg,
                         staging_dir=str(tmp_path / "staging"))
    assert swapper.poll_once() is False
    assert match in swapper.status()["last_error"] and holder.version == 0
    assert swapper.status()["rollbacks_total"] == 1


def test_breaker_skips_polls_while_the_root_fails(versions, servable, tmp_path):
    predict, predictor, holder, cfg = load_swappable_servable(servable, device="cpu")
    root = tmp_path / "publish"
    root.mkdir()
    (root / "MANIFEST-00000001.json").write_text("{not json")
    swapper = HotSwapper(holder, predictor, str(root), cfg,
                         staging_dir=str(tmp_path / "staging"))
    for _ in range(5):
        assert swapper.poll_once() is False
    st = swapper.status()
    assert st["poll_errors_total"] == 3 and st["polls_skipped_total"] == 2
    assert st["breaker"]["state"] == "open" and st["rollbacks_total"] == 0
    with pytest.raises(NotImplementedError, match="A6, A15"):
        HotSwapper(holder, predictor, "s3://bucket/publish", cfg)


def _reload_lines(text: str) -> list[str]:
    return [x for x in text.splitlines()
            if x.startswith(("deepfm_reload_events_total", "deepfm_reload_model_version"))]


def test_status_and_metrics_match_the_jax_swapper(versions, tmp_path):
    """Both swappers through one scenario (v1 good, v2 NaN, v3 good), each
    from its own package's publish root: the same status and the same
    ``deepfm_reload_*`` samples."""
    (cfg0, st0), (_, st1), (_, st2) = versions["states"]
    jdir = tmp_path / "jax_v0"
    jax_export_servable(cfg0, st0, jdir)
    pdir = export_servable(*versions["port"][0], tmp_path / "port_v0")
    nan_params = dict(st2.params)
    nan_params["fm_v"] = np.full(np.shape(st2.params["fm_v"]), np.nan, np.float32)
    nan_state = st2._replace(params=nan_params)
    _, nan_sd = _port(cfg0, nan_state)
    seq = [(st1, versions["port"][1][1]), (nan_state, nan_sd), (st2, versions["port"][2][1])]
    jpub, ppub = JaxPublisher(str(tmp_path / "jpub")), ModelPublisher(str(tmp_path / "ppub"))
    _, jpredict_with, jholder, jcfg = jax_load_swappable(str(jdir))
    jswap = JaxSwapper(jholder, jpredict_with, jpub.root, jcfg,
                       staging_dir=str(tmp_path / "jstage"))
    _, predictor, holder, pcfg = load_swappable_servable(pdir, device="cpu")
    pswap = HotSwapper(holder, predictor, ppub.root, pcfg,
                       staging_dir=str(tmp_path / "pstage"))
    results = []
    for jstate, sd in seq:
        jpub.publish(cfg0, jstate)
        ppub.publish(pcfg, sd)
        results.append((jswap.poll_once(), pswap.poll_once()))
    assert results == [(True, True), (False, False), (True, True)]
    js, ps = jswap.status(), pswap.status()
    assert set(js) <= set(ps)
    for key in ("model_version", "reload_interval_secs", "swaps_total", "rollbacks_total",
                "poll_errors_total", "polls_skipped_total", "breaker", "model_step"):
        assert js[key] == ps[key], key
    assert js["last_error"] is None and ps["last_error"] is None
    assert (_reload_lines(jswap.registry.render_prometheus())
            == _reload_lines(pswap.registry.render_prometheus()))


def _post(base, path, instances, timeout=60):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(
        {"instances": instances}).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.load(r)


def test_end_to_end_swap_under_concurrent_traffic(versions, servable, tmp_path):
    """The server on v0 adopts v1 then v2 from a publish root while four
    clients post :predict: every response equals JAX's prediction of the
    version before or after the swap in flight (1e-4), no request fails,
    and after the last swap every response is v2's."""
    root = tmp_path / "publish"
    ready = threading.Event()
    t = threading.Thread(target=serve_forever, args=(servable,), daemon=True, kwargs=dict(
        port=0, buckets=(4, 8), max_wait_ms=1.0, device="cpu", reload_url=str(root),
        reload_interval_secs=0.05, ready=ready))
    t.start()
    assert ready.wait(timeout=120), "server did not come up"
    host = f"http://127.0.0.1:{ready.port}"
    base = f"{host}/v1/models/deepfm"
    stop = threading.Event()
    failures, seen = [], []
    lock = threading.Lock()

    def request(seed):
        ids, vals = _rows(1 + seed % 3, seed)
        inst = [{"feat_ids": i.tolist(), "feat_vals": v.tolist()} for i, v in zip(ids, vals)]
        return seed, inst, [f(ids, vals) for f in versions["jax"]]

    def client(seed, inst, want):
        while not stop.is_set():
            try:
                doc = _post(base, ":predict", inst)
                got = np.asarray(doc["predictions"], np.float32)
                match = [v for v, w in enumerate(want)
                         if np.allclose(got, w, rtol=0, atol=TOL)]
                with lock:
                    seen.append((doc["model_version"], match))
                if not match:
                    failures.append(f"client {seed}: {got} matches no version")
                    return
            except Exception as e:
                failures.append(f"{type(e).__name__}: {e}")
                return

    def answered_on(version, count):
        # each version is published only once traffic has been answered on
        # the one before, so the traffic spans both swaps however slow the
        # clients run
        deadline = time.time() + 60
        while sum(v == version for v, _ in list(seen)) < count:
            assert not failures, failures[:3]
            assert time.time() < deadline, f"no traffic answered on version {version}"
            time.sleep(0.01)

    clients = [threading.Thread(target=client, args=request(s), daemon=True)
               for s in range(4)]
    try:
        assert _post(base, ":predict", [{"feat_ids": [1] * FIELD,
                                          "feat_vals": [1.0] * FIELD}])["model_version"] == 0
        for c in clients:
            c.start()
        for idx in (1, 2):
            answered_on(idx - 1, len(clients))
            _publish(root, versions, idx)
            deadline = time.time() + 60
            while _get(f"{host}/v1/metrics")["reload"]["model_version"] < idx:
                assert time.time() < deadline, "the swap never surfaced"
                time.sleep(0.02)
        time.sleep(0.3)
        stop.set()
        for c in clients:
            c.join(timeout=60)
        assert not failures, failures[:3]
        assert not any(c.is_alive() for c in clients)
        with lock:
            matched = {v for _, m in seen for v in m}
        assert matched == {0, 1, 2}, "traffic did not span both swaps"
        # after the last swap every response is v2's
        for seed in range(4):
            ids, vals = _rows(2, 100 + seed)
            doc = _post(base, ":predict", [{"feat_ids": i.tolist(), "feat_vals": v.tolist()}
                                           for i, v in zip(ids, vals)])
            assert doc["model_version"] == 2
            np.testing.assert_allclose(doc["predictions"], versions["jax"][2](ids, vals),
                                       rtol=0, atol=TOL)
        metrics = _get(f"{host}/v1/metrics")
        assert metrics["reload"]["swaps_total"] == 2 and metrics["reload"]["rollbacks_total"] == 0
        assert _get(base)["model_version_status"][0]["version"] == "2"
        assert _get(f"{host}/readyz")["model_version"] == 2
    finally:
        stop.set()
        ready.server.shutdown()
        t.join(timeout=60)
    assert not t.is_alive()
