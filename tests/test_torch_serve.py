"""The port's serving path (deepfm_tpu_torch/serve) against the JAX
package's: a JAX servable (Orbax) is restored, converted with
``params_from_jax`` and written in the port's format; the port's
``load_servable(device="cpu")`` and its HTTP server must give the JAX
``load_servable`` predictions.

Tolerance on probabilities: 1e-5 (float32 MLP; the same arithmetic with
sums in another order).
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import orbax.checkpoint as ocp
import pytest

from deepfm_tpu.core.config import Config
from deepfm_tpu.serve import export_servable as jax_export_servable
from deepfm_tpu.serve import load_servable as jax_load_servable
from deepfm_tpu.train import create_train_state
from deepfm_tpu_torch.convert import params_from_jax
from deepfm_tpu_torch.core.config import load_config
from deepfm_tpu_torch.serve.batcher import (MicroBatcher, OverloadedError,
                                            instances_to_arrays, pick_bucket)
from deepfm_tpu_torch.serve.export import export_servable, load_servable
from deepfm_tpu_torch.serve.server import make_handler, serve_forever

FEATURE, FIELD = 70, 5
TOL = 1e-5


@pytest.fixture(scope="module")
def servables(tmp_path_factory):
    cfg = Config.from_dict({"model": {
        "feature_size": FEATURE, "field_size": FIELD, "embedding_size": 4,
        "deep_layers": (8, 4), "dropout_keep": (1.0, 1.0),
        "compute_dtype": "float32", "batch_norm": True, "fused_kernel": "auto",
    }})
    jdir = tmp_path_factory.mktemp("jax_servable")
    jax_export_servable(cfg, create_train_state(cfg), jdir)
    # restore without a target: the BN NamedTuples come back as containers
    # of their own choosing, which the converter must accept
    ckptr = ocp.StandardCheckpointer()
    payload = ckptr.restore(str(jdir / "params"))
    ckptr.close()
    pcfg = load_config(jdir)
    state_dict = params_from_jax(payload["params"], payload["model_state"], pcfg)
    pdir = tmp_path_factory.mktemp("port_servable")
    export_servable(pcfg, state_dict, pdir)
    return str(jdir), str(pdir)


def _features(n, seed=0):
    """In-range ids.  Out-of-range ones are held to the JAX eager forward in
    test_torch_deepfm.py: the JAX servable's jitted predict receives int64
    ids as int32 (x64 off), so its narrow_ids does not clip them to
    feature_size - 1, and ids in [feature_size, padded rows) reach fm_v's
    zero pad rows there (ROADMAP.md section C)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, FEATURE, size=(n, FIELD)).astype(np.int64)
    return ids, rng.random((n, FIELD)).astype(np.float32)


def _instances(ids, vals):
    return [{"feat_ids": i.tolist(), "feat_vals": v.tolist()} for i, v in zip(ids, vals)]


def test_port_servable_matches_jax_servable(servables):
    jdir, pdir = servables
    jax_predict, _ = jax_load_servable(jdir)
    predict, cfg = load_servable(pdir, device="cpu")
    assert cfg.field_size == FIELD and cfg.fused_kernel == "auto"
    ids, vals = _features(33)
    got = predict(ids, vals)
    assert got.dtype == np.float32 and got.shape == (33,)
    np.testing.assert_allclose(got, np.asarray(jax_predict(ids, vals)), rtol=TOL, atol=TOL)
    # int64 ids past the vocabulary clip to its last row before narrowing
    wild = ids.copy()
    wild[:, 0] = [-5, FEATURE, FEATURE + 20, 2**40] * 8 + [-1]
    clipped = np.clip(wild, 0, FEATURE - 1)
    np.testing.assert_array_equal(predict(wild, vals), predict(clipped, vals))


def test_load_servable_refuses_a_jax_servable(servables):
    jdir, _ = servables
    with pytest.raises(FileNotFoundError, match="params_from_jax"):
        load_servable(jdir, device="cpu")


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.load(r)


def test_http_server_matches_jax(servables):
    jdir, pdir = servables
    jax_predict, _ = jax_load_servable(jdir)
    ready = threading.Event()
    t = threading.Thread(target=serve_forever, args=(pdir,), daemon=True, kwargs=dict(
        port=0, buckets=(4, 8), max_wait_ms=1.0, device="cpu", ready=ready))
    t.start()
    assert ready.wait(timeout=60), "server did not come up"
    base = f"http://127.0.0.1:{ready.port}"
    try:
        for n in (1, 20):  # 20 rows chunk through the largest bucket
            ids, vals = _features(n, seed=n)
            code, doc = _post(f"{base}/v1/models/deepfm:predict",
                              json.dumps({"instances": _instances(ids, vals)}).encode())
            assert code == 200
            np.testing.assert_allclose(np.asarray(doc["predictions"], np.float32),
                                       np.asarray(jax_predict(ids, vals)),
                                       rtol=TOL, atol=TOL)
        ragged = {"instances": [{"feat_ids": [1, 2, 3], "feat_vals": [1.0]}]}
        code, doc = _post(f"{base}/v1/models/deepfm:predict", json.dumps(ragged).encode())
        assert code == 400 and "error" in doc
        code, _ = _post(f"{base}/v1/models/deepfm:predict", b"{not json")
        assert code == 400
        code, _ = _post(f"{base}/v1/models/other:predict", b"{}")
        assert code == 404
        assert _get(f"{base}/healthz") == (200, {"status": "alive"})
        assert _get(f"{base}/readyz")[1]["ready"] is True
        code, metrics = _get(f"{base}/v1/metrics")
        assert code == 200 and metrics["model"] == "deepfm"
        # the ragged body was refused before it reached the engine
        assert metrics["requests_total"] == 2 and metrics["rows_total"] == 21
        assert metrics["buckets"] == [4, 8] and metrics["latency_ms"]["count"] == 2
    finally:
        ready.server.shutdown()
        t.join(timeout=30)
    assert not t.is_alive()


def test_overload_answers_503():
    class Full:
        def score_instances(self, instances):
            raise OverloadedError("scoring queue full")

        def metrics_snapshot(self):
            return {}

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(Full(), "deepfm"))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        code, doc = _post(f"http://127.0.0.1:{httpd.server_address[1]}"
                          f"/v1/models/deepfm:predict", b'{"instances": []}')
        assert code == 503 and "queue full" in doc["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


def test_batcher_buckets_padding_and_backpressure():
    assert [pick_bucket((4, 8), n) for n in (1, 4, 5, 8, 9)] == [4, 4, 8, 8, 8]
    with pytest.raises(ValueError, match="instances\\[1\\]"):
        instances_to_arrays([{"feat_ids": [1], "feat_vals": [1.0]}, {"feat_ids": [1]}])
    gate = threading.Event()
    shapes = []

    def fn(ids, vals):
        shapes.append(ids.shape)
        gate.wait(timeout=30)
        return ids.sum(axis=1).astype(np.float32)

    b = MicroBatcher(fn, 2, buckets=(4, 8), max_wait_ms=0.0, max_queue_rows=8)
    try:
        first = threading.Thread(target=b.score, args=(np.ones((3, 2)), np.ones((3, 2))))
        first.start()
        deadline = time.monotonic() + 10
        while not shapes and time.monotonic() < deadline:
            time.sleep(0.01)
        assert shapes == [(4, 2)]  # 3 rows padded to the 4-bucket
        second = threading.Thread(target=b.score, args=(np.ones((6, 2)), np.ones((6, 2))))
        second.start()  # queued behind the blocked dispatch
        while b.metrics_snapshot()["queue_rows"] < 6 and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(OverloadedError):
            b.score(np.ones((3, 2)), np.ones((3, 2)))
        gate.set()
        first.join(timeout=30)
        second.join(timeout=30)
        assert not first.is_alive() and not second.is_alive()
        out = b.score(np.arange(4).reshape(2, 2), np.ones((2, 2)))
        np.testing.assert_array_equal(out, [1.0, 5.0])
        snap = b.metrics_snapshot()
        assert snap["rejected_total"] == 1 and snap["requests_total"] == 3
        assert snap["padded_rows_total"] == 1 + 2 + 2
        with pytest.raises(ValueError, match="expected"):
            b.score(np.ones((2, 3)), np.ones((2, 3)))
    finally:
        gate.set()
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.score(np.ones((1, 2)), np.ones((1, 2)))


def test_warm_up_runs_every_bucket_on_the_worker_thread():
    """Per-thread device state (CUDA context binding, cuBLAS handles) must
    exist on the dispatching thread before the first request."""
    seen = []

    def fn(ids, vals):
        seen.append((threading.current_thread().name, ids.shape[0]))
        return np.zeros(ids.shape[0], np.float32)

    b = MicroBatcher(fn, 3, buckets=(8, 2), name="warm")
    try:
        timings = b.precompile()
        assert sorted(timings) == [2, 8]
        assert seen == [("micro-batcher-warm", 2), ("micro-batcher-warm", 8)]
        b.score(np.ones((1, 3)), np.ones((1, 3)))
        assert seen[-1] == ("micro-batcher-warm", 2)
        assert b.metrics_snapshot()["requests_total"] == 1  # warm-up not counted
    finally:
        b.close()
