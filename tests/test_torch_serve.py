"""The port's serving path (deepfm_tpu_torch/serve) against the JAX
package's: a JAX servable (Orbax) is restored, converted with
``params_from_jax`` and written in the port's format; the port's
``load_servable(device="cpu")`` and its HTTP server must give the JAX
``load_servable`` predictions, ``:predict_binary`` the JAX server's, the
deadline and priority headers the JAX server's status codes, ``--stdin``
the JAX scorer's lines and the two-tower endpoints the JAX retrieval
scorer's answers; the CLI's serve task answers ``:predict``; ``/metrics``,
the trace ring and the flight recorder are served.

Tolerance on probabilities: 1e-5 (float32 MLP; the same arithmetic with
sums in another order); embeddings and retrieval scores 1e-5.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest

from deepfm_tpu.core.config import Config
from deepfm_tpu.models.two_tower import encode_tower as jax_encode_tower
from deepfm_tpu.models.two_tower import init_two_tower
from deepfm_tpu.serve import export_servable as jax_export_servable
from deepfm_tpu.serve import load_servable as jax_load_servable
from deepfm_tpu.serve.batcher import MicroBatcher as JaxBatcher
from deepfm_tpu.serve.control.admission import AdmissionController as JaxAdmission
from deepfm_tpu.serve.control.cost import BucketCostModel as JaxCost
from deepfm_tpu.serve.server import RetrievalScorer as JaxRetrievalScorer
from deepfm_tpu.serve.server import ScoringHTTPServer as JaxHTTPServer
from deepfm_tpu.serve.server import make_handler as jax_make_handler
from deepfm_tpu.serve.server import score_stdin as jax_score_stdin
from deepfm_tpu.train import create_train_state
from deepfm_tpu_torch.convert import params_from_jax, two_tower_params_from_jax
from deepfm_tpu_torch.core.config import ModelConfig, load_config
from deepfm_tpu_torch.serve.batcher import (MicroBatcher, OverloadedError,
                                            instances_to_arrays, pick_bucket)
from deepfm_tpu_torch.serve.control import AdmissionController, BucketCostModel
from deepfm_tpu_torch.serve.export import (export_servable, load_batching_servable,
                                           load_retrieval_servable, load_servable)
from deepfm_tpu_torch.serve.server import (ScoringHTTPServer, encode_binary_request,
                                           make_handler, score_stdin, serve_forever)

ROOT = Path(__file__).resolve().parent.parent

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


class _Served:
    """An HTTP server over a handler on port 0, stopped by ``close``."""

    def __init__(self, server_cls, handler):
        self.httpd = server_cls(("127.0.0.1", 0), handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _request(url, body: bytes, headers=None):
    """(status, headers, body bytes) of a POST, error statuses included."""
    req = urllib.request.Request(url, data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_predict_binary_matches_predict_and_the_jax_server(servables):
    jdir, pdir = servables
    jax_predict, jcfg = jax_load_servable(jdir)
    jbatcher = JaxBatcher(jax_predict, FIELD, buckets=(4, 8), max_wait_ms=1.0)
    jsrv = _Served(JaxHTTPServer, jax_make_handler(jbatcher, "deepfm"))
    ready = threading.Event()
    t = threading.Thread(target=serve_forever, args=(pdir,), daemon=True, kwargs=dict(
        port=0, buckets=(4, 8), max_wait_ms=1.0, device="cpu", ready=ready))
    t.start()
    assert ready.wait(timeout=60), "server did not come up"
    base = f"http://127.0.0.1:{ready.port}/v1/models/deepfm"
    try:
        for n in (1, 3, 13):
            ids, vals = _features(n, seed=40 + n)
            body = encode_binary_request(ids, vals)
            code, hdrs, raw = _request(f"{base}:predict_binary", body)
            assert code == 200 and hdrs["Content-Type"] == "application/octet-stream"
            assert int(hdrs["X-Serving-Pid"]) == os.getpid()
            got = np.frombuffer(raw, "<f4")
            jcode, _, jraw = _request(f"{jsrv.base}/v1/models/deepfm:predict_binary", body)
            assert jcode == 200
            np.testing.assert_allclose(got, np.frombuffer(jraw, "<f4"), rtol=TOL, atol=TOL)
            code, doc = _post(f"{base}:predict", json.dumps(
                {"instances": _instances(ids, vals)}).encode())
            np.testing.assert_allclose(got, doc["predictions"], rtol=TOL, atol=TOL)
        for bad in (b"\x01\x00", encode_binary_request(*_features(2))[:-4]):
            assert (_request(f"{base}:predict_binary", bad)[0]
                    == _request(f"{jsrv.base}/v1/models/deepfm:predict_binary", bad)[0]
                    == 400)
        wrong = encode_binary_request(np.ones((2, FIELD + 1), np.int64),
                                      np.ones((2, FIELD + 1), np.float32))
        assert _request(f"{base}:predict_binary", wrong)[0] == 400
    finally:
        ready.server.shutdown()
        t.join(timeout=30)
        jsrv.close()
        jbatcher.close()
    assert not t.is_alive()


@pytest.fixture(scope="module")
def predicts(servables):
    """The JAX servable's predict and the port's eager one (CPU)."""
    jdir, pdir = servables
    return jax_load_servable(jdir)[0], load_servable(pdir, device="cpu")[0]


def _warm(adm, util, n):
    """Drive a controller's smoothed utilization with ``n`` samples."""
    for _ in range(n):
        adm.observe_utilization(int(util * 1000), 1000)


# (admission: None, or (EWMA samples at full queue, a cost observation)),
# headers -> the same status code and Retry-After presence in both servers
SLO_CASES = [
    (None, {"X-Deadline-Ms": "0"}, 504),            # expired in the queue
    (None, {"X-Deadline-Ms": "60000"}, 200),
    (None, {"X-Priority": "shadow"}, 200),          # no ladder without admission
    (None, {"X-Deadline-Ms": "not-a-number"}, 200),
    ((0, 10.0), {"X-Deadline-Ms": "50"}, 503),      # priced unmeetable: Retry-After
    ((0, 10.0), {"X-Deadline-Ms": "60000"}, 200),
    ((105, None), {"X-Priority": "shadow"}, 503),   # level 1 sheds shadow work
    ((105, None), {"X-Priority": "predict"}, 200),
    ((400, None), {"X-Priority": "predict"}, 503),  # level 3 sheds predicts
    ((400, None), {"X-Priority": "Recommend "}, 503),
]


@pytest.mark.parametrize("admission,headers,code", SLO_CASES,
                         ids=[f"{a and a[0]}-{'-'.join(h.values())}" for a, h, _ in SLO_CASES])
def test_deadline_and_priority_headers_match_the_jax_server(predicts, admission, headers,
                                                            code):
    jax_predict, predict = predicts
    ids, vals = _features(2, seed=7)
    results = []
    for batcher_cls, adm_cls, cost_cls, handler, server in (
            (JaxBatcher, JaxAdmission, JaxCost, jax_make_handler, JaxHTTPServer),
            (MicroBatcher, AdmissionController, BucketCostModel, make_handler,
             ScoringHTTPServer)):
        adm = None
        if admission is not None:
            adm = adm_cls(cost_cls((4, 8)), util_alpha=0.01)
            _warm(adm, 1.0, admission[0])
            if admission[1] is not None:
                adm.cost.observe(4, admission[1])
        fn = jax_predict if batcher_cls is JaxBatcher else predict
        b = batcher_cls(fn, FIELD, buckets=(4, 8), max_wait_ms=1.0, admission=adm)
        srv = _Served(server, handler(b, "deepfm"))
        try:
            out = []
            for path, body in ((":predict", json.dumps({"instances": _instances(ids, vals)})
                                .encode()),
                               (":predict_binary", encode_binary_request(ids, vals))):
                code, hdrs, raw = _request(f"{srv.base}/v1/models/deepfm{path}", body, headers)
                out.append((code, "Retry-After" in hdrs,
                            hdrs.get("Retry-After", "0") != "0"))
            results.append(out)
        finally:
            srv.close()
            b.close()
    assert results[0] == results[1]
    # both wire formats answer alike, and a 503 of admission says when to retry
    retry = code == 503 and admission is not None
    assert results[1] == [(code, retry, retry)] * 2


def test_score_stdin_matches_jax(servables, monkeypatch, capsys):
    jdir, pdir = servables
    rng = np.random.default_rng(3)
    lines = []
    for i in range(11):
        ids = rng.integers(0, FEATURE, FIELD).tolist()
        vals = rng.random(FIELD).round(4).tolist()
        if i % 2:
            lines.append(json.dumps({"feat_ids": ids, "feat_vals": vals}))
        else:
            lines.append("1 " + " ".join(f"{c}:{v}" for c, v in zip(ids, vals)))
    text = "\n".join(lines) + "\n\n"
    outs = []
    for fn, d, kw in ((jax_score_stdin, jdir, {}), (score_stdin, pdir, {"device": "cpu"})):
        import io

        monkeypatch.setattr("sys.stdin", io.StringIO(text))
        assert fn(d, batch_size=4, **kw) == 11
        outs.append(capsys.readouterr().out.splitlines())
    assert len(outs[0]) == len(outs[1]) == 11
    assert all(len(x.split(".")[1]) == 6 for x in outs[1])  # %.6f
    np.testing.assert_allclose(np.asarray(outs[1], float), np.asarray(outs[0], float),
                               rtol=0, atol=2e-6)


TT = {"model_name": "two_tower", "user_vocab_size": 50, "item_vocab_size": 40,
      "user_field_size": 2, "item_field_size": 3, "tower_layers": (8,), "tower_dim": 4,
      "embedding_size": 4, "compute_dtype": "float32"}


def test_two_tower_endpoints_match_jax(tmp_path):
    jcfg = Config.from_dict({"model": TT})
    params, _ = init_two_tower(jax.random.PRNGKey(4), jcfg.model)
    pcfg = ModelConfig.from_dict(TT)
    pdir = export_servable(pcfg, two_tower_params_from_jax(jax.device_get(params), pcfg),
                           tmp_path / "tower")
    rng = np.random.default_rng(5)
    corpus = [{"id": 1000 + i, "item_ids": rng.integers(0, 45, 3).tolist(),
               "item_vals": rng.random(3).round(3).tolist()} for i in range(25)]
    corpus_path = tmp_path / "items.jsonl"
    corpus_path.write_text("\n".join(json.dumps(c) for c in corpus) + "\n")
    jscorer = JaxRetrievalScorer(
        jax.jit(lambda i, v: jax_encode_tower(params, i, v, cfg=jcfg.model, side="user")),
        jax.jit(lambda i, v: jax_encode_tower(params, i, v, cfg=jcfg.model, side="item")),
        jcfg, buckets=(4, 8), max_wait_ms=1.0)
    ready = threading.Event()
    t = threading.Thread(target=serve_forever, args=(str(pdir),), daemon=True, kwargs=dict(
        port=0, model_name="tower", buckets=(4, 8), max_wait_ms=1.0, device="cpu",
        item_corpus=str(corpus_path), ready=ready))
    t.start()
    assert ready.wait(timeout=60), "retrieval server did not come up"
    base = f"http://127.0.0.1:{ready.port}/v1/models/tower"
    try:
        jscorer.load_corpus(str(corpus_path))
        users = [{"user_ids": rng.integers(-3, 60, 2).tolist(),
                  "user_vals": rng.random(2).tolist()} for _ in range(5)]
        code, doc = _post(f"{base}:encode_user", json.dumps({"instances": users}).encode())
        assert code == 200
        np.testing.assert_allclose(doc["embeddings"], jscorer.encode_instances("user", users),
                                   rtol=1e-5, atol=1e-5)
        code, doc = _post(f"{base}:encode_item", json.dumps({"instances": corpus[:6]}).encode())
        np.testing.assert_allclose(doc["embeddings"],
                                   jscorer.encode_instances("item", corpus[:6]),
                                   rtol=1e-5, atol=1e-5)
        code, doc = _post(f"{base}:retrieve", json.dumps({"instances": users, "k": 5}).encode())
        want_ids, want_scores = jscorer.retrieve(users, 5)
        assert code == 200
        np.testing.assert_array_equal(doc["neighbors"], want_ids)
        np.testing.assert_allclose(doc["scores"], want_scores, rtol=1e-5, atol=1e-5)
        assert _get(base)[1]["corpus_items"] == 25
        assert _post(f"{base}:retrieve", json.dumps(
            {"instances": users, "k": 0}).encode())[0] == 400
        metrics = _get(f"http://127.0.0.1:{ready.port}/v1/metrics")[1]
        assert metrics["item"]["rows_total"] >= 31 and metrics["user"]["rows_total"] >= 10
    finally:
        ready.server.shutdown()
        t.join(timeout=30)
        jscorer._batchers["user"].close()
        jscorer._batchers["item"].close()
    assert not t.is_alive()
    enc_user, enc_item, cfg = load_retrieval_servable(pdir, device="cpu")
    assert cfg == pcfg and enc_user(np.ones((2, 2), np.int64),
                                    np.ones((2, 2), np.float32)).shape == (2, 4)
    with pytest.raises(ValueError, match="two-tower"):
        serve_forever(str(pdir), reload_url=str(tmp_path), device="cpu")


def test_obs_surfaces_and_traced_spans(servables):
    _, pdir = servables
    ready = threading.Event()
    t = threading.Thread(target=serve_forever, args=(pdir,), daemon=True, kwargs=dict(
        port=0, buckets=(4, 8), max_wait_ms=1.0, device="cpu", ready=ready,
        trace_sample_rate=0.0))
    t.start()
    assert ready.wait(timeout=60), "server did not come up"
    host = f"http://127.0.0.1:{ready.port}"
    try:
        ids, vals = _features(3, seed=9)
        body = json.dumps({"instances": _instances(ids, vals)}).encode()
        code, hdrs, _ = _request(f"{host}/v1/models/deepfm:predict", body,
                                 {"X-Trace-Id": "00c0ffee00c0ffee"})
        assert code == 200 and hdrs["X-Trace-Id"] == "00c0ffee00c0ffee"
        code, hdrs, _ = _request(f"{host}/v1/models/deepfm:predict", body)
        assert code == 200 and "X-Trace-Id" not in hdrs  # fresh requests unsampled
        traces = _get(f"{host}/v1/trace/recent")[1]["traces"]
        assert [x["trace_id"] for x in traces] == ["00c0ffee00c0ffee"]
        spans = {s["name"]: s for s in traces[0]["spans"]}
        assert set(spans) == {"predict.queue", "predict.dispatch"}
        assert spans["predict.dispatch"]["bucket"] == 4
        assert spans["predict.dispatch"]["rows_coalesced"] == 3
        assert traces[0]["attrs"]["status"] == 200
        with urllib.request.urlopen(f"{host}/metrics", timeout=60) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        samples = {}
        for line in text.splitlines():
            if line.startswith("#"):
                assert line.split()[1] in ("HELP", "TYPE")
                continue
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
        assert samples['deepfm_serve_requests_total{engine="predict"}'] == 2
        assert samples['deepfm_serve_dispatches_total{engine="predict",bucket="4"}'] == 2
        assert 'deepfm_serve_latency_seconds_count{engine="predict"}' in samples
        assert isinstance(_get(f"{host}/v1/flight")[1]["events"], list)
        assert _get(f"{host}/v1/models/deepfm")[1]["model_version_status"][0]["version"] == "1"
    finally:
        ready.server.shutdown()
        t.join(timeout=30)
    assert not t.is_alive()


def test_load_batching_servable_scores_through_the_engine(servables):
    jdir, pdir = servables
    jax_predict, _ = jax_load_servable(jdir)
    batcher, cfg = load_batching_servable(pdir, device="cpu", buckets=(4, 8))
    try:
        assert cfg.field_size == FIELD and batcher.buckets == (4, 8)
        ids, vals = _features(11, seed=12)
        np.testing.assert_allclose(batcher.score(ids, vals), np.asarray(jax_predict(ids, vals)),
                                   rtol=TOL, atol=TOL)
        assert batcher.metrics_snapshot()["requests_total"] == 1
    finally:
        batcher.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_task_answers_predict(servables):
    _, pdir = servables
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepfm_tpu_torch", "--task_type", "serve", "--device", "cpu",
         "--servable_model_dir", pdir, "--set", f"run.serve_port={port}",
         "--set", "run.serve_buckets=4,8"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.communicate()[0]
            try:
                if _get(f"http://127.0.0.1:{port}/readyz")[1]["ready"]:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "the serve task did not come up"
            time.sleep(0.2)
        ids, vals = _features(5, seed=21)
        code, doc = _post(f"http://127.0.0.1:{port}/v1/models/deepfm:predict",
                          json.dumps({"instances": _instances(ids, vals)}).encode())
        predict, _ = load_servable(pdir, device="cpu")
        assert code == 200
        np.testing.assert_allclose(doc["predictions"], predict(ids, vals), rtol=TOL, atol=TOL)
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    assert proc.returncode is not None
