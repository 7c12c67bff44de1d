"""The serving pools (``deepfm_tpu_torch/serve/pool``, ``serve/server.py
serve_pool``) on the CPU, after JAX's ``tests/test_serve_pool.py``: the
members' row-sharded predict against the single-process predict (bit for
bit) and JAX's ``load_sharded_servable`` (within ``TOL``), the
group-atomic swap protocol and its drills, the router's hashing,
ejection, re-pinning, tracing and surfaces, the funnel member's degraded
oversample, the process pool, the impression log through the join, and
the supervisor CLI.  Members run in-process unless the test is about
processes.

Tolerances: ``TOL`` = 1e-5 where two implementations compute the same
float32 function with sums in another order (JAX against the port, a
padded bucket against one eager row); everything the port computes twice
by one code path is compared exactly."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.flywheel import JoinService as JaxJoinService
from deepfm_tpu.flywheel.impressions import ImpressionLogger as JaxImpressionLogger
from deepfm_tpu.serve import export_servable as jax_export_servable
from deepfm_tpu.serve.pool.router import HashRing as JaxHashRing
from deepfm_tpu.serve.pool.sharded import build_serve_mesh
from deepfm_tpu.serve.pool.sharded import load_sharded_servable as jax_load_sharded
from deepfm_tpu.train import create_train_state
from deepfm_tpu_torch.convert import params_from_jax
from deepfm_tpu_torch.core.config import ModelConfig, SloConfig, load_config
from deepfm_tpu_torch.data.example_proto import parse_example
from deepfm_tpu_torch.data.tfrecord import read_records
from deepfm_tpu_torch.flywheel import JoinService, parse_impression, serialize_click
from deepfm_tpu_torch.flywheel.impressions import ImpressionLogger
from deepfm_tpu_torch.models.deepfm import DeepFM
from deepfm_tpu_torch.online.publisher import ModelPublisher, version_location
from deepfm_tpu_torch.online.stream import SegmentWriter, open_tail
from deepfm_tpu_torch.serve.export import export_servable, model_from_state, read_params
from deepfm_tpu_torch.serve.graphs import GraphedPredictor
from deepfm_tpu_torch.serve.pool.router import HashRing, Router, start_router
from deepfm_tpu_torch.serve.pool.sharded import load_sharded_servable, resolve_serve_exchange
from deepfm_tpu_torch.serve.pool.swap import GroupSwapper
from deepfm_tpu_torch.serve.pool.worker import GroupMember, start_member

ROOT = Path(__file__).resolve().parent.parent
FEATURE, FIELD = 64, 5
BUCKETS = (4, 8)
TOL = 1e-5


def _cfg_dict():
    return {"feature_size": FEATURE, "field_size": FIELD, "embedding_size": 4,
            "deep_layers": (8,), "dropout_keep": (1.0,), "compute_dtype": "float32"}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A JAX servable, the port's conversion of it, and a local publish
    root with version 1 (the servable's weights) and 2 (perturbed)."""
    root = tmp_path_factory.mktemp("pool")
    jcfg = JaxConfig.from_dict({"model": _cfg_dict()})
    jdir = root / "jax_servable"
    jax_export_servable(jcfg, create_train_state(jcfg), jdir)
    ckptr = ocp.StandardCheckpointer()
    payload = ckptr.restore(str(jdir / "params"))
    ckptr.close()
    cfg = load_config(jdir)
    sd1 = params_from_jax(payload["params"], payload["model_state"], cfg)
    servable = export_servable(cfg, sd1, root / "servable")
    sd2 = {k: v + np.float32(0.05) for k, v in sd1.items()}
    pub = str(root / "publish")
    assert ModelPublisher(pub).publish(cfg, sd1, step=1).version == 1
    assert ModelPublisher(pub).publish(cfg, sd2, step=2).version == 2
    return {"cfg": cfg, "jdir": str(jdir), "servable": servable, "publish": pub,
            "weights": {0: sd1, 1: sd1, 2: sd2}, "root": root}


def _features(n, seed=0, high=FEATURE):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, high, (n, FIELD)).astype(np.int64),
            rng.random((n, FIELD)).astype(np.float32))


def _instances(ids, vals):
    return [{"feat_ids": i.tolist(), "feat_vals": v.tolist()} for i, v in zip(ids, vals)]


def _post(url, payload, headers=None, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _status(url, payload, headers=None):
    try:
        req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json",
                                              **(headers or {})})
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), dict(e.headers)


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def _plain(cfg, sd, ids, vals):
    """The plain pipeline: the eager DeepFM with ``sd``'s weights."""
    model = model_from_state(cfg, sd, "cpu")
    with torch.no_grad():
        return torch.sigmoid(model(torch.from_numpy(ids), torch.from_numpy(vals))).numpy()


def _member(env, **kw):
    kw = {"group": "g0", "buckets": BUCKETS, "max_wait_ms": 1.0, "device": "cpu",
          "source": env["publish"], "staging_dir": str(env["root"] / f"stage_{time.time_ns()}"),
          **kw}
    return start_member(env["servable"], **kw)


def _close(*servers):
    for s in servers:
        if isinstance(s, Router):
            s.close()
        elif isinstance(s, GroupMember):
            s.close()
        else:
            s.shutdown()
            s.server_close()


# ------------------------------------------------------------ sharded predict

SPLITS = [(2, 4, "psum"), (2, 4, "alltoall"), (4, 2, "psum"), (4, 2, "alltoall"),
          (1, 2, "psum"), (1, 2, "alltoall")]


@pytest.mark.parametrize("dp,mp,exchange", SPLITS, ids=[f"{d}x{m}-{e}" for d, m, e in SPLITS])
def test_sharded_predict_equals_the_single_process_predict(env, dp, mp, exchange):
    """Every bucket, a spread batch and one whose distinct ids crowd the
    first shard past the all-to-all's capacity (the psum fallback, taken
    on the device): bit for bit the single-process graphed path's
    answers."""
    single = GraphedPredictor(env["cfg"], read_params(env["servable"]), device="cpu",
                              buckets=BUCKETS)
    _, pred, _, ctx = load_sharded_servable(env["servable"], dp, mp, device="cpu",
                                            exchange=exchange, buckets=BUCKETS)
    assert ctx.exchange == exchange and ctx.cfg.feature_size % mp == 0
    for b in BUCKETS:
        ids, vals = _features(b, seed=b, high=FEATURE + 9)  # some ids past the vocabulary
        assert np.array_equal(pred.predict_with(0, ids, vals),
                              single.predict_with(0, ids, vals))
    skewed = (np.arange(8 * FIELD) % (ctx.rows_local)).reshape(8, FIELD).astype(np.int64)
    vals = np.ones((8, FIELD), np.float32)
    assert np.array_equal(pred.predict_with(0, skewed, vals),
                          single.predict_with(0, skewed, vals))


@pytest.mark.parametrize("dp,mp,exchange", SPLITS, ids=[f"{d}x{m}-{e}" for d, m, e in SPLITS])
def test_sharded_predict_matches_jax(env, dp, mp, exchange):
    mesh = build_serve_mesh(dp, mp)
    jpredict, _, _, jctx = jax_load_sharded(env["jdir"], mesh, exchange=exchange)
    _, pred, _, ctx = load_sharded_servable(env["servable"], dp, mp, device="cpu",
                                            exchange=exchange, buckets=BUCKETS)
    assert jctx.cfg.model.feature_size == ctx.cfg.feature_size
    ids, vals = _features(8, seed=3)
    want = np.asarray(jpredict(ids.astype(np.int32), vals))
    np.testing.assert_allclose(pred.predict_with(0, ids, vals), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("mode,mp,want", [("auto", 2, "psum"), ("auto", 1, "psum"),
                                          ("alltoall", 2, "alltoall"), ("alltoall", 1, "psum"),
                                          ("psum", 4, "psum")])
def test_member_exchange_resolution(mode, mp, want):
    """One shard exchanges nothing; "auto" is psum (a member's shards share
    one process, so the all-to-all saves no wire); "alltoall" is taken
    when asked for."""
    cfg = ModelConfig(feature_size=64, field_size=3, embedding_size=4, shard_exchange=mode)
    assert resolve_serve_exchange(cfg, mp) == want
    with pytest.raises(ValueError, match="must resolve"):
        resolve_serve_exchange(cfg, 2, "ring")


def test_member_refuses_indivisible_buckets(env):
    with pytest.raises(ValueError, match="not divisible"):
        GroupMember(env["servable"], data_parallel=4, buckets=(2, 8), device="cpu")
    # a multi-tenant member is held to the same bucket rule, and its tenant
    # list to JAX's validation
    with pytest.raises(ValueError, match="not divisible"):
        GroupMember(env["servable"], data_parallel=4, buckets=(2, 8), device="cpu",
                    tenants=[{"name": "a"}, {"name": "b"}])
    with pytest.raises(ValueError, match="duplicate fleet tenant"):
        GroupMember(env["servable"], device="cpu", tenants=[{"name": "exp"}, {"name": "exp"}])


# ---------------------------------------------------------------- the swap

def test_skew_abort_and_rollback(env):
    """Protocol order, the pinned-generation 409, commit/rollback, and the
    third slot that keeps the rollback payload while a later version is
    staged."""
    h, url, m = _member(env, model_parallel=2, exchange="alltoall")
    try:
        ids, vals = _features(2)
        body = {"instances": _instances(ids, vals)}
        code, doc, _ = _status(f"{url}/admin:commit", {"generation": 1, "version": 1})
        assert code == 409 and "without a staged" in doc["error"]
        assert _post(f"{url}/admin:stage", {"version": 1})["staged_version"] == 1
        code, _, _ = _status(f"{url}/admin:commit", {"generation": 0, "version": 1})
        assert code == 409  # a generation that does not advance
        assert _post(f"{url}/admin:commit", {"generation": 1, "version": 1})[
            "group_generation"] == 1
        code, doc, _ = _status(f"{url}/v1/models/deepfm:predict", body,
                               {"X-Pinned-Generation": "0"})
        assert code == 409 and doc["group_generation"] == 1
        assert m.skew_aborts_total == 1
        doc = _post(f"{url}/v1/models/deepfm:predict", body, {"X-Pinned-Generation": "1"})
        assert (doc["group_generation"], doc["model_version"], doc["shard_group"]) == (1, 1, "g0")
        # stage 2 while the kept version-0 slot and the live slot are both held
        assert _post(f"{url}/admin:stage", {"version": 2})["staged_version"] == 2
        assert len({m.holder.get(), m.prev[0], m.staged[0]}) == 3
        # a re-stage (say after a lost abort) reuses the staged slot
        assert _post(f"{url}/admin:stage", {"version": 2})["staged_version"] == 2
        assert len({m.holder.get(), m.prev[0], m.staged[0]}) == 3
        assert _post(f"{url}/admin:commit", {"generation": 2, "version": 2})[
            "model_version"] == 2
        v2 = _post(f"{url}/v1/models/deepfm:predict", body)["predictions"]
        np.testing.assert_allclose(v2, _plain(env["cfg"], env["weights"][2], ids, vals),
                                   rtol=0, atol=TOL)
        back = _post(f"{url}/admin:rollback", {})
        assert (back["group_generation"], back["model_version"]) == (1, 1)
        doc = _post(f"{url}/v1/models/deepfm:predict", body)
        np.testing.assert_allclose(doc["predictions"],
                                   _plain(env["cfg"], env["weights"][1], ids, vals),
                                   rtol=0, atol=TOL)
        assert _status(f"{url}/admin:rollback", {})[0] == 409  # nothing kept now
        assert _post(f"{url}/admin:abort", {})["aborted"] is False
        assert _status(f"{url}/admin:stage", {"version": 1, "tenant": "exp"})[0] == 400
    finally:
        _close(h, m)


def test_swap_under_traffic_zero_failed_zero_mixed(env):
    """8 clients through the router while group g0 (two members) swaps
    to version 2: no failed predict, every response's (generation,
    version) a committed pair, and each answer equal, within TOL, to the
    plain pipeline with its version's own weights."""
    h1, u1, m1 = _member(env, model_parallel=2, exchange="alltoall")
    h2, u2, m2 = _member(env, member="m1", model_parallel=2, exchange="psum")
    h3, u3, m3 = _member(env, group="g1")
    rh, rurl, router = start_router({"g0": [u1, u2], "g1": [u3]}, retry_limit=1,
                                    probe_interval_secs=0.2)
    results, errors = [], []
    lock, stop = threading.Lock(), threading.Event()

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            ids, vals = _features(1, seed=int(rng.integers(1 << 30)))
            try:
                doc = _post(f"{rurl}/v1/models/deepfm:predict",
                            {"key": f"k{rng.integers(0, 64)}",
                             "instances": _instances(ids, vals)})
                with lock:
                    results.append((doc["shard_group"], doc["group_generation"],
                                    doc["model_version"], ids, vals, doc["predictions"][0]))
            except Exception as e:
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(100 + i,)) for i in range(8)]
    sw = GroupSwapper([u1, u2], env["publish"], group="g0")
    try:
        for t in threads:
            t.start()
        time.sleep(0.8)
        assert sw.poll_once() is True
        assert (sw.generation, sw.version) == (1, 2)
        time.sleep(0.8)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        _close(router, rh, h1, h2, h3, m1, m2, m3)
    assert not errors, errors[:3]
    assert len(results) > 40
    seen = {(g, v) for grp, g, v, *_ in results if grp == "g0"}
    assert seen <= {(0, 0), (1, 2)} and (1, 2) in seen, seen
    assert all((g, v) == (0, 0) for grp, g, v, *_ in results if grp == "g1")
    for _, _, version, ids, vals, p in results:
        np.testing.assert_allclose(p, _plain(env["cfg"], env["weights"][version], ids, vals)[0],
                                   rtol=0, atol=TOL)


def test_group_swapper_over_an_object_store_publish_root(env, tmp_path):
    """The group-atomic swap from a publish root on the port's dev store:
    both members stage version 2 from the URL (fetched into their staging
    directories, hash-checked, canaried) and commit one generation; each
    answers version 2 within 1e-5 of the plain forward of its weights.
    JAX's reader takes the same manifest from the root."""
    from deepfm_tpu.online.publisher import latest_manifest as jax_latest_manifest
    from deepfm_tpu_torch.utils.dev_object_store import serve as serve_store

    server, base = serve_store(str(tmp_path / "store_root"))
    url = f"{base}/bucket/publish"
    members = []
    try:
        pub = ModelPublisher(url)
        assert pub.publish(env["cfg"], env["weights"][1], step=1).version == 1
        want = pub.publish(env["cfg"], env["weights"][2], step=2)
        members = [_member(env, source=url, member=m) for m in ("m0", "m1")]
        sw = GroupSwapper([u for _, u, _ in members], url, group="g0")
        assert sw.poll_once() is True
        assert (sw.generation, sw.version, sw.rollbacks_total) == (1, 2, 0)
        jm = jax_latest_manifest(url)
        assert (jm.version, jm.step, jm.param_hash) == (2, 2, want.param_hash)
        ids, vals = _features(3, seed=5)
        for _, u, m in members:
            assert (m.generation, m.version) == (1, 2)
            doc = _post(f"{u}/v1/models/deepfm:predict", {"instances": _instances(ids, vals)})
            assert (doc["model_version"], doc["group_generation"]) == (2, 1)
            np.testing.assert_allclose(doc["predictions"],
                                       _plain(env["cfg"], env["weights"][2], ids, vals),
                                       rtol=0, atol=TOL)
        assert sw.poll_once() is False  # nothing newer
    finally:
        for h, _, m in members:
            _close(h, m)
        server.shutdown()
        server.server_close()


def test_swapper_repairs_a_respawned_stale_member(env):
    """A member that restarted at generation 0 while its group moved on is
    staged and committed to the group's version and generation."""
    h1, u1, m1 = _member(env)
    h2, u2, m2 = _member(env, member="m1")
    try:
        sw = GroupSwapper([u1], env["publish"], group="g0")
        assert sw.poll_once() and (sw.generation, sw.version) == (1, 2)
        repair = GroupSwapper([u1, u2], env["publish"], group="g0")
        repair.generation, repair.version = sw.generation, sw.version
        assert repair.repair_once() == 1
        assert (m2.generation, m2.version) == (1, 2)
        assert repair.repair_once() == 0  # converged
    finally:
        _close(h1, h2, m1, m2)


def test_swapper_rolls_back_a_member_ahead_of_its_group(env):
    h, u, m = _member(env)
    try:
        _post(f"{u}/admin:stage", {"version": 2})
        _post(f"{u}/admin:commit", {"generation": 5, "version": 2})
        sw = GroupSwapper([u], env["publish"], group="g0")
        sw.generation, sw.version = 0, 1  # the group never committed 5
        assert sw.repair_once() == 1
        assert (m.generation, m.version) == (0, 0)
    finally:
        _close(h, m)


@pytest.mark.parametrize("fault", ["nan", "torn"])
def test_a_bad_version_aborts_group_wide(env, tmp_path, fault):
    """A NaN version fails the canary, a torn one the param hash, on one
    member: the whole group aborts and stays on its generation."""
    import shutil

    pub = str(tmp_path / "pub")
    shutil.copytree(env["publish"], pub)
    sd = dict(env["weights"][2])
    if fault == "nan":
        sd["fm_b"] = np.full_like(sd["fm_b"], np.nan)
        ModelPublisher(pub).publish(env["cfg"], sd, step=3)
    else:
        ModelPublisher(pub).publish(env["cfg"], sd, step=3)
        loc = version_location(pub, 3)
        with np.load(os.path.join(loc, "params.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        arrays["fm_b"] = arrays["fm_b"] + np.float32(1.0)
        np.savez(os.path.join(loc, "params.npz"), **arrays)
    h1, u1, m1 = _member(env, source=pub)
    h2, u2, m2 = _member(env, member="m1", source=pub)
    try:
        sw = GroupSwapper([u1, u2], pub, group="g0")
        assert sw.swap_to(3) is False
        assert sw.rollbacks_total == 1 and sw.generation == 0
        assert "HTTP Error 400" in sw.last_error
        from deepfm_tpu_torch.obs import flight

        failed = [e for e in flight.render_events() if e["kind"] == "swap_stage_failed"]
        assert ("canary" if fault == "nan" else "hash mismatch") in failed[-1]["error"]
        for m in (m1, m2):
            assert (m.generation, m.version, m.staged) == (0, 0, None)
        assert m1.stage_failures_total == 1
    finally:
        _close(h1, h2, m1, m2)


# ---------------------------------------------------------------- the router

def test_hash_ring_stability_under_churn():
    ring, jring = HashRing([f"g{i}" for i in range(4)]), JaxHashRing([f"g{i}" for i in range(4)])
    keys = [f"user-{i}" for i in range(2000)]
    assert all(ring.candidates(k) == jring.candidates(k) for k in keys[:200])
    before = {k: ring.candidates(k)[0] for k in keys}
    ring.remove("g2")
    after = {k: ring.candidates(k)[0] for k in keys}
    moved = {k for k in keys if before[k] != after[k]}
    assert moved == {k for k in keys if before[k] == "g2"}
    assert 0.1 < len(moved) / len(keys) < 0.45
    ring.add("g2")
    assert {k: ring.candidates(k)[0] for k in keys} == before


class _FlapMember:
    """A stub member whose health is switchable."""

    def __init__(self):
        self.healthy = True
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):
                code = 200 if stub.healthy else 500
                body = json.dumps({"ready": stub.healthy, "group_generation": 0}).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"


def test_router_ejects_and_readmits_on_healthz_flaps():
    a, b = _FlapMember(), _FlapMember()
    router = Router({"g0": [a.url], "g1": [b.url]}, eject_after=2, probe_interval_secs=30)
    try:
        router.probe_once()
        a.healthy = False
        router.probe_once()
        assert router.ejections_total == 0  # one failure is no verdict
        router.probe_once()
        assert router.ejections_total == 1
        snap = router.metrics_snapshot()["groups"]
        assert snap["g0"]["healthy_members"] == 0
        # the members the router routes to, by URL (an ejected one stays listed)
        assert (snap["g0"]["member_urls"], snap["g1"]["member_urls"]) == ([a.url], [b.url])
        assert router._plan("any") == ["g1"]
        a.healthy = True
        router.probe_once()
        assert router.readmissions_total == 1
        assert router.metrics_snapshot()["groups"]["g0"]["healthy_members"] == 1
    finally:
        router.close()
        _close(a.httpd, b.httpd)


def test_router_skew_abort_repins_and_retries(env):
    h, u, m = _member(env)
    rh, rurl, router = start_router({"g0": [u]}, probe_interval_secs=60)
    try:
        ids, vals = _features(1)
        body = {"instances": _instances(ids, vals)}
        assert _post(f"{rurl}/v1/models/deepfm:predict", body)["group_generation"] == 0
        # the group swaps behind the router's back: its cached pin is stale
        _post(f"{u}/admin:stage", {"version": 2})
        _post(f"{u}/admin:commit", {"generation": 1, "version": 2})
        doc = _post(f"{rurl}/v1/models/deepfm:predict", body)
        assert (doc["group_generation"], doc["model_version"]) == (1, 2)
        assert doc["router"]["attempts"] == 2
        assert router.skew_aborts_total == 1 and m.skew_aborts_total == 1
    finally:
        _close(router, rh, h, m)


def test_trace_propagates_router_worker_engine(env):
    h, u, m = _member(env)
    rh, rurl, router = start_router({"g0": [u]}, probe_interval_secs=60)
    try:
        ids, vals = _features(2)
        req = urllib.request.Request(
            f"{rurl}/v1/models/deepfm:predict",
            data=json.dumps({"instances": _instances(ids, vals)}).encode(),
            headers={"Content-Type": "application/json", "X-Trace-Id": "pooltrace01"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.headers["X-Trace-Id"] == "pooltrace01"
        rt = [t for t in _get(f"{rurl}/v1/trace/recent")["traces"]
              if t["trace_id"] == "pooltrace01"]
        mt = [t for t in _get(f"{u}/v1/trace/recent")["traces"]
              if t["trace_id"] == "pooltrace01"]
        assert rt and mt
        assert "router.forward" in {s["name"] for s in rt[0]["spans"]}
        names = {s["name"] for s in mt[0]["spans"]}
        assert {"predict[g0/m0].queue", "predict[g0/m0].dispatch"} <= names
        assert mt[0]["parent_span_id"] == rt[0]["span_id"]
    finally:
        _close(router, rh, h, m)


def test_the_exit_report_is_one_write_of_one_line(monkeypatch):
    """A pool's workers and members share their parent's stdout pipe and
    exit together: each writes its kernel_runs line, newline included, in
    one write, so an unbuffered stdout cannot interleave two processes'
    lines (two JSON documents on one line broke the reader of phase 18)."""
    import atexit as atexit_mod
    import io
    import signal as signal_mod

    from deepfm_tpu_torch.serve import server

    class Writes(io.StringIO):
        calls: list = []

        def write(self, s):
            self.calls.append(s)
            return super().write(s)

    hooks = []
    monkeypatch.setattr(atexit_mod, "register", hooks.append)
    monkeypatch.setattr(signal_mod, "signal", lambda *a: None)
    monkeypatch.setattr(sys, "stdout", Writes())
    server.report_kernel_counts_at_exit("pool-worker")
    assert len(hooks) == 1
    hooks[0]()
    assert len(Writes.calls) == 1 and Writes.calls[0].endswith("\n")
    doc = json.loads(Writes.calls[0])
    assert doc["kind"] == "kernel_runs" and doc["role"] == "pool-worker"


@pytest.mark.parametrize("hop", ["router", "member"])
def test_a_trace_is_recorded_before_its_response_is_written(env, hop):
    """The router and the member finish a request's span before they write
    its response, so a client that reads /v1/trace/recent as soon as it has
    its answer always finds it: a finish held up 0.3 s still lands first."""
    h, u, m = _member(env)
    rh, rurl, router = start_router({"g0": [u]}, probe_interval_secs=60)
    tracer = router.tracer if hop == "router" else m.tracer
    finish = tracer.finish

    def slow_finish(*args, **kwargs):
        time.sleep(0.3)
        finish(*args, **kwargs)

    tracer.finish = slow_finish
    try:
        ids, vals = _features(1)
        req = urllib.request.Request(
            f"{rurl}/v1/models/deepfm:predict",
            data=json.dumps({"instances": _instances(ids, vals)}).encode(),
            headers={"Content-Type": "application/json", "X-Trace-Id": f"early-{hop}"})
        with urllib.request.urlopen(req, timeout=30) as r:
            r.read()
        base = rurl if hop == "router" else u
        assert [t for t in _get(f"{base}/v1/trace/recent")["traces"]
                if t["trace_id"] == f"early-{hop}"]
    finally:
        _close(router, rh, h, m)


def test_member_and_router_prometheus_and_flight_surfaces(env):
    h, u, m = _member(env)
    rh, rurl, router = start_router({"g0": [u]}, probe_interval_secs=60)
    try:
        ids, vals = _features(1)
        _post(f"{rurl}/v1/models/deepfm:predict", {"instances": _instances(ids, vals)})
        _post(f"{u}/admin:stage", {"version": 2})
        _post(f"{u}/admin:commit", {"generation": 1, "version": 2})
        text = urllib.request.urlopen(f"{rurl}/metrics", timeout=10).read().decode()
        assert "deepfm_router_requests_total 1" in text
        mtext = urllib.request.urlopen(f"{u}/metrics", timeout=10).read().decode()
        assert "deepfm_serve_requests_total" in mtext
        kinds = {e["kind"] for e in _get(f"{u}/v1/flight")["events"]}
        assert {"swap_stage", "swap_commit"} <= kinds
        snap = _get(f"{u}/v1/metrics")
        assert snap["router"]["shard_group"] == "g0" and snap["router"]["mesh"] == [1, 1]
        assert snap["reload"]["model_version"] == 2 and "device_reserved_bytes" not in snap["router"]
        ready = _get(f"{u}/readyz")
        assert (ready["group_generation"], ready["model_version"]) == (1, 2)
        code, doc, _ = _status(f"{rurl}/admin:split", {"percentages": {"a": 100}})
        # a router without a traffic split refuses a re-split
        assert code == 400 and "no traffic split configured" in doc["error"]
    finally:
        _close(router, rh, h, m)


def test_member_deadline_rejection_is_a_503_with_retry_after(env):
    h, u, m = _member(env, slo=SloConfig(deadline_ms=250.0))
    rh, rurl, router = start_router({"g0": [u]}, probe_interval_secs=60)
    try:
        ids, vals = _features(2)
        body = {"instances": _instances(ids, vals)}
        for _ in range(3):  # warm the cost model: a cold one admits everything
            _post(f"{u}/v1/models/deepfm:predict", body, {"X-Deadline-Ms": "250"})
        for base in (u, rurl):
            code, doc, headers = _status(f"{base}/v1/models/deepfm:predict", body,
                                         {"X-Deadline-Ms": "0.001", "X-Priority": "predict"})
            assert code == 503 and "deadline unmeetable" in doc["error"]
            assert int(headers["Retry-After"]) >= 1 and doc["retry_after_s"] > 0
        assert _get(f"{u}/v1/metrics")["admission"]["deadline_rejected_total"] == 2
    finally:
        _close(router, rh, h, m)


# ---------------------------------------------------- the degraded oversample

@pytest.fixture(scope="module")
def funnel_servable(tmp_path_factory):
    from deepfm_tpu_torch.funnel import build_index, export_funnel_servable
    from deepfm_tpu_torch.models import TwoTower

    rank_cfg = ModelConfig(**_cfg_dict())
    query_cfg = ModelConfig(model_name="two_tower", user_vocab_size=50, item_vocab_size=FEATURE,
                            user_field_size=2, item_field_size=2, tower_layers=(16,),
                            tower_dim=8, embedding_size=4, compute_dtype="float32")
    g = torch.Generator().manual_seed(4)
    rank = DeepFM(rank_cfg, device="cpu", generator=g)
    tower = TwoTower(query_cfg, device="cpu", generator=g)
    rng = np.random.default_rng(4)
    items = rng.permutation(FEATURE)[:48]
    index = build_index(tower, items, rng.integers(0, FEATURE, (48, 2)),
                        np.ones((48, 2), np.float32))
    d = str(tmp_path_factory.mktemp("funnel") / "servable")
    export_funnel_servable(d, rank_cfg, rank.state_dict(), query_cfg, tower.state_dict(), index,
                           top_k=4, return_n=3, capacity=64, retrieval="int8", oversample=4,
                           min_recall=0.01)
    return d


def test_degraded_oversample_under_forced_load(funnel_servable):
    """A funnel member with an SLO: under a forced high utilisation its
    ``/v1/recommend`` answers come from the retrieve at ``os_d`` (equal to
    the plain pipeline there) and ``degraded_dispatch_total`` rises."""
    from deepfm_tpu_torch.funnel.index import build_rank_topn_with, build_retrieve_with

    slo = SloConfig(shed_shadow_util=0.01, degrade_util=0.02, shed_predict_util=1.0,
                    degrade_floor_pct=50.0)
    h, u, m = start_member(funnel_servable, buckets=BUCKETS, device="cpu", slo=slo,
                           max_wait_ms=0.5)
    rh, rurl, router = start_router({"g0": [u]}, probe_interval_secs=60)
    try:
        assert m.funnel and m._scorer.degraded_oversample == 2
        payload = m._scorer.graphs.payload(0)
        degraded = build_retrieve_with(m.ctx._replace(oversample=2))
        rank = build_rank_topn_with(m.ctx)
        for _ in range(60):  # forced saturation: the ladder engages level 2+
            m.admission.observe_utilization(1, 1)
        rng = np.random.default_rng(9)
        before = m._scorer.degraded_dispatch_total
        for i in range(6):
            inst = {"user_ids": rng.integers(0, 50, 2).tolist(), "user_vals": [1.0, 1.0],
                    "feat_ids": rng.integers(0, FEATURE, FIELD).tolist(),
                    "feat_vals": [1.0] * FIELD}
            doc = _post(f"{rurl}/v1/recommend", {"instances": [inst], "n": 3,
                                                 "key": f"u{i}"})
            assert doc["shard_group"] == "g0"
            with torch.no_grad():
                s, c = degraded(payload, torch.tensor([inst["user_ids"]]),
                                torch.tensor([inst["user_vals"]]))
                pack = rank(payload, torch.tensor([inst["feat_ids"]]),
                            torch.tensor([inst["feat_vals"]]), c, s).numpy()
            assert doc["items"][0] == pack[0, 0, :3].astype(np.int64).tolist()
            np.testing.assert_allclose(doc["scores"][0], pack[0, 1, :3], rtol=0, atol=1e-6)
        snap = _get(f"{u}/v1/metrics")["funnel"]
        assert snap["degraded_dispatch_total"] - before == 6
        assert snap["oversample_effective"] == 2 and snap["oversample"] == 4
    finally:
        _close(router, rh, h, m)


# ------------------------------------------------------------ process pool

def _wait_ready(url, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if _get(f"{url}/readyz", timeout=2).get("ready"):
                return
        except Exception:
            pass
        time.sleep(0.2)
    raise TimeoutError(f"{url} never became ready")


def test_process_pool_answers_as_one_server_and_restarts_a_worker(env, monkeypatch):
    """Two CPU workers on one port answer as one server does; a killed
    worker is restarted; the parent never resolves the device nor calls
    into torch.cuda before (or after) it starts the workers."""
    from deepfm_tpu_torch.core import platform
    from deepfm_tpu_torch.serve import server
    from deepfm_tpu_torch.serve.export import load_batching_servable

    def forbidden(*a, **k):
        raise AssertionError("the pool's parent touched CUDA")

    monkeypatch.setattr(platform, "resolve_device", forbidden)
    for name in ("is_available", "init", "device_count", "current_device", "set_device",
                 "synchronize", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    ready = threading.Event()
    t = threading.Thread(target=server.serve_pool, args=(env["servable"],),
                         kwargs=dict(workers=2, port=0, buckets=BUCKETS, device="cpu",
                                     max_wait_ms=0.5, ready=ready), daemon=True)
    t.start()
    assert ready.wait(60)
    url = f"http://127.0.0.1:{ready.port}"
    try:
        _wait_ready(url)
        monkeypatch.undo()
        batcher, _ = load_batching_servable(env["servable"], device="cpu", buckets=BUCKETS)
        ids, vals = _features(3, seed=5)
        want = batcher.score(ids, vals)
        batcher.close()
        pids = set()
        for _ in range(40):
            code, doc, headers = _status(f"{url}/v1/models/deepfm:predict",
                                         {"instances": _instances(ids, vals)})
            assert code == 200 and np.array_equal(np.float32(doc["predictions"]), want)
            pids.add(int(headers["X-Serving-Pid"]))
        assert pids <= set(ready.pids) and len(ready.pids) == 2
        victim = sorted(ready.pids)[0]
        os.kill(victim, signal.SIGKILL)
        deadline = time.monotonic() + 60
        while (ready.restarts[0] < 1 or victim in ready.pids) and time.monotonic() < deadline:
            time.sleep(0.2)
        assert ready.restarts[0] == 1 and len(ready.pids) == 2
        _wait_ready(url)
        for _ in range(5):
            assert _status(f"{url}/v1/models/deepfm:predict",
                           {"instances": _instances(ids, vals)})[0] == 200
    finally:
        ready.stop.set()
        t.join(timeout=60)
    assert not ready.pids and not torch.cuda.is_initialized()


# ------------------------------------------------------------ impression log

def test_impression_log_is_jax_loggers_and_joins_as_jax(env, tmp_path):
    """The router offers every answered predict to the port's
    ImpressionLogger; its records equal those JAX's logger writes for the
    same offers, and the port's join over them emits what JAX's join emits
    over JAX's log, clicks on half of the impressions."""
    h, u, m = _member(env)
    imp_p, imp_j, clicks = (str(tmp_path / d) for d in ("imp_p", "imp_j", "clicks"))
    logger = ImpressionLogger(imp_p, roll_bytes=1 << 20, roll_age_secs=60).start()
    jlogger = JaxImpressionLogger(imp_j, roll_bytes=1 << 20, roll_age_secs=60).start()
    rh, rurl, router = start_router({"g0": [u]}, probe_interval_secs=60, flywheel=logger)
    try:
        for i in range(12):
            ids, vals = _features(2, seed=20 + i)
            inst = _instances(ids, vals)
            doc = _post(f"{rurl}/v1/models/deepfm:predict", {"key": f"k{i}", "instances": inst},
                        {"X-Trace-Id": f"tr{i:04d}"})
            jlogger.offer(key=f"k{i}", trace_id=f"tr{i:04d}", tenant=doc["tenant"],
                          model_version=doc["model_version"], instances=inst,
                          scores=doc["predictions"], deadline_class="default")
        assert router.metrics_snapshot()["flywheel"]["logged_total"] >= 0
    finally:
        _close(router, rh, h, m)
        logger.stop()
        jlogger.stop()

    def records(root):
        out = []
        tail = open_tail(root)
        for name in tail.list_segments():
            with tail.open_segment(name) as f:
                for rec in read_records(f):
                    imp = parse_impression(rec)._asdict()
                    imp.pop("ts_ms")
                    out.append({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                                for k, v in imp.items()})
        return out

    port_recs, jax_recs = records(imp_p), records(imp_j)
    assert len(port_recs) == 24 and port_recs == jax_recs
    writer = SegmentWriter(clicks, roll_bytes=0, roll_age_secs=0)
    for r in port_recs[::2]:
        writer.append(serialize_click(impression_id=r["impression_id"],
                                      ts_ms=int(time.time() * 1000)))
    writer.flush()

    def emitted(root):
        rows = []
        tail = open_tail(root)
        for name in tail.list_segments():
            with tail.open_segment(name) as f:
                rows += [(float(parse_example(rec)["label"][0]),
                          parse_example(rec)["ids"].tolist()) for rec in read_records(f)]
        return sorted(rows)

    JoinService(imp_p, clicks, str(tmp_path / "out_p"),
                attribution_window_secs=600).run(drain_at_eof=True)
    JaxJoinService(imp_j, clicks, str(tmp_path / "out_j"),
                   attribution_window_secs=600).run(drain_at_eof=True)
    joined = emitted(str(tmp_path / "out_p"))
    assert joined == emitted(str(tmp_path / "out_j"))
    assert len(joined) == 24 and sum(label for label, _ in joined) == 12


# --------------------------------------------------------------- supervisor

def _free_port_block(n: int) -> int:
    rng = np.random.default_rng(os.getpid())
    for _ in range(200):
        base = int(rng.integers(20000, 50000))
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                s.bind(("127.0.0.1", p))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port block")


def test_supervisor_respawns_a_killed_member(env):
    """``python -m deepfm_tpu_torch.serve.pool --device cpu``: a killed
    member is respawned and re-admitted, and SIGTERM takes the whole tree
    down."""
    base = _free_port_block(3)
    router_port, member_port = base, base + 1
    env_vars = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepfm_tpu_torch.serve.pool", "--servable", env["servable"],
         "--router", "--groups", "1", "--port", str(router_port), "--member-port-base",
         str(member_port), "--buckets", "4,8", "--health-interval", "0.2",
         "--restart-backoff-secs", "0.2", "--device", "cpu"],
        env=env_vars, cwd=str(ROOT), stdout=subprocess.PIPE, text=True)
    rurl, murl = f"http://127.0.0.1:{router_port}", f"http://127.0.0.1:{member_port}"
    try:
        _wait_ready(murl)
        _wait_ready(rurl)
        ids, vals = _features(1)
        body = {"instances": _instances(ids, vals)}
        code, doc, headers = _status(f"{murl}/v1/models/deepfm:predict", body)
        first = int(headers["X-Serving-Pid"])
        os.kill(first, signal.SIGKILL)
        deadline = time.monotonic() + 90
        pid = first
        while pid == first and time.monotonic() < deadline:
            try:
                pid = int(_status(f"{murl}/v1/models/deepfm:predict", body)[2]["X-Serving-Pid"])
            except Exception:
                time.sleep(0.3)
        assert pid != first
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            code, doc, _ = _status(f"{rurl}/v1/models/deepfm:predict", body)
            if code == 200:
                break
            time.sleep(0.2)
        assert code == 200 and doc["shard_group"] == "g0"
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0
    lines = [json.loads(x) for x in out.splitlines() if x.startswith('{"kind": "kernel_runs"')]
    assert [x["role"] for x in lines] == ["member:g0"] and lines[0]["pid"] == pid
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
