"""The port's region layer (``deepfm_tpu_torch/region``) against JAX's
(``deepfm_tpu/region``), after JAX's ``tests/test_region.py``: both fronts
are driven against the same stub region routers with the same requests
and the same probe ticks, and reach the same decisions (each key's home,
the failover order, the budget's 503, ejection and re-admission, the
staleness drain and catch-up).  The port's replicator mirrors marker-last
and verbatim (its stores byte-equal JAX's replicator's), keeps a torn
mirror invisible and cleans it, isolates a browned-out region behind its
breaker and follows the home root's retention; ``RegionsConfig`` refuses
what JAX refuses with JAX's messages; ``--task_type region-front`` serves.
Host-only: no weights anywhere.  Every comparison is exact."""

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
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.core.config import RegionsConfig as JaxRegionsConfig
from deepfm_tpu.obs.flight import FlightRecorder as JaxRecorder
from deepfm_tpu.obs.flight import set_recorder as jax_set_recorder
from deepfm_tpu.region.front import start_front as jax_start_front
from deepfm_tpu.region.replicator import ManifestReplicator as JaxReplicator
from deepfm_tpu_torch.core.config import Config, RegionsConfig
from deepfm_tpu_torch.data.object_store import set_store
from deepfm_tpu_torch.fleet.split import rendezvous_ranking
from deepfm_tpu_torch.obs.flight import FlightRecorder, set_recorder
from deepfm_tpu_torch.online.publisher import (Manifest, ModelPublisher, list_versions,
                                               read_manifest, resolve_version,
                                               version_location)
from deepfm_tpu_torch.region import ManifestReplicator, start_front
from deepfm_tpu_torch.utils.dev_object_store import FaultPlan
from deepfm_tpu_torch.utils.dev_object_store import serve as store_serve
from deepfm_tpu_torch.utils.retry import RetryPolicy

ROOT = Path(__file__).resolve().parent.parent
NO_SLEEP = RetryPolicy(max_attempts=3, base_delay_secs=0.0, max_delay_secs=0.0,
                       sleep=lambda s: None)


@pytest.fixture()
def recorders():
    port, jax = FlightRecorder(capacity=512), JaxRecorder(capacity=512)
    prev = set_recorder(port), jax_set_recorder(jax)
    yield port, jax
    set_recorder(prev[0])
    jax_set_recorder(prev[1])


def publish_fake(root: str, version: int, *, fence: int = 1) -> Manifest:
    """A committed version without weights: one artifact file, then the
    manifest, through the port's publisher commit path."""
    manifest = Manifest(version=version, step=version * 10, param_hash="0" * 64, field_size=5,
                        feature_size=32, model_name="deepfm", created_unix=time.time(),
                        extra={"fence_token": fence})

    def write_tree(dest: str) -> None:
        os.makedirs(dest, exist_ok=True)
        with open(os.path.join(dest, "weights.bin"), "w") as f:
            f.write(f"v{version}")

    return ModelPublisher(root, keep=99, retry=NO_SLEEP)._publish_artifact(manifest, write_tree)


# ------------------------------------------------------------- replicator

def _tree(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_the_replicator_mirrors_marker_last_and_verbatim_as_jax_s(tmp_path, recorders):
    home = str(tmp_path / "home")
    for v in (1, 2, 3):
        publish_fake(home, v, fence=v)
    stores = {"a": str(tmp_path / "ra"), "b": str(tmp_path / "rb")}
    rep = ManifestReplicator(home, stores, retry=NO_SLEEP)
    out = rep.run_once()
    for name, root in stores.items():
        assert out[name]["mirrored"] == [1, 2, 3] and list_versions(root) == [1, 2, 3]
        for v in (1, 2, 3):
            assert read_manifest(root, v).extra["fence_token"] == v
            with open(os.path.join(version_location(root, v), "weights.bin")) as f:
                assert f.read() == f"v{v}"
    st = rep.status()["regions"]
    assert all(r["lag_versions"] == 0 and r["fence_token"] == 3 for r in st.values())
    assert [e["kind"] for e in recorders[0].events()].count("region_version_replicated") == 6
    jstores = {"a": str(tmp_path / "ja"), "b": str(tmp_path / "jb")}
    assert JaxReplicator(home, jstores).run_once() == out
    for name in stores:
        assert _tree(stores[name]) == _tree(jstores[name])
        with open(os.path.join(home, "MANIFEST-00000002.json"), "rb") as f:
            assert _tree(stores[name])["MANIFEST-00000002.json"] == f.read()


def test_a_torn_mirror_stays_invisible_and_is_cleaned(tmp_path, recorders):
    home = str(tmp_path / "home")
    publish_fake(home, 1)
    publish_fake(home, 2)
    region = str(tmp_path / "region")

    def kill_on_v2(name, version):
        if version == 2:
            raise RuntimeError("injected kill before the manifest mirror")

    out = ManifestReplicator(home, {"r": region}, retry=NO_SLEEP,
                             on_artifact=kill_on_v2).run_once()
    assert out["r"]["mirrored"] == [1] and out["r"]["lag_versions"] == 1
    assert list_versions(region) == [1]
    with pytest.raises(FileNotFoundError):
        resolve_version(region, 2, str(tmp_path / "staging"))
    assert os.path.isdir(version_location(region, 2))
    rep2 = ManifestReplicator(home, {"r": region}, retry=NO_SLEEP)
    assert rep2.clean_orphans() == {"r": [2]}
    assert rep2.run_once()["r"]["mirrored"] == [2] and list_versions(region) == [1, 2]
    assert "region_orphan_cleaned" in [e["kind"] for e in recorders[0].events()]


def test_a_dropped_manifest_put_is_never_exposed_and_a_breaker_isolates_a_region(tmp_path):
    home = str(tmp_path / "home")
    publish_fake(home, 1)
    plan = FaultPlan()
    server, base_url = store_serve(str(tmp_path / "region_store"), fault_plan=plan)
    try:
        set_store(None)
        region = f"{base_url}/regions/r1"
        plan.add(verb="PUT", key="*MANIFEST-*", status=503)
        rep = ManifestReplicator(home, {"r1": region}, retry=NO_SLEEP)
        out = rep.run_once()
        assert out["r1"]["mirrored"] == [] and list_versions(region) == []
        plan.clear()
        assert rep.run_once()["r1"]["mirrored"] == [1] and list_versions(region) == [1]
        m, local = resolve_version(region, 1, str(tmp_path / "staging"))
        with open(os.path.join(local, "weights.bin")) as f:
            assert (m.version, f.read()) == (1, "v1")
        good, bad = str(tmp_path / "good"), f"{base_url}/regions/bad"
        for verb in ("PUT", "GET", "LIST"):
            plan.add(verb=verb, key="*", status=503)
        rep = ManifestReplicator(home, {"good": good, "bad": bad}, retry=NO_SLEEP,
                                 breaker_window=2, breaker_threshold=0.5,
                                 breaker_cooldown_secs=60.0)
        assert rep.run_once()["good"]["mirrored"] == [1]
        for _ in range(3):
            out = rep.run_once()
        assert out["bad"]["open"] is True and list_versions(good) == [1]
        assert rep.status()["regions"]["bad"]["breaker"] == "open"
    finally:
        server.shutdown()
        set_store(None)


def test_retention_follows_the_home_root(tmp_path):
    home = str(tmp_path / "home")
    for v in (1, 2, 3):
        publish_fake(home, v)
    region = str(tmp_path / "region")
    rep = ManifestReplicator(home, {"r": region}, retry=NO_SLEEP)
    rep.run_once()
    os.remove(os.path.join(home, "MANIFEST-00000001.json"))
    assert rep.run_once()["r"]["pruned"] == [1]
    assert list_versions(region) == [2, 3] and not os.path.isdir(version_location(region, 1))


# ----------------------------------------------------------------- front

class _Stub:
    """A scriptable region router: /healthz, /readyz and a predict that
    answers with its name and version and records the X-Trace-Id."""

    def __init__(self, name, version=1):
        self.name, self.version, self.plan, self.seen_traces = name, version, FaultPlan(), []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, code, doc):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                rule = stub.plan.match("GET", self.path.lstrip("/"))
                if rule is not None and rule.status:
                    return self._send(rule.status, {"error": "down"})
                if self.path in ("/healthz", "/readyz"):
                    return self._send(200, {"ready": True})
                return self._send(404, {})

            def do_POST(self):  # noqa: N802
                self.rfile.read(int(self.headers.get("Content-Length", "0")))
                rule = stub.plan.match("POST", self.path.lstrip("/"))
                if rule is not None and rule.status:
                    return self._send(rule.status, {"error": "boom"})
                stub.seen_traces.append(self.headers.get("X-Trace-Id"))
                return self._send(200, {"predictions": [0.5], "model_version": stub.version,
                                        "served_by": stub.name,
                                        "tenant": self.headers.get("X-Tenant")})

            def log_message(self, fmt, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()


class _Fronts:
    """The port's and JAX's fronts over the same stubs, with probing left
    to the test (one probe at start, then none for an hour)."""

    def __init__(self, tmp_path, names, *, stores=False, **kw):
        self.stubs = {n: _Stub(n) for n in names}
        regions = {n: {"router_url": s.url,
                       **({"store_root": str(tmp_path / f"store_{n}")} if stores else {})}
                   for n, s in self.stubs.items()}
        kw = {"probe_interval_secs": 3600.0, "failover_budget_pct": 100.0, **kw}
        self.port = start_front(regions, **kw)
        self.jax = jax_start_front(regions, **kw)

    def front(self, which):
        return getattr(self, which)[2]

    def both(self, fn):
        return [fn(self.front(w)) for w in ("port", "jax")]

    def post(self, which, body, headers=None):
        req = urllib.request.Request(f"{getattr(self, which)[1]}/v1/models/deepfm:predict",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json",
                                              **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.load(r), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e), dict(e.headers)

    def post_both(self, body, headers=None):
        out = []
        for which in ("port", "jax"):
            code, doc, hdrs = self.post(which, body, headers)
            # a trace id comes back unasked only when the front sampled the
            # request (at random): compare it where the client sent one
            keys = ("X-Region", "X-Region-Home", "Retry-After") + (
                ("X-Trace-Id",) if headers and "X-Trace-Id" in headers else ())
            out.append((code, doc, {k: hdrs.get(k) for k in keys}))
        assert out[0] == out[1]
        return out[0]

    def statuses(self):
        docs = self.both(lambda f: f.status())
        for d in docs:
            d.pop("budget")
        assert docs[0] == docs[1]
        return docs[0]

    def close(self):
        for which in ("port", "jax"):
            httpd, _, front = getattr(self, which)
            httpd.shutdown()
            front.close()
        for s in self.stubs.values():
            s.close()


def _key_homed(names, home, start=0):
    return next(k for k in (f"user-{i}" for i in range(start, start + 500))
                if rendezvous_ranking(k, sorted(names))[0] == home)


@pytest.mark.parametrize("names", [("use1", "euw1"), ("use1", "euw1", "apne1")],
                         ids=["two-regions", "three-regions"])
def test_home_routing_and_the_region_headers_equal_jax(tmp_path, names):
    f = _Fronts(tmp_path, names)
    try:
        for i in range(24):
            key = f"user-{i}"
            home = rendezvous_ranking(key, sorted(names))[0]
            code, doc, hdrs = f.post_both({"instances": [[0.0]], "key": key},
                                          {"X-Tenant": "A"})
            assert code == 200 and doc["served_by"] == home and doc["tenant"] == "A"
            assert doc["region"] == {"served": home, "home": home, "attempts": 1}
            assert (hdrs["X-Region"], hdrs["X-Region-Home"]) == (home, home)
        assert f.statuses()["regions"][names[0]]["requests"] > 0
    finally:
        f.close()


def test_the_failover_order_and_the_trace_id_equal_jax(tmp_path, recorders):
    names = ("use1", "euw1", "apne1")
    f = _Fronts(tmp_path, names, eject_after=50)
    try:
        key = _key_homed(names, "use1")
        order = rendezvous_ranking(key, sorted(names))
        f.stubs[order[0]].plan.add(verb="POST", key="v1/models/*", status=500)
        f.stubs[order[1]].plan.add(verb="POST", key="v1/models/*", status=503)
        code, doc, hdrs = f.post_both({"instances": [[0.0]], "key": key},
                                      {"X-Trace-Id": "trace-span-all"})
        assert code == 200 and doc["served_by"] == order[2]
        assert doc["region"] == {"served": order[2], "home": "use1", "attempts": 3}
        assert (hdrs["X-Region"], hdrs["X-Region-Home"]) == (order[2], "use1")
        assert hdrs["X-Trace-Id"] == "trace-span-all"
        assert f.stubs[order[2]].seen_traces == ["trace-span-all", "trace-span-all"]
        for rec in recorders:
            assert "region_failover" in [e["kind"] for e in rec.events()]
        # a 4xx is the client's in every region: surfaced, no failover
        f.stubs[order[0]].plan.clear()
        f.stubs[order[0]].plan.add(verb="POST", key="v1/models/*", status=400)
        code, doc, hdrs = f.post_both({"instances": [[0.0]], "key": key})
        assert code == 400 and hdrs["X-Region"] == order[0]
        f.statuses()
    finally:
        f.close()


def test_an_empty_failover_budget_fails_fast_as_jax_s(tmp_path):
    names = ("use1", "euw1")
    f = _Fronts(tmp_path, names, eject_after=1000, failover_budget_pct=0.0)
    try:
        for front in f.both(lambda x: x):
            front.retry_budget._tokens = 0.0  # the initial burst spent
        key = _key_homed(names, "use1")
        f.stubs["use1"].plan.add(verb="POST", key="v1/models/*", status=500)
        code, doc, hdrs = f.post_both({"instances": [[0.0]], "key": key})
        assert code == 503 and "budget" in doc["error"] and doc["home_region"] == "use1"
        assert (hdrs["Retry-After"], hdrs["X-Region-Home"]) == ("1", "use1")
    finally:
        f.close()


def test_ejection_and_readmission_after_catch_up_equal_jax(tmp_path, recorders):
    """Probe ticks in lockstep: a dead region is ejected after
    ``eject_after`` failures; healed but stale beyond the SLO it stays
    out; caught up it comes back."""
    names = ("use1", "euw1")
    for n in names:
        publish_fake(str(tmp_path / f"store_{n}"), 1)
    home = str(tmp_path / "home")
    publish_fake(home, 1)
    f = _Fronts(tmp_path, names, stores=True, home_root=home, eject_after=2,
                max_version_skew=1, readmit_version_skew=0)
    try:
        # the probe every front runs as it starts must be over first
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and any(
                r["store_version"] != 1 for front in f.both(lambda x: x)
                for r in front.status()["regions"].values()):
            time.sleep(0.02)
        f.stubs["euw1"].plan.add(verb="GET", key="*", status=503)
        f.both(lambda x: x.probe_once())
        assert f.statuses()["regions"]["euw1"]["admitted"]
        f.both(lambda x: x.probe_once())
        assert not f.statuses()["regions"]["euw1"]["admitted"]
        key = _key_homed(names, "euw1")
        code, doc, _ = f.post_both({"instances": [[0.0]], "key": key})
        assert code == 200 and doc["region"] == {"served": "use1", "home": "euw1",
                                                  "attempts": 1}
        for v in (2, 3):
            publish_fake(home, v)
            publish_fake(str(tmp_path / "store_use1"), v)
        f.stubs["euw1"].plan.clear()
        f.both(lambda x: x.probe_once())
        st = f.statuses()["regions"]["euw1"]
        assert st["version_skew"] == 2 and not st["admitted"]
        for v in (2, 3):
            publish_fake(str(tmp_path / "store_euw1"), v)
        f.both(lambda x: x.probe_once())
        assert f.statuses()["regions"]["euw1"]["admitted"]
        for rec in recorders:
            kinds = [e["kind"] for e in rec.events()]
            assert kinds.index("region_eject") < kinds.index("region_readmit")
        # failures seen in traffic eject at request speed too
        f.stubs["use1"].plan.add(verb="POST", key="v1/models/*", status=502)
        key = _key_homed(names, "use1")
        for _ in range(2):
            f.post_both({"instances": [[0.0]], "key": key})
        assert not f.statuses()["regions"]["use1"]["admitted"]
    finally:
        f.close()


def test_a_stale_region_drains_and_catches_up_as_jax_s(tmp_path, recorders):
    names = ("use1", "euw1")
    f = _Fronts(tmp_path, names, max_version_skew=1, readmit_version_skew=0)
    try:
        for front in f.both(lambda x: x):
            front.note_store_version("use1", 5)
            front.note_store_version("euw1", 5)
            front.note_home_version(5)
        key = _key_homed(names, "euw1")
        for front in f.both(lambda x: x):
            front.note_store_version("use1", 8)
            front.note_store_version("euw1", 7)
            front.note_home_version(8)           # skew 1: inside the SLO
        assert not f.statuses()["regions"]["euw1"]["draining"]
        for front in f.both(lambda x: x):
            front.note_store_version("use1", 9)
            front.note_home_version(9)           # skew 2: the drain edge
        assert f.statuses()["regions"]["euw1"]["draining"]
        code, doc, _ = f.post_both({"instances": [[0.0]], "key": key})
        assert code == 200 and doc["served_by"] == "use1" and doc["region"]["home"] == "euw1"
        for front in f.both(lambda x: x):
            front.note_store_version("euw1", 8)  # skew 1: still draining (hysteresis)
        assert f.statuses()["regions"]["euw1"]["draining"]
        for front in f.both(lambda x: x):
            front.note_store_version("euw1", 9)
        assert not f.statuses()["regions"]["euw1"]["draining"]
        code, doc, _ = f.post_both({"instances": [[0.0]], "key": key})
        assert code == 200 and doc["served_by"] == "euw1"
        for rec in recorders:
            kinds = [e["kind"] for e in rec.events()]
            assert "region_drain" in kinds and "region_catchup" in kinds
        # no region inside the SLO: a fail-fast 503
        for front in f.both(lambda x: x):
            front.note_home_version(20)
        code, doc, hdrs = f.post_both({"instances": [[0.0]], "key": key})
        assert code == 503 and "staleness SLO" in doc["error"] and hdrs["Retry-After"] == "1"
    finally:
        f.close()


def test_the_front_s_observability_endpoints(tmp_path):
    f = _Fronts(tmp_path, ("use1",))
    try:
        f.post("port", {"instances": [[0.0]], "key": "u"}, {"X-Trace-Id": "obs-trace"})
        url = f.port[1]
        with urllib.request.urlopen(f"{url}/v1/metrics", timeout=10) as r:
            snap = json.load(r)
        assert snap["role"] == "region-front" and snap["regions"]["use1"]["requests"] == 1
        with urllib.request.urlopen(f"{url}/metrics", timeout=10) as r:
            prom = r.read().decode()
        assert "region_front_requests_total" in prom and "region_version_skew" in prom
        for path, key, want in (("/readyz", "ready", True), ("/healthz", "role", "region-front")):
            with urllib.request.urlopen(f"{url}{path}", timeout=10) as r:
                assert json.load(r)[key] == want
        with urllib.request.urlopen(f"{url}/v1/trace/recent", timeout=10) as r:
            assert any(t["name"] == "front" for t in json.load(r)["traces"])
    finally:
        f.close()


# ----------------------------------------------------------------- config

REGIONS = [{"name": "use1", "router_url": "http://a:8500", "store_root": "/stores/use1"},
           {"name": "euw1", "router_url": "http://b:8500", "store_root": "/stores/euw1"}]
BAD_REGIONS = [
    {"enabled": True, "regions": [{"name": "a", "router_url": "http://x"}]},
    {"enabled": True, "home_root": "/pub"},
    {"regions": [{"name": "a", "router_url": "http://x"}, {"name": "a", "router_url": "http://y"}]},
    {"regions": [{"name": "a"}]},
    {"max_version_skew": 1, "readmit_version_skew": 2},
    {"max_version_skew": -1},
    {"failover_budget_pct": 120.0},
    {"replication_poll_secs": 0.0},
    {"probe_interval_secs": float("nan")},
    {"eject_after": 0},
    {"publish_keep_window": -1},
]


@pytest.mark.parametrize("fields", BAD_REGIONS, ids=[
    "no-home-root", "no-regions", "duplicate", "no-router", "readmit-laxer", "negative-skew",
    "budget", "poll", "probe-nan", "eject", "keep-window"])
def test_regions_config_refuses_what_jax_refuses(fields):
    with pytest.raises(ValueError) as port:
        RegionsConfig(**fields)
    with pytest.raises(ValueError) as jax:
        JaxRegionsConfig(**fields)
    assert str(port.value) == str(jax.value)


def test_regions_config_round_trips_and_warns_as_jax_s():
    d = {"regions": {"enabled": True, "home_root": "/pub", "regions": REGIONS,
                     "max_version_skew": 3, "publish_keep_window": 6}}
    cfg = Config.from_dict(d)
    assert cfg.regions.regions == JaxConfig.from_dict(d).regions.regions
    assert Config.from_dict(cfg.to_dict()) == cfg
    d = {"run": {"keep_checkpoints": 2},
         "regions": {"enabled": True, "home_root": "/pub", "regions": REGIONS[:1],
                     "max_version_skew": 4}}
    with warnings.catch_warnings(record=True) as port:
        warnings.simplefilter("always")
        Config.from_dict(d)
    with warnings.catch_warnings(record=True) as jax:
        warnings.simplefilter("always")
        JaxConfig.from_dict(d)
    keep = [str(w.message) for w in port if "keep window" in str(w.message)]
    assert keep and keep == [str(w.message) for w in jax if "keep window" in str(w.message)]


# ------------------------------------------------------------------ task

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_region_front_task_serves_and_stops_on_sigterm(tmp_path):
    """``python -m deepfm_tpu_torch --task_type region-front`` over the
    ``regions`` section: the replicator fills both stores marker-last, the
    front routes each key home, and SIGTERM exits 0."""
    home = str(tmp_path / "home")
    publish_fake(home, 1)
    stubs = {n: _Stub(n) for n in ("use1", "euw1")}
    port = _free_port()
    regions = [{"name": n, "router_url": s.url, "store_root": str(tmp_path / f"s_{n}")}
               for n, s in stubs.items()]
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepfm_tpu_torch", "--task_type", "region-front",
         "--set", "regions.enabled=true", "--set", f"regions.home_root={home}",
         "--set", "regions.regions=" + json.dumps(regions), "--set", f"regions.front_port={port}",
         "--set", "regions.replication_poll_secs=0.1", "--set", "regions.probe_interval_secs=0.1",
         "--set", "run.keep_checkpoints=3"],
        env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=str(ROOT), stderr=subprocess.PIPE,
        text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f"{url}/v1/metrics", timeout=2) as r:
                    snap = json.load(r)
                if all(r["store_version"] == 1 for r in snap["regions"].values()):
                    break
            except OSError:
                pass
            time.sleep(0.1)
        assert all(list_versions(str(tmp_path / f"s_{n}")) == [1] for n in stubs)
        for i in range(6):
            req = urllib.request.Request(f"{url}/v1/models/deepfm:predict",
                                         data=json.dumps({"key": f"u{i}",
                                                          "instances": [[0.0]]}).encode())
            with urllib.request.urlopen(req, timeout=10) as r:
                doc = json.load(r)
            assert doc["served_by"] == rendezvous_ranking(f"u{i}", sorted(stubs))[0]
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        for s in stubs.values():
            s.close()
    assert proc.returncode == 0, err[-2000:]
    assert "region front serving on" in err
