"""The port's serving control plane (``deepfm_tpu_torch/serve/control``:
``TokenBudget``, ``HedgeController``, ``AutoScaler``, ``LoadShedGate``;
``utils/retry.py``: ``RetryPolicy``, ``run_with_restarts``; the ``slo``
config section) fed the same event sequences as the JAX package's
classes, with equal decisions required; then the brownout retry budget
and the group-stall hedge drill through the port's router."""

import json
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from deepfm_tpu.core.config import SloConfig as JaxSlo
from deepfm_tpu.serve.control.admission import LoadShedGate as JaxGate
from deepfm_tpu.serve.control.autoscale import AutoScaler as JaxScaler
from deepfm_tpu.serve.control.hedge import HedgeController as JaxHedge
from deepfm_tpu.serve.control.hedge import TokenBudget as JaxBudget
from deepfm_tpu.utils.retry import RetryPolicy as JaxPolicy
from deepfm_tpu.utils.retry import run_with_restarts as jax_run_with_restarts
from deepfm_tpu_torch.core.config import Config, SloConfig
from deepfm_tpu_torch.launch import preemption
from deepfm_tpu_torch.serve.control import (AutoScaler, HedgeController, LoadShedGate,
                                            TokenBudget)
from deepfm_tpu_torch.serve.pool.router import Router, start_router
from deepfm_tpu_torch.utils.retry import RetryPolicy, run_with_restarts


def _events(seed: int, n: int = 400) -> list:
    rng = np.random.default_rng(seed)
    return [("note" if x < 0.6 else "spend") for x in rng.random(n)]


@pytest.mark.parametrize("ratio,burst,initial", [(0.1, 16.0, None), (0.25, 2.0, 0.0),
                                                 (1.0, 1.0, 1.0), (0.0, 4.0, 2.0)])
def test_token_budget_decides_as_jax(ratio, burst, initial):
    port, jax = TokenBudget(ratio, burst=burst, initial=initial), \
        JaxBudget(ratio, burst=burst, initial=initial)
    for ev in _events(int(ratio * 100 + burst)):
        if ev == "note":
            port.note_request()
            jax.note_request()
        else:
            assert port.try_spend() == jax.try_spend()
    assert port.snapshot() == jax.snapshot()
    with pytest.raises(ValueError):
        TokenBudget(-0.1)


def test_hedge_controller_decides_as_jax():
    rng = np.random.default_rng(1)
    port = HedgeController(slo_budget_ms=80.0, after_pct=50.0,
                           budget=TokenBudget(0.2, burst=3.0, initial=1.0))
    jax = JaxHedge(slo_budget_ms=80.0, after_pct=50.0,
                   budget=JaxBudget(0.2, burst=3.0, initial=1.0))
    for _ in range(300):
        p95 = None if rng.random() < 0.1 else float(rng.uniform(10, 300))
        assert port.plan(p95) == jax.plan(p95)
        port.budget.note_request()
        jax.budget.note_request()
        if rng.random() < 0.5:
            fired = port.try_fire()
            assert fired == jax.try_fire()
            if fired:
                won = bool(rng.random() < 0.5)
                port.record_outcome(hedge_won=won)
                jax.record_outcome(hedge_won=won)
    assert port.snapshot() == jax.snapshot()
    assert port.snapshot()["fired_total"] > 0
    for cls in (HedgeController, JaxHedge):
        with pytest.raises(ValueError):
            cls(slo_budget_ms=0.0)


def test_autoscaler_decides_as_jax():
    kw = dict(min_groups=1, max_groups=3, up_util=0.75, down_util=0.25, slo_ms=100.0,
              up_window_secs=5.0, down_window_secs=30.0, cooldown_secs=10.0)
    port, jax = AutoScaler(**kw), JaxScaler(**kw)
    rng = np.random.default_rng(2)
    groups, decisions = 1, []
    t = 0.0
    for step in range(600):
        t += float(rng.uniform(0.2, 2.0))
        phase = (step // 80) % 3
        util = float(rng.uniform(0.8, 1.0) if phase == 0 else
                     rng.uniform(0.0, 0.2) if phase == 1 else rng.uniform(0.3, 0.6))
        lo, hi = ((50, 200), (10, 60), (30, 110))[phase]
        p95 = None if rng.random() < 0.2 else float(rng.uniform(lo, hi))
        a = port.observe(t, groups=groups, util=util, p95_ms=p95)
        assert a == jax.observe(t, groups=groups, util=util, p95_ms=p95)
        if a is not None:
            decisions.append(a)
            groups += 1 if a == "up" else -1
            port.note_scaled(t)
            jax.note_scaled(t)
        assert port.snapshot() == jax.snapshot()
    assert "up" in decisions and "down" in decisions
    for bad in ({"min_groups": 0}, {"min_groups": 3, "max_groups": 2},
                {"up_util": 0.3, "down_util": 0.3}):
        with pytest.raises(ValueError):
            AutoScaler(**bad)
        with pytest.raises(ValueError):
            JaxScaler(**bad)


@pytest.mark.parametrize("threshold,alpha", [(0.3, 0.5), (0.3, 0.05), (0.1, 0.2)])
def test_load_shed_gate_decides_as_jax(threshold, alpha):
    port, jax = LoadShedGate(threshold=threshold, alpha=alpha), \
        JaxGate(threshold=threshold, alpha=alpha)
    rng = np.random.default_rng(3)
    flips = 0
    for i in range(500):
        # bursts of backpressure between calm stretches
        overloaded = bool(rng.random() < (0.8 if (i // 50) % 2 else 0.05))
        before = port.allow_shadow()
        port.note(overloaded)
        jax.note(overloaded)
        assert port.allow_shadow() == jax.allow_shadow()
        flips += before != port.allow_shadow()
        assert port.snapshot() == jax.snapshot()
    assert flips >= 2


class _FakeClock:
    def __init__(self):
        self.now = 0.0
        self.slept = []

    def clock(self):
        return self.now

    def sleep(self, s):
        self.slept.append(s)
        self.now += s


@pytest.mark.parametrize("jitter,deadline", [("full", None), ("equal", None),
                                             ("full", 0.35), ("equal", 2.0)])
def test_retry_policy_retries_as_jax(jitter, deadline):
    runs = []
    for cls in (RetryPolicy, JaxPolicy):
        fake = _FakeClock()
        policy = cls(max_attempts=6, base_delay_secs=0.1, max_delay_secs=0.5,
                     deadline_secs=deadline, jitter=jitter, clock=fake.clock,
                     sleep=fake.sleep, rng=random.Random(7))
        calls, retries = [0], []

        def flaky():
            calls[0] += 1
            raise OSError("store down")

        with pytest.raises(OSError):
            policy.call(flaky, on_retry=lambda a, e, d: retries.append((a, round(d, 12))))
        runs.append((calls[0], retries, [round(s, 12) for s in fake.slept],
                     [policy.backoff_cap(i) for i in range(1, 6)]))
    assert runs[0] == runs[1]
    # a non-retryable error propagates at once, in both
    for cls in (RetryPolicy, JaxPolicy):
        err = ValueError("corrupt")
        err.retryable = False
        n = [0]

        def once():
            n[0] += 1
            raise err

        with pytest.raises(ValueError):
            cls(max_attempts=5, sleep=lambda s: None).call(once)
        assert n[0] == 1


def test_run_with_restarts_restarts_as_jax():
    runs = []
    for fn_restart, cls in ((run_with_restarts, RetryPolicy),
                            (jax_run_with_restarts, JaxPolicy)):
        fake = _FakeClock()
        policy = cls(max_attempts=5, base_delay_secs=0.5, max_delay_secs=4.0,
                     jitter="equal", sleep=fake.sleep, rng=random.Random(11))
        seen, n = [], [0]

        def crashy():
            n[0] += 1
            if n[0] < 4:
                raise RuntimeError(f"crash {n[0]}")
            return "up"

        out = fn_restart(crashy, max_restarts=4, policy=policy,
                         on_restart=lambda a, e, d: seen.append((a, str(e), round(d, 12))))
        runs.append((out, n[0], seen, [round(s, 12) for s in fake.slept]))
        with pytest.raises(RuntimeError, match="stop"):
            fn_restart(lambda: (_ for _ in ()).throw(RuntimeError("stop")),
                       max_restarts=3, policy=policy,
                       should_restart=lambda e: "stop" not in str(e))
    assert runs[0] == runs[1]
    assert all(cap / 2 <= d <= cap for (a, _, d), cap in
               zip(runs[0][2], (0.5, 1.0, 2.0)))


def test_the_train_task_restarts_on_the_shared_schedule():
    """launch/preemption.py run_with_restarts is utils/retry.py's with an
    equal-jitter RetryPolicy: the same draws from the same RNG."""
    waits, shared = [], []
    n = [0]

    def crashy():
        n[0] += 1
        if n[0] < 4:
            raise RuntimeError("boom")
        return n[0]

    assert preemption.run_with_restarts(crashy, max_restarts=5, backoff_secs=2.0,
                                        max_backoff_secs=5.0, sleep=waits.append,
                                        rng=random.Random(5)) == 4
    n[0] = 0
    run_with_restarts(crashy, max_restarts=5, policy=RetryPolicy(
        max_attempts=6, base_delay_secs=2.0, max_delay_secs=5.0, jitter="equal",
        sleep=shared.append, rng=random.Random(5)))
    assert waits == shared and len(waits) == 3
    with pytest.raises(preemption.PreemptedError):
        preemption.run_with_restarts(
            lambda: (_ for _ in ()).throw(preemption.PreemptedError("sigterm")),
            max_restarts=5, sleep=waits.append)


SLO_BAD = [
    {"deadline_ms": -1.0}, {"deadline_ms": float("inf")}, {"hedge_after_pct": 101.0},
    {"retry_budget_pct": -1.0}, {"degrade_floor_pct": 150.0}, {"shed_shadow_util": 0.0},
    {"scale_up_util": 1.5}, {"shed_shadow_util": 0.8, "degrade_util": 0.7},
    {"min_groups": 0}, {"min_groups": 3, "max_groups": 2},
    {"scale_down_util": 0.8, "scale_up_util": 0.75}, {"cooldown_secs": 0.0},
]


@pytest.mark.parametrize("bad", SLO_BAD, ids=[",".join(b) for b in SLO_BAD])
def test_slo_section_validates_as_jax(bad):
    with pytest.raises(ValueError) as port_err:
        SloConfig(**bad)
    with pytest.raises(ValueError) as jax_err:
        JaxSlo(**bad)
    assert str(port_err.value) == str(jax_err.value)
    d = Config().to_dict()
    d["slo"].update(bad)
    with pytest.raises(ValueError):
        Config.from_dict(json.loads(json.dumps(d)))


def test_slo_section_is_carried():
    cfg = Config.from_dict({"slo": {"deadline_ms": 50.0, "max_groups": 3}})
    assert (cfg.slo.deadline_ms, cfg.slo.max_groups) == (50.0, 3)
    assert SloConfig() == SloConfig(**{k: v for k, v in JaxSlo().__dict__.items()})


# ---------------------------------------------------------------------------
# the router's budget and hedging over stub members


class _StubMember:
    """A healthy, ready member whose predicts answer ``status`` after
    ``delay`` seconds (both settable), counting the hits."""

    def __init__(self, group: str, status: int = 200, delay: float = 0.0):
        self.group, self.status, self.delay, self.hits = group, status, delay, 0
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

            def do_GET(self):
                if self.path == "/healthz":
                    return self._send(200, {"status": "alive"})
                if self.path == "/readyz":
                    return self._send(200, {"ready": True, "shard_group": stub.group,
                                            "group_generation": 0})
                return self._send(404, {"error": "nope"})

            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                stub.hits += 1
                if stub.delay:
                    time.sleep(stub.delay)
                if stub.status != 200:
                    return self._send(stub.status, {"error": "scoring queue full"})
                return self._send(200, {"predictions": [0.5] * len(body["instances"]),
                                        "model_version": 1, "shard_group": stub.group,
                                        "group_generation": 0})

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.load(r), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), dict(e.headers)


def test_brownout_retry_budget_keeps_amplification_sublinear():
    """Both groups 503 every predict: the shared budget caps the retries at
    ~10% of the request rate and fails the rest fast with Retry-After,
    instead of doubling the offered load."""
    a, b = _StubMember("g0", 503), _StubMember("g1", 503)
    httpd, base, router = start_router(
        {"g0": [a.url], "g1": [b.url]}, retry_limit=1, probe_interval_secs=30,
        retry_budget=TokenBudget(0.1, burst=1.0, initial=0.0))
    try:
        n, fail_fast = 60, 0
        for i in range(n):
            code, doc, headers = _post(f"{base}/v1/models/deepfm:predict",
                                       {"key": f"k{i}", "instances": [
                                           {"feat_ids": [0], "feat_vals": [0.0]}]})
            assert code == 503
            if "retry budget exhausted" in doc.get("error", ""):
                fail_fast += 1
                assert doc["retry_after_s"] == pytest.approx(1.0)
                assert headers.get("Retry-After") == "1"
        hits = a.hits + b.hits
        assert n <= hits <= n + int(0.1 * n) + 2, (a.hits, b.hits)
        assert fail_fast > 0
        snap = router.metrics_snapshot()
        assert snap["router"]["retry_budget_exhausted_total"] == fail_fast
        assert snap["router"]["retry_budget"]["spent_total"] == hits - n
        assert snap["router"]["ejections_total"] == 0  # backpressure is no health verdict
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.close()
        a.close()
        b.close()


def test_group_stall_hedges_through_then_decays_to_zero():
    """One group stalls: hedges to the other group fire and win, the
    stalled group is never ejected, no request fails, and once it heals no
    hedge fires (the primary answers inside the hedge delay)."""
    a, b = _StubMember("g0"), _StubMember("g1")
    hedge = HedgeController(slo_budget_ms=80.0, after_pct=50.0,
                            budget=TokenBudget(1.0, burst=64.0))
    router = Router({"g0": [a.url], "g1": [b.url]}, retry_limit=1, spread=1,
                    probe_interval_secs=30, request_timeout_secs=10, hedge=hedge)
    try:
        router.probe_once()
        key = next(k for k in (f"k{i}" for i in range(200))
                   if router._ring.candidates(k)[0] == "g0")
        body = {"key": key, "instances": [{"feat_ids": [0], "feat_vals": [0.0]}]}
        failed = 0

        def drive(n):
            nonlocal failed
            tags = []
            for _ in range(n):
                code, doc = router.handle_predict(dict(body))
                failed += code != 200
                tags.append(doc.get("router", {}).get("hedge"))
            return tags

        drive(20)
        assert hedge.fired_total == 0
        # the stall: a 0.6 s primary against an adaptive delay of half the
        # group's p95, so a healed request would need 0.3 s to draw a hedge
        a.delay = 0.6
        stall = drive(12)
        assert hedge.fired_total > 0 and hedge.wins_total > 0 and "hedge" in stall
        a.delay = 0.0
        drive(3)
        fired = hedge.fired_total
        # healed: the primary answers inside the hedge delay, so none fires
        drive(20)
        assert hedge.fired_total == fired
        assert failed == 0
        assert router.metrics_snapshot()["router"]["ejections_total"] == 0
    finally:
        router.close()
        a.close()
        b.close()
