"""The port's observability copies (deepfm_tpu_torch/obs, utils/retry.py)
against the JAX package's: the same operations give the same Prometheus
text from both metrics registries, the same trace documents and the same
breaker transitions on a scripted clock; the flight recorder records and
dumps as the JAX one does."""

import json
import threading

import pytest

from deepfm_tpu.obs import flight as jax_flight
from deepfm_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deepfm_tpu.obs.trace import Tracer as JaxTracer
from deepfm_tpu.utils.retry import CircuitBreaker as JaxBreaker
from deepfm_tpu_torch.obs import flight
from deepfm_tpu_torch.obs.metrics import MetricsRegistry
from deepfm_tpu_torch.obs.trace import TRACE_HEADER, Tracer, current_trace, span
from deepfm_tpu_torch.utils.retry import CircuitBreaker, CircuitOpenError


def _exercise(reg):
    """One fixed script of registry operations (families, labels, hooks)."""
    req = reg.counter("deepfm_serve_requests_total", "requests", labels=("engine",))
    req.labels("predict").inc()
    req.labels("predict").inc(4)
    req.labels('we"ird\\name\n').inc(2)
    disp = reg.counter("deepfm_serve_dispatches_total", "by bucket",
                       labels=("engine", "bucket"))
    for b in (8, 32, 8, 512):
        disp.labels("predict", str(b)).inc()
    disp.labels("predict", "128")  # a child at zero
    g = reg.gauge("deepfm_serve_queue_rows", "queued rows")
    g.set(7)
    g.inc(2.5)
    g.dec()
    hook_gauge = reg.gauge("deepfm_reload_model_version", "live version")
    reg.on_collect(lambda: hook_gauge.set(3))
    lat = reg.histogram("deepfm_serve_latency_seconds", "latency",
                        labels=("engine",), window=5)
    for v in (0.004, 0.001, 0.010, 0.002, 0.003, 0.020, 0.0005):
        lat.labels("predict").observe(v)
    reg.counter("deepfm_empty_total", "")  # no help line, one unlabeled child
    with pytest.raises(ValueError):
        reg.gauge("deepfm_serve_requests_total", labels=("engine",))
    with pytest.raises(ValueError):
        req.labels("a", "b")
    return reg


def test_render_prometheus_matches_jax():
    port = _exercise(MetricsRegistry()).render_prometheus()
    jax = _exercise(JaxRegistry()).render_prometheus()
    assert port == jax
    assert 'deepfm_reload_model_version 3\n' in port
    assert 'deepfm_serve_latency_seconds{engine="predict",quantile="0.5"}' in port


def test_histogram_snapshots_match_jax():
    a, b = MetricsRegistry(), JaxRegistry()
    assert (a.histogram("h_seconds").snapshot(include_max=True)
            == b.histogram("h_seconds").snapshot(include_max=True) == {"count": 0})
    for reg in (a, b):
        h = reg.histogram("h_seconds", window=4)
        for v in (0.5, 0.1, 0.3, 0.9, 0.2):
            h.observe(v)
    snap = a.histogram("h_seconds").snapshot(include_max=True)
    assert snap == b.histogram("h_seconds").snapshot(include_max=True)
    assert snap["count"] == 5 and snap["max"] == 900.0


def test_tracer_documents_match_jax():
    headers = {TRACE_HEADER: "abcd1234abcd1234", "X-Span-Id": "feedbeef"}
    docs = []
    for cls in (Tracer, JaxTracer):
        tracer = cls("server", sample_rate=0.0, capacity=2)
        assert tracer.begin("predict", {}) is None  # unsampled, fresh
        ctx = tracer.begin("predict", headers)      # propagated: recorded
        token = tracer.activate(ctx)
        ctx.add_span("predict.queue", ctx.t_start, ctx.t_start + 0.002, rows=3)
        tracer.finish(ctx, token, status=200)
        doc = tracer.recent()[-1]
        docs.append({k: doc[k] for k in ("trace_id", "parent_span_id", "service",
                                         "name", "attrs")}
                    | {"spans": [(s["name"], s["duration_ms"], s["rows"])
                                 for s in doc["spans"]]})
        assert tracer.dropped_unsampled_total == 1 and tracer.traces_total == 1
    assert docs[0] == docs[1]
    assert docs[0]["spans"] == [("predict.queue", 2.0, 3)]


def test_span_and_current_trace_follow_the_thread(tmp_path):
    tracer = Tracer("t", sample_rate=1.0, export_path=str(tmp_path / "tr.jsonl"))
    assert current_trace() is None
    with span("nothing"):
        pass  # no active trace: a no-op
    ctx = tracer.begin("predict")
    token = tracer.activate(ctx)
    with span("handler", n=1):
        seen = []
        t = threading.Thread(target=lambda: seen.append(current_trace()))
        t.start()
        t.join(timeout=10)
        assert seen == [None]  # context does not leak to other threads
    tracer.finish(ctx, token, status=200)
    tracer.close()
    assert current_trace() is None
    line = json.loads((tmp_path / "tr.jsonl").read_text().splitlines()[0])
    assert line["spans"][0]["name"] == "handler" and line["attrs"]["status"] == 200
    assert tracer.recent()[0]["trace_id"] == ctx.trace_id


def _breaker_script(cls, clock):
    b = cls(failure_threshold=0.5, window=4, min_calls=3, cooldown_secs=10.0,
            clock=lambda: clock[0], name="reload")
    states = []
    for outcome in ("ok", "fail", "fail", "fail", "allow", "tick9", "allow",
                    "tick2", "allow", "allow", "fail", "tick11", "allow", "ok", "allow"):
        if outcome == "ok":
            b.record_success()
        elif outcome == "fail":
            b.record_failure()
        elif outcome.startswith("tick"):
            clock[0] += float(outcome[4:])
        else:
            states.append(b.allow())
        states.append(b.status())
    return states


def test_circuit_breaker_matches_jax_on_a_scripted_clock():
    assert _breaker_script(CircuitBreaker, [0.0]) == _breaker_script(JaxBreaker, [0.0])
    b = CircuitBreaker(min_calls=1, cooldown_secs=60.0)
    with pytest.raises(RuntimeError):
        b.call(lambda: (_ for _ in ()).throw(RuntimeError("store down")))
    with pytest.raises(CircuitOpenError, match="open"):
        b.call(lambda: 1)


def test_flight_recorder_records_and_dumps_like_jax(tmp_path):
    rec, jrec = flight.FlightRecorder(capacity=3), jax_flight.FlightRecorder(capacity=3)
    for r in (rec, jrec):
        for i in range(5):
            r.record("swap_commit", subsystem="reload", version=i)
    strip = [[{k: v for k, v in e.items() if k != "t_unix"} for e in r.events()]
             for r in (rec, jrec)]
    assert strip[0] == strip[1] and [e["version"] for e in strip[0]] == [2, 3, 4]
    assert rec.events(kind="swap_commit", limit=1)[0]["seq"] == 5
    prev = flight.set_recorder(rec)
    try:
        flight.record("breaker_open", breaker="reload")
        assert flight.render_events()[-1]["kind"] == "breaker_open"
        path = rec.dump(str(tmp_path / "flight.jsonl"), reason="manual")
        lines = [json.loads(x) for x in open(path)]
        assert lines[0]["kind"] == "flight_dump" and lines[0]["events"] == 3
    finally:
        flight.set_recorder(prev)
