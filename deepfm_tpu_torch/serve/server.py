"""REST serving front: the port's counterpart of ``deepfm_tpu/serve/server.py``
for one process.

    POST /v1/models/<name>:predict         {"instances": [{"feat_ids": [...],
                                            "feat_vals": [...]}, ...]}
                                        -> {"predictions": [...]}
    POST /v1/models/<name>:predict_binary  u32 n, u32 f, n*f int64 ids,
                                           n*f f32 vals (little-endian)
                                        -> n f32 probabilities
    GET  /v1/models/<name>   model status (the live version with --reload-url)
    GET  /healthz            liveness
    GET  /readyz             readiness (503 while the reloader's breaker is open)
    GET  /v1/metrics         the engine's counters and latency percentiles
                             (and a ``reload`` section with --reload-url)
    GET  /metrics            the metrics registry, Prometheus text format
    GET  /v1/trace/recent    the recent-traces ring (obs/trace.py)
    GET  /v1/flight          the flight recorder's ring (obs/flight.py)

A malformed body answers 400, a scoring failure 500, a full queue 503.
``X-Deadline-Ms`` (relative, made absolute on arrival) and ``X-Priority``
reach the micro-batcher: a deadline that passes while the request is
queued answers 504; an admission controller's refusal answers 503 with
``Retry-After``.  Responses carry ``X-Serving-Pid`` and, when traced,
``X-Trace-Id``.

CTR servables run behind the micro-batcher over the CUDA-graphed predict
(serve/graphs.py, captured before the socket opens), whose worker thread
is the only thread that touches the device.  ``--reload-url DIR`` polls a
publish root (online/publisher.py) and hot-swaps new versions into the
idle weight slot (serve/reload.py).  Two-tower servables serve
``:encode_user``, ``:encode_item`` and, with ``--item-corpus``,
``:retrieve``.  A servable with a ``funnel.json`` (funnel/publish.py)
serves ``POST /v1/recommend`` (funnel/serve.py).  ``--stdin`` scores
libsvm or JSON lines to one probability a line.

    python -m deepfm_tpu_torch.serve.server --servable DIR --port 8501
    python -m deepfm_tpu_torch.serve.server --servable DIR --reload-url PUB
    cat rows.libsvm | python -m deepfm_tpu_torch.serve.server --servable DIR --stdin

runs on the card (``--device cpu`` for the plain CPU path).
``--workers N`` runs the process pool (:func:`serve_pool`): N of these
servers, each a fresh interpreter with its own graphs and reload poller,
share one port through ``SO_REUSEPORT``, and a dead one is restarted.  The
router-fronted shard-group pool is ``python -m
deepfm_tpu_torch.serve.pool`` (serve/pool/).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np

from ..obs import flight as obs_flight
from ..obs.metrics import MetricsRegistry
from ..obs.trace import DEFAULT_SAMPLE_RATE, TRACE_HEADER, Tracer, current_trace
from .batcher import DEFAULT_BUCKETS, MicroBatcher, OverloadedError
from .control.admission import DeadlineExpiredError, DeadlineRejectedError


class ScoringHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog for connection bursts.
    ``reuse_port`` lets the process pool's workers share one port (the
    kernel spreads accepted connections over the listeners)."""

    request_queue_size = 128
    reuse_port = False

    def server_bind(self):
        if self.reuse_port:
            import socket

            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


def kernel_counts() -> dict[str, int]:
    """Kernel B1's (``forward``) and B2's (``retrieval``) runs in this
    process: the wrappers' eager launches plus the runs inside bucket-graph
    replays (serve/graphs.py, funnel/graphs.py, the pool members').  A pool
    worker or member prints them at exit (:func:`report_kernel_counts_at_exit`)."""
    from ..funnel import graphs as funnel_graphs
    from ..ops import fused_ctr, retrieval
    from . import graphs

    return {"forward": (fused_ctr.launches + graphs.graph_kernel_runs["forward"]
                        + funnel_graphs.graph_kernel_runs["forward"]),
            "retrieval": retrieval.launches + funnel_graphs.graph_kernel_runs["retrieval"]}


def device_memory() -> dict[str, int]:
    """The caching allocator's bytes on this process's card (``{}`` when
    the process never initialised CUDA): reserved now and at its peak."""
    import torch

    if not torch.cuda.is_initialized():
        return {}
    return {"device_reserved_bytes": int(torch.cuda.memory_reserved()),
            "device_max_reserved_bytes": int(torch.cuda.max_memory_reserved())}


def report_kernel_counts_at_exit(role: str) -> None:
    """At exit (SIGTERM included: it becomes ``SystemExit``), print one
    JSON line ``{"kind": "kernel_runs", "role", "pid", "forward",
    "retrieval", ...device memory}`` to stdout: how a pool's processes
    report their kernel runs to whoever started the pool."""
    import atexit
    import signal

    def _term(*_):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _term)
    atexit.register(lambda: print(json.dumps({"kind": "kernel_runs", "role": role,
                                              "pid": os.getpid(), **kernel_counts(),
                                              **device_memory()}), flush=True))


def _parse_buckets(s) -> tuple[int, ...]:
    if isinstance(s, str):
        return tuple(int(x) for x in s.split(",") if x.strip())
    return tuple(int(x) for x in s)


def _send_json(self, code: int, payload: dict, extra_headers: dict | None = None) -> None:
    body = json.dumps(payload).encode()
    self.send_response(code)
    self.send_header("Content-Type", "application/json")
    self.send_header("Content-Length", str(len(body)))
    for k, v in (extra_headers or {}).items():
        self.send_header(k, str(v))
    self.send_header("X-Serving-Pid", str(os.getpid()))
    ctx = current_trace()
    if ctx is not None:
        # every traced response carries its id: the client's handle into
        # /v1/trace/recent
        self.send_header(TRACE_HEADER, ctx.trace_id)
    self.end_headers()
    self.wfile.write(body)
    self._obs_status = code


def _send_text(self, code: int, body: str,
               content_type: str = "text/plain; version=0.0.4") -> None:
    raw = body.encode()
    self.send_response(code)
    self.send_header("Content-Type", content_type)
    self.send_header("Content-Length", str(len(raw)))
    self.end_headers()
    self.wfile.write(raw)


def _slo_kwargs(headers, scorer) -> dict:
    """The request's ``X-Deadline-Ms`` made absolute against this host's
    clock on arrival (so queue wait counts against it) and its
    ``X-Priority`` class, for engines that take them
    (``supports_deadline``); other engines get neither."""
    if not getattr(scorer, "supports_deadline", False):
        return {}
    kw: dict = {}
    hdr = headers.get("X-Deadline-Ms")
    if hdr is not None:
        try:
            ms = float(hdr)
        except ValueError:
            ms = -1.0
        if ms >= 0:
            kw["deadline_s"] = time.perf_counter() + ms / 1e3
    pri = headers.get("X-Priority")
    if pri:
        kw["priority"] = pri.strip().lower()
    return kw


def _retry_after_headers(e: DeadlineRejectedError) -> dict:
    # whole seconds on the wire, never 0 ("retry now" is the opposite hint)
    return {"Retry-After": max(1, int(e.retry_after_s + 0.999))}


def make_handler(scorer, model_name: str, reload_status: Callable | None = None,
                 readiness: Callable | None = None,
                 registry: MetricsRegistry | None = None, tracer: Tracer | None = None,
                 group_status: Callable | None = None):
    """REST handler over an engine exposing ``score``/``score_instances``
    and ``metrics_snapshot`` (the micro-batcher over the bucket graphs, or
    the tiered scorer, tiered/serving.py, whose ``paging_snapshot`` joins
    ``/v1/metrics``).  ``reload_status`` (the HotSwapper's
    ``status``) adds the live ``model_version`` to the status document and
    to every ``:predict`` response, and a ``reload`` section to
    ``/v1/metrics``.  ``readiness`` returns the ``/readyz`` document (with
    a boolean ``ready``; default: ready).  ``registry`` (default: the
    scorer's) backs ``GET /metrics``; ``tracer`` traces ``:predict`` and
    ``:predict_binary`` (a client's ``X-Trace-Id`` is always recorded).

    ``group_status`` (a shard-group member's, serve/pool/worker.py) turns
    on the pool surface: its document (``shard_group``, ``tenant``,
    ``group_generation``, ``exchange``, ``mesh``,
    ``exchange_wire_bytes_est``, ...) is ``/v1/metrics``' ``router``
    section and is merged into ``/readyz``; every JSON ``:predict``
    carries its ``shard_group``, ``tenant`` and ``group_generation``, and a
    ``:predict_binary`` answer the ``X-Shard-Group``, ``X-Tenant`` and
    ``X-Group-Generation`` headers."""
    predict_path = f"/v1/models/{model_name}:predict"
    binary_path = f"/v1/models/{model_name}:predict_binary"
    status_path = f"/v1/models/{model_name}"
    registry = registry if registry is not None else getattr(scorer, "registry", None)
    tracer = tracer if tracer is not None else Tracer(model_name,
                                                      sample_rate=DEFAULT_SAMPLE_RATE)

    class Handler(BaseHTTPRequestHandler):
        # keep-alive: every response carries Content-Length; no Nagle stall
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True
        _send = _send_json
        _send_plain = _send_text
        obs_tracer = tracer

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._send(200, {"status": "alive"})
            elif self.path == "/metrics" and registry is not None:
                self._send_plain(200, registry.render_prometheus())
            elif self.path == "/v1/trace/recent":
                self._send(200, {"traces": tracer.recent()})
            elif self.path == "/v1/flight":
                self._send(200, {"events": obs_flight.render_events()})
            elif self.path == "/readyz":
                doc = (readiness() if readiness is not None
                       else {"ready": True, "engine_compiled": True, "weights_loaded": True})
                if group_status is not None:
                    doc = {**doc, **group_status()}
                self._send(200 if doc.get("ready") else 503, doc)
            elif self.path == status_path:
                version = "1"
                if reload_status is not None:
                    version = str(reload_status().get("model_version", 0))
                self._send(200, {"model_version_status": [
                    {"version": version, "state": "AVAILABLE"}]})
            elif self.path == "/v1/metrics" and hasattr(scorer, "metrics_snapshot"):
                snap = {"model": model_name, **scorer.metrics_snapshot()}
                if reload_status is not None:
                    snap["reload"] = reload_status()
                # an engine that pages its weights through tiers (the tiered
                # scorer, tiered/serving.py) adds its hit rate and bytes
                if "paging" not in snap and hasattr(scorer, "paging_snapshot"):
                    snap["paging"] = scorer.paging_snapshot()
                if group_status is not None:
                    snap["router"] = group_status()
                self._send(200, snap)
            else:
                self._send(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802
            traced = self.path in (predict_path, binary_path)
            ctx = tracer.begin(self.path.rsplit(":", 1)[-1], self.headers) if traced else None
            token = tracer.activate(ctx)
            self._obs_status = None
            try:
                self._handle_post()
            finally:
                tracer.finish(ctx, token, status=self._obs_status)

        def _score(self, score: Callable):
            """``score(**slo)`` -> its result, or None after answering the
            error: 400 for a bad request, 503 (+ Retry-After) for an
            admission refusal or a full queue, 504 for a deadline that
            passed in the queue, 500 for a scoring failure."""
            try:
                return score(**_slo_kwargs(self.headers, scorer))
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except DeadlineRejectedError as e:
                self._send(503, {"error": str(e), "retry_after_s": round(e.retry_after_s, 3)},
                           extra_headers=_retry_after_headers(e))
            except DeadlineExpiredError as e:
                self._send(504, {"error": str(e)})
            except OverloadedError as e:
                self._send(503, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return None

        def _handle_post(self):
            if self.path == binary_path:
                self._predict_binary()
                return
            if self.path != predict_path:
                self._send(404, {"error": f"unknown path {self.path!r}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                instances = json.loads(self.rfile.read(length))["instances"]
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            probs = self._score(lambda **kw: scorer.score_instances(instances, **kw))
            if probs is None:
                return
            doc = {"predictions": [float(p) for p in probs]}
            if reload_status is not None:
                # the live version when the response is assembled: a request
                # in flight across a swap may have scored one version behind
                doc["model_version"] = reload_status().get("model_version", 0)
            if group_status is not None:
                gs = group_status()
                doc.update({k: gs[k] for k in ("shard_group", "tenant", "group_generation")
                            if k in gs})
            self._send(200, doc)

        def _predict_binary(self):
            # JSON encode/decode of many numbers dominates the HTTP layer at
            # large batches; this wire format skips it (little-endian):
            #   request:  u32 n, u32 f, n*f int64 feat_ids, n*f f32 feat_vals
            #   response: n f32 probabilities (application/octet-stream)
            try:
                length = int(self.headers.get("Content-Length", "0"))
                buf = self.rfile.read(length)
                if len(buf) < 8:
                    raise ValueError("truncated header")
                n, f = (int(x) for x in np.frombuffer(buf, "<u4", count=2))
                need = 8 + n * f * 12
                if len(buf) != need:
                    raise ValueError(f"body is {len(buf)} bytes, expected {need} "
                                     f"for n={n} f={f}")
                ids = np.frombuffer(buf, "<i8", count=n * f, offset=8).reshape(n, f)
                vals = np.frombuffer(buf, "<f4", count=n * f,
                                     offset=8 + n * f * 8).reshape(n, f)
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            probs = self._score(lambda **kw: scorer.score(ids, vals, **kw))
            if probs is None:
                return
            body = np.ascontiguousarray(probs, np.float32).astype("<f4", copy=False).tobytes()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Serving-Pid", str(os.getpid()))
            ctx = current_trace()
            if ctx is not None:
                self.send_header(TRACE_HEADER, ctx.trace_id)
            self._obs_status = 200
            if group_status is not None:
                gs = group_status()
                self.send_header("X-Shard-Group", str(gs.get("shard_group")))
                if "tenant" in gs:
                    self.send_header("X-Tenant", str(gs.get("tenant")))
                self.send_header("X-Group-Generation", str(gs.get("group_generation")))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def encode_binary_request(ids: np.ndarray, vals: np.ndarray) -> bytes:
    """The ``:predict_binary`` request body for [N, F] ids and vals."""
    ids = np.ascontiguousarray(ids, "<i8")
    vals = np.ascontiguousarray(vals, "<f4")
    n, f = ids.shape
    return np.asarray([n, f], "<u4").tobytes() + ids.tobytes() + vals.tobytes()


class RetrievalScorer:
    """Two-tower serving: encode either side; top-k retrieve against an
    item corpus encoded at startup.  Each tower has its own micro-batcher
    (own field width, own buckets), both in one metrics registry."""

    def __init__(self, encode_user: Callable, encode_item: Callable, cfg,
                 buckets=DEFAULT_BUCKETS, max_wait_ms: float = 2.0,
                 max_queue_rows: int | None = None, registry=None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._batchers = {
            "user": MicroBatcher(encode_user, cfg.user_field_size, buckets=buckets,
                                 max_wait_ms=max_wait_ms, max_queue_rows=max_queue_rows,
                                 name="encode_user", registry=self.registry),
            "item": MicroBatcher(encode_item, cfg.item_field_size, buckets=buckets,
                                 max_wait_ms=max_wait_ms, max_queue_rows=max_queue_rows,
                                 name="encode_item", registry=self.registry),
        }
        self._corpus_ids: np.ndarray | None = None
        self._corpus_emb: np.ndarray | None = None

    def precompile(self) -> dict:
        return {s: b.precompile() for s, b in self._batchers.items()}

    def metrics_snapshot(self) -> dict:
        return {s: b.metrics_snapshot() for s, b in self._batchers.items()}

    def close(self) -> None:
        for b in self._batchers.values():
            b.close()

    def encode(self, side: str, ids: np.ndarray, vals: np.ndarray) -> np.ndarray:
        try:
            return self._batchers[side].score(ids, vals)
        except ValueError as e:
            raise ValueError(f"{side}: {e}") from None

    def encode_instances(self, side: str, instances: list[dict]) -> np.ndarray:
        ids = np.asarray([i[f"{side}_ids"] for i in instances], np.int64)
        vals = np.asarray([i[f"{side}_vals"] for i in instances], np.float32)
        return self.encode(side, ids, vals)

    def load_corpus(self, path: str) -> int:
        """JSONL corpus, one item a line: ``{"id": <int>, "item_ids":
        [...], "item_vals": [...]}``, encoded once."""
        ids_out, rows = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    obj = json.loads(line)
                    ids_out.append(int(obj["id"]))
                    rows.append(obj)
        if not rows:
            raise ValueError(f"empty item corpus {path!r}")
        self._corpus_emb = self.encode_instances("item", rows)
        self._corpus_ids = np.asarray(ids_out, np.int64)
        return len(rows)

    def retrieve(self, user_instances: list[dict], k: int):
        if self._corpus_emb is None:
            raise ValueError("no item corpus loaded (start the server with --item-corpus)")
        k = int(k)
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        u = self.encode_instances("user", user_instances)   # [B, D]
        scores = u @ self._corpus_emb.T                     # [B, N]
        k = min(k, scores.shape[1])
        top = np.argpartition(-scores, kth=k - 1, axis=1)[:, :k]
        row = np.arange(scores.shape[0])[:, None]
        order = np.argsort(-scores[row, top], axis=1)
        top = top[row, order]
        return self._corpus_ids[top], scores[row, top]


def make_retrieval_handler(scorer: RetrievalScorer, model_name: str, tracer=None):
    base = f"/v1/models/{model_name}"
    known = {f"{base}:encode_user", f"{base}:encode_item", f"{base}:retrieve"}
    tracer = tracer if tracer is not None else Tracer(model_name,
                                                      sample_rate=DEFAULT_SAMPLE_RATE)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True
        _send = _send_json
        _send_plain = _send_text
        obs_tracer = tracer

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._send(200, {"status": "alive"})
            elif self.path == "/metrics":
                self._send_plain(200, scorer.registry.render_prometheus())
            elif self.path == "/v1/trace/recent":
                self._send(200, {"traces": tracer.recent()})
            elif self.path == "/v1/flight":
                self._send(200, {"events": obs_flight.render_events()})
            elif self.path == "/readyz":
                self._send(200, {"ready": True, "engine_compiled": True,
                                 "weights_loaded": True})
            elif self.path == base:
                self._send(200, {
                    "model_version_status": [{"version": "1", "state": "AVAILABLE"}],
                    "corpus_items": (0 if scorer._corpus_ids is None
                                     else int(scorer._corpus_ids.shape[0]))})
            elif self.path == "/v1/metrics":
                self._send(200, {"model": model_name, **scorer.metrics_snapshot()})
            else:
                self._send(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802
            ctx = (tracer.begin(self.path.rsplit(":", 1)[-1], self.headers)
                   if self.path in known else None)
            token = tracer.activate(ctx)
            self._obs_status = None
            try:
                self._handle_post()
            finally:
                tracer.finish(ctx, token, status=self._obs_status)

        def _handle_post(self):
            if self.path not in known:
                self._send(404, {"error": f"unknown path {self.path!r}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                instances = req["instances"]
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                if self.path == f"{base}:retrieve":
                    ids, scores = scorer.retrieve(instances, req.get("k", 10))
                    self._send(200, {"neighbors": ids.tolist(), "scores": scores.tolist()})
                else:
                    side = "user" if self.path.endswith(":encode_user") else "item"
                    emb = scorer.encode_instances(side, instances)
                    self._send(200, {"embeddings": emb.tolist()})
            except OverloadedError as e:
                self._send(503, {"error": str(e)})
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):
            pass

    return Handler


def serve_forever(
    servable_dir: str, *, port: int = 8501, host: str = "127.0.0.1",
    model_name: str = "deepfm", buckets=DEFAULT_BUCKETS,
    max_wait_ms: float = 2.0, max_queue_rows: int | None = None,
    item_corpus: str | None = None, reload_url: str | None = None,
    reload_interval_secs: float = 2.0,
    trace_sample_rate: float = DEFAULT_SAMPLE_RATE, trace_export: str | None = None,
    device=None, ready: threading.Event | None = None, funnel: dict | None = None,
) -> None:
    """Serve whichever servable lives at ``servable_dir`` on ``device``
    (default: the card) until ``shutdown()``: a CTR model behind
    ``:predict``/``:predict_binary`` (bucket graphs captured and warmed up
    before the socket opens), a two-tower model behind its encoders and,
    with ``item_corpus``, ``:retrieve``, or a funnel behind
    ``/v1/recommend`` (``funnel.serve.serve_funnel``, with the ``funnel``
    keywords, which other servables refuse).

    ``reload_url`` (a local publish root) turns on hot reload: a
    :class:`~.reload.HotSwapper` (over a funnel servable, a
    ``funnel.serve.FunnelSwapper`` on a ``FunnelPublisher`` root) adopts
    any version already published before the socket opens, then polls
    every ``reload_interval_secs``.

    ``ready`` is set once the socket is bound; it then carries ``.port``,
    ``.server`` (call ``.shutdown()`` on it to stop; the engines and the
    swapper stop on the way out), ``.scorer``, ``.predictor`` (a CTR
    servable's :class:`~.graphs.GraphedPredictor`) and, with
    ``reload_url``, ``.swapper``."""
    from ..core.config import load_config
    from ..funnel.publish import is_funnel_servable

    buckets = _parse_buckets(buckets)
    if is_funnel_servable(servable_dir):
        from ..funnel.serve import serve_funnel

        if item_corpus:
            raise ValueError("--item-corpus applies to two-tower servables; a funnel "
                             "servable carries its own published index")
        serve_funnel(servable_dir, port=port, host=host, model_name=model_name,
                     buckets=buckets, max_wait_ms=max_wait_ms,
                     max_queue_rows=max_queue_rows, reload_url=reload_url,
                     reload_interval_secs=reload_interval_secs,
                     trace_sample_rate=trace_sample_rate, trace_export=trace_export,
                     device=device, ready=ready, **(funnel or {}))
        return
    if funnel:
        raise ValueError(f"funnel options {sorted(funnel)} apply to funnel "
                         f"servables; {servable_dir} has no funnel.json")
    cfg = load_config(servable_dir)
    two_tower = cfg.model_name == "two_tower"
    if reload_url and two_tower:
        raise ValueError("--reload-url supports CTR servables only (two-tower "
                         "serving has no hot-swap path)")
    if item_corpus and not two_tower:
        raise ValueError(f"--item-corpus only applies to two-tower servables; "
                         f"{servable_dir!r} holds {cfg.model_name!r}")
    # one registry and one trace head a process: the engines, the swapper
    # and the handler all render into them
    registry = MetricsRegistry()
    swapper = predictor = None
    if two_tower:
        from .export import load_retrieval_servable

        encode_user, encode_item, cfg = load_retrieval_servable(servable_dir, device)
        scorer = RetrievalScorer(encode_user, encode_item, cfg, buckets=buckets,
                                 max_wait_ms=max_wait_ms,
                                 max_queue_rows=max_queue_rows, registry=registry)
    else:
        from .export import build_graphed_batcher

        scorer, predictor, holder, cfg, warm = build_graphed_batcher(
            servable_dir, device=device, buckets=buckets, max_wait_ms=max_wait_ms,
            max_queue_rows=max_queue_rows, registry=registry)
    tracer = Tracer("server", sample_rate=trace_sample_rate, export_path=trace_export)
    try:
        if two_tower:
            warm = scorer.precompile()
            if item_corpus:
                print(f"encoded item corpus: {scorer.load_corpus(item_corpus)} items",
                      file=sys.stderr)
            handler = make_retrieval_handler(scorer, model_name, tracer=tracer)
            endpoint = "encode_user|encode_item|retrieve"
        else:
            from .reload import HotSwapper

            reload_status = None
            if reload_url:
                swapper = HotSwapper(holder, predictor, reload_url, cfg,
                                     run=scorer.run_on_worker,
                                     interval_secs=reload_interval_secs,
                                     registry=registry)
                # adopt a version already published before the socket opens
                swapper.poll_once()
                swapper.start()
                reload_status = swapper.status

            def readiness():
                # the handler exists only after load and capture; the live
                # signal is the reloader's breaker (open: the weight supply
                # is broken and this process may be serving stale scores)
                doc = {"ready": True, "engine_compiled": True, "weights_loaded": True}
                if reload_status is not None:
                    st = reload_status()
                    breaker = st.get("breaker") or {}
                    doc["model_version"] = st.get("model_version")
                    doc["reload_breaker"] = breaker.get("state", "closed")
                    doc["ready"] = breaker.get("state") != "open"
                return doc

            handler = make_handler(scorer, model_name, reload_status=reload_status,
                                   readiness=readiness, registry=registry, tracer=tracer)
            endpoint = "predict"
        print(f"captured and warmed up the bucket shapes (s): {warm}", file=sys.stderr)
        with ScoringHTTPServer((host, port), handler) as httpd:
            if ready is not None:
                ready.port = httpd.server_address[1]  # type: ignore[attr-defined]
                ready.server = httpd  # type: ignore[attr-defined]
                ready.scorer = scorer  # type: ignore[attr-defined]
                ready.swapper = swapper  # type: ignore[attr-defined]
                ready.predictor = predictor  # type: ignore[attr-defined]
                ready.set()
            print(f"serving {model_name} on http://{httpd.server_address[0]}:"
                  f"{httpd.server_address[1]}/v1/models/{model_name}:{endpoint}",
                  file=sys.stderr)
            httpd.serve_forever()
    finally:
        if swapper is not None:
            swapper.stop()
        scorer.close()
        tracer.close()


def _worker_argv(servable_dir: str, *, port: int, host: str, model_name: str, buckets,
                 max_wait_ms: float, max_queue_rows: int | None, item_corpus: str | None,
                 reload_url: str | None, reload_interval_secs: float, device,
                 funnel: dict | None) -> list[str]:
    """One process-pool worker's command line: this module's ``main`` with
    ``--pool-worker`` (SO_REUSEPORT, the kernel-runs exit line)."""
    argv = [sys.executable, "-m", "deepfm_tpu_torch.serve.server", "--pool-worker",
            "--servable", os.path.abspath(servable_dir), "--port", str(port),
            "--host", host, "--model-name", model_name,
            "--buckets", ",".join(str(b) for b in _parse_buckets(buckets)),
            "--max-wait-ms", str(max_wait_ms), "--device", str(device or "cuda")]
    if max_queue_rows is not None:
        argv += ["--max-queue-rows", str(max_queue_rows)]
    if item_corpus:
        argv += ["--item-corpus", item_corpus]
    if reload_url:
        argv += ["--reload-url", reload_url, "--reload-interval", str(reload_interval_secs)]
    flags = {"top_k": "--funnel-top-k", "return_n": "--funnel-return-n",
             "retrieval": "--funnel-retrieval", "oversample": "--funnel-oversample",
             "model_parallel": "--funnel-mp"}
    for key, value in (funnel or {}).items():
        if key not in flags:
            raise ValueError(f"unknown funnel option {key!r} for a pool worker")
        argv += [flags[key], str(value)]
    return argv


def serve_pool(
    servable_dir: str, *, workers: int, port: int = 8501, host: str = "127.0.0.1",
    model_name: str = "deepfm", buckets=DEFAULT_BUCKETS, max_wait_ms: float = 2.0,
    max_queue_rows: int | None = None, item_corpus: str | None = None,
    reload_url: str | None = None, reload_interval_secs: float = 2.0,
    device=None, funnel: dict | None = None, max_restarts: int = 10,
    ready: threading.Event | None = None,
) -> None:
    """The process pool (JAX ``serve_pool``): ``workers`` full servers
    (:func:`serve_forever`, each with its own bucket graphs or funnel
    scorer and its own reload poller) share one port through
    ``SO_REUSEPORT``, and the kernel spreads connections over them.  A
    worker that dies is restarted, at most ``max_restarts`` times in all;
    SIGTERM or SIGINT (or ``ready.stop.set()``) stops the pool and its
    workers.  Versions are committed marker-last, so workers that reload
    on their own converge without coordination.

    Each worker is a fresh interpreter (``python -m
    deepfm_tpu_torch.serve.server --pool-worker``), never a fork: this
    parent initialises no CUDA (it does not even resolve the device), so
    no child inherits a CUDA context.  The parent binds an
    ``SO_REUSEPORT`` placeholder socket, never listening, so ``port=0``
    resolves once and every worker binds the resolved port.  Each worker
    prints its kernel runs as one JSON line at exit
    (:func:`report_kernel_counts_at_exit`).

    ``ready`` is set once the workers are started, with ``.port``,
    ``.pids`` (the live workers' pids, kept current), ``.restarts`` (a
    one-element list) and ``.stop`` (an Event that stops the pool)."""
    import signal
    import socket
    import subprocess

    placeholder = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    placeholder.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    placeholder.bind((host, port))
    port = placeholder.getsockname()[1]
    argv = _worker_argv(servable_dir, port=port, host=host, model_name=model_name,
                        buckets=buckets, max_wait_ms=max_wait_ms,
                        max_queue_rows=max_queue_rows, item_corpus=item_corpus,
                        reload_url=reload_url, reload_interval_secs=reload_interval_secs,
                        device=device, funnel=funnel)
    stop = threading.Event()
    children: dict[int, tuple[subprocess.Popen, int]] = {}
    pids: dict[int, int] = {}
    restarts = [0]

    def spawn(idx: int) -> None:
        proc = subprocess.Popen(argv)
        children[proc.pid] = (proc, idx)
        pids[proc.pid] = idx

    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.set())
    try:
        for i in range(int(workers)):
            spawn(i)
        print(f"serving pool: {workers} workers on {host}:{port}", file=sys.stderr)
        if ready is not None:
            ready.port = port  # type: ignore[attr-defined]
            ready.pids = pids  # type: ignore[attr-defined]
            ready.restarts = restarts  # type: ignore[attr-defined]
            ready.stop = stop  # type: ignore[attr-defined]
            ready.set()
        while not stop.wait(0.2):
            for pid, (proc, idx) in list(children.items()):
                code = proc.poll()
                if code is None:
                    continue
                children.pop(pid)
                pids.pop(pid, None)
                if stop.is_set():
                    break
                restarts[0] += 1
                if restarts[0] > max_restarts:
                    print(f"serving pool: worker {idx} died (status {code}); restart "
                          f"budget exhausted", file=sys.stderr)
                    stop.set()
                    break
                print(f"serving pool: worker {idx} died (status {code}); restarting "
                      f"({restarts[0]}/{max_restarts})", file=sys.stderr)
                spawn(idx)
    finally:
        for proc, _ in children.values():
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + 15.0
        for proc, _ in children.values():
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                # a worker that ignores TERM (a wedged request) is killed
                proc.kill()
                proc.wait()
        pids.clear()
        placeholder.close()


def score_stdin(servable_dir: str, *, batch_size: int = 256,
                buckets=DEFAULT_BUCKETS, device=None) -> int:
    """libsvm (``label id:val ...``, label ignored) or JSON lines on stdin
    -> one probability a line (``%.6f``); returns the count.  Lines are
    scored ``batch_size`` at a time through the eager servable behind the
    bucketed engine with ``max_wait_ms=0`` (one caller: waiting for
    bucket-mates would only add latency); ``batch_size`` is a bucket of
    its own, so a full flush is not padded."""
    from ..data.libsvm import parse_libsvm_line
    from .export import load_servable

    predict, cfg = load_servable(servable_dir, device=device)
    scorer = MicroBatcher(predict, cfg.field_size,
                          buckets=sorted(set(_parse_buckets(buckets)) | {int(batch_size)}),
                          max_wait_ms=0.0)
    count = 0
    buf_ids: list[list[int]] = []
    buf_vals: list[list[float]] = []

    def flush():
        nonlocal count
        if not buf_ids:
            return
        probs = scorer.score(np.asarray(buf_ids, np.int64), np.asarray(buf_vals, np.float32))
        for p in probs:
            sys.stdout.write(f"{float(p):.6f}\n")
        sys.stdout.flush()  # a pipeline sees results batch by batch
        count += len(buf_ids)
        buf_ids.clear()
        buf_vals.clear()

    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                obj = json.loads(line)
                buf_ids.append(obj["feat_ids"])
                buf_vals.append(obj["feat_vals"])
            else:
                _, ids, vals = parse_libsvm_line(line)
                buf_ids.append(ids)
                buf_vals.append(vals)
            if len(buf_ids) >= batch_size:
                flush()
        flush()
    finally:
        scorer.close()
    sys.stdout.flush()
    return count


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--servable", required=True)
    ap.add_argument("--port", type=int, default=8501)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (0.0.0.0 for non-loopback clients)")
    ap.add_argument("--item-corpus", default=None,
                    help="two-tower only: JSONL item corpus ({\"id\": N, \"item_ids\": "
                         "[...], \"item_vals\": [...]} a line) encoded at startup "
                         "for :retrieve")
    ap.add_argument("--model-name", default="deepfm")
    ap.add_argument("--buckets", default="8,32,128,512",
                    help="micro-batch bucket sizes, comma-separated; each is one "
                         "CUDA graph a weight slot")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="max time a request waits for bucket-mates")
    ap.add_argument("--max-queue-rows", type=int, default=None,
                    help="queue bound in rows (default 16x the largest bucket); "
                         "beyond it requests get HTTP 503")
    ap.add_argument("--batch-size", type=int, default=256,
                    help="stdin mode only: lines scored a flush")
    ap.add_argument("--workers", type=int, default=1,
                    help="process pool size: N servers on one port (SO_REUSEPORT), "
                         "each its own interpreter, a dead one restarted")
    ap.add_argument("--max-restarts", type=int, default=10,
                    help="--workers > 1: worker restarts before the pool gives up")
    ap.add_argument("--pool-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--stdin", action="store_true",
                    help="score stdin lines (libsvm or JSON) instead of serving HTTP")
    ap.add_argument("--reload-url", default=None,
                    help="local publish root (online/publisher.py) to poll for new "
                         "versions, hot-swapped into the idle weight slot after a "
                         "hash check and a canary")
    ap.add_argument("--reload-interval", type=float, default=2.0,
                    help="seconds between manifest polls with --reload-url")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, needs a Hopper card) or cpu")
    ap.add_argument("--funnel-top-k", type=int, default=0,
                    help="funnel servables: candidates retrieved per user "
                         "(0 = the servable's funnel.json default)")
    ap.add_argument("--funnel-return-n", type=int, default=0,
                    help="funnel servables: ranked items returned per user "
                         "(0 = the servable's funnel.json default)")
    ap.add_argument("--funnel-retrieval", default="", choices=("", "exact", "int8", "auto"),
                    help="funnel retrieval tier: exact f32 scoring, int8 scoring "
                         "(kernel B2) with an exact f32 rescore of the oversampled "
                         "shortlist, or auto (int8 from 2**20 index rows); '' = the "
                         "servable's section")
    ap.add_argument("--funnel-oversample", type=int, default=0,
                    help="int8 shortlist width multiplier (top_k * oversample "
                         "candidates reach the rescore; 0 = the servable's value)")
    ap.add_argument("--funnel-mp", type=int, default=0,
                    help="funnel servables: index row shards, all on the serving "
                         "card (0 = 1 shard)")
    ap.add_argument("--trace-sample", type=float, default=DEFAULT_SAMPLE_RATE,
                    help="head-sampling rate for fresh requests (a client's "
                         "X-Trace-Id is always recorded); 0 mints none, 1 traces all")
    ap.add_argument("--trace-export", default=None,
                    help="JSONL file every finished trace is appended to")
    ap.add_argument("--flight-dump", default=None,
                    help="write the flight recorder's ring here as JSONL on SIGTERM "
                         "or a crash (the live ring is GET /v1/flight)")
    args = ap.parse_args(argv)
    funnel = {k: v for k, v in (("top_k", args.funnel_top_k),
                                ("return_n", args.funnel_return_n),
                                ("retrieval", args.funnel_retrieval),
                                ("oversample", args.funnel_oversample),
                                ("model_parallel", args.funnel_mp)) if v}
    if args.workers > 1 and not args.stdin:
        serve_pool(args.servable, workers=args.workers, port=args.port, host=args.host,
                   model_name=args.model_name, buckets=args.buckets,
                   max_wait_ms=args.max_wait_ms, max_queue_rows=args.max_queue_rows,
                   item_corpus=args.item_corpus, reload_url=args.reload_url,
                   reload_interval_secs=args.reload_interval, device=args.device,
                   funnel=funnel, max_restarts=args.max_restarts)
        return 0
    if args.pool_worker:
        ScoringHTTPServer.reuse_port = True
        report_kernel_counts_at_exit("pool-worker")
    if args.flight_dump:
        obs_flight.install(args.flight_dump)
        # no PreemptionGuard in a serve process: dump, then die by the signal
        obs_flight.dump_on_signal()
    if args.stdin:
        score_stdin(args.servable, batch_size=args.batch_size, buckets=args.buckets,
                    device=args.device)
        return 0
    serve_forever(args.servable, port=args.port, host=args.host,
                  model_name=args.model_name, buckets=args.buckets,
                  max_wait_ms=args.max_wait_ms, max_queue_rows=args.max_queue_rows,
                  item_corpus=args.item_corpus, reload_url=args.reload_url,
                  reload_interval_secs=args.reload_interval,
                  trace_sample_rate=args.trace_sample, trace_export=args.trace_export,
                  device=args.device, funnel=funnel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
