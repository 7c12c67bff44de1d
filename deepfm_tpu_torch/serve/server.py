"""REST serving front: the ``:predict`` surface of
``deepfm_tpu/serve/server.py`` over the port's servable.

    POST /v1/models/<name>:predict  {"instances": [{"feat_ids": [...],
                                     "feat_vals": [...]}, ...]}
                                 -> {"predictions": [...]}
    GET  /healthz    liveness
    GET  /readyz     readiness (the model is loaded and warmed up)
    GET  /v1/metrics the engine's counters and latency percentiles

A malformed body answers 400, a full queue 503, a scoring failure 500.
Requests ride the micro-batching engine (serve/batcher.py), whose worker
thread is the only thread that touches the device.

    python -m deepfm_tpu_torch.serve.server --servable DIR --port 8501

runs on the card (``--device cpu`` for the plain CPU path).  A servable
with a ``funnel.json`` (funnel/publish.py) serves ``POST /v1/recommend``
instead of ``:predict`` (funnel/serve.py), tuned by the ``--funnel-*``
flags.  No pool or hot reload yet.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .batcher import DEFAULT_BUCKETS, MicroBatcher, OverloadedError
from .export import load_servable


class ScoringHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog for connection bursts."""

    request_queue_size = 128


def _parse_buckets(s) -> tuple[int, ...]:
    if isinstance(s, str):
        return tuple(int(x) for x in s.split(",") if x.strip())
    return tuple(int(x) for x in s)


def make_handler(scorer, model_name: str):
    """REST handler over an engine exposing ``score_instances`` and
    ``metrics_snapshot``."""
    predict_path = f"/v1/models/{model_name}:predict"

    class Handler(BaseHTTPRequestHandler):
        # keep-alive: every response carries Content-Length; no Nagle stall
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._send(200, {"status": "alive"})
            elif self.path == "/readyz":
                self._send(200, {"ready": True, "engine_compiled": True,
                                 "weights_loaded": True})
            elif self.path == "/v1/metrics":
                self._send(200, {"model": model_name, **scorer.metrics_snapshot()})
            else:
                self._send(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):  # noqa: N802
            if self.path != predict_path:
                self._send(404, {"error": f"unknown path {self.path!r}"})
                return
            # parse/validate -> 400; scoring failure -> 500
            try:
                length = int(self.headers.get("Content-Length", "0"))
                instances = json.loads(self.rfile.read(length))["instances"]
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                probs = scorer.score_instances(instances)
            except (ValueError, TypeError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            except OverloadedError as e:
                self._send(503, {"error": str(e)})
                return
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {"predictions": [float(p) for p in probs]})

    return Handler


def serve_forever(
    servable_dir: str, *, port: int = 8501, host: str = "127.0.0.1",
    model_name: str = "deepfm", buckets=DEFAULT_BUCKETS,
    max_wait_ms: float = 2.0, max_queue_rows: int | None = None,
    device=None, ready: threading.Event | None = None,
    funnel: dict | None = None,
) -> None:
    """Load the servable on ``device`` (default: the card), warm every
    bucket up, open the socket and serve until ``shutdown()``.

    ``ready`` is set once the socket is bound; it then carries ``.port``
    (so a caller can bind port 0) and ``.server`` (call ``.shutdown()`` on
    it to stop; the engine is closed on the way out).

    A funnel servable goes to ``funnel.serve.serve_funnel`` with the
    ``funnel_*`` keywords; they are refused for any other servable."""
    from ..funnel.publish import is_funnel_servable

    if is_funnel_servable(servable_dir):
        from ..funnel.serve import serve_funnel

        serve_funnel(servable_dir, port=port, host=host, model_name=model_name,
                     buckets=_parse_buckets(buckets), max_wait_ms=max_wait_ms,
                     max_queue_rows=max_queue_rows, device=device, ready=ready,
                     **(funnel or {}))
        return
    if funnel:
        raise ValueError(f"funnel options {sorted(funnel)} apply to funnel "
                         f"servables; {servable_dir} has no funnel.json")
    predict, cfg = load_servable(servable_dir, device=device)
    scorer = MicroBatcher(predict, cfg.field_size, buckets=_parse_buckets(buckets),
                          max_wait_ms=max_wait_ms, max_queue_rows=max_queue_rows)
    try:
        warm = scorer.precompile()
        print(f"warmed up bucket shapes (s): {warm}", file=sys.stderr)
        httpd = ScoringHTTPServer((host, port), make_handler(scorer, model_name))
        with httpd:
            if ready is not None:
                ready.port = httpd.server_address[1]  # type: ignore[attr-defined]
                ready.server = httpd  # type: ignore[attr-defined]
                ready.set()
            print(f"serving {model_name} on http://{httpd.server_address[0]}:"
                  f"{httpd.server_address[1]}/v1/models/{model_name}:predict",
                  file=sys.stderr)
            httpd.serve_forever()
    finally:
        scorer.close()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--servable", required=True)
    ap.add_argument("--port", type=int, default=8501)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (0.0.0.0 for non-loopback clients)")
    ap.add_argument("--model-name", default="deepfm")
    ap.add_argument("--buckets", default="8,32,128,512",
                    help="micro-batch bucket sizes, comma-separated")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="max time a request waits for bucket-mates")
    ap.add_argument("--max-queue-rows", type=int, default=None,
                    help="queue bound in rows (default 16x the largest "
                         "bucket); beyond it requests get HTTP 503")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, needs a Hopper card) or cpu")
    ap.add_argument("--funnel-top-k", type=int, default=0,
                    help="funnel servables: candidates retrieved per user "
                         "(0 = the servable's funnel.json default)")
    ap.add_argument("--funnel-return-n", type=int, default=0,
                    help="funnel servables: ranked items returned per user "
                         "(0 = the servable's funnel.json default)")
    ap.add_argument("--funnel-retrieval", default="",
                    choices=("", "exact", "int8", "auto"),
                    help="funnel retrieval tier: exact f32 scoring, int8 "
                         "scoring (kernel B2) with an exact f32 rescore of "
                         "the oversampled shortlist, or auto (int8 from "
                         "2**20 index rows); '' = the servable's section")
    ap.add_argument("--funnel-oversample", type=int, default=0,
                    help="int8 shortlist width multiplier (top_k * "
                         "oversample candidates reach the rescore; 0 = the "
                         "servable's value)")
    args = ap.parse_args(argv)
    funnel = {k: v for k, v in (("top_k", args.funnel_top_k),
                                ("return_n", args.funnel_return_n),
                                ("retrieval", args.funnel_retrieval),
                                ("oversample", args.funnel_oversample)) if v}
    serve_forever(args.servable, port=args.port, host=args.host,
                  model_name=args.model_name, buckets=args.buckets,
                  max_wait_ms=args.max_wait_ms,
                  max_queue_rows=args.max_queue_rows, device=args.device,
                  funnel=funnel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
