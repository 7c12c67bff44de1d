"""``/v1/recommend``: the recommendation funnel behind the micro-batching
engine, on one card.  Counterpart of ``FunnelScorer``, ``handle_recommend``,
the funnel handler and ``serve_funnel`` in ``deepfm_tpu/funnel/serve.py``.

One request carries a user's query features (two-tower user side) and
ranking features (the CTR row minus the item slot); one response carries
the top-N ranked items.  Per coalesced dispatch (serve/batcher.py buckets):

    1. retrieve - encode the queries, score the index (exact, or int8
                  through kernel B2 plus the f32 rescore) -> K (id, score)
                  candidates per row (funnel/index.build_retrieve_with);
    2. rank     - each row's K candidates fan out to K ranking rows (the
                  candidate id in ``item_field``), score through the DeepFM
                  (kernel B1 on the card) and keep the top N
                  (funnel/index.build_rank_topn_with).

    POST /v1/recommend  {"instances": [{"user_ids", "user_vals",
                          "feat_ids", "feat_vals"}, ...], "n": N}
                     -> {"items", "scores", "retrieval_scores",
                         "model_version", "index_version"}

A malformed body or a bad ``n`` answers 400, a full queue 503, a scoring
failure 500.  ``/v1/metrics`` carries a ``funnel`` section (stage latency
percentiles, candidates/s, index occupancy, merge overflow).  Both
versions are 0: the hot swap (``FunnelSwapper``), versioned publishing,
admission control and its degraded oversample, and pool members are not
ported yet.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from ..serve.batcher import DEFAULT_BUCKETS, MicroBatcher, OverloadedError
from ..serve.export import model_from_state
from .index import (build_rank_topn_with, build_retrieve_with,
                    funnel_score_bytes_est, make_funnel_context,
                    stage_funnel_payload)
from .publish import load_funnel_artifact

RECOMMEND_PATH = "/v1/recommend"
STAGE_WINDOW = 4096  # dispatches in each stage's sliding latency window


class _StageWindow:
    """Sliding window of one stage's per-dispatch seconds."""

    def __init__(self):
        self._lock = threading.Lock()
        self._secs: deque[float] = deque(maxlen=STAGE_WINDOW)
        self._count = 0

    def observe(self, secs: float) -> None:
        with self._lock:
            self._secs.append(secs)
            self._count += 1

    def snapshot(self) -> dict:
        """``{"count": N, "p50": ms, "p99": ms}`` (percentiles once any
        dispatch was recorded)."""
        with self._lock:
            out = {"count": self._count}
            w = np.asarray(self._secs, np.float64) * 1e3
        if w.size:
            p50, p99 = np.percentile(w, [50, 99])
            out.update(p50=float(p50), p99=float(p99))
        return out


class FunnelScorer:
    """The funnel serving engine on ``device`` (default: the card):
    retrieve + rank dispatched through the MicroBatcher (request width
    ``user_fields + rank_fields``, rows padded to the engine's buckets).
    ``top_k``/``return_n`` of 0 take the servable's funnel.json defaults;
    ``retrieval``/``oversample`` of ""/0 take its ``retrieval`` section
    (exact when none was stamped)."""

    def __init__(self, servable_dir: str, *, device=None, top_k: int = 0,
                 return_n: int = 0, retrieval: str = "", oversample: int = 0,
                 buckets=DEFAULT_BUCKETS, max_wait_ms: float = 2.0,
                 max_queue_rows: int | None = None):
        art = load_funnel_artifact(servable_dir)
        meta = art.meta
        rsec = meta.get("retrieval") or {}
        self.ctx = make_funnel_context(
            art.rank_cfg, art.query_cfg,
            capacity=int(meta.get("capacity") or art.index.item_ids.shape[0]),
            top_k=int(top_k) or int(meta["top_k"]),
            return_n=int(return_n) or int(meta["return_n"]),
            item_field=int(meta["item_field"]),
            retrieval=retrieval or str(rsec.get("mode", "exact")),
            oversample=int(oversample) or int(rsec.get("oversample", 4)),
        )
        rank = model_from_state(art.rank_cfg, art.rank_state, device)
        query = model_from_state(art.query_cfg, art.query_state, rank.fm_v.device)
        self.payload = stage_funnel_payload(self.ctx, rank, query, art.index)
        self.device = rank.fm_v.device
        self._retrieve_with = build_retrieve_with(self.ctx)
        self._rank_with = build_rank_topn_with(self.ctx)
        self._items = int(art.index.item_ids.shape[0])
        self._flock = threading.Lock()
        self._precompiling = False
        self.candidates_total = 0
        self.retrieval_secs_total = 0.0
        self.merge_overflow_total = 0
        self._retr_window = _StageWindow()
        self._rank_window = _StageWindow()
        self.engine = MicroBatcher(
            self._funnel_fn, self.ctx.user_fields + self.ctx.rank_fields,
            buckets=buckets, max_wait_ms=max_wait_ms,
            max_queue_rows=max_queue_rows, name="recommend",
        )
        self.compile_secs = self.precompile()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the engine fn ------------------------------------------------------
    def _funnel_fn(self, ids: np.ndarray, vals: np.ndarray) -> np.ndarray:
        """One coalesced dispatch: [B, Fu+F] -> [B, 3, N] pack.  The
        payload is read once and both stages run on it."""
        fu = self.ctx.user_fields
        payload = self.payload
        dev = self.device
        tids = torch.from_numpy(np.ascontiguousarray(ids)).to(dev)
        tvals = torch.from_numpy(np.ascontiguousarray(vals)).to(dev)
        with torch.inference_mode():
            t0 = time.perf_counter()
            scores, cand = self._retrieve_with(payload, tids[:, :fu], tvals[:, :fu])
            self._sync()
            t1 = time.perf_counter()
            pack = self._rank_with(payload, tids[:, fu:], tvals[:, fu:], cand, scores)
            pack = pack.cpu().numpy()
            t2 = time.perf_counter()
            overflow = bool((cand < 0).any())
        if self._precompiling:
            # warm-up dispatches are set-up time, not serving
            return pack
        self._retr_window.observe(t1 - t0)
        self._rank_window.observe(t2 - t1)
        with self._flock:
            self.candidates_total += ids.shape[0] * self.ctx.top_k
            self.retrieval_secs_total += t1 - t0
            if overflow:
                # the corpus holds fewer valid items than top_k asks for
                self.merge_overflow_total += 1
        return pack

    # -- request surface ----------------------------------------------------
    def recommend(self, user_ids, user_vals, feat_ids, feat_vals,
                  n: int | None = None) -> dict:
        """Query features [B, Fu] + ranking features [B, F] -> the top
        ``n`` (<= return_n) ranked items per row."""
        ids = np.concatenate(
            [np.asarray(user_ids, np.int64).reshape(len(user_ids), -1),
             np.asarray(feat_ids, np.int64).reshape(len(feat_ids), -1)], axis=1)
        vals = np.concatenate(
            [np.asarray(user_vals, np.float32).reshape(ids.shape[0], -1),
             np.asarray(feat_vals, np.float32).reshape(ids.shape[0], -1)], axis=1)
        # a bad n is refused before it costs a dispatch
        n = self.ctx.return_n if n is None else int(n)
        if not 1 <= n <= self.ctx.return_n:
            raise ValueError(f"n={n} out of [1, return_n={self.ctx.return_n}]")
        pack = self.engine.score(ids, vals)          # [B, 3, return_n]
        items = pack[:, 0, :n].astype(np.int64)
        rank_s = np.where(np.isfinite(pack[:, 1, :n]), pack[:, 1, :n], 0.0)
        retr_s = np.where(np.isfinite(pack[:, 2, :n]), pack[:, 2, :n], 0.0)
        return {
            "items": items.tolist(),
            "scores": np.round(rank_s, 6).tolist(),
            "retrieval_scores": np.round(retr_s, 6).tolist(),
        }

    def recommend_instances(self, instances: list[dict], n: int | None = None) -> dict:
        fu, f = self.ctx.user_fields, self.ctx.rank_fields
        u_ids, u_vals, r_ids, r_vals = [], [], [], []
        for i, inst in enumerate(instances):
            if not isinstance(inst, dict):
                raise ValueError(
                    f"instances[{i}] is {type(inst).__name__}, expected an "
                    f"object with user_ids/user_vals/feat_ids/feat_vals")
            missing = [k for k in ("user_ids", "user_vals", "feat_ids", "feat_vals")
                       if k not in inst]
            if missing:
                raise ValueError(f"instances[{i}] is missing {missing}")
            u_ids.append(inst["user_ids"])
            u_vals.append(inst["user_vals"])
            r_ids.append(inst["feat_ids"])
            r_vals.append(inst["feat_vals"])
        try:
            u_ids = np.asarray(u_ids, np.int64).reshape(len(instances), fu)
            u_vals = np.asarray(u_vals, np.float32).reshape(len(instances), fu)
            r_ids = np.asarray(r_ids, np.int64).reshape(len(instances), f)
            r_vals = np.asarray(r_vals, np.float32).reshape(len(instances), f)
        except ValueError as e:
            raise ValueError(
                f"instances are ragged or mis-sized (user side is [{fu}], "
                f"rank side [{f}]): {e}") from None
        return self.recommend(u_ids, u_vals, r_ids, r_vals, n=n)

    # -- observability ------------------------------------------------------
    def versions(self) -> tuple[int, int]:
        """(model_version, index_version): 0 and 0, there is no swapper."""
        return 0, 0

    def metrics_snapshot(self) -> dict:
        return {**self.engine.metrics_snapshot(), "funnel": self.funnel_snapshot()}

    def funnel_snapshot(self) -> dict:
        mv, iv = self.versions()
        with self._flock:
            secs = self.retrieval_secs_total
            out = {
                "model_version": mv,
                "index_version": iv,
                "index_items": self._items,
                "index_capacity": self.ctx.capacity,
                "top_k": self.ctx.top_k,
                "return_n": self.ctx.return_n,
                "retrieval_mode": self.ctx.retrieval_mode,
                "oversample": self.ctx.oversample,
                "candidates_total": self.candidates_total,
                "candidates_per_sec": (self.candidates_total / secs if secs else None),
                "merge_overflow_total": self.merge_overflow_total,
            }
        out["retrieval_ms"] = self._retr_window.snapshot()
        out["rank_ms"] = self._rank_window.snapshot()
        out.update(funnel_score_bytes_est(self.ctx, max(self.engine.buckets)))
        return out

    def precompile(self) -> dict:
        """Warm-up: one dispatch per bucket before traffic (kernel builds,
        cuBLAS handles), kept out of the metrics."""
        self._precompiling = True
        try:
            self.compile_secs = self.engine.precompile()
        finally:
            self._precompiling = False
        return self.compile_secs

    def close(self) -> None:
        self.engine.close()


def handle_recommend(scorer: FunnelScorer, req: dict) -> tuple[int, dict]:
    """``/v1/recommend`` request handling: scores through the engine and
    stamps the (model_version, index_version) pair."""
    try:
        doc = scorer.recommend_instances(req["instances"], n=req.get("n"))
    except OverloadedError as e:
        return 503, {"error": str(e)}
    except (ValueError, KeyError, TypeError) as e:
        return 400, {"error": f"{type(e).__name__}: {e}"}
    except Exception as e:
        return 500, {"error": f"{type(e).__name__}: {e}"}
    doc["model_version"], doc["index_version"] = scorer.versions()
    return 200, doc


def make_funnel_handler(scorer: FunnelScorer, model_name: str):
    """serve/server.py's handler (``/healthz``, ``/readyz``, ``/v1/metrics``
    with the ``funnel`` section) with POST routed only to
    ``/v1/recommend``."""
    from ..serve.server import make_handler

    base = make_handler(scorer, model_name)

    class FunnelHandler(base):
        def do_POST(self):  # noqa: N802 (http.server API)
            if self.path != RECOMMEND_PATH:
                self._send(404, {"error": f"unknown path {self.path!r} (funnel "
                                          f"servables serve POST {RECOMMEND_PATH})"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                if not isinstance(req, dict):
                    raise TypeError(f"the body is {type(req).__name__}, not an object")
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(*handle_recommend(scorer, req))

    return FunnelHandler


def serve_funnel(servable_dir: str, *, port: int = 8501, host: str = "127.0.0.1",
                 model_name: str = "deepfm", buckets=DEFAULT_BUCKETS,
                 max_wait_ms: float = 2.0, max_queue_rows: int | None = None,
                 top_k: int = 0, return_n: int = 0, retrieval: str = "",
                 oversample: int = 0, device=None,
                 ready: threading.Event | None = None) -> None:
    """Blocking funnel server on one card (``serve/server.py
    serve_forever`` delegates here when the servable has a funnel.json).
    ``ready`` as in ``serve_forever``: set once the socket is bound, with
    ``.port`` and ``.server``."""
    from ..serve.server import ScoringHTTPServer

    scorer = FunnelScorer(
        os.path.abspath(servable_dir), device=device, top_k=top_k,
        return_n=return_n, retrieval=retrieval, oversample=oversample,
        buckets=buckets, max_wait_ms=max_wait_ms, max_queue_rows=max_queue_rows)
    try:
        print(f"warmed up funnel bucket shapes (s): {scorer.compile_secs}",
              file=sys.stderr)
        httpd = ScoringHTTPServer((host, port), make_funnel_handler(scorer, model_name))
        with httpd:
            if ready is not None:
                ready.port = httpd.server_address[1]  # type: ignore[attr-defined]
                ready.server = httpd  # type: ignore[attr-defined]
                ready.scorer = scorer  # type: ignore[attr-defined]
                ready.set()
            print(f"serving funnel {model_name} on http://{httpd.server_address[0]}:"
                  f"{httpd.server_address[1]}{RECOMMEND_PATH} (retrieval "
                  f"{scorer.ctx.retrieval_mode}, top_k {scorer.ctx.top_k} -> "
                  f"return_n {scorer.ctx.return_n})", file=sys.stderr)
            httpd.serve_forever()
    finally:
        scorer.close()
