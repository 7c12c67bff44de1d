"""``/v1/recommend``: the recommendation funnel behind the micro-batching
engine, with its versioned hot swap.  Counterpart of ``FunnelHolder``,
``FunnelScorer``, ``FunnelSwapper``, ``handle_recommend``, the funnel
handler and ``serve_funnel`` in ``deepfm_tpu/funnel/serve.py``.

One request carries a user's query features (two-tower user side) and
ranking features (the CTR row minus the item slot); one response carries
the top-N ranked items.  Per coalesced dispatch (serve/batcher.py buckets)
the two stages replay as CUDA graphs of the live weight slot
(funnel/graphs.py; eagerly on the CPU):

    1. retrieve - encode the queries, score every index shard (exact, or
                  int8 through kernel B2 plus the f32 rescore), merge the
                  shards' candidate packs -> K (id, score) candidates per
                  row (funnel/index.build_retrieve_with);
    2. rank     - each row's K candidates fan out to K ranking rows (the
                  candidate id in ``item_field``), score through the ranker
                  (kernel B1 on the card) and keep the top N
                  (funnel/index.build_rank_topn_with).

    POST /v1/recommend  {"instances": [{"user_ids", "user_vals",
                          "feat_ids", "feat_vals"}, ...], "n": N}
                     -> {"items", "scores", "retrieval_scores",
                         "model_version", "index_version"}

**Version consistency is structural.**  Query tower, ranking weights and
the index live in one weight slot behind one drain-aware
:class:`FunnelHolder`; a dispatch takes the slot once and runs both
stages on it, and :class:`FunnelSwapper` stages, canaries and commits a
whole published funnel version (funnel/publish.py: one manifest covers
the weights and the index) in one swap.  Retrieval at index v never
meets ranking at weights v+1.

A malformed body or a bad ``n`` answers 400, a full queue 503, a scoring
failure 500.  ``/v1/metrics`` carries a ``funnel`` section (stage latency
percentiles, candidates/s, the index's version and occupancy, merge
overflow) and, with ``reload_url``, a ``reload`` section; the stage
latencies are the registry's ``deepfm_funnel_stage_seconds`` (on the card
each graph's stream time between CUDA events, host gaps before a launch
included), so ``/metrics`` shows them too; ``/v1/recommend`` is traced (``recommend.queue`` and
``recommend.dispatch`` spans in ``/v1/trace/recent``).

With an admission controller (a shard-group pool member's, from
``--slo``) the engine prices deadlines and sheds, and under int8 retrieval
the shed ladder's degrade narrows the shortlist: a second retrieve graph
at ``max(1, int(oversample · degrade_floor))`` is captured at boot and a
dispatch takes it while ``admission.degrade_factor() < 1``
(``oversample_effective`` and ``degraded_dispatch_total`` in the
``funnel`` section).  The pool members (serve/pool/worker.py) serve
``/v1/recommend`` through :class:`FunnelScorer` with three weight slots.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

from ..obs import flight as obs_flight
from ..obs.metrics import MetricsRegistry
from ..obs.trace import DEFAULT_SAMPLE_RATE, Tracer
from ..online.publisher import (Manifest, fetch_version, latest_manifest,
                                resolve_version)
from ..serve.batcher import DEFAULT_BUCKETS, MicroBatcher, OverloadedError
from ..serve.reload import DRAIN_TIMEOUT_SECS, SwappableParams
from ..utils.retry import CircuitBreaker
from ..serve.graphs import SLOTS
from .graphs import FunnelGraphs
from .index import (FunnelContext, funnel_score_bytes_est, funnel_wire_bytes_est,
                    index_hash, index_shards, make_funnel_context)
from .publish import load_funnel_artifact, query_param_hash, rank_param_hash

RECOMMEND_PATH = "/v1/recommend"


class FunnelHolder(SwappableParams):
    """The live weight slot behind a drain-aware swap, with an atomic
    (model_version, index_version) read: both come from the one manifest
    the last swap installed, read under the holder's lock, so a response
    never reports a (weights, index) pair that was not one version."""

    def versions(self) -> tuple[int, int]:
        with self._cond:
            m = self.manifest
            iv = self.version if m is None else int(m.version)
            return self.version, iv


def _canary_probes(ctx: FunnelContext, rows: int):
    """Spread in-vocabulary query ids and zero ranking rows (the
    HotSwapper's probe construction at both funnel widths)."""
    fu, f = ctx.user_fields, ctx.rank_fields
    uv = ctx.query_cfg.user_vocab_size or ctx.query_cfg.feature_size
    uids = np.zeros((rows, fu), np.int64)
    if rows > 1:
        uids[1:] = np.linspace(0, max(0, uv - 1), (rows - 1) * fu,
                               dtype=np.int64).reshape(rows - 1, fu)
    ids = np.concatenate([uids, np.zeros((rows, f), np.int64)], axis=1)
    vals = np.concatenate([np.ones((rows, fu), np.float32),
                           np.ones((rows, f), np.float32)], axis=1)
    return ids, vals


class FunnelScorer:
    """The funnel serving engine on ``device`` (default: the card): the
    two stages of the live slot (funnel/graphs.py) dispatched through the
    MicroBatcher (request width ``user_fields + rank_fields``, rows padded
    to the engine's buckets), behind :class:`FunnelHolder`.

    ``top_k``/``return_n`` of 0 take the servable's funnel.json defaults;
    ``retrieval``/``oversample`` of ""/0 take its ``retrieval`` section
    (exact when none was stamped).  ``model_parallel`` row-shards the
    index on the serving device; ``data_parallel`` splits each bucket into
    row slices.  ``name`` and ``registry`` name the engine and share a
    process's metrics registry; ``admission`` (an
    ``AdmissionController``) prices deadlines, sheds, and under int8
    retrieval arms the degraded retrieve; ``slots`` is the weight slot
    count (a pool member keeps three: live, staged, previous)."""

    def __init__(self, servable_dir: str, *, device=None, top_k: int = 0,
                 return_n: int = 0, retrieval: str = "", oversample: int = 0,
                 model_parallel: int = 1, data_parallel: int = 1,
                 buckets=DEFAULT_BUCKETS, max_wait_ms: float = 2.0,
                 max_queue_rows: int | None = None, name: str = "recommend",
                 registry: MetricsRegistry | None = None, admission=None,
                 slots: int = SLOTS):
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
            model_parallel=model_parallel,
        )
        # the shed ladder's degraded oversample (JAX funnel/serve.py): only
        # where admission can degrade and the int8 shortlist can narrow
        self._admission = admission
        self.degraded_oversample = None
        if (admission is not None and self.ctx.retrieval_mode == "int8"
                and self.ctx.oversample > 1):
            os_d = max(1, int(self.ctx.oversample * admission.degrade_floor))
            if os_d < self.ctx.oversample:
                self.degraded_oversample = os_d
        self._degraded_active = False
        self.degraded_dispatch_total = 0
        self.graphs = FunnelGraphs(self.ctx, art.rank_state, art.query_state, art.index,
                                   device=device, buckets=buckets, slots=slots,
                                   degraded_oversample=self.degraded_oversample,
                                   data_parallel=data_parallel)
        self.device = self.graphs.device
        self.holder = FunnelHolder(0, version=0)
        self._boot_items = int(art.index.item_ids.shape[0])
        self._canary = _canary_probes(self.ctx, int(min(buckets)))
        self._flock = threading.Lock()
        self._precompiling = False
        self.candidates_total = 0
        self.retrieval_secs_total = 0.0
        self.merge_overflow_total = 0
        self.last_stage_ms: float | None = None
        self.last_canary_ms: float | None = None
        # stage latency lives in the shared obs registry, as JAX's does
        self.registry = registry if registry is not None else MetricsRegistry()
        stage = self.registry.histogram(
            "deepfm_funnel_stage_seconds",
            "per-dispatch funnel stage latency (on the card each graph's stream time "
            "between CUDA events, host gaps before a launch included)",
            labels=("stage",), quantiles=(0.50, 0.99))
        self._retr_window = stage.labels("retrieval")
        self._rank_window = stage.labels("rank")
        self.engine = MicroBatcher(
            self._funnel_fn, self.ctx.user_fields + self.ctx.rank_fields,
            buckets=buckets, max_wait_ms=max_wait_ms,
            max_queue_rows=max_queue_rows, name=name, registry=self.registry,
            admission=admission,
        )
        self.compile_secs: dict = {}
        try:
            self.precompile()
        except BaseException:
            self.engine.close()
            raise

    # -- the engine fn ------------------------------------------------------
    def _funnel_fn(self, ids: np.ndarray, vals: np.ndarray) -> np.ndarray:
        """One coalesced dispatch: [B, Fu+F] -> [B, 3, N] pack.  The live
        slot is taken once and both stages run on it.  While admission
        degrades, the retrieve runs at the degraded oversample (its own
        graph, captured at boot)."""
        degraded = (self.degraded_oversample is not None
                    and self._admission.degrade_factor() < 1.0)
        if degraded != self._degraded_active and not self._precompiling:
            # one flight record a transition; the flag is read by scrapes
            with self._flock:
                self._degraded_active = degraded
            obs_flight.record("funnel_degrade", subsystem="funnel", engaged=degraded,
                              oversample=(self.degraded_oversample if degraded
                                          else self.ctx.oversample))
        slot, gen = self.holder.acquire()
        try:
            pack, overflow, (t_retr, t_rank) = self.graphs.dispatch(slot, ids, vals,
                                                                    degraded=degraded)
        finally:
            self.holder.release(gen)
        if self._precompiling:
            # warm-up dispatches are set-up time, not serving
            return pack
        self._retr_window.observe(t_retr)
        self._rank_window.observe(t_rank)
        with self._flock:
            self.candidates_total += ids.shape[0] * self.ctx.top_k
            self.retrieval_secs_total += t_retr
            if degraded:
                self.degraded_dispatch_total += 1
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

    # -- staging (the swapper's path) ---------------------------------------
    def stage_version(self, root: str, version: int, staging_dir: str,
                      slot: int | None = None) -> tuple[int, Manifest]:
        """Resolve, verify and canary one committed funnel version into
        ``slot`` (default: the idle one of two; a scorer with more slots
        needs ``slot``); returns ``(slot,
        manifest)`` ready for one swap.
        Raises on any verification failure, leaving the live slot as it
        was.  The checks on the host, each with JAX's meaning: a funnel
        version (an ``index`` section), the ranker's ``param_hash`` and
        the index's ``sha256`` (a torn or corrupted artifact), the query
        tower's hash (index and encoder would disagree), the retrieval
        mode (a policy refusal), and the staging guards (capacity, id
        range).  Then the upload into the idle slot, refused where a
        leaf's shape or dtype differs from the slot's, and the canary
        through its graphs, both on the engine's worker."""
        t0 = time.perf_counter()
        manifest, local = resolve_version(root, int(version), staging_dir)
        if manifest.index is None:
            raise ValueError(
                f"version {version} carries no index section: not a funnel "
                f"version (published by FunnelPublisher?)")
        try:
            # corruption-shaped failures purge the staged copy so the next
            # poll fetches it again
            art = load_funnel_artifact(local)
            got = rank_param_hash(art.rank_cfg, art.rank_state)
            if manifest.param_hash and got != manifest.param_hash:
                raise ValueError(
                    f"version {version} rank param hash mismatch (manifest "
                    f"{manifest.param_hash[:12]}…, staged {got[:12]}…): torn or "
                    f"corrupted artifact")
            if index_hash(art.index) != manifest.index["sha256"]:
                raise ValueError(
                    f"version {version} index hash mismatch: torn or corrupted index.npz")
            qh = manifest.index.get("query_param_hash")
            if qh and query_param_hash(art.query_cfg, art.query_state) != qh:
                raise ValueError(
                    f"version {version} query tower hash mismatch: the index and "
                    f"query encoder would disagree")
        except Exception:
            self._purge_staged(local, staging_dir)
            raise
        pub_mode = (manifest.index.get("retrieval") or {}).get("mode")
        if pub_mode is not None and pub_mode != self.ctx.retrieval_mode:
            # a policy refusal, not corruption: the publish-time recall
            # gate ran for pub_mode
            raise ValueError(
                f"version {version} was published for retrieval mode "
                f"{pub_mode!r} but this scorer serves {self.ctx.retrieval_mode!r}: "
                f"retrieval-mode skew; republish for this mode or redeploy the scorer")
        staged = {"rank": art.rank_state, "query": art.query_state,
                  "shards": index_shards(self.ctx, art.index)}
        live, n_slots = self.holder.get(), self.graphs.slots
        if slot is None:
            if n_slots != 2:
                raise ValueError(
                    f"with {n_slots} weight slots the caller names the slot to stage "
                    f"into (only two slots have one idle slot)")
            idle = 1 - live
        else:
            idle = int(slot)
        if not 0 <= idle < n_slots:
            raise ValueError(f"slot {idle} is out of range: this scorer has {n_slots} slots")
        if idle == live:
            raise ValueError(f"slot {idle} is live: a version stages into an idle slot")
        self.engine.run_on_worker(lambda: self.graphs.load_slot(idle, staged))
        t1 = time.perf_counter()
        self.engine.run_on_worker(
            lambda: self._canary_check(idle, items=int(manifest.index["items"])))
        t2 = time.perf_counter()
        self.last_stage_ms = round(1e3 * (t1 - t0), 3)
        self.last_canary_ms = round(1e3 * (t2 - t1), 3)
        return idle, manifest

    @staticmethod
    def _purge_staged(local: str, staging_dir: str) -> None:
        """Only what lies under the staging directory is ever deleted (a
        local root's version is read in place and stays)."""
        if os.path.abspath(local).startswith(os.path.abspath(staging_dir) + os.sep):
            shutil.rmtree(local, ignore_errors=True)

    def _canary_check(self, slot: int, *, items: int) -> None:
        """The probe batch through ``slot``'s graphs at the smallest
        bucket: no pad among the top K when the corpus can fill it,
        finite retrieval scores, finite probabilities in [0, 1]."""
        pack, _, _, scores, cand = self.graphs.dispatch(slot, *self._canary, full=True)
        if items >= self.ctx.top_k and (cand < 0).any():
            raise ValueError(
                f"canary retrieve returned pad entries from a {items}-item index "
                f"(top_k={self.ctx.top_k}): the staged index is mis-padded")
        if not np.isfinite(scores[cand >= 0]).all():
            raise ValueError("canary retrieve produced non-finite scores")
        probs = pack[:, 1, :][pack[:, 0, :] >= 0]
        if not np.isfinite(probs).all():
            raise ValueError(
                f"canary rank produced non-finite probabilities "
                f"({int((~np.isfinite(probs)).sum())}/{probs.size} bad)")
        if ((probs < 0.0) | (probs > 1.0)).any():
            raise ValueError("canary rank produced out-of-range scores")

    # -- observability ------------------------------------------------------
    def versions(self) -> tuple[int, int]:
        return self.holder.versions()

    def metrics_snapshot(self) -> dict:
        return {**self.engine.metrics_snapshot(), "funnel": self.funnel_snapshot()}

    def funnel_snapshot(self) -> dict:
        mv, iv = self.holder.versions()
        manifest = self.holder.manifest
        items = self._boot_items if manifest is None else int(manifest.index["items"])
        with self._flock:
            secs = self.retrieval_secs_total
            out = {
                "model_version": mv,
                "index_version": iv,
                "index_items": items,
                "index_capacity": self.ctx.capacity,
                "model_parallel": self.ctx.model_parallel,
                "top_k": self.ctx.top_k,
                "return_n": self.ctx.return_n,
                "retrieval_mode": self.ctx.retrieval_mode,
                "oversample": self.ctx.oversample,
                "oversample_degraded": self.degraded_oversample,
                "oversample_effective": (self.degraded_oversample if self._degraded_active
                                         else self.ctx.oversample),
                "kernel_engaged": (self.ctx.retrieval_mode == "int8"
                                   and self.device.type == "cuda"),
                "degraded_dispatch_total": self.degraded_dispatch_total,
                "candidates_total": self.candidates_total,
                "candidates_per_sec": (self.candidates_total / secs if secs else None),
                "merge_overflow_total": self.merge_overflow_total,
            }
        out["retrieval_ms"] = self._retr_window.snapshot()
        out["rank_ms"] = self._rank_window.snapshot()
        out["wire_bytes_est"] = funnel_wire_bytes_est(self.ctx, max(self.engine.buckets))
        out.update(funnel_score_bytes_est(self.ctx, max(self.engine.buckets)))
        return out

    def precompile(self) -> dict:
        """The graphs' captures on the engine's worker, then one dispatch
        per bucket through them (kernel builds, cuBLAS handles), kept out
        of the metrics."""
        self._precompiling = True
        try:
            capture = self.engine.run_on_worker(self.graphs.precompile)
            self.compile_secs = {"capture": capture, "warm": self.engine.precompile()}
        finally:
            self._precompiling = False
        return self.compile_secs

    def close(self) -> None:
        self.engine.close()


class FunnelSwapper:
    """Poll a funnel publish root; stage, canary and swap whole versions.

    The HotSwapper protocol (serve/reload.py) over the funnel's slots: a
    failure to list or fetch feeds a circuit breaker (while it is open,
    polls are skipped and the old version keeps serving); a staged
    version that fails verification or the canary is rolled back.  The
    swap itself repoints one slot: ranking weights and index move
    together or not at all."""

    def __init__(self, scorer: FunnelScorer, source: str, *, interval_secs: float = 2.0,
                 staging_dir: str | None = None):
        self._scorer = scorer
        self._source = str(source)
        self._interval = float(interval_secs)
        self._staging = staging_dir or os.path.join(
            tempfile.gettempdir(), f"deepfm_funnel_{os.getpid()}")
        os.makedirs(self._staging, exist_ok=True)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._breaker = CircuitBreaker(
            failure_threshold=0.5, window=6, min_calls=3,
            cooldown_secs=max(5.0, 4.0 * self._interval), name="funnel-reload")
        events = scorer.registry.counter(
            "deepfm_reload_events_total", "hot-reload lifecycle events by kind",
            labels=("event",))
        self._c_swaps = events.labels("swap")
        self._c_rollbacks = events.labels("rollback")
        self._c_poll_errors = events.labels("poll_error")
        self._c_polls_skipped = events.labels("poll_skipped")
        self.last_swap_ms: float | None = None
        self.last_stage_ms: float | None = None
        self.last_canary_ms: float | None = None
        self.last_check_unix: float | None = None
        self.last_error: str | None = None

    @property
    def swaps_total(self) -> int:
        return int(self._c_swaps.value)

    @property
    def rollbacks_total(self) -> int:
        return int(self._c_rollbacks.value)

    @property
    def poll_errors_total(self) -> int:
        return int(self._c_poll_errors.value)

    @property
    def polls_skipped_total(self) -> int:
        return int(self._c_polls_skipped.value)

    def _poll_error(self, what: str, e: Exception) -> None:
        self._breaker.record_failure()
        self._c_poll_errors.inc()
        with self._lock:
            self.last_error = f"{what}: {type(e).__name__}: {e}"

    def poll_once(self) -> bool:
        """Check for a newer committed version; stage, canary and swap
        it.  True when a swap happened.  Never raises."""
        with self._lock:
            self.last_check_unix = time.time()
        if not self._breaker.allow():
            self._c_polls_skipped.inc()
            return False
        try:
            manifest = latest_manifest(self._source)
        except Exception as e:
            self._poll_error("poll", e)
            return False
        holder = self._scorer.holder
        if manifest is None or manifest.version <= holder.version:
            self._breaker.record_success()
            return False
        try:
            # the store-facing leg, breaker food; stage_version resolves it again
            fetch_version(self._source, manifest.version, self._staging)
        except Exception as e:
            self._poll_error("stage", e)
            return False
        self._breaker.record_success()
        try:
            slot, staged = self._scorer.stage_version(self._source, manifest.version,
                                                      self._staging)
            t0 = time.perf_counter()
            drained = holder.swap(slot, version=staged.version, manifest=staged,
                                  drain_timeout_secs=DRAIN_TIMEOUT_SECS)
            self._c_swaps.inc()
            with self._lock:
                self.last_swap_ms = round(1e3 * (time.perf_counter() - t0), 3)
                self.last_stage_ms = self._scorer.last_stage_ms
                self.last_canary_ms = self._scorer.last_canary_ms
                self.last_error = None if drained else "drain timeout (swap still applied)"
            obs_flight.record("swap_commit", subsystem="funnel", version=staged.version,
                              drained=bool(drained))
            return True
        except Exception as e:
            self._c_rollbacks.inc()
            with self._lock:
                self.last_error = f"{type(e).__name__}: {e}"
            obs_flight.record("swap_rollback", subsystem="funnel", version=manifest.version,
                              error=f"{type(e).__name__}: {e}")
            return False

    def start(self) -> "FunnelSwapper":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="funnel-swapper")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self._interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def status(self) -> dict:
        mv, iv = self._scorer.versions()
        manifest = self._scorer.holder.manifest
        with self._lock:
            out = {
                "model_version": mv,
                "index_version": iv,
                "reload_source": self._source,
                "reload_interval_secs": self._interval,
                "swaps_total": self.swaps_total,
                "rollbacks_total": self.rollbacks_total,
                "poll_errors_total": self.poll_errors_total,
                "polls_skipped_total": self.polls_skipped_total,
                "breaker": self._breaker.status(),
                "last_swap_ms": self.last_swap_ms,
                "last_stage_ms": self.last_stage_ms,
                "last_canary_ms": self.last_canary_ms,
                "last_check_unix": self.last_check_unix,
                "last_error": self.last_error,
                "live_slot": self._scorer.holder.get(),
                "graphs": self._scorer.graphs.graph_count,
            }
        if manifest is not None:
            out["model_step"] = manifest.step
            out["published_unix"] = manifest.created_unix
            out["weight_staleness_secs"] = round(
                max(0.0, time.time() - manifest.created_unix), 3)
        return out


def handle_recommend(scorer: FunnelScorer, req: dict) -> tuple[int, dict]:
    """``/v1/recommend`` request handling: scores through the engine and
    stamps the atomic (model_version, index_version) pair."""
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


def make_funnel_handler(scorer: FunnelScorer, model_name: str, reload_status=None,
                        readiness=None, tracer: Tracer | None = None):
    """serve/server.py's handler (``/healthz``, ``/readyz``, ``/v1/metrics``
    with the ``funnel`` and ``reload`` sections, ``/metrics`` from the
    scorer's registry, ``/v1/trace/recent``, ``/v1/flight``) with POST
    routed only to ``/v1/recommend``, traced like ``:predict``."""
    from ..serve.server import make_handler, traced_request

    base = make_handler(scorer, model_name, reload_status=reload_status,
                        readiness=readiness, registry=scorer.registry, tracer=tracer)

    class FunnelHandler(base):
        def do_POST(self):  # noqa: N802 (http.server API)
            if self.path != RECOMMEND_PATH:
                self._send(404, {"error": f"unknown path {self.path!r} (funnel "
                                          f"servables serve POST {RECOMMEND_PATH})"})
                return
            with traced_request(self, self.obs_tracer, "recommend"):
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
                 reload_url: str | None = None, reload_interval_secs: float = 2.0,
                 top_k: int = 0, return_n: int = 0, retrieval: str = "",
                 oversample: int = 0, model_parallel: int = 1, data_parallel: int = 1,
                 trace_sample_rate: float = DEFAULT_SAMPLE_RATE,
                 trace_export: str | None = None, device=None,
                 ready: threading.Event | None = None) -> None:
    """Blocking funnel server (``serve/server.py serve_forever`` delegates
    here when the servable has a funnel.json).  ``model_parallel``
    row-shards the index on the serving card; ``data_parallel`` splits
    each bucket into that many row slices.  ``reload_url`` (a
    publish root: a directory or an object-store URL) adopts a version already published there before
    the socket opens, then polls every ``reload_interval_secs``.
    ``ready`` as in ``serve_forever``: set once the socket is bound, with
    ``.port``, ``.server``, ``.scorer`` and ``.swapper``."""
    from ..serve.server import ScoringHTTPServer

    scorer = FunnelScorer(
        os.path.abspath(servable_dir), device=device, top_k=top_k,
        return_n=return_n, retrieval=retrieval, oversample=oversample,
        model_parallel=model_parallel, data_parallel=data_parallel, buckets=buckets,
        max_wait_ms=max_wait_ms, max_queue_rows=max_queue_rows)
    swapper = None
    tracer = Tracer("funnel", sample_rate=trace_sample_rate, export_path=trace_export)
    try:
        if reload_url:
            swapper = FunnelSwapper(scorer, reload_url, interval_secs=reload_interval_secs)
            swapper.poll_once()   # adopt an already-published version pre-socket
            swapper.start()
        reload_status = swapper.status if swapper is not None else None

        def readiness():
            doc = {"ready": True, "engine_compiled": True, "weights_loaded": True,
                   "retrieval_mode": scorer.ctx.retrieval_mode}
            doc["model_version"], doc["index_version"] = scorer.versions()
            if swapper is not None:
                breaker = swapper.status().get("breaker") or {}
                doc["reload_breaker"] = breaker.get("state", "closed")
                doc["ready"] = breaker.get("state") != "open"
            return doc

        handler = make_funnel_handler(scorer, model_name, reload_status=reload_status,
                                      readiness=readiness, tracer=tracer)
        print(f"captured and warmed up the funnel graphs (s): {scorer.compile_secs}",
              file=sys.stderr)
        with ScoringHTTPServer((host, port), handler) as httpd:
            if ready is not None:
                ready.port = httpd.server_address[1]  # type: ignore[attr-defined]
                ready.server = httpd  # type: ignore[attr-defined]
                ready.scorer = scorer  # type: ignore[attr-defined]
                ready.swapper = swapper  # type: ignore[attr-defined]
                ready.set()
            print(f"serving funnel {model_name} on http://{httpd.server_address[0]}:"
                  f"{httpd.server_address[1]}{RECOMMEND_PATH} (index over "
                  f"{scorer.ctx.model_parallel} shard(s), retrieval "
                  f"{scorer.ctx.retrieval_mode}, top_k {scorer.ctx.top_k} -> return_n "
                  f"{scorer.ctx.return_n})", file=sys.stderr)
            httpd.serve_forever()
    finally:
        if swapper is not None:
            swapper.stop()
        scorer.close()
        tracer.close()
