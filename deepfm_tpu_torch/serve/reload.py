"""Zero-downtime hot weight reload under the micro-batching engine: the
port's counterpart of ``deepfm_tpu/serve/reload.py``.

The JAX server passes the parameter payload to its per-bucket executables
as an argument, so a new version with the same shapes is a jit cache hit.
Here the payload is a weight slot of :class:`~.graphs.GraphedPredictor`:
the bucket graphs of both slots are captured once, and a new version is
copied into the slot that serves no traffic.  The swap protocol
(:meth:`HotSwapper.poll_once`):

1. **poll** the publish root (online/publisher.py) for a manifest newer
   than the live version, behind a circuit breaker;
2. **stage**: read the version's servable on the host, check the
   manifest's ``param_hash`` against the staged weights (a mismatch is
   refused and the staged copy purged), the field size and every
   tensor's shape and dtype against the live slot's (another shape would
   need new graphs: refused, not re-captured);
3. **upload** the weights into the idle slot and wait for the copy;
4. **canary**: score a probe batch through the idle slot's graphs and
   require finite probabilities in [0, 1]; a NaN model is rolled back
   before any request sees it;
5. **swap**: point traffic at the idle slot (:meth:`SwappableParams.swap`)
   and drain: wait until every dispatch that took the old slot has
   finished, so when the swap returns all traffic is on the new weights.

Steps 3 and 4 run through ``run`` (the batcher's ``run_on_worker``), so
the upload and the canary's replays happen on the worker thread between
dispatches: no replay ever overlaps another or an upload.  ``status()``
feeds ``/v1/metrics``'s ``reload`` section (the JAX keys, plus the last
stage and canary times, the live slot and the graph count).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Sequence

import numpy as np

from ..convert import params_to_jax
from ..core.config import ModelConfig, load_config
from ..obs import flight as obs_flight
from ..obs.metrics import MetricsRegistry
from ..online.publisher import (fetch_version, latest_manifest,
                                param_tree_hash)
from ..utils.retry import CircuitBreaker
from .batcher import DEFAULT_BUCKETS
from .export import read_params
from .graphs import GraphedPredictor

# rows of the canary's probe batch (a zero row plus spread in-vocabulary ids)
CANARY_ROWS = 8
# how long a swap waits for the dispatches on the old slot; every dispatch
# runs on the batcher's one worker thread, so the drain is one dispatch long
DRAIN_TIMEOUT_SECS = 30.0


class SwappableParams:
    """The live payload (here: the live slot) behind an atomic, drain-aware
    swap.  Dispatches ``acquire()`` it, tagged with the current generation,
    and ``release()`` when they finish; ``swap()`` installs a new payload
    and blocks until every holder of an older generation has released."""

    def __init__(self, payload, *, version: int = 0, manifest=None):
        self._cond = threading.Condition()
        self._payload = payload
        self._gen = 0
        self._inflight: dict[int, int] = {}
        self.version = int(version)
        self.manifest = manifest

    def acquire(self):
        with self._cond:
            self._inflight[self._gen] = self._inflight.get(self._gen, 0) + 1
            return self._payload, self._gen

    def release(self, gen: int) -> None:
        with self._cond:
            left = self._inflight.get(gen, 0) - 1
            if left <= 0:
                self._inflight.pop(gen, None)
            else:
                self._inflight[gen] = left
            self._cond.notify_all()

    def get(self):
        with self._cond:
            return self._payload

    def swap(self, payload, *, version: int, manifest=None,
             drain_timeout_secs: float = 30.0) -> bool:
        """Install ``payload`` and drain old-generation dispatches.  True
        when the drain completed; False on timeout (the swap still
        happened: new dispatches already take the new payload)."""
        with self._cond:
            old_gen = self._gen
            self._payload = payload
            self._gen += 1
            self.version = int(version)
            self.manifest = manifest
            deadline = time.monotonic() + drain_timeout_secs
            while any(g <= old_gen for g in self._inflight):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True


def build_predict_with(predictor: GraphedPredictor,
                       run: Callable | None = None) -> Callable:
    """``predict_with(slot, feat_ids, feat_vals) -> probs``: the weight
    slot as an argument, run through ``run`` (the batcher's
    ``run_on_worker``; None calls it on this thread)."""
    def predict_with(slot: int, feat_ids, feat_vals) -> np.ndarray:
        if run is None:
            return predictor.predict_with(slot, feat_ids, feat_vals)
        return run(lambda: predictor.predict_with(slot, feat_ids, feat_vals))

    return predict_with


def load_swappable_servable(directory: str | os.PathLike, *, device=None,
                            buckets: Sequence[int] = DEFAULT_BUCKETS):
    """A CTR servable for hot reload: ``(predict, predictor, holder, cfg)``.

    * ``predict(ids, vals)``: what the micro-batcher calls, on its worker
      thread: the live slot from ``holder``, scored through its graphs;
    * ``predictor``: the :class:`~.graphs.GraphedPredictor` (its
      ``precompile`` captures the graphs, ``load_slot`` uploads weights);
    * ``holder``: the :class:`SwappableParams` whose payload is the live
      slot, which :class:`HotSwapper` swaps;
    * ``cfg``: the servable's ``ModelConfig``."""
    directory = os.path.abspath(directory)
    cfg = load_config(directory)
    if cfg.model_name == "two_tower":
        raise ValueError("hot reload supports CTR servables; two-tower retrieval "
                         "serving does not take --reload-url")
    predictor = GraphedPredictor(cfg, read_params(directory), device=device,
                                 buckets=buckets)
    holder = SwappableParams(0, version=0)

    def predict(feat_ids, feat_vals) -> np.ndarray:
        slot, gen = holder.acquire()
        try:
            # returns after the device-to-host copy: the dispatch is done
            # on the device when the generation is released
            return predictor.predict_with(slot, feat_ids, feat_vals)
        finally:
            holder.release(gen)

    return predict, predictor, holder, cfg


class HotSwapper:
    """Poll a publish root (a directory or an object-store URL) and swap
    new versions into the idle weight slot.  ``run`` runs device work on the batcher's worker thread
    (``MicroBatcher.run_on_worker``; None runs it on the polling thread,
    for a predictor nothing else replays).  The poll runs behind a
    circuit breaker: while the store fails, polls are skipped (one probe a
    cooldown) and the old weights keep serving; ``/readyz`` reads the
    breaker."""

    def __init__(self, holder: SwappableParams, predictor: GraphedPredictor,
                 reload_source: str, cfg: ModelConfig, *, run: Callable | None = None,
                 interval_secs: float = 2.0, staging_dir: str | None = None,
                 breaker: CircuitBreaker | None = None,
                 registry: MetricsRegistry | None = None):
        self._holder = holder
        self._predictor = predictor
        self._run = run if run is not None else (lambda job: job())
        self._predict_with = build_predict_with(predictor, run)
        self._source = str(reload_source)
        self._cfg = cfg
        self._interval = float(interval_secs)
        self._staging = staging_dir or os.path.join(
            tempfile.gettempdir(), f"deepfm_reload_{os.getpid()}")
        os.makedirs(self._staging, exist_ok=True)
        n, f = CANARY_ROWS, cfg.field_size
        ids = np.zeros((n, f), np.int64)
        ids[1:] = np.linspace(0, max(0, cfg.feature_size - 1), (n - 1) * f,
                              dtype=np.int64).reshape(n - 1, f)
        self._canary = (ids, np.ones((n, f), np.float32))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=0.5, window=6, min_calls=3,
            cooldown_secs=max(5.0, 4.0 * self._interval), name="reload")
        self.registry = registry if registry is not None else MetricsRegistry()
        events = self.registry.counter(
            "deepfm_reload_events_total", "hot-reload lifecycle events by kind",
            labels=("event",))
        self._c_swaps = events.labels("swap")
        self._c_rollbacks = events.labels("rollback")
        self._c_poll_errors = events.labels("poll_error")
        self._c_polls_skipped = events.labels("poll_skipped")
        self._g_version = self.registry.gauge(
            "deepfm_reload_model_version", "live served model version")
        self._g_staleness = self.registry.gauge(
            "deepfm_reload_weight_staleness_seconds",
            "now minus the live manifest's publish time")
        self.registry.on_collect(self._refresh_gauges)
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

    def _refresh_gauges(self) -> None:
        self._g_version.set(self._holder.version)
        manifest = self._holder.manifest
        if manifest is not None:
            self._g_staleness.set(max(0.0, time.time() - manifest.created_unix))

    # -- one poll/swap cycle ------------------------------------------------
    def poll_once(self) -> bool:
        """Check for a newer committed version; stage, upload, canary and
        swap it.  True when a swap happened.  Never raises: a bad version
        is rolled back (``rollbacks_total``); a failure to list or read the
        root is a poll error (``poll_errors_total``, fed to the breaker);
        while the breaker is open the poll is skipped."""
        with self._lock:
            self.last_check_unix = time.time()
        if not self._breaker.allow():
            self._c_polls_skipped.inc()
            return False
        try:
            manifest = latest_manifest(self._source)
        except Exception as e:
            self._breaker.record_failure()
            self._c_poll_errors.inc()
            with self._lock:
                self.last_error = f"poll: {type(e).__name__}: {e}"
            return False
        if manifest is None or manifest.version <= self._holder.version:
            self._breaker.record_success()
            return False
        try:
            local = fetch_version(self._source, manifest.version, self._staging)
        except Exception as e:
            self._breaker.record_failure()
            self._c_poll_errors.inc()
            with self._lock:
                self.last_error = f"stage: {type(e).__name__}: {e}"
            return False
        self._breaker.record_success()
        try:
            t0 = time.perf_counter()
            state = self._stage(manifest, local)
            idle = 1 - self._holder.get()
            self._run(lambda: self._predictor.load_slot(idle, state))
            t1 = time.perf_counter()
            self._canary_check(idle)
            t2 = time.perf_counter()
            drained = self._holder.swap(idle, version=manifest.version, manifest=manifest,
                                        drain_timeout_secs=DRAIN_TIMEOUT_SECS)
            t3 = time.perf_counter()
            self._c_swaps.inc()
            with self._lock:
                self.last_stage_ms = round(1e3 * (t1 - t0), 3)
                self.last_canary_ms = round(1e3 * (t2 - t1), 3)
                self.last_swap_ms = round(1e3 * (t3 - t2), 3)
                self.last_error = None if drained else "drain timeout (swap still applied)"
            obs_flight.record("swap_commit", subsystem="reload",
                              version=manifest.version, drained=bool(drained))
            return True
        except Exception as e:
            self._c_rollbacks.inc()
            with self._lock:
                self.last_error = f"{type(e).__name__}: {e}"
            obs_flight.record("swap_rollback", subsystem="reload",
                              version=manifest.version, error=f"{type(e).__name__}: {e}")
            return False

    def _purge_staged(self, local: str) -> None:
        """Drop a corruption-shaped artifact from the staging directory, so
        the next poll fetches it again instead of failing on it forever.
        Only what lies under the staging directory is ever deleted (a
        local root's version is read in place and stays)."""
        if os.path.abspath(local).startswith(os.path.abspath(self._staging) + os.sep):
            shutil.rmtree(local, ignore_errors=True)

    def _stage(self, manifest, local: str) -> dict:
        """The version's weights on the host, checked: its hash against the
        manifest's, its field size and its tensors' shapes and dtypes
        against the live slot's."""
        try:
            # corruption-shaped failures: purge the staged copy
            served_cfg = load_config(local)
            state = read_params(local)
            got = param_tree_hash(*params_to_jax(state, served_cfg))
            if manifest.param_hash and got != manifest.param_hash:
                raise ValueError(
                    f"version {manifest.version} param hash mismatch (manifest "
                    f"{manifest.param_hash[:12]}…, staged {got[:12]}…) — torn or "
                    f"corrupted artifact")
        except Exception:
            self._purge_staged(local)
            raise
        if served_cfg.field_size != self._cfg.field_size:
            raise ValueError(
                f"version {manifest.version} has field_size {served_cfg.field_size}, "
                f"engine serves {self._cfg.field_size} — not hot-swappable")
        live = self._predictor.slot_specs()
        new = {k: (tuple(v.shape), str(v.dtype)) for k, v in state.items()}
        if live != new:
            diff = sorted(set(live.items()) ^ set(new.items()))[:4]
            raise ValueError(
                f"version {manifest.version} parameter tree differs from the live "
                f"graphs' (first diffs: {diff}) — swapping would need a re-capture "
                f"(the JAX server's recompile); redeploy instead")
        return state

    def _canary_check(self, slot: int) -> None:
        probs = np.asarray(self._predict_with(slot, *self._canary))
        if not np.isfinite(probs).all():
            raise ValueError(
                f"canary probe produced non-finite scores "
                f"({int((~np.isfinite(probs)).sum())}/{probs.size} bad)")
        if ((probs < 0.0) | (probs > 1.0)).any():
            raise ValueError("canary probe produced out-of-range scores")

    # -- background polling -------------------------------------------------
    def start(self) -> "HotSwapper":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run_loop, daemon=True,
                                            name="hot-swapper")
            self._thread.start()
        return self

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self._interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # -- observability ------------------------------------------------------
    def status(self) -> dict:
        manifest = self._holder.manifest
        with self._lock:
            out = {
                "model_version": self._holder.version,
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
                "live_slot": self._holder.get(),
                "graphs": self._predictor.graph_count,
            }
        if manifest is not None:
            out["model_step"] = manifest.step
            out["published_unix"] = manifest.created_unix
            out["weight_staleness_secs"] = round(
                max(0.0, time.time() - manifest.created_unix), 3)
        return out
