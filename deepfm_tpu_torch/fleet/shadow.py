"""Shadow scoring: a challenger scores the live stream, silently (the
port's copy of ``deepfm_tpu/fleet/shadow.py``).

A challenger must never slow or change a single live answer, so:

* the router answers every request from the incumbent as always; after
  the response is formed, a hash-stable sample of requests is **offered**
  to a bounded queue (``put_nowait``: O(1), no lock shared with the
  serving path);
* a full queue **sheds** the offer (counted, never blocks);
* one background worker drains the queue and re-scores each sampled
  request against the challenger tenant (the same pool, the challenger's
  own weight slots), recording ``|p_challenger - p_incumbent|`` into a
  registry histogram.  Only the incumbent's answer was ever returned.

Divergence percentiles (``deepfm_shadow_divergence``) are the promotion
signal: a challenger whose p99 divergence is noise-level is safe to ramp
through the traffic split.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from ..obs.metrics import MetricsRegistry
from .split import sampled


class ShadowScorer:
    """Off-response-path challenger scoring for one (challenger,
    incumbent) pair.  ``bind(forward)`` supplies the scoring callable —
    the router's own tenant-addressed forward,
    ``forward(body) -> (status, doc)`` — after construction, because the
    router and its shadow reference each other."""

    def __init__(
        self,
        challenger: str,
        incumbent: str,
        *,
        sample_percent: float = 100.0,
        queue_depth: int = 128,
        registry: MetricsRegistry | None = None,
    ):
        if challenger == incumbent:
            raise ValueError(
                f"a tenant cannot shadow itself ({challenger!r})"
            )
        self.challenger = challenger
        self.incumbent = incumbent
        self._sample_percent = float(sample_percent)
        self._q: queue.Queue = queue.Queue(maxsize=int(queue_depth))
        self._forward = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        events = self.registry.counter(
            "deepfm_shadow_events_total",
            "shadow-scoring lifecycle events by kind",
            labels=("tenant", "event"))
        self._c_offered = events.labels(challenger, "offered")
        self._c_scored = events.labels(challenger, "scored")
        self._c_shed = events.labels(challenger, "shed")
        self._c_errors = events.labels(challenger, "error")
        # offers dropped by the router's load-shed gate BEFORE sampling —
        # the first rung of the SLO shed ladder (serve/control/admission
        # LoadShedGate): under sustained member backpressure the
        # challenger loses samples at the source, the incumbent loses
        # nothing
        self._c_gated = events.labels(challenger, "gated")
        self._gate = None
        # raw |challenger - incumbent| probability gap per request (mean
        # over the request's rows) — NOT a latency; snapshot scale=1
        self._divergence = self.registry.histogram(
            "deepfm_shadow_divergence",
            "per-request mean |challenger - incumbent| score gap",
            labels=("tenant",),
        ).labels(challenger)

    def bind(self, forward) -> "ShadowScorer":
        self._forward = forward
        return self

    def set_gate(self, gate) -> "ShadowScorer":
        """Attach a zero-arg shed gate (``gate() -> bool``, True =
        offers allowed); a False answer sheds the offer before sampling
        and counts it as ``gated``."""
        self._gate = gate
        return self

    def set_sample_percent(self, percent: float) -> None:
        """Retune the hash-stable sampling gate live (the bench's paired
        toggled-window design flips it per window; operators ramp it)."""
        self._sample_percent = float(percent)

    # -- serving-path side (must stay O(1) and non-blocking) ----------------
    def offer(self, key: str, body: dict, incumbent_preds) -> bool:
        """Offer one live (request, incumbent answer) pair.  Hash-stable
        sampling per key; a full queue sheds.  Returns True when
        enqueued."""
        if self._gate is not None and not self._gate():
            self._c_gated.inc()
            return False
        if not sampled(key, self._sample_percent):
            return False
        self._c_offered.inc()
        try:
            self._q.put_nowait((body, list(incumbent_preds)))
            return True
        except queue.Full:
            self._c_shed.inc()
            return False

    # -- worker side --------------------------------------------------------
    def _score_one(self, body: dict, incumbent_preds: list) -> None:
        code, doc = self._forward(body)
        preds = doc.get("predictions") if code == 200 else None
        if preds is None or len(preds) != len(incumbent_preds):
            self._c_errors.inc()
            return
        gap = float(np.mean(np.abs(
            np.asarray(preds, np.float64)
            - np.asarray(incumbent_preds, np.float64)
        )))
        self._divergence.observe(gap)
        self._c_scored.inc()

    def _run(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:
                # wake sentinel from stop(); a stale one left over from a
                # prior stop/start cycle must not kill the new worker
                if self._stop.is_set():
                    return
                continue
            try:
                self._score_one(*item)
            # da:allow[swallowed-exception] advisory by contract: a challenger outage (or a router mid-shutdown) costs samples — counted in errors_total — never a crash loop in the serving process
            except Exception:
                self._c_errors.inc()

    def start(self) -> "ShadowScorer":
        if self._forward is None:
            raise ValueError("bind(forward) before start()")
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"shadow-{self.challenger}",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(None)  # wake the worker past its timeout
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # re-armable: offers keep landing (bounded, shedding) while the
        # worker is down, and a later start() resumes draining — the
        # bench pauses the worker to isolate the response-path cost
        self._stop = threading.Event()

    def drain(self, timeout_secs: float = 10.0) -> None:
        """Block until the queue is empty (bench/test synchronization)."""
        import time

        deadline = time.monotonic() + timeout_secs
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        offered = int(self._c_offered.value)
        shed = int(self._c_shed.value)
        return {
            "challenger": self.challenger,
            "incumbent": self.incumbent,
            "sample_percent": self._sample_percent,
            "offered_total": offered,
            "scored_total": int(self._c_scored.value),
            "shed_total": shed,
            "gated_total": int(self._c_gated.value),
            "errors_total": int(self._c_errors.value),
            "shed_rate": round(shed / offered, 4) if offered else 0.0,
            "divergence": self._divergence.snapshot(scale=1.0, digits=6),
        }
