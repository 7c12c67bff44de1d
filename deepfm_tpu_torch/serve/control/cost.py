"""Per-bucket online dispatch cost model: the port's copy of
``deepfm_tpu/serve/control/cost.py``.

Admission (admission.py) asks "if this request is admitted now, when does
it finish?": the queue's drain time plus the request's own dispatch, each
priced per bucket shape.  The model is an EWMA over the micro-batcher's
host-side dispatch timings (the same boundary as the ``dispatch`` trace
span), one cell per bucket.  A bucket that never dispatched has no
estimate (``None``), and admission treats unknown cost as admissible; once
any bucket has run, its per-row rate stands in for the rest.
"""

from __future__ import annotations

import threading
from typing import Sequence


class BucketCostModel:
    """EWMA dispatch-seconds per bucket shape; thread-safe.

    ``alpha`` is the EWMA weight of the newest observation — high enough
    to track a paging stall within a few dispatches, low enough that one
    outlier dispatch does not flip admission."""

    def __init__(self, buckets: Sequence[int], *, alpha: float = 0.2):
        if not buckets:
            raise ValueError("cost model needs at least one bucket size")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self._buckets = tuple(sorted(int(b) for b in buckets))
        self._alpha = float(alpha)
        self._lock = threading.Lock()
        self._ewma_s: dict[int, float] = {}
        self.observations_total = 0

    @property
    def buckets(self) -> tuple[int, ...]:
        return self._buckets

    def _fit(self, rows: int) -> int:
        for b in self._buckets:
            if rows <= b:
                return b
        return self._buckets[-1]

    def observe(self, bucket: int, seconds: float) -> None:
        """Feed one dispatch timing (the host-side t1-t0 around the
        engine's ``fn`` call — the same boundary the trace span uses)."""
        bucket = int(bucket)
        if seconds < 0:
            return
        with self._lock:
            prev = self._ewma_s.get(bucket)
            self._ewma_s[bucket] = (
                seconds if prev is None
                else prev + self._alpha * (seconds - prev)
            )
            self.observations_total += 1

    def dispatch_estimate_s(self, rows: int) -> float | None:
        """Estimated seconds for one dispatch of ``rows`` rows (through
        the smallest bucket that fits).  None while that cost is still
        unobserved and no other bucket can stand in."""
        bucket = self._fit(rows)
        with self._lock:
            est = self._ewma_s.get(bucket)
            if est is not None:
                return est
            # backstop: scale the nearest observed bucket's per-row rate
            if self._ewma_s:
                near = min(self._ewma_s, key=lambda b: abs(b - bucket))
                return self._ewma_s[near] * (bucket / near)
        return None

    def drain_estimate_s(self, queued_rows: int) -> float | None:
        """Estimated seconds to drain ``queued_rows`` already-queued rows
        ahead of a new arrival.  The engine drains through the LARGEST
        bucket under load (full coalescing), so the queue is priced as
        ``ceil(queued/largest)`` big dispatches plus one remainder-sized
        one.  None while the model is cold."""
        if queued_rows <= 0:
            return 0.0
        big = self._buckets[-1]
        full, rem = divmod(int(queued_rows), big)
        total = 0.0
        if full:
            per = self.dispatch_estimate_s(big)
            if per is None:
                return None
            total += full * per
        if rem:
            per = self.dispatch_estimate_s(rem)
            if per is None:
                return None
            total += per
        return total

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "observations_total": self.observations_total,
                "dispatch_ewma_ms": {
                    str(b): round(s * 1e3, 3)
                    for b, s in sorted(self._ewma_s.items())
                },
            }
