"""Deadline-aware cost-based admission and the priority shed ladder: the
port's copy of ``deepfm_tpu/serve/control/admission.py``, with the pool
router's ``LoadShedGate``.

**Admission** prices each arriving request against its deadline before it
takes queue slots: the remaining time of the dispatch in flight, plus the
drain time of the rows already queued (cost.py), plus the request's own
dispatch.  A request that cannot finish in time is refused at the door
(HTTP 503 with ``Retry-After``) instead of timing out in the queue.

**The shed ladder** handles sustained saturation.  As the EWMA-smoothed
queue utilization climbs, work sheds cheapest first: level 1 shadow
offers, level 2 recommend width (a degrade factor), level 3 plain
predicts.  Each level releases at 85% of its engage threshold, every shed
is counted by priority class and every level change is flight-recorded.

Nothing here fails admitted work: a deadline that passes while a request
is queued is answered 504 at dequeue by the engine (serve/batcher.py).
"""

from __future__ import annotations

import threading
import time

from ...obs import flight as obs_flight
from ...obs.metrics import MetricsRegistry
from .cost import BucketCostModel

# priority classes, cheapest-to-shed first.  The wire surface is the
# X-Priority header (router -> member); anything unrecognized scores as
# a plain predict — an unknown class must degrade LAST, not first.
PRIORITY_SHADOW = "shadow"
PRIORITY_RECOMMEND = "recommend"
PRIORITY_PREDICT = "predict"


class DeadlineRejectedError(RuntimeError):
    """Admission-time rejection: the request cannot finish inside its
    deadline given current queue depth (mapped to HTTP 503 with a
    ``Retry-After`` hint — the client should back off, not resubmit
    immediately into the same queue)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(0.001, float(retry_after_s))


class ShedError(DeadlineRejectedError):
    """Priority-ladder shed at admission (same 503 + Retry-After wire
    shape as a deadline rejection; distinguished for counting)."""


class DeadlineExpiredError(RuntimeError):
    """The deadline passed while the request was QUEUED: answered 504 at
    dequeue, slot backfilled — never dispatched, never scored."""


class AdmissionController:
    """Per-engine admission policy: deadline pricing + the shed ladder.

    One controller fronts one MicroBatcher's queue (per-tenant engines
    on a member share one controller — their dispatches share the same
    executables, so one cost model prices all of them).  All methods are
    thread-safe and O(1); they run on the caller's thread inside the
    engine's admission path."""

    def __init__(
        self,
        cost_model: BucketCostModel,
        *,
        deadline_ms: float = 0.0,
        shed_shadow_util: float = 0.60,
        degrade_util: float = 0.75,
        shed_predict_util: float = 0.90,
        degrade_floor_pct: float = 50.0,
        util_alpha: float = 0.1,
        name: str = "predict",
        registry: MetricsRegistry | None = None,
    ):
        self.cost = cost_model
        self._deadline_s = max(0.0, float(deadline_ms)) / 1e3
        self._thresholds = (
            float(shed_shadow_util), float(degrade_util),
            float(shed_predict_util),
        )
        if not (self._thresholds[0] <= self._thresholds[1]
                <= self._thresholds[2]):
            raise ValueError(
                f"shed ladder thresholds must be ordered cheapest-first, "
                f"got {self._thresholds}"
            )
        self._degrade_floor = float(degrade_floor_pct) / 100.0
        self._alpha = float(util_alpha)
        self._lock = threading.Lock()
        self._util_ewma = 0.0
        self._level = 0
        self.name = name
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        sheds = self.registry.counter(
            "deepfm_slo_sheds_total",
            "admission-time sheds by priority class",
            labels=("engine", "class"))
        # pre-create every class child so the shed breakdown renders
        # zeros (the bench reports the full ladder either way)
        self._c_shed = {
            p: sheds.labels(name, p)
            for p in (PRIORITY_SHADOW, PRIORITY_RECOMMEND, PRIORITY_PREDICT)
        }
        self._c_deadline = self.registry.counter(
            "deepfm_slo_deadline_rejected_total",
            "requests rejected at admission: deadline unmeetable",
            labels=("engine",)).labels(name)

    # -- deadline ----------------------------------------------------------
    @property
    def default_deadline_s(self) -> float:
        """Config default deadline in seconds (0 = none)."""
        return self._deadline_s

    def effective_deadline(self, now: float,
                           deadline_s: float | None) -> float | None:
        """The request's absolute deadline: the explicit one
        (``X-Deadline-Ms``, already made absolute by the handler) or
        now + the config default; None when neither exists."""
        if deadline_s is not None:
            return deadline_s
        if self._deadline_s > 0:
            return now + self._deadline_s
        return None

    # -- the ladder --------------------------------------------------------
    def observe_utilization(self, queued_rows: int,
                            max_queue_rows: int) -> int:
        """Fold one queue-depth sample into the smoothed utilization and
        return the (possibly transitioned) ladder level.  Called on
        every admission; EWMA supplies the "sustained" in "sustained
        saturation", and release thresholds sit at 85% of engage so the
        ladder steps down cleanly instead of chattering."""
        util = queued_rows / max(1, max_queue_rows)
        with self._lock:
            self._util_ewma += self._alpha * (util - self._util_ewma)
            ew, level = self._util_ewma, self._level
            new = level
            # engage upward against the full thresholds...
            while new < 3 and ew > self._thresholds[new]:
                new += 1
            # ...release downward only once under 85% of the band below
            while new > 0 and ew < 0.85 * self._thresholds[new - 1]:
                new -= 1
            if new != level:
                self._level = new
            else:
                return level
        obs_flight.record(
            "shed_level", subsystem="slo", engine=self.name,
            level=new, previous=level, util_ewma=round(ew, 4),
        )
        return new

    def level(self) -> int:
        with self._lock:
            return self._level

    @property
    def degrade_floor(self) -> float:
        """The configured level-2 width multiplier — what
        :meth:`degrade_factor` returns once the ladder engages.  Callers
        that pre-compile a degraded executable (the funnel's narrowed
        oversample) size it off this at boot."""
        return self._degrade_floor

    def degrade_factor(self) -> float:
        """Width multiplier for recommend expand/rank (and the int8
        funnel's retrieval oversample) at the current ladder level: 1.0
        normally, the configured floor at level >= 2 (degraded answers
        beat absent ones)."""
        return self._degrade_floor if self.level() >= 2 else 1.0

    # -- the admission decision --------------------------------------------
    def check(self, *, rows: int, queued_rows: int, max_queue_rows: int,
              deadline_s: float | None, priority: str = PRIORITY_PREDICT,
              now: float | None = None,
              inflight: tuple[int, float] | None = None) -> float | None:
        """Admit or raise.  Returns the request's effective absolute
        deadline (None = none) so the engine can stamp queue items.

        ``inflight`` is the dispatch currently executing, as ``(bucket_
        rows, started_at)`` (absolute ``perf_counter`` seconds), or None
        when the worker is idle: its estimated REMAINING time is priced
        ahead of the queue drain, since every queued row waits behind it.

        Raises :class:`ShedError` when the ladder sheds this priority
        class, :class:`DeadlineRejectedError` when the cost model says
        the deadline is unmeetable at current depth.  Never raises for
        a cold cost model — unknown cost is admissible."""
        now = time.perf_counter() if now is None else now
        level = self.observe_utilization(queued_rows, max_queue_rows)
        if level >= 3 and priority != PRIORITY_SHADOW:
            # level 3 sheds everything arriving; shadow-class work was
            # already gone at level 1 (counted where it sheds)
            self._c_shed[
                priority if priority in self._c_shed else PRIORITY_PREDICT
            ].inc()
            raise ShedError(
                f"engine {self.name!r} saturated (shed level {level}); "
                f"retry later",
                retry_after_s=self._retry_after(queued_rows),
            )
        if level >= 1 and priority == PRIORITY_SHADOW:
            self._c_shed[PRIORITY_SHADOW].inc()
            raise ShedError(
                f"engine {self.name!r} shedding shadow-class work "
                f"(level {level})",
                retry_after_s=self._retry_after(queued_rows),
            )
        deadline = self.effective_deadline(now, deadline_s)
        if deadline is None:
            return None
        drain = self.cost.drain_estimate_s(queued_rows)
        own = self.cost.dispatch_estimate_s(rows)
        if drain is None or own is None:
            return deadline      # cold model: admit
        busy = self._inflight_remaining_s(inflight, now)
        eta = now + busy + drain + own
        if eta > deadline:
            self._c_deadline.inc()
            late_by = eta - deadline
            raise DeadlineRejectedError(
                f"deadline unmeetable: estimated completion in "
                f"{(busy + drain + own) * 1e3:.1f} ms exceeds the "
                f"deadline by {late_by * 1e3:.1f} ms "
                f"({queued_rows} rows queued)",
                retry_after_s=max(late_by, busy + drain),
            )
        return deadline

    def _inflight_remaining_s(self, inflight: tuple[int, float] | None,
                              now: float) -> float:
        if inflight is None:
            return 0.0
        bucket_rows, started_at = inflight
        est = self.cost.dispatch_estimate_s(bucket_rows)
        if est is None:
            return 0.0          # cold for this shape: claim nothing
        return max(0.0, est - (now - started_at))

    def _retry_after(self, queued_rows: int) -> float:
        est = self.cost.drain_estimate_s(queued_rows)
        return est if est else 1.0

    def record_shed(self, priority: str) -> None:
        """Count a shed decided OUTSIDE the admission path (the router's
        shadow gate reports through this)."""
        self._c_shed[
            priority if priority in self._c_shed else PRIORITY_PREDICT
        ].inc()

    def snapshot(self) -> dict:
        with self._lock:
            ew, level = self._util_ewma, self._level
        return {
            "level": level,
            "util_ewma": round(ew, 4),
            "deadline_ms": round(self._deadline_s * 1e3, 3),
            "degrade_factor": (self._degrade_floor if level >= 2 else 1.0),
            "deadline_rejected_total": int(self._c_deadline.value),
            "sheds_total": {
                p: int(c.value) for p, c in self._c_shed.items()
            },
            "cost": self.cost.snapshot(),
        }


class LoadShedGate:
    """Router-side saturation signal for the shadow shed-first hook.

    The router has no queue to watch — its saturation evidence is the
    member responses themselves (503s are the engines' backpressure).
    The gate smooths that into an overload score; while it is high,
    ``allow_shadow()`` answers False and the ShadowScorer sheds offers
    at the source (fleet/shadow.py ``gate=``) — the first rung of the
    ladder, applied before the offer even reaches the bounded queue."""

    def __init__(self, *, threshold: float = 0.3, alpha: float = 0.05):
        self._threshold = float(threshold)
        self._alpha = float(alpha)
        self._lock = threading.Lock()
        self._overload_ewma = 0.0
        self._shedding = False

    def note(self, overloaded: bool) -> None:
        """Fold one routed-request outcome in (True = backpressure)."""
        with self._lock:
            self._overload_ewma += self._alpha * (
                (1.0 if overloaded else 0.0) - self._overload_ewma
            )
            was = self._shedding
            # engage/release hysteresis mirrors the ladder's
            if not was and self._overload_ewma > self._threshold:
                self._shedding = True
            elif was and self._overload_ewma < 0.5 * self._threshold:
                self._shedding = False
            flipped = was != self._shedding
            now_shedding = self._shedding
        if flipped:
            obs_flight.record(
                "shadow_gate", subsystem="slo",
                shedding=now_shedding,
                overload_ewma=round(self._overload_ewma, 4),
            )

    def allow_shadow(self) -> bool:
        with self._lock:
            return not self._shedding

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "shedding": self._shedding,
                "overload_ewma": round(self._overload_ewma, 4),
            }
