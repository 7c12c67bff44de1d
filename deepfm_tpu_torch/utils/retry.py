"""Bounded retry, crash-loop restarts and circuit breaking: the port's
copy of ``RetryPolicy``, ``run_with_restarts`` and ``CircuitBreaker`` from
``deepfm_tpu/utils/retry.py``.

* :class:`RetryPolicy`: bounded attempts, exponential backoff with full
  jitter (``uniform(0, cap)``) or equal jitter (``uniform(cap/2, cap)``),
  an optional overall deadline and a classifier; clock, sleep and RNG are
  injectable so tests run on a fake clock.
* :func:`run_with_restarts`: the crash-loop supervisor over a policy with
  equal jitter.  The serving pool's supervisor restarts member processes
  with it (serve/pool/__main__.py), and the train task's restart loop
  (launch/preemption.py) is a call of it: one backoff schedule.
* :class:`CircuitBreaker`: closed -> open -> half-open.  A failure rate
  over a sliding window of recorded outcomes opens the circuit; after
  ``cooldown_secs`` one probe is admitted; its success closes the
  circuit, its failure re-opens it.  A store outage then costs one probe a
  cooldown instead of a failed poll a tick, and the old weights keep
  serving.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, TypeVar

T = TypeVar("T")


def _default_classify(exc: BaseException) -> bool:
    """Retryable unless the exception says otherwise: an error with a
    ``retryable`` attribute is believed; any other defaults to retryable."""
    return bool(getattr(exc, "retryable", True))


@dataclass(frozen=True)
class RetryPolicy:
    """Immutable retry schedule: ``call(fn)`` runs ``fn`` up to
    ``max_attempts`` times, sleeping a jittered exponential backoff between
    attempts, never past ``deadline_secs`` of projected total time (None:
    no deadline).  The last error propagates; an error ``classify`` calls
    not retryable propagates at once."""

    max_attempts: int = 4
    base_delay_secs: float = 0.1
    max_delay_secs: float = 5.0
    deadline_secs: float | None = None
    # "full" = uniform(0, cap): decorrelates hot-path retries; "equal" =
    # uniform(cap/2, cap): keeps a floor, for crash-loop supervisors whose
    # resource under pressure needs an actual rest
    jitter: str = "full"
    clock: Callable[[], float] = time.monotonic
    sleep: Callable[[float], None] = time.sleep
    rng: random.Random = field(default_factory=random.Random)

    def backoff_cap(self, attempt: int) -> float:
        """Upper bound of the jittered delay after failed attempt N (1-based)."""
        return min(self.max_delay_secs, self.base_delay_secs * (2.0 ** (attempt - 1)))

    def _draw_delay(self, attempt: int) -> float:
        cap = self.backoff_cap(attempt)
        lo = cap / 2.0 if self.jitter == "equal" else 0.0
        return self.rng.uniform(lo, cap)

    def call(self, fn: Callable[[], T], *,
             classify: Callable[[BaseException], bool] = _default_classify,
             on_retry: Callable[[int, BaseException, float], None] | None = None) -> T:
        start = self.clock()
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:
                attempt += 1
                if not classify(e) or attempt >= self.max_attempts:
                    raise
                delay = self._draw_delay(attempt)
                if (self.deadline_secs is not None
                        and (self.clock() - start) + delay > self.deadline_secs):
                    raise
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                if delay > 0:
                    self.sleep(delay)


def run_with_restarts(
    fn: Callable[[], T],
    *,
    max_restarts: int = 5,
    policy: RetryPolicy | None = None,
    should_restart: Callable[[BaseException], bool] | None = None,
    on_restart: Callable[[int, BaseException, float], None] | None = None,
) -> T:
    """Crash-loop supervisor: run ``fn`` to completion, restarting it after
    each failure (at most ``max_restarts`` times) with the ``policy``'s
    backoff, equal jitter by default.  The last error propagates;
    ``should_restart`` returning False propagates it at once;
    ``on_restart(attempt, error, delay_secs)`` observes each restart.  A
    ``BaseException`` that is not an ``Exception`` (KeyboardInterrupt,
    SystemExit) always propagates."""
    policy = policy or RetryPolicy(max_attempts=max_restarts + 1, base_delay_secs=0.5,
                                   max_delay_secs=30.0, jitter="equal")
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            attempt += 1
            if should_restart is not None and not should_restart(e):
                raise
            if attempt > max_restarts:
                raise
            delay = policy._draw_delay(attempt)
            if on_restart is not None:
                on_restart(attempt, e, delay)
            if delay > 0:
                policy.sleep(delay)


class CircuitOpenError(RuntimeError):
    """Raised by :meth:`CircuitBreaker.call` when the circuit is open."""


class CircuitBreaker:
    """closed → open → half-open breaker over a sliding outcome window.

    Callers either use the explicit protocol (``allow()`` before the guarded
    operation, then ``record_success()``/``record_failure()``) or the
    ``call(fn)`` convenience.  The window holds the last ``window`` recorded
    outcomes; once at least ``min_calls`` are recorded and the failure rate
    reaches ``failure_threshold``, the circuit opens.  ``allow()`` rejects
    while open; after ``cooldown_secs`` it admits one probe (half-open) —
    probe success closes and clears the window, probe failure re-opens and
    restarts the cooldown."""

    def __init__(
        self,
        *,
        failure_threshold: float = 0.5,
        window: int = 8,
        min_calls: int = 3,
        cooldown_secs: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        name: str = "",
    ):
        if not 0.0 < failure_threshold <= 1.0:
            raise ValueError(
                f"failure_threshold must be in (0, 1], got {failure_threshold}"
            )
        self.name = name
        self._threshold = float(failure_threshold)
        self._min_calls = max(1, int(min_calls))
        self._cooldown = float(cooldown_secs)
        self._clock = clock
        self._lock = threading.Lock()
        self._window: deque[bool] = deque(maxlen=max(1, int(window)))
        self._state = "closed"
        self._opened_at: float | None = None
        self._probe_inflight = False
        self._probe_started: float | None = None
        self.open_total = 0

    # -- state machine (all under _lock) ------------------------------------
    def _resolve(self) -> str:
        """open → half_open once the cooldown elapsed (lazy transition)."""
        if (self._state == "open" and self._opened_at is not None
                and self._clock() - self._opened_at >= self._cooldown):
            self._state = "half_open"
            self._probe_inflight = False
            self._probe_started = None
        return self._state

    def _trip(self) -> None:
        self._state = "open"
        self._opened_at = self._clock()
        self._probe_inflight = False
        self._probe_started = None
        self._window.clear()
        self.open_total += 1
        # breaker transitions are incident landmarks: one line in the
        # flight-recorder timeline (obs/flight.py) per open/close
        from ..obs import flight as _flight

        _flight.record("breaker_open", breaker=self.name or "breaker",
                       open_total=self.open_total)

    # -- caller protocol -----------------------------------------------------
    def allow(self) -> bool:
        with self._lock:
            state = self._resolve()
            if state == "closed":
                return True
            if state == "half_open":
                # a probe that never recorded an outcome (caller died
                # between allow() and record_*) must not wedge the breaker
                # shut forever: after a further cooldown, admit a new probe
                stale = (self._probe_inflight
                         and self._probe_started is not None
                         and self._clock() - self._probe_started
                         >= self._cooldown)
                if not self._probe_inflight or stale:
                    self._probe_inflight = True
                    self._probe_started = self._clock()
                    return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._resolve() == "half_open":
                self._state = "closed"
                self._opened_at = None
                self._probe_inflight = False
                self._probe_started = None
                self._window.clear()
                from ..obs import flight as _flight

                _flight.record("breaker_close",
                               breaker=self.name or "breaker")
            else:
                self._window.append(True)

    def record_failure(self) -> None:
        with self._lock:
            if self._resolve() == "half_open":
                self._trip()
                return
            if self._state == "open":
                return  # cooldown already running; nothing to learn
            self._window.append(False)
            n = len(self._window)
            failures = sum(1 for ok in self._window if not ok)
            if n >= self._min_calls and failures / n >= self._threshold:
                self._trip()

    def call(self, fn: Callable[[], T]) -> T:
        if not self.allow():
            raise CircuitOpenError(
                f"circuit {self.name or 'breaker'} is open"
                + (f" ({self.cooldown_remaining():.1f}s cooldown left)"
                   if self.cooldown_remaining() else "")
            )
        try:
            out = fn()
        except BaseException:
            # BaseException included (KeyboardInterrupt, SystemExit): an
            # unrecorded outcome would leave a half-open probe inflight
            self.record_failure()
            raise
        self.record_success()
        return out

    # -- observability -------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._resolve()

    def cooldown_remaining(self) -> float:
        with self._lock:
            if self._state != "open" or self._opened_at is None:
                return 0.0
            return max(0.0,
                       self._cooldown - (self._clock() - self._opened_at))

    def status(self) -> dict:
        with self._lock:
            state = self._resolve()
            n = len(self._window)
            failures = sum(1 for ok in self._window if not ok)
            return {
                "state": state,
                "open_total": self.open_total,
                "window_calls": n,
                "window_failures": failures,
                "cooldown_remaining_secs": round(
                    max(0.0, self._cooldown
                        - (self._clock() - self._opened_at))
                    if state == "open" and self._opened_at is not None
                    else 0.0, 3),
            }
