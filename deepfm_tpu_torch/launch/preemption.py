"""Preemption tolerance: a copy of ``deepfm_tpu/launch/preemption.py``.

The reference left fault handling to the platform: SageMaker spot training
restarts an interrupted job, and the job resumes from the latest
checkpoint in its ``model_dir``.  Here:

- :class:`PreemptionGuard` turns SIGTERM/SIGINT (what cluster managers and
  spot reclaims send) into a ``should_stop`` flag the train loop reads once
  a step.  The loop then saves a checkpoint and raises
  :class:`PreemptedError`, which the CLI turns into exit 0; the next run of
  the same command resumes from that checkpoint (train/loop.py).
- :func:`install_early_handler` covers the window before a guard exists
  (imports, config, setup): a signal there is recorded and honoured by the
  next guard.  A second signal, in either, kills the process at once.
- :func:`run_with_restarts` reruns a task after a crash up to
  ``max_restarts`` times, waiting a capped, jittered, doubling backoff in
  between.  A signalled stop is not retried: the sender owns the
  reschedule.
"""

from __future__ import annotations

import itertools
import signal
import threading
import time
from typing import Callable, TypeVar

T = TypeVar("T")

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)

# Signals delivered BEFORE a PreemptionGuard exists (during the CLI's heavy
# imports and config resolution — seconds of exposure on a loaded host) land
# here; the guard folds the flag into should_stop on __enter__.  The only
# uncovered window left is interpreter/package import itself, where no state
# exists to lose and default die-and-reschedule semantics are correct.
_EARLY_SIGNAL = threading.Event()

# which signals currently point at the record-only early handler, so a
# guard's __exit__ can recognize it (see PreemptionGuard.__exit__)
_EARLY_HANDLERS: dict[int, object] = {}

# Observers of the FIRST stop request (signal or cooperative).  Invoked
# from the signal handler path, so every callback must be
# async-signal-tolerant (no locks shared with the interrupted code) and is
# exception-isolated: a broken observer must never eat the stop itself.
_STOP_CALLBACKS: list = []


def register_stop_callback(fn) -> None:
    """``fn(signum_or_None)`` runs once per stop request (SIGTERM/SIGINT
    or ``request_stop``), before escalation logic."""
    _STOP_CALLBACKS.append(fn)


def _notify_stop(signum=None) -> None:
    import sys

    for fn in list(_STOP_CALLBACKS):
        try:
            fn(signum)
        except Exception as e:
            # observers must never break the stop path; best-effort note
            print(f"stop callback failed: {type(e).__name__}: {e}",
                  file=sys.stderr)


def install_early_handler(signals=_DEFAULT_SIGNALS) -> bool:
    """Install a minimal record-only handler for the pre-guard window.

    Called by the launcher at task entry (train tasks only — serve/eval/
    infer keep default signal semantics so SIGTERM still stops them).
    A REPEATED signal escalates to default handling (immediate termination)
    so a wedged setup can still be killed with a second Ctrl-C.
    No-op off the main thread.  Returns True when installed.

    Re-entrancy: the arrival counter (see PreemptionGuard._handle) makes
    a second signal landing INSIDE the first invocation escalate
    deterministically — a check-then-set flag would let both invocations
    read "first" and swallow the escalation."""
    if threading.current_thread() is not threading.main_thread():
        return False

    arrivals = itertools.count()

    def _record(signum, frame) -> None:
        n = next(arrivals)  # atomic under the GIL (one bytecode)
        _EARLY_SIGNAL.set()
        if n == 0:
            _notify_stop(signum)
        if n > 0:
            _escalate(signum)

    for sig in signals:
        signal.signal(sig, _record)
        _EARLY_HANDLERS[sig] = _record
    return True


def _escalate(signum) -> None:
    """Second termination signal: stop being graceful — restore the default
    handler and re-deliver, terminating immediately."""
    import os

    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


class PreemptionGuard:
    """Cooperative stop flag set by termination signals.

    Only the main thread may install signal handlers, so constructing this
    off-thread degrades to a manually-settable flag (``request_stop``),
    which is also what unit tests use.
    """

    def __init__(self, signals=_DEFAULT_SIGNALS):
        self._signals = tuple(signals)
        self._stop = threading.Event()
        # stop-request arrival counter: next() is ONE bytecode, so it is
        # atomic w.r.t. signal-handler re-entrancy (handlers run between
        # bytecodes on the main thread and can interrupt each other)
        self._arrivals = itertools.count()
        self._prev: dict[int, object] = {}
        self._installed = False
        self.signaled_at: float | None = None

    # -- context manager ---------------------------------------------------

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                self._prev[sig] = signal.signal(sig, self._handle)
            self._installed = True
        if _EARLY_SIGNAL.is_set():
            # a termination signal landed in the pre-guard window
            # (install_early_handler): honor it as an immediate stop request.
            # Consume the flag — THIS guard acts on it; a fresh guard in the
            # same process (retry harness, notebook re-run) starts clean
            _EARLY_SIGNAL.clear()
            self.request_stop()
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            for sig, prev in self._prev.items():
                if prev is not None and prev is _EARLY_HANDLERS.get(sig):
                    # the pre-guard record-only handler: with no guard left
                    # to consume the flag, it would swallow the FIRST
                    # SIGTERM/SIGINT for the rest of the process (teardown,
                    # retry backoff).  Training is over — restore default
                    # die-and-reschedule semantics instead.
                    signal.signal(sig, signal.SIG_DFL)
                    _EARLY_HANDLERS.pop(sig, None)
                else:
                    signal.signal(sig, prev)
            self._prev.clear()
            self._installed = False

    # -- flag --------------------------------------------------------------

    def _handle(self, signum, frame) -> None:
        # claim an arrival slot FIRST, atomically (one bytecode): a check
        # of the flag then a set would let a second signal delivered
        # between them take the first-signal path too and lose the
        # escalation.  With the counter exactly one invocation draws slot
        # 0, whatever the interleaving; every other one escalates.
        n = next(self._arrivals)
        self.signaled_at = time.time()
        self._stop.set()
        if n == 0:
            # first stop request: let observers see it before any
            # escalation can terminate the process
            _notify_stop(signum)
        if n > 0:
            # repeated signal while a graceful stop is already pending
            # (e.g. Ctrl-C during a long compile): escalate to default
            # handling so the process can actually be terminated
            _escalate(signum)

    def request_stop(self) -> None:
        """Set the flag without a signal (tests, cooperative shutdown).
        Draws an arrival slot like a real signal, so a SIGTERM landing
        after a cooperative stop still escalates."""
        n = next(self._arrivals)
        self.signaled_at = time.time()
        self._stop.set()
        if n == 0:
            _notify_stop(None)

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()


class PreemptedError(RuntimeError):
    """Raised by tasks that stopped on a preemption signal, so supervisors
    can distinguish clean-preempted exits from crashes."""


def run_with_restarts(
    fn: Callable[[], T],
    *,
    max_restarts: int = 0,
    backoff_secs: float = 5.0,
    max_backoff_secs: float = 120.0,
    on_restart: Callable[[int, BaseException], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    rng=None,
) -> T:
    """Run ``fn``, rerunning it after a crash up to ``max_restarts`` times.

    ``PreemptedError`` and ``KeyboardInterrupt`` propagate at once (the
    sender owns the reschedule); any other exception is retried after a
    wait, and the last one propagates.  Each rerun resumes from the latest
    checkpoint, because the train task restores on start.

    The wait doubles from ``backoff_secs`` per consecutive crash up to
    ``max_backoff_secs``, and each is drawn uniformly from [cap/2, cap]
    ("equal jitter": hosts that crashed on one cause do not retry in
    lockstep, and shared storage still gets a rest): the schedule of
    ``utils/retry.py run_with_restarts``, which this calls with an
    equal-jitter ``RetryPolicy``.  ``sleep`` and ``rng`` are injectable for
    tests."""
    import random

    from ..utils import retry

    policy = retry.RetryPolicy(
        max_attempts=max_restarts + 1, base_delay_secs=backoff_secs,
        max_delay_secs=max_backoff_secs, jitter="equal", sleep=sleep,
        rng=rng if rng is not None else random.Random())
    return retry.run_with_restarts(
        fn, max_restarts=max_restarts, policy=policy,
        should_restart=lambda e: not isinstance(e, PreemptedError),
        on_restart=(None if on_restart is None
                    else lambda attempt, e, delay: on_restart(attempt, e)))
