"""Crash flight recorder: the port's copy of ``deepfm_tpu/obs/flight.py``,
a bounded ring of structured lifecycle events.

Subsystems append through one hook, :func:`record` (breaker transitions in
utils/retry.py, hot-swap commits and rollbacks in serve/reload.py, shed
level changes in serve/control/admission.py).  Every event carries a
sequence number and a wall-clock time, so a dump is one ordered timeline.

The ring surfaces as ``GET /v1/flight`` on the HTTP front, as a JSONL dump
written on SIGTERM/SIGINT (through launch/preemption.py's stop callbacks,
:func:`install`, or :func:`dump_on_signal` in a process without a guard)
and on an unhandled crash, and on demand (:meth:`FlightRecorder.dump`).
Module-global by design, so every subsystem lands in one timeline; tests
swap it with :func:`set_recorder`.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque


class FlightRecorder:
    """Bounded ring of ``{"seq", "t_unix", "kind", ...}`` events."""

    def __init__(self, capacity: int = 4096):
        # RLock, deliberately: the termination hooks (install /
        # dump_on_signal) call record()+dump() from inside a signal
        # handler, which CPython runs on the main thread — if the signal
        # interrupted the main thread mid-record() with the lock held, a
        # plain Lock would deadlock the graceful stop.  Re-entry is safe:
        # the critical sections only append/read the deque, so an
        # interrupted append still leaves a consistent ring.
        self._lock = threading.RLock()
        self._events: deque[dict] = deque(maxlen=max(1, int(capacity)))
        self._seq = 0
        self._dump_path: str | None = None
        self.recorded_total = 0

    @property
    def capacity(self) -> int:
        return self._events.maxlen or 0

    def record(self, kind: str, **fields) -> None:
        """Append one event.  Values pass through untouched (numpy
        scalars etc. are coerced at dump/serve time), so the record path
        stays allocation-light."""
        with self._lock:
            self._seq += 1
            self.recorded_total += 1
            self._events.append(
                {"seq": self._seq, "t_unix": round(time.time(), 6),
                 "kind": kind, **fields}
            )

    def events(self, limit: int | None = None,
               kind: str | None = None) -> list[dict]:
        with self._lock:
            out = list(self._events)
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        return out if limit is None else out[-int(limit):]

    # -- dumps --------------------------------------------------------------
    def configure_dump(self, path: str) -> None:
        """Arm the termination dump: :meth:`dump` (and the signal/crash
        hooks installed by :func:`install`) write here."""
        with self._lock:
            self._dump_path = path

    def dump(self, path: str | None = None, *, reason: str = "manual"
             ) -> str | None:
        """Write the ring as JSONL; returns the path (None when no path
        is configured).  Never raises — a failing dump on the way down
        must not mask the original crash."""
        with self._lock:
            target = path or self._dump_path
            events = list(self._events)
            seq = self._seq
        if not target:
            return None
        try:
            with open(target, "w") as f:
                f.write(json.dumps(
                    {"seq": seq + 1, "t_unix": round(time.time(), 6),
                     "kind": "flight_dump", "reason": reason,
                     "events": len(events)}, default=str) + "\n")
                for e in events:
                    f.write(json.dumps(e, default=str) + "\n")
            return target
        except OSError:
            return None


_LOCK = threading.Lock()
_RECORDER = FlightRecorder()
_INSTALLED = False


def get_recorder() -> FlightRecorder:
    return _RECORDER


def set_recorder(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the process-global recorder (tests); returns the previous."""
    global _RECORDER
    with _LOCK:
        prev, _RECORDER = _RECORDER, recorder
        return prev


def record(kind: str, **fields) -> None:
    """THE append hook every subsystem calls."""
    _RECORDER.record(kind, **fields)


def render_events() -> list[dict]:
    """The ``GET /v1/flight`` document body: the live ring, coerced
    JSON-safe (record() stores values untouched — numpy scalars etc.
    stringify here, at scrape time, the one place every HTTP surface
    shares)."""
    return json.loads(json.dumps(_RECORDER.events(), default=str))


def install(dump_path: str, *, capacity: int | None = None) -> FlightRecorder:
    """Arm termination/crash dumps onto ``dump_path``.

    * registers with the PreemptionGuard stop-callback hook
      (launch/preemption.py): the first SIGTERM/SIGINT records a
      ``termination_signal`` event and writes the JSONL dump — the same
      cooperative path that triggers the preemption checkpoint;
    * chains ``sys.excepthook``: an unhandled exception records a
      ``crash`` event (type + message) and dumps before the original
      hook prints the traceback.

    Idempotent per process (re-installing just re-points the path)."""
    global _INSTALLED
    rec = _RECORDER
    if capacity is not None and capacity != rec.capacity:
        rec = FlightRecorder(capacity)
        set_recorder(rec)
    rec.configure_dump(dump_path)
    with _LOCK:
        if _INSTALLED:
            return rec
        _INSTALLED = True
    from ..launch.preemption import register_stop_callback

    def _on_stop(signum=None) -> None:
        r = _RECORDER
        r.record("termination_signal",
                 signum=signum, pid=os.getpid())
        r.dump(reason="termination_signal")

    register_stop_callback(_on_stop)

    prev_hook = sys.excepthook

    def _on_crash(exc_type, exc, tb):
        r = _RECORDER
        r.record("crash", error=f"{exc_type.__name__}: {exc}",
                 pid=os.getpid())
        r.dump(reason="crash")
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _on_crash
    return rec


def dump_on_signal(sig: int | None = None) -> bool:
    """Arm the dump for processes WITHOUT a PreemptionGuard (the serve
    surfaces keep default SIGTERM semantics — the stop-callback path of
    :func:`install` never fires there).  The handler writes the dump,
    then re-delivers the signal with the default action, so termination
    behavior is unchanged — the process still dies, it just leaves the
    timeline first.  Returns False off the main thread (CPython only
    allows ``signal.signal`` there) or when no dump path is configured
    yet; call :func:`install` first."""
    import signal as _signal

    sig = _signal.SIGTERM if sig is None else sig
    if threading.current_thread() is not threading.main_thread():
        return False

    def _handler(signum, frame):
        r = _RECORDER
        r.record("termination_signal", signum=signum, pid=os.getpid())
        r.dump(reason="termination_signal")
        _signal.signal(signum, _signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    _signal.signal(sig, _handler)
    return True
