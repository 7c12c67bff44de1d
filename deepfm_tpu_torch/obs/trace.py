"""Request tracing: the port's copy of ``deepfm_tpu/obs/trace.py`` without
the train loop's ``StepPhases``.

A trace is minted where a request enters (or adopted from the client's
``X-Trace-Id``) and accumulates per-stage spans as the request moves
through the handler and the micro-batcher: queue wait and each dispatch
(bucket, rows coalesced, padding).  Sampling is decided at the head
(``sample_rate``); a propagated trace id is always recorded.

Spans are host-side timers around dispatch boundaries: nothing here runs
inside a CUDA graph or a kernel.  The non-sampled fast path is one
``ContextVar.get``; the recent-traces ring behind ``GET /v1/trace/recent``
is bounded; finished traces can be appended to a JSONL file.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from collections import deque

TRACE_HEADER = "X-Trace-Id"
SPAN_HEADER = "X-Span-Id"

# the shipped head-sampling rate (the JAX package's): fresh requests trace
# at this probability; a request that arrives with an X-Trace-Id is always
# recorded, so a client pins a trace by sending the id.  Override per
# server with --trace-sample / Tracer(sample_rate=...).
DEFAULT_SAMPLE_RATE = 0.1

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "deepfm_trace", default=None
)


def current_trace() -> "TraceContext | None":
    """The active request's trace context on THIS thread (None when the
    request is unsampled or there is no request) — the one hook the
    MicroBatcher and handlers read; costs a ContextVar.get."""
    return _CURRENT.get()


@contextlib.contextmanager
def span(name: str, **attrs):
    """Record a span on the current trace (no-op when none is active)."""
    ctx = _CURRENT.get()
    if ctx is None:
        yield None
        return
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        ctx.add_span(name, t0, time.perf_counter(), **attrs)


class TraceContext:
    """One request's accumulating trace: id pair + span list.

    ``spans`` is appended from multiple threads (the handler thread and
    the batcher's dispatch thread); ``list.append`` is atomic under the
    GIL and entries are immutable tuples, so no lock is needed on the
    record path.  Record-time work is deliberately minimal — raw
    perf_counter readings and attr dicts are stored as tuples, and ALL
    rendering (ms conversion, rounding, document assembly) is deferred
    to :meth:`to_dict`, which runs at scrape time (``/v1/trace/recent``)
    or export, never on the request path."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "name",
                 "service", "t_start", "t_end", "start_unix", "spans",
                 "attrs")

    def __init__(self, name: str, service: str, *,
                 trace_id: str | None = None,
                 parent_span_id: str | None = None):
        # one urandom syscall covers both ids (hot path: once per
        # sampled request)
        rnd = os.urandom(16).hex()
        self.trace_id = trace_id or rnd[:16]
        self.span_id = rnd[16:]
        self.parent_span_id = parent_span_id
        self.name = name
        self.service = service
        self.t_start = time.perf_counter()
        self.t_end: float | None = None
        self.start_unix = time.time()
        self.spans: list[tuple] = []   # (name, t0, t1, attrs | None)
        self.attrs: dict = {}

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Record one completed stage; ``t0``/``t1`` are perf_counter
        readings taken by the caller AROUND the stage (never inside
        traced code)."""
        self.spans.append((name, t0, t1, attrs or None))

    def headers(self) -> dict[str, str]:
        """The propagation pair a forwarding hop (the pool router) sends
        downstream."""
        return {TRACE_HEADER: self.trace_id, SPAN_HEADER: self.span_id}

    def to_dict(self) -> dict:
        """Render the trace document (scrape/export time only)."""
        spans = []
        for name, t0, t1, attrs in list(self.spans):
            s = {
                "name": name,
                "start_ms": round(1e3 * (t0 - self.t_start), 3),
                "duration_ms": round(1e3 * (t1 - t0), 3),
            }
            if attrs:
                s.update(attrs)
            spans.append(s)
        out = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "service": self.service,
            "name": self.name,
            "start_unix": round(self.start_unix, 6),
            "spans": spans,
        }
        if self.parent_span_id:
            out["parent_span_id"] = self.parent_span_id
        if self.t_end is not None:
            out["duration_ms"] = round(1e3 * (self.t_end - self.t_start), 3)
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out


class Tracer:
    """Per-process trace head: sampling, activation, the bounded
    recent-traces ring, optional JSONL export.

    ``begin()`` at the request edge; ``finish()`` in the handler's
    ``finally``.  A request carrying a propagated ``X-Trace-Id`` is
    always recorded (the head already sampled it); fresh requests are
    head-sampled at ``sample_rate``."""

    def __init__(self, service: str, *, sample_rate: float = 1.0,
                 capacity: int = 256, export_path: str | None = None):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in [0,1], got {sample_rate}")
        self.service = service
        self.sample_rate = float(sample_rate)
        self._lock = threading.Lock()
        self._recent: deque[dict] = deque(maxlen=max(1, int(capacity)))
        self._export_path = export_path
        self._export_file = None
        # exports serialize on their own lock so a slow disk only stalls
        # exporting threads — never the ring (recent() scrapes) or the
        # counters under self._lock
        self._export_lock = threading.Lock()
        self.traces_total = 0
        self.dropped_unsampled_total = 0

    # -- lifecycle ----------------------------------------------------------
    def begin(self, name: str, headers=None) -> "TraceContext | None":
        """Mint (or adopt) a trace for one request and activate it on the
        current thread.  Returns None (and activates nothing) when the
        head-based sampler drops it."""
        trace_id = parent = None
        if headers is not None:
            trace_id = headers.get(TRACE_HEADER) or None
            parent = headers.get(SPAN_HEADER) or None
        if trace_id is None and not self._sample():
            with self._lock:
                self.dropped_unsampled_total += 1
            return None
        return TraceContext(name, self.service, trace_id=trace_id,
                            parent_span_id=parent)

    def _sample(self) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        # id-independent head sampling; os.urandom avoids sharing any
        # seeded RNG with model code
        return int.from_bytes(os.urandom(2), "big") < 65536 * self.sample_rate

    def activate(self, ctx: "TraceContext | None"):
        """Install ``ctx`` as the current trace; returns the reset token
        (None when ctx is None)."""
        if ctx is None:
            return None
        return _CURRENT.set(ctx)

    def finish(self, ctx: "TraceContext | None", token=None, *,
               status: str | int | None = None) -> None:
        """Close the request: deactivate, stamp duration/status, push to
        the recent ring, export.  No-op for unsampled requests.  The ring
        holds live contexts; rendering to documents happens at scrape
        time (:meth:`recent`) so the request path pays an append, not a
        serialization."""
        if token is not None:
            _CURRENT.reset(token)
        if ctx is None:
            return
        ctx.t_end = time.perf_counter()
        if status is not None:
            ctx.attrs["status"] = status
        with self._lock:
            self.traces_total += 1
            self._recent.append(ctx)
        if self._export_path:
            # render + write OUTSIDE the ring lock: a stalled disk must
            # not block request completion on other threads or scrapes
            self._export(ctx.to_dict())

    # -- surfaces -----------------------------------------------------------
    def recent(self, limit: int | None = None) -> list[dict]:
        """Most-recent-last trace documents for ``GET /v1/trace/recent``."""
        with self._lock:
            out = list(self._recent)
        if limit is not None:
            out = out[-int(limit):]
        return [c.to_dict() for c in out]

    def _export(self, doc: dict) -> None:
        line = json.dumps(doc, default=str) + "\n"
        with self._export_lock:
            if not self._export_path:
                return
            try:
                if self._export_file is None:
                    self._export_file = open(self._export_path, "a")
                self._export_file.write(line)
                self._export_file.flush()
            except OSError:
                # a broken export must not fail serving
                self._export_path = None

    def close(self) -> None:
        with self._export_lock:
            if self._export_file is not None:
                self._export_file.close()
                self._export_file = None
