"""Dynamic micro-batching engine: the port's copy of
``deepfm_tpu/serve/batcher.py``'s ``MicroBatcher``.

Concurrent ``score`` calls queue their rows; one worker thread coalesces
them into the smallest bucket shape that fits (default 8/32/128/512),
zero-pads, and calls the predict function once per dispatch.  A lone
request waits at most ``max_wait_ms`` for bucket-mates; beyond
``max_queue_rows`` queued rows callers fail fast with
:class:`OverloadedError` (HTTP 503).

As in the JAX engine:

* **Deadlines and admission.**  ``score(..., deadline_s=, priority=)``
  takes an absolute ``time.perf_counter`` deadline (the server's
  ``X-Deadline-Ms`` made absolute) and a priority class (``X-Priority``).
  An attached :class:`~.control.admission.AdmissionController` prices the
  request at the door (503 + ``Retry-After`` when the deadline cannot be
  met, or when the shed ladder drops its class); a chunk whose deadline
  passes while it is queued is answered with
  :class:`~.control.admission.DeadlineExpiredError` (504) at dequeue, and
  its slots are backfilled from the queue before padding is counted.
* **Metrics** (``_Metrics``) live in a shared
  :class:`~..obs.metrics.MetricsRegistry` (``GET /metrics``), with queue
  gauges refreshed at each scrape; ``metrics_snapshot`` renders the same
  ``/v1/metrics`` document as the JAX engine.
* **Tracing.**  A caller with an active trace (obs/trace.py) gets a
  ``<name>.queue`` span (admission to first dispatch) and a
  ``<name>.dispatch`` span per dispatch (bucket, rows, padding).

Unlike the JAX engine, the worker thread also runs **jobs**
(:meth:`run_on_worker`): callables queued ahead of traffic and run between
dispatches.  The warm-up, a CUDA graph capture (serve/graphs.py), a weight
upload into an idle slot and a hot-reload canary (serve/reload.py) all go
through it, so the worker stays the only thread that touches the device:
every launch and graph replay happens on that thread's current stream, one
at a time, and HTTP threads never touch CUDA.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np

from ..obs.metrics import MetricsRegistry
from ..obs.trace import current_trace
from .control.admission import DeadlineExpiredError

DEFAULT_BUCKETS = (8, 32, 128, 512)


class OverloadedError(RuntimeError):
    """Queue depth exceeded: shed load instead of growing a backlog."""


def admission_starts(rows: int, cap: int) -> range:
    """Chunk offsets ``score()`` splits an admitted request at (each chunk
    <= ``cap`` rows)."""
    return range(0, rows, cap)


def pick_bucket(buckets: Sequence[int], rows: int) -> int:
    """Smallest bucket that fits ``rows`` (the largest for oversized
    batches, which ``score`` has already chunked down to it)."""
    for b in buckets:
        if rows <= b:
            return b
    return buckets[-1]


def instances_to_arrays(instances: list[dict]) -> tuple[np.ndarray, np.ndarray]:
    """JSON ``instances`` rows -> ([N, F] int64 ids, [N, F] f32 vals).
    Malformed rows raise ``ValueError`` with a row-indexed message."""
    ids_rows, val_rows = [], []
    for n, inst in enumerate(instances):
        if not isinstance(inst, dict):
            raise ValueError(
                f"instances[{n}] is {type(inst).__name__}, expected an "
                f"object with 'feat_ids' and 'feat_vals'"
            )
        missing = [k for k in ("feat_ids", "feat_vals") if k not in inst]
        if missing:
            raise ValueError(f"instances[{n}] is missing {missing} (has {sorted(inst)})")
        ids_rows.append(inst["feat_ids"])
        val_rows.append(inst["feat_vals"])
    try:
        ids = np.asarray(ids_rows, np.int64)
        vals = np.asarray(val_rows, np.float32)
    except (ValueError, TypeError) as e:
        raise ValueError(f"instances rows are ragged or non-numeric: {e}") from None
    return ids, vals


def check_features(ids: np.ndarray, vals: np.ndarray, fields: int) -> None:
    """Reject malformed [N, F] pairs."""
    if ids.ndim != 2 or ids.shape[1] != fields:
        raise ValueError(f"expected [N, {fields}] features, got {ids.shape}")
    if vals.shape != ids.shape:
        raise ValueError(f"feat_vals shape {vals.shape} != feat_ids shape {ids.shape}")


class _Metrics:
    """Engine counters and the sliding latency window, in the registry.
    Families carry the label ``engine=<name>``, so one registry holds many
    engines (the two towers' pair); ``snapshot()`` renders the
    ``/v1/metrics`` fields of the JAX engine from the same values."""

    def __init__(self, buckets: Sequence[int], *, name: str = "predict",
                 registry: MetricsRegistry | None = None, window: int = 4096):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._requests = r.counter(
            "deepfm_serve_requests_total",
            "requests admitted to the micro-batching engine",
            labels=("engine",)).labels(name)
        self._rows = r.counter(
            "deepfm_serve_rows_total", "rows admitted", labels=("engine",)).labels(name)
        self._rejected = r.counter(
            "deepfm_serve_rejected_total",
            "requests shed by queue backpressure", labels=("engine",)).labels(name)
        self._padded = r.counter(
            "deepfm_serve_padded_rows_total",
            "dispatched minus real rows (padding waste)", labels=("engine",)).labels(name)
        dispatches = r.counter(
            "deepfm_serve_dispatches_total",
            "device dispatches by bucket shape", labels=("engine", "bucket"))
        # every bucket's child up front, so the histogram renders zeros
        self._dispatch_by_bucket = {int(b): dispatches.labels(name, str(int(b)))
                                    for b in buckets}
        self._latency = r.histogram(
            "deepfm_serve_latency_seconds",
            "end-to-end request latency through the engine",
            labels=("engine",), window=window).labels(name)
        self._expired = r.counter(
            "deepfm_serve_expired_total",
            "requests whose deadline passed while queued (answered 504 "
            "at dequeue, never dispatched)", labels=("engine",)).labels(name)

    def record_admit(self, rows: int) -> None:
        self._requests.inc()
        self._rows.inc(rows)

    def record_reject(self) -> None:
        self._rejected.inc()

    def record_dispatch(self, bucket: int, rows: int) -> None:
        self._padded.inc(bucket - rows)
        self._dispatch_by_bucket[bucket].inc()

    def record_expired(self) -> None:
        self._expired.inc()

    def record_latency(self, seconds: float) -> None:
        self._latency.observe(seconds)

    def snapshot(self) -> dict:
        hist = {str(b): int(c.value) for b, c in sorted(self._dispatch_by_bucket.items())}
        return {
            "requests_total": int(self._requests.value),
            "rows_total": int(self._rows.value),
            "dispatches_total": sum(hist.values()),
            "padded_rows_total": int(self._padded.value),
            "rejected_total": int(self._rejected.value),
            "expired_total": int(self._expired.value),
            "batch_size_hist": hist,
            "latency_ms": self._latency.snapshot(include_max=True),
        }


class _Request:
    """One caller's submission: output assembled from dispatch slices."""

    __slots__ = ("rows", "out", "remaining", "done", "error", "t_submit",
                 "trace", "t_dispatch")

    def __init__(self, rows: int, chunks: int, trace=None):
        self.rows = rows
        self.out: np.ndarray | None = None
        self.remaining = chunks
        self.done = threading.Event()
        self.error: BaseException | None = None
        self.t_submit = time.perf_counter()
        # the caller's trace (obs/trace.py), captured on the submitting
        # thread so the worker can attach dispatch spans
        self.trace = trace
        self.t_dispatch: float | None = None  # first dispatch start


class MicroBatcher:
    """Micro-batching front over ``fn(ids [B, F] int64, vals [B, F] f32)
    -> [B]`` (or ``[B, D]``), called only at the bucket shapes and only on
    the worker thread.  ``registry`` shares one metrics registry across a
    process's engines; ``admission`` attaches deadline pricing and the
    shed ladder (None: the queue bound alone)."""

    # handlers probe this before passing deadline/priority kwargs
    supports_deadline = True

    def __init__(self, fn: Callable, field_size: int, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 2.0, max_queue_rows: int | None = None,
                 name: str = "predict", registry: MetricsRegistry | None = None,
                 admission=None):
        if not buckets:
            raise ValueError("need at least one bucket size")
        self._buckets = tuple(sorted(int(b) for b in buckets))
        if self._buckets[0] <= 0:
            raise ValueError(f"bucket sizes must be positive: {buckets}")
        if len(set(self._buckets)) != len(self._buckets):
            raise ValueError(f"duplicate bucket sizes: {buckets}")
        self._fn = fn
        self._fields = int(field_size)
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._max_queue_rows = (16 * self._buckets[-1] if max_queue_rows is None
                                else int(max_queue_rows))
        self.name = name
        self._span_queue = f"{name}.queue"
        self._span_dispatch = f"{name}.dispatch"
        self.metrics = _Metrics(self._buckets, name=name, registry=registry)
        self.registry = self.metrics.registry
        self.admission = admission
        self._g_queue_rows = self.registry.gauge(
            "deepfm_serve_queue_rows", "rows queued awaiting dispatch",
            labels=("engine",)).labels(name)
        self._g_queue_requests = self.registry.gauge(
            "deepfm_serve_queue_requests", "queued request chunks",
            labels=("engine",)).labels(name)
        self.registry.on_collect(self._refresh_queue_gauges)
        self._cond = threading.Condition()
        # (request, offset in request, ids chunk, vals chunk, arrival,
        # absolute deadline or None)
        self._queue: deque[tuple] = deque()
        self._queued_rows = 0
        # callables the worker runs between dispatches (run_on_worker)
        self._jobs: deque[Callable] = deque()
        # the dispatch executing, as (bucket rows, start): admission prices
        # its remaining time ahead of the queue's drain
        self._inflight_dispatch: tuple[int, float] | None = None
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=f"micro-batcher-{name}")
        self._worker.start()

    @property
    def buckets(self) -> tuple[int, ...]:
        return self._buckets

    @property
    def max_wait_ms(self) -> float:
        return self._max_wait_s * 1e3

    def run_on_worker(self, job: Callable):
        """Run ``job()`` on the worker thread, ahead of queued traffic and
        between dispatches; returns its result or re-raises its error on
        the caller's thread."""
        result: list = []
        errors: list[BaseException] = []
        done = threading.Event()

        def wrapped():
            try:
                result.append(job())
            except BaseException as e:  # re-raised on the caller's thread
                errors.append(e)
            finally:
                done.set()

        with self._cond:
            if self._closed:
                raise RuntimeError(f"MicroBatcher {self.name!r} is closed")
            self._jobs.append(wrapped)
            self._cond.notify()
        done.wait()
        if errors:
            raise errors[0]
        return result[0]

    def precompile(self) -> dict[int, float]:
        """Warm-up: run each bucket shape once (zero batch) on the worker
        thread before traffic, so per-thread device state (the CUDA context
        binding, cuBLAS handles and workspaces) exists before the first
        request.  Returns {bucket: seconds}; not counted in the metrics."""

        def warm_up() -> dict[int, float]:
            timings = {}
            for b in self._buckets:
                ids = np.zeros((b, self._fields), np.int64)
                vals = np.zeros((b, self._fields), np.float32)
                t0 = time.perf_counter()
                np.asarray(self._fn(ids, vals))
                timings[b] = round(time.perf_counter() - t0, 4)
            return timings

        return self.run_on_worker(warm_up)

    def score(self, ids: np.ndarray, vals: np.ndarray, *,
              deadline_s: float | None = None,
              priority: str = "predict") -> np.ndarray:
        """ids/vals [N, F] -> [N] (or [N, D]); blocks until scored.

        Raises ``ValueError`` for malformed shapes (on the caller's
        thread), :class:`OverloadedError` past the queue bound, and with
        an admission controller ``DeadlineRejectedError``/``ShedError`` at
        the door; ``DeadlineExpiredError`` when ``deadline_s`` (absolute
        ``time.perf_counter`` seconds) passed while the request was
        queued."""
        ids = np.asarray(ids, np.int64)
        vals = np.asarray(vals, np.float32)
        check_features(ids, vals, self._fields)
        n = ids.shape[0]
        if n == 0:
            return np.zeros((0,), np.float32)
        cap = self._buckets[-1]
        starts = list(admission_starts(n, cap))
        req = _Request(n, len(starts), trace=current_trace())
        with self._cond:
            if self._closed:
                raise RuntimeError(f"MicroBatcher {self.name!r} is closed")
            # the bound sheds BACKLOG, not request size: one request bigger
            # than the bound is admitted into an empty queue
            if self._queued_rows > 0 and self._queued_rows + n > self._max_queue_rows:
                self.metrics.record_reject()
                raise OverloadedError(
                    f"scoring queue full ({self._queued_rows} rows queued, "
                    f"bound {self._max_queue_rows}); retry later"
                )
            arrival = time.perf_counter()
            if self.admission is not None:
                # raises before anything is queued; returns the effective
                # absolute deadline the chunks carry
                deadline_s = self.admission.check(
                    rows=n, queued_rows=self._queued_rows,
                    max_queue_rows=self._max_queue_rows, deadline_s=deadline_s,
                    priority=priority, now=arrival,
                    inflight=self._inflight_dispatch)
            for s in starts:
                self._queue.append((req, s, ids[s:s + cap], vals[s:s + cap],
                                    arrival, deadline_s))
            self._queued_rows += n
            self._cond.notify()
        self.metrics.record_admit(n)
        req.done.wait()
        self.metrics.record_latency(time.perf_counter() - req.t_submit)
        if req.trace is not None and req.t_dispatch is not None:
            req.trace.add_span(self._span_queue, req.t_submit, req.t_dispatch, rows=n)
        if req.error is not None:
            raise req.error
        return req.out

    def score_instances(self, instances: list[dict], *,
                        deadline_s: float | None = None,
                        priority: str = "predict") -> np.ndarray:
        return self.score(*instances_to_arrays(instances),
                          deadline_s=deadline_s, priority=priority)

    def _refresh_queue_gauges(self) -> None:
        """Pre-scrape hook: the live queue depth as gauges."""
        with self._cond:
            rows, reqs = self._queued_rows, len(self._queue)
        self._g_queue_rows.set(rows)
        self._g_queue_requests.set(reqs)

    def metrics_snapshot(self) -> dict:
        with self._cond:
            queue_rows, queue_requests = self._queued_rows, len(self._queue)
        snap = {
            "engine": "micro_batcher",
            "name": self.name,
            "buckets": list(self._buckets),
            "max_wait_ms": round(self.max_wait_ms, 3),
            "max_queue_rows": self._max_queue_rows,
            "queue_rows": queue_rows,
            "queue_requests": queue_requests,
        }
        snap.update(self.metrics.snapshot())
        if self.admission is not None:
            snap["admission"] = self.admission.snapshot()
        return snap

    def close(self) -> None:
        """Stop the worker (queued requests finish first; later
        submissions raise RuntimeError)."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._worker.join(timeout=10)

    def _run(self) -> None:
        while True:
            job, batch, rows = None, [], 0
            with self._cond:
                while not self._queue and not self._jobs and not self._closed:
                    self._cond.wait()
                if self._jobs:
                    job = self._jobs.popleft()
                elif not self._queue:
                    return  # closed and drained
                else:
                    # wait for bucket-mates until the oldest item has
                    # waited max_wait, or the smallest bucket is full
                    deadline = self._queue[0][4] + self._max_wait_s
                    while self._queued_rows < self._buckets[0] and not self._closed:
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                    batch, rows = self._collect()
            if job is not None:
                job()
            elif batch:
                try:
                    self._dispatch(batch, rows)
                finally:
                    with self._cond:
                        self._inflight_dispatch = None

    def _collect(self) -> tuple[list[tuple], int]:
        """Pop up to the largest bucket of live chunks (under ``_cond``).
        A chunk whose request already failed is dropped; a chunk whose
        deadline passed is answered 504 now and its slots backfill from the
        queue, so a bucket of stale work dispatches nothing."""
        batch, rows = [], 0
        t_collect = time.perf_counter()
        while self._queue and rows + self._queue[0][2].shape[0] <= self._buckets[-1]:
            item = self._queue.popleft()
            req = item[0]
            if req.error is not None:
                self._queued_rows -= item[2].shape[0]
                continue
            if item[5] is not None and t_collect > item[5]:
                self._queued_rows -= item[2].shape[0]
                req.error = DeadlineExpiredError(
                    f"deadline passed while queued "
                    f"({(t_collect - item[5]) * 1e3:.1f} ms late at dequeue)")
                self.metrics.record_expired()
                req.done.set()
                continue
            batch.append(item)
            rows += item[2].shape[0]
        self._queued_rows -= rows
        if batch:
            self._inflight_dispatch = (pick_bucket(self._buckets, rows), time.perf_counter())
        return batch, rows

    def _dispatch(self, batch: list[tuple], rows: int) -> None:
        bucket = pick_bucket(self._buckets, rows)
        t0 = time.perf_counter()
        for req, *_ in batch:
            if req.t_dispatch is None:
                req.t_dispatch = t0
        try:
            ids = np.zeros((bucket, self._fields), np.int64)
            vals = np.zeros((bucket, self._fields), np.float32)
            off = 0
            for _req, _ro, cids, cvals, *_ in batch:
                ids[off:off + cids.shape[0]] = cids
                vals[off:off + cids.shape[0]] = cvals
                off += cids.shape[0]
            res = np.asarray(self._fn(ids, vals))
            self.metrics.record_dispatch(bucket, rows)
            t1 = time.perf_counter()
            if self.admission is not None:
                # the cost model eats the dispatch span's own boundary
                self.admission.cost.observe(bucket, t1 - t0)
            for req, *_ in batch:
                if req.trace is not None:
                    req.trace.add_span(self._span_dispatch, t0, t1, bucket=bucket,
                                       rows_coalesced=rows, padded=bucket - rows)
            off = 0
            for req, req_off, cids, *_ in batch:
                k = cids.shape[0]
                if req.out is None:
                    req.out = np.empty((req.rows, *res.shape[1:]), res.dtype)
                req.out[req_off:req_off + k] = res[off:off + k]
                off += k
        except Exception as e:  # a runtime failure fails the whole dispatch
            for req, *_ in batch:
                req.error = e
        finally:
            for req, *_ in batch:
                req.remaining -= 1
                if req.remaining == 0 or req.error is not None:
                    req.done.set()
