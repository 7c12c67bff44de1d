"""Dynamic micro-batching engine: a trimmed copy of
``deepfm_tpu/serve/batcher.py``'s ``MicroBatcher``.

Concurrent ``score`` calls queue their rows; one worker thread coalesces
them into the smallest bucket shape that fits (default 8/32/128/512),
zero-pads, and calls the predict function once per dispatch.  A lone
request waits at most ``max_wait_ms`` for bucket-mates; beyond
``max_queue_rows`` queued rows callers fail fast with
:class:`OverloadedError` (HTTP 503).  The worker thread is the only thread
that calls the predict function, so on the card every launch happens on
that thread's current stream, and HTTP threads never touch CUDA.

Left out against the JAX engine: deadlines and admission control, trace
spans and the shared metrics registry.  ``precompile`` is a warm-up that
runs each bucket once on the device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np

DEFAULT_BUCKETS = (8, 32, 128, 512)
LATENCY_WINDOW = 4096  # requests in the sliding latency window


class OverloadedError(RuntimeError):
    """Queue depth exceeded: shed load instead of growing a backlog."""


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


class _Request:
    """One caller's submission: output assembled from dispatch slices."""

    __slots__ = ("rows", "out", "remaining", "done", "error", "t_submit")

    def __init__(self, rows: int, chunks: int):
        self.rows = rows
        self.out: np.ndarray | None = None
        self.remaining = chunks
        self.done = threading.Event()
        self.error: BaseException | None = None
        self.t_submit = time.perf_counter()


class MicroBatcher:
    """Micro-batching front over ``fn(ids [B, F] int64, vals [B, F] f32)
    -> [B]``, called only at the bucket shapes."""

    def __init__(self, fn: Callable, field_size: int, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 2.0, max_queue_rows: int | None = None,
                 name: str = "predict"):
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
        self._cond = threading.Condition()
        # (request, offset in request, ids chunk, vals chunk, arrival)
        self._queue: deque[tuple] = deque()
        self._queued_rows = 0
        # callables the worker runs between dispatches (the warm-up)
        self._jobs: deque[Callable] = deque()
        self._closed = False
        # counters, guarded by _cond
        self._requests = 0
        self._rows = 0
        self._rejected = 0
        self._padded = 0
        self._dispatches = {b: 0 for b in self._buckets}
        self._latency_s: deque[float] = deque(maxlen=LATENCY_WINDOW)
        self._latency_count = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=f"micro-batcher-{name}")
        self._worker.start()

    @property
    def buckets(self) -> tuple[int, ...]:
        return self._buckets

    def precompile(self) -> dict[int, float]:
        """Warm-up: run each bucket shape once (zero batch) before traffic,
        on the worker thread, so per-thread device state (the CUDA context
        binding, cuBLAS handles and workspaces) exists before the first
        request.  Returns {bucket: seconds}."""
        timings: dict[int, float] = {}
        errors: list[BaseException] = []
        done = threading.Event()

        def warm_up():
            try:
                for b in self._buckets:
                    ids = np.zeros((b, self._fields), np.int64)
                    vals = np.zeros((b, self._fields), np.float32)
                    t0 = time.perf_counter()
                    np.asarray(self._fn(ids, vals))
                    timings[b] = round(time.perf_counter() - t0, 4)
            except Exception as e:  # re-raised on the caller's thread
                errors.append(e)
            finally:
                done.set()

        with self._cond:
            if self._closed:
                raise RuntimeError(f"MicroBatcher {self.name!r} is closed")
            self._jobs.append(warm_up)
            self._cond.notify()
        done.wait()
        if errors:
            raise errors[0]
        return timings

    def score(self, ids: np.ndarray, vals: np.ndarray) -> np.ndarray:
        """ids/vals [N, F] -> [N]; blocks until scored.  Raises
        ``ValueError`` for malformed shapes (on the caller's thread) and
        :class:`OverloadedError` past the queue bound."""
        ids = np.asarray(ids, np.int64)
        vals = np.asarray(vals, np.float32)
        check_features(ids, vals, self._fields)
        n = ids.shape[0]
        if n == 0:
            return np.zeros((0,), np.float32)
        cap = self._buckets[-1]
        starts = range(0, n, cap)
        req = _Request(n, len(starts))
        with self._cond:
            if self._closed:
                raise RuntimeError(f"MicroBatcher {self.name!r} is closed")
            # the bound sheds BACKLOG, not request size: one request bigger
            # than the bound is admitted into an empty queue
            if self._queued_rows > 0 and self._queued_rows + n > self._max_queue_rows:
                self._rejected += 1
                raise OverloadedError(
                    f"scoring queue full ({self._queued_rows} rows queued, "
                    f"bound {self._max_queue_rows}); retry later"
                )
            arrival = time.perf_counter()
            for s in starts:
                self._queue.append((req, s, ids[s:s + cap], vals[s:s + cap], arrival))
            self._queued_rows += n
            self._requests += 1
            self._rows += n
            self._cond.notify()
        req.done.wait()
        with self._cond:
            self._latency_s.append(time.perf_counter() - req.t_submit)
            self._latency_count += 1
        if req.error is not None:
            raise req.error
        return req.out

    def score_instances(self, instances: list[dict]) -> np.ndarray:
        return self.score(*instances_to_arrays(instances))

    def metrics_snapshot(self) -> dict:
        with self._cond:
            hist = {str(b): c for b, c in self._dispatches.items()}
            lat = np.asarray(self._latency_s, np.float64) * 1e3
            snap = {
                "engine": "micro_batcher",
                "name": self.name,
                "buckets": list(self._buckets),
                "max_wait_ms": round(self._max_wait_s * 1e3, 3),
                "max_queue_rows": self._max_queue_rows,
                "queue_rows": self._queued_rows,
                "queue_requests": len(self._queue),
                "requests_total": self._requests,
                "rows_total": self._rows,
                "dispatches_total": sum(self._dispatches.values()),
                "padded_rows_total": self._padded,
                "rejected_total": self._rejected,
                "batch_size_hist": hist,
            }
            count = self._latency_count
        latency = {"count": count}
        if lat.size:
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            latency.update(p50=float(p50), p95=float(p95), p99=float(p99),
                           max=float(lat.max()))
        snap["latency_ms"] = latency
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
                    while (self._queue and rows + self._queue[0][2].shape[0]
                           <= self._buckets[-1]):
                        item = self._queue.popleft()
                        if item[0].error is not None:
                            # a sibling chunk already failed this request
                            self._queued_rows -= item[2].shape[0]
                            continue
                        batch.append(item)
                        rows += item[2].shape[0]
                    self._queued_rows -= rows
            if job is not None:
                job()
            elif batch:
                self._dispatch(batch, rows)

    def _dispatch(self, batch: list[tuple], rows: int) -> None:
        bucket = pick_bucket(self._buckets, rows)
        try:
            ids = np.zeros((bucket, self._fields), np.int64)
            vals = np.zeros((bucket, self._fields), np.float32)
            off = 0
            for _req, _ro, cids, cvals, _t in batch:
                ids[off:off + cids.shape[0]] = cids
                vals[off:off + cids.shape[0]] = cvals
                off += cids.shape[0]
            res = np.asarray(self._fn(ids, vals))
            with self._cond:
                self._dispatches[bucket] += 1
                self._padded += bucket - rows
            off = 0
            for req, req_off, cids, _v, _t in batch:
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
