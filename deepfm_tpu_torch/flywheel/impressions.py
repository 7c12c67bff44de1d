"""Bounded, sampled impression logging off the serving response path: the
port's copy of ``deepfm_tpu/flywheel/impressions.py``.  The pool router
(serve/pool/router.py) offers it every answered ``:predict``.

Same structural guarantee as shadow scoring (fleet/shadow.py): the
router answers every request as always, and *after* the answer is
formed the request is **offered** here — a hash-stable sampling gate,
then ``put_nowait`` into a bounded queue.  A full queue drops the offer
(counted, never blocks); one background writer drains the queue,
serializes impression records off-path, and publishes them through the
shared :class:`~deepfm_tpu_torch.online.stream.SegmentWriter` size/age roll
into the immutable-segment format the join service tails.

The sampling decision is per impression id (the trace id when the
request carried one, else the routing key) via
:func:`~deepfm_tpu_torch.flywheel.records.impression_sampled` — deterministic,
so the join service recomputes the identical keep/drop slice and a click
for a sampled-out impression is recognized as such, not treated as an
orphan.
"""

from __future__ import annotations

import queue
import threading
import time

from ..obs.metrics import MetricsRegistry
from ..online.stream import SegmentWriter
from .records import impression_sampled, serialize_impression


class ImpressionLogger:
    """Router-side scored-impression logger: sample → bound → segment."""

    def __init__(
        self,
        root: str,
        *,
        sample_rate: float = 1.0,
        queue_depth: int = 1024,
        roll_bytes: int = 1 << 20,
        roll_age_secs: float = 10.0,
        join_output_url: str = "",
        registry: MetricsRegistry | None = None,
    ):
        if not root:
            raise ValueError("ImpressionLogger needs a log root")
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in (0, 1], got {sample_rate}")
        self.root = root
        self.join_output_url = join_output_url
        self._sample_rate = float(sample_rate)
        self._q: queue.Queue = queue.Queue(maxsize=int(queue_depth))
        self._writer = SegmentWriter(
            root, roll_bytes=roll_bytes, roll_age_secs=roll_age_secs)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        events = self.registry.counter(
            "deepfm_flywheel_impressions_total",
            "impression-logging events by kind",
            labels=("event",))
        self._c_logged = events.labels("logged")
        self._c_sampled_out = events.labels("sampled_out")
        self._c_dropped = events.labels("dropped")
        self._c_errors = events.labels("error")

    # -- serving-path side (must stay O(1) and non-blocking) ----------------
    def offer(
        self,
        *,
        key: str,
        trace_id: str = "",
        tenant: str = "",
        model_version: int = -1,
        instances: list,
        scores: list,
        deadline_class: str = "",
    ) -> int:
        """Offer one scored request; returns rows enqueued.

        One impression row per instance, ids ``{base}#{row}`` so clicks
        attribute at item granularity while the sampling decision is
        made once per request on the base id (trace id, else routing
        key).  Serialization happens on the writer thread — the serving
        path pays one tuple enqueue per row, or a counted drop."""
        base = trace_id or key
        if not impression_sampled(base, self._sample_rate):
            self._c_sampled_out.inc(len(instances))
            return 0
        ts_ms = int(time.time() * 1000)
        enqueued = 0
        for row, (inst, score) in enumerate(zip(instances, scores)):
            # the serving request schema (serve/server.py): feat_ids /
            # feat_vals per instance
            item = (f"{base}#{row}", trace_id, tenant, int(model_version),
                    inst.get("feat_ids", ()), inst.get("feat_vals", ()),
                    float(score), deadline_class, ts_ms)
            try:
                self._q.put_nowait(item)
                enqueued += 1
            except queue.Full:
                self._c_dropped.inc()
        return enqueued

    # -- writer side --------------------------------------------------------
    def _write_one(self, item: tuple) -> None:
        (imp_id, trace_id, tenant, version, ids, values, score,
         deadline_class, ts_ms) = item
        record = serialize_impression(
            impression_id=imp_id, trace_id=trace_id, tenant=tenant,
            model_version=version, ids=ids, values=values, score=score,
            deadline_class=deadline_class, ts_ms=ts_ms)
        self._writer.append(record)
        self._c_logged.inc()

    def _run(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set():
                    return
                self._safe(self._writer.poll)
                continue
            if item is None:
                if self._stop.is_set():
                    return
                continue
            self._safe(self._write_one, item)
            self._safe(self._writer.poll)

    def _safe(self, fn, *args) -> None:
        try:
            fn(*args)
        # advisory by contract: a log-store outage costs impressions
        # (counted in errors_total), never a crash loop beside the router
        except Exception:
            self._c_errors.inc()

    def start(self) -> "ImpressionLogger":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="flywheel-impressions")
            self._thread.start()
        return self

    def stop(self) -> None:
        """Drain the queue, publish the tail segment, park the worker."""
        self.drain()
        self._stop.set()
        try:
            self._q.put_nowait(None)  # wake the worker past its timeout
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._safe(self._writer.flush)
        self._stop = threading.Event()

    def drain(self, timeout_secs: float = 10.0) -> None:
        """Block until the queue is empty (bench/test synchronization)."""
        deadline = time.monotonic() + timeout_secs
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.01)

    def flush(self) -> None:
        """Publish whatever the writer has buffered (tests/benches)."""
        self.drain()
        self._safe(self._writer.flush)

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        out = {
            "root": self.root,
            "sample_rate": self._sample_rate,
            "logged_total": int(self._c_logged.value),
            "sampled_out_total": int(self._c_sampled_out.value),
            "dropped_total": int(self._c_dropped.value),
            "errors_total": int(self._c_errors.value),
            "segments_published": self._writer.segments_published_total,
            "queue_depth": self._q.qsize(),
        }
        if self.join_output_url:
            from .join import load_status

            out["join"] = load_status(self.join_output_url)
        return out
