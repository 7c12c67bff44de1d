"""Append-only event logs for online training: the port's copy of
``deepfm_tpu/online/stream.py`` for local log roots.

An event log is a directory into which producers publish immutable
TFRecord *segments* with monotonically increasing names
(``segment_name(seq)``, zero-padded so that name order is publish order).
A segment appears whole: it is written under a ``_tmp.`` name, which a
tail skips, and renamed into place.

* A :class:`StreamCursor` ``(segment, record)`` says that every segment
  sorting before ``segment`` and ``record`` records of ``segment`` itself
  are consumed.  Cursors only move forward; a consumer that commits its
  cursor with its own state (``online/trainer.py``) applies each record
  exactly once.
* ``EventLogReader.watermark()`` is the publish time (mtime) of the
  newest fully consumed segment: every event at or before it was read.
* :class:`SegmentWriter` is the producer side with the size and age roll
  (the join's output, ``flywheel/join.py``).

The records decode with the port's ``data/example_proto.decode_ctr_batch``.
An object-store root (a URL, JAX's ``PrefixTail``) raises: ROADMAP A6 and
A15.  Segments strictly behind every consumer's cursor may be deleted;
never one at or ahead of a live cursor.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import BinaryIO, Iterator, NamedTuple, Sequence

import numpy as np

from ..data.example_proto import decode_ctr_batch, serialize_ctr_example
from ..data.tfrecord import frame_record, read_records
from ..obs import flight as obs_flight
from .publisher import check_local_root

_SEGMENT_SUFFIXES = (".tfrecords", ".tfrecord")

log = logging.getLogger(__name__)


class StreamCursor(NamedTuple):
    """Durable stream position: segments ``< segment`` are fully consumed,
    plus ``record`` records of ``segment`` itself.  ``StreamCursor()`` is
    the start of the log."""

    segment: str = ""
    record: int = 0

    def advanced_past(self, name: str) -> bool:
        """True when ``name`` is fully behind this cursor (never re-read)."""
        return bool(self.segment) and name < self.segment


def segment_name(seq: int, *, suffix: str = ".tfrecords") -> str:
    """Zero-padded so lexicographic order == numeric publish order."""
    return f"{seq:012d}{suffix}"


class DirectoryTail:
    """Tail a local directory of immutable TFRecord segments."""

    def __init__(self, path: str):
        self.path = check_local_root(path)

    def list_segments(self) -> list[str]:
        if not os.path.isdir(self.path):
            return []
        return sorted(
            name for name in os.listdir(self.path)
            if name.endswith(_SEGMENT_SUFFIXES)
            and not name.startswith((".", "_"))
            and os.path.isfile(os.path.join(self.path, name)))

    def open_segment(self, name: str) -> BinaryIO:
        return open(os.path.join(self.path, name), "rb")

    def segment_time(self, name: str) -> float:
        """Publish time (mtime: the rename that made the segment visible)."""
        try:
            return os.path.getmtime(os.path.join(self.path, name))
        except OSError:
            return 0.0


def open_tail(root: str) -> DirectoryTail:
    """The tail of a local event log; a URL raises (ROADMAP A6, A15)."""
    return DirectoryTail(root)


def publish_segment(root: str, name: str, payload: bytes) -> str:
    """Make one immutable segment visible atomically (producer side): written
    to a ``_tmp.`` name, which tails skip, and renamed into place.
    Re-publishing a name with identical bytes is a no-op in effect, which
    the join's publish-then-checkpoint crash window relies on.  Returns the
    segment name."""
    root = check_local_root(root)
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f"_tmp.{name}")
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, os.path.join(root, name))
    return name


def append_segment(root: str, labels: Sequence[float], ids: np.ndarray,
                   vals: np.ndarray, *, seq: int) -> str:
    """Publish one segment of CTR events (labels [N], ids [N, F], vals
    [N, F]) as segment ``seq``; returns its name."""
    payload = b"".join(frame_record(serialize_ctr_example(float(labels[i]), ids[i], vals[i]))
                       for i in range(len(labels)))
    return publish_segment(root, segment_name(seq), payload)


class SegmentWriter:
    """Buffered producer with the size/age segment roll.

    The buffer becomes the next segment when its framed bytes reach
    ``roll_bytes``, or when its oldest record has waited ``roll_age_secs``
    (checked by :meth:`poll`, which the owner ticks).  ``roll_bytes <= 0``
    turns the size trigger off and ``roll_age_secs <= 0`` the age trigger;
    with both off only :meth:`flush` publishes.  The size trigger is a pure
    function of the appended records, so a producer that must re-emit a
    bit-exact stream after a crash (the join) keeps the age trigger off.
    Sequence numbers continue after the segments already in ``root``.
    Single-writer: the owning thread appends and polls."""

    def __init__(self, root: str, *, roll_bytes: int = 1 << 20,
                 roll_age_secs: float = 10.0, start_seq: int | None = None,
                 clock=time.time):
        self.root = check_local_root(root)
        self._roll_bytes = int(roll_bytes)
        self._roll_age = float(roll_age_secs)
        self._clock = clock
        if start_seq is None:
            names = open_tail(root).list_segments()
            start_seq = int(names[-1].split(".", 1)[0]) + 1 if names else 0
        self._seq = int(start_seq)
        self._buf: list[bytes] = []
        self._buf_bytes = 0
        self._oldest: float | None = None
        self.segments_published_total = 0
        self.records_published_total = 0

    @property
    def next_seq(self) -> int:
        return self._seq

    @property
    def pending_records(self) -> int:
        return len(self._buf)

    def append(self, record: bytes) -> str | None:
        """Buffer one serialized record; returns the segment name when this
        append tripped the size trigger, else None."""
        framed = frame_record(record)
        if self._oldest is None:
            self._oldest = self._clock()
        self._buf.append(framed)
        self._buf_bytes += len(framed)
        if self._roll_bytes > 0 and self._buf_bytes >= self._roll_bytes:
            return self.flush()
        return None

    def poll(self) -> str | None:
        """Age trigger: publish the buffer once its oldest record has
        waited ``roll_age_secs``."""
        if self._buf and self._roll_age > 0 and self._clock() - self._oldest >= self._roll_age:
            return self.flush()
        return None

    def flush(self) -> str | None:
        """Publish every buffered record as the next segment (None when the
        buffer is empty: an empty segment is never published)."""
        if not self._buf:
            return None
        name = publish_segment(self.root, segment_name(self._seq), b"".join(self._buf))
        self.records_published_total += len(self._buf)
        self.segments_published_total += 1
        self._seq += 1
        self._buf = []
        self._buf_bytes = 0
        self._oldest = None
        return name


class EventLogReader:
    """Decode an event log into training batches with cursor tracking.

    Each item is ``(batch, cursor)``: ``batch`` the CTR host batch
    ({feat_ids [B, F] int64, feat_vals [B, F] f32, label [B] f32}) and
    ``cursor`` the position after it, so replay from a persisted cursor
    yields exactly the remaining records.  Batches may span segments; a
    trailing partial batch waits for more events (``follow=True``) or is
    flushed at the end of the log, at a stop and at the idle timeout.

    A segment read to its end has its record count cached (segments are
    immutable), so a tail poll skips it without reopening it.  In follow
    mode a segment whose read keeps failing is retried on
    ``max_segment_failures`` consecutive polls, then quarantined: skipped,
    counted and recorded in the flight recorder.  One-shot reads raise."""

    def __init__(self, source: DirectoryTail, *, field_size: int, batch_size: int,
                 poll_interval_secs: float = 0.2, max_segment_failures: int = 3):
        self._source = source
        self._fields = int(field_size)
        self._batch = int(batch_size)
        self._poll = float(poll_interval_secs)
        self._watermark = 0.0
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._max_segment_failures = max(1, int(max_segment_failures))
        self._fail_counts: dict[str, int] = {}
        self._quarantined: set[str] = set()
        self.segments_quarantined_total = 0
        self.read_failures_total = 0

    def watermark(self) -> float:
        """Publish time of the newest fully consumed segment (0.0 before
        any segment completes)."""
        with self._lock:
            return self._watermark

    def stats(self) -> dict:
        """The read-failure and quarantine counters (``quarantined`` lists
        the quarantined segments not yet behind the cursor)."""
        with self._lock:
            return {"read_failures_total": self.read_failures_total,
                    "segments_quarantined": self.segments_quarantined_total,
                    "quarantined": sorted(self._quarantined)}

    def _note_read_failure(self, name: str, err: BaseException) -> bool:
        """Count one failed read of ``name``; True once it crossed the
        quarantine threshold (it is then skipped)."""
        with self._lock:
            self.read_failures_total += 1
            n = self._fail_counts.get(name, 0) + 1
            self._fail_counts[name] = n
            quarantine = n >= self._max_segment_failures
            if quarantine:
                self._quarantined.add(name)
                self.segments_quarantined_total += 1
                self._fail_counts.pop(name, None)
        if quarantine:
            obs_flight.record("segment_quarantine", subsystem="stream", segment=name,
                              failures=n, error=f"{type(err).__name__}: {err}")
            log.warning("segment %s quarantined after %d failed reads (skipping it; "
                        "last error: %s)", name, n, err)
        else:
            log.warning("segment %s read failed (%d/%d before quarantine): %s",
                        name, n, self._max_segment_failures, err)
        return quarantine

    def _records_from(self, cursor: StreamCursor, *, suppress_errors: bool = False
                      ) -> Iterator[tuple[bytes, StreamCursor]]:
        """Raw records after ``cursor`` among the listed segments, each with
        the cursor that marks it consumed.  ``suppress_errors`` (follow
        mode) turns a failed read into a retry at the next poll and, past
        the threshold, a quarantine; otherwise a failed read raises."""
        for name in self._source.list_segments():
            if cursor.advanced_past(name):
                # behind the cursor for good: drop its bookkeeping
                self._counts.pop(name, None)
                with self._lock:
                    self._fail_counts.pop(name, None)
                    self._quarantined.discard(name)
                continue
            if suppress_errors and name in self._quarantined:
                continue
            skip = cursor.record if name == cursor.segment else 0
            known = self._counts.get(name)
            if known is not None and skip >= known:
                if skip > known:
                    raise ValueError(
                        f"segment {name!r} has {known} records but the cursor claims "
                        f"{skip} consumed — segments must be immutable")
                self._bump_watermark(name)
                continue
            idx = 0
            try:
                with self._source.open_segment(name) as f:
                    for rec in read_records(f):
                        idx += 1
                        if idx <= skip:
                            continue
                        yield rec, StreamCursor(segment=name, record=idx)
            except OSError as e:
                if not suppress_errors:
                    with self._lock:
                        self.read_failures_total += 1
                    raise
                if idx > skip:
                    # new records came before the failure: resume next poll
                    with self._lock:
                        self.read_failures_total += 1
                        self._fail_counts.pop(name, None)
                    log.warning("segment %s read failed after yielding %d new records "
                                "(will resume next poll): %s", name, idx - skip, e)
                    return
                if self._note_read_failure(name, e):
                    continue
                return
            with self._lock:
                self._fail_counts.pop(name, None)
            self._counts[name] = idx
            if idx < skip:
                raise ValueError(
                    f"segment {name!r} has {idx} records but the cursor claims {skip} "
                    f"consumed — segments must be immutable")
            self._bump_watermark(name)

    def _bump_watermark(self, name: str) -> None:
        with self._lock:
            self._watermark = max(self._watermark, self._source.segment_time(name))

    def batches(self, cursor: StreamCursor = StreamCursor(), *, follow: bool = False,
                stop: threading.Event | None = None, idle_timeout_secs: float = 0.0,
                max_batches: int = 0) -> Iterator[tuple[dict, StreamCursor]]:
        """Batches from ``cursor`` on.  ``follow=False`` reads the log as it
        stands and flushes a final partial batch; ``follow=True`` polls for
        new segments every ``poll_interval_secs`` until ``stop`` is set,
        ``idle_timeout_secs`` pass without a new record (0: never) or
        ``max_batches`` were yielded (0: no limit).  A stop or the idle
        timeout flushes the partial buffer as a short batch."""
        buf: list[tuple[bytes, StreamCursor]] = []
        yielded = 0
        last_progress = time.time()
        while True:
            progressed = False
            try:
                for rec, rec_cursor in self._records_from(buf[-1][1] if buf else cursor,
                                                          suppress_errors=follow):
                    buf.append((rec, rec_cursor))
                    progressed = True
                    if len(buf) >= self._batch:
                        yield self._decode(buf)
                        cursor = buf[-1][1]
                        buf = []
                        yielded += 1
                        if max_batches and yielded >= max_batches:
                            return
                    if stop is not None and stop.is_set():
                        break
            except OSError as e:
                # a failed listing: a tail outlives it, a one-shot read raises
                if not follow:
                    raise
                with self._lock:
                    self.read_failures_total += 1
                log.warning("event-log poll failed (will retry): %s", e)
            if progressed:
                last_progress = time.time()
            if stop is not None and stop.is_set():
                break
            if not follow:
                break
            if idle_timeout_secs > 0 and time.time() - last_progress >= idle_timeout_secs:
                break
            if stop is not None:
                stop.wait(self._poll)
            else:
                time.sleep(self._poll)
        if buf:
            yield self._decode(buf)

    def _decode(self, buf: list[tuple[bytes, StreamCursor]]) -> tuple[dict, StreamCursor]:
        feats, labels = decode_ctr_batch((r for r, _ in buf), self._fields)
        return {**feats, "label": labels}, buf[-1][1]
