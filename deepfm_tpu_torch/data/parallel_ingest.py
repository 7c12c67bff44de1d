"""Several training files decoded at once: a copy of
``deepfm_tpu/data/parallel_ingest.py``.

Each source gets its own C++ reader (``native.NativeCtrReader``) on a
thread of its own; ``ctypes`` releases the interpreter lock for each call,
so the framing, CRC and decode of K sources run on K cores.  Each reader
fills a bounded queue of row chunks, and the merger drains the queues in
source order, so the batches are the sequential reader's over the same
source list, in the same order: parallelism changes the timing, never the
batches.

Round-robin record sharding (record i to shard i % n) is a stride over the
merged stream, exact for the same reason.  The sequential reader skips
decoding other shards' records and this one decodes them all, so the
pipeline takes this path only with one shard (``pipeline.py``).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Sequence

import numpy as np

from ..native import NativeCtrReader

_DONE = object()
_KEYS = ("feat_ids", "feat_vals", "label")


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class _Rebatcher:
    """Cuts a stream of row chunks of any length into batches of
    ``batch_size``; copies only across chunk boundaries."""

    def __init__(self, batch_size: int):
        self._b = batch_size
        self._parts: list[dict] = []
        self._have = 0

    def add(self, chunk: dict) -> None:
        n = int(chunk["label"].shape[0])
        if n:
            self._parts.append(chunk)
            self._have += n

    def pop(self) -> dict | None:
        """One full batch, or None while fewer rows are held."""
        if self._have < self._b:
            return None
        take, got = [], 0
        while got < self._b:
            part = self._parts.pop(0)
            n = int(part["label"].shape[0])
            need = self._b - got
            if n > need:
                self._parts.insert(0, {k: part[k][need:] for k in _KEYS})
                part = {k: part[k][:need] for k in _KEYS}
                n = need
            take.append(part)
            got += n
        self._have -= self._b
        if len(take) == 1:
            return take[0]
        return {k: np.concatenate([p[k] for p in take]) for k in _KEYS}

    def tail(self) -> dict | None:
        if not self._have:
            return None
        batch = {k: np.concatenate([p[k] for p in self._parts]) for k in _KEYS}
        self._parts, self._have = [], 0
        return batch


def parallel_ctr_batches(
    sources: Sequence[str | os.PathLike], *, batch_size: int, field_size: int,
    shard_n: int = 1, shard_i: int = 0, drop_remainder: bool = True,
    verify: bool = True, skip_counter: list[int] | None = None,
    num_threads: int = 4, chunk_records: int = 4096, queue_chunks: int = 2,
) -> Iterator[dict]:
    """The batches of ``pipeline.ctr_batches_from_sources``'s sequential
    native route over ``sources`` (same shard, skip and tail rules), with
    up to ``num_threads`` sources decoded at once."""
    srcs = [os.fspath(s) for s in sources]
    if not srcs:
        return
    qs = [queue.Queue(maxsize=max(1, queue_chunks)) for _ in srcs]
    stop = threading.Event()
    next_src = [0]
    pick_lock = threading.Lock()

    def offer(q: queue.Queue, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        while not stop.is_set():
            with pick_lock:
                i = next_src[0]
                if i >= len(srcs):
                    return
                next_src[0] += 1
            try:
                for chunk in NativeCtrReader([srcs[i]], batch_size=chunk_records,
                                             field_size=field_size,
                                             drop_remainder=False, verify=verify):
                    if not offer(qs[i], chunk):
                        return
            except BaseException as e:  # handed to the merger, which raises it
                offer(qs[i], _WorkerError(e))
                return  # no further source after a failure
            finally:
                offer(qs[i], _DONE)

    threads = [threading.Thread(target=worker, name=f"native-reader-{t}", daemon=True)
               for t in range(max(1, min(num_threads, len(srcs))))]
    for t in threads:
        t.start()

    rb = _Rebatcher(batch_size)
    phase = 0  # global record index mod shard_n, across the sources

    def skipped() -> bool:
        if skip_counter is not None and skip_counter[0] > 0:
            skip_counter[0] -= 1
            return True
        return False

    try:
        for q in qs:
            while (item := q.get()) is not _DONE:
                if isinstance(item, _WorkerError):
                    raise item.exc
                if shard_n > 1:
                    n = int(item["label"].shape[0])
                    start = (shard_i - phase) % shard_n
                    phase = (phase + n) % shard_n
                    item = {k: item[k][start::shard_n] for k in _KEYS}
                rb.add(item)
                while (batch := rb.pop()) is not None:
                    if not skipped():
                        yield batch
        tail = rb.tail()
        # a kept tail is a step, so a pending skip takes it
        if not drop_remainder and tail is not None and not skipped():
            yield tail
    finally:
        stop.set()
        for q in qs:  # frees a worker blocked on a full queue
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for t in threads:
            t.join(timeout=5)
