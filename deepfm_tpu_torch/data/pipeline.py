"""Host input pipeline, file mode: a trimmed copy of
``deepfm_tpu/data/pipeline.py``.

``make_input_pipeline`` globs ``<pattern>*.tfrecords`` under the training
directory, shuffles the FILE list with a seeded RNG (the reference shuffles
no records; every rank draws the same order), streams the records
(``record_stream``) with round-robin record sharding (record i to shard
i % n, ``dataset.shard`` semantics: data/sharding.py's ``shard_plan`` for
the worker's topology), batches them and decodes each whole batch
(``batched_ctr_batches``), epoch after epoch.  ``eval_batches`` reads
``va*``/``val*``/``eval*`` files in order, sharded the same way, and keeps
the tail batch.  ``Prefetcher`` runs any batch iterator ahead on a reader
thread.

Not ported yet (ROADMAP A6): the native C++ reader (host code), object-store
URLs, FIFO stream mode, record-level shuffling, id permutation and the
resume skip.
"""

from __future__ import annotations

import glob as globlib
import os
import queue
import random
import threading
from typing import Iterable, Iterator

from ..core.config import DataConfig
from .example_proto import decode_ctr_batch
from .sharding import ShardDecision, WorkerTopology, shard_plan
from .tfrecord import read_records

EVAL_PATTERNS = ("va", "val", "eval")


def discover_files(
    data_dir: str, patterns: Iterable[str] = ("tr", "train"), *, shuffle: bool = True,
    seed: int | None = None,
) -> list[str]:
    """Recursive glob for ``<pattern>*.tfrecords`` / ``*.tfrecord``, sorted,
    then shuffled by ``random.Random(seed)`` when ``shuffle``."""
    files: list[str] = []
    for pat in patterns:
        for ext in ("tfrecords", "tfrecord"):
            files.extend(globlib.glob(os.path.join(data_dir, "**", f"{pat}*.{ext}"),
                                      recursive=True))
    files = sorted(set(files))
    if shuffle:
        random.Random(seed).shuffle(files)
    return files


def record_stream(sources: Iterable[str | os.PathLike], *,
                  decision: ShardDecision | None = None,
                  verify_crc: bool = False) -> Iterator[bytes]:
    """The records of every source file, in order, record i kept when
    ``i % decision.num_shards == decision.shard_index`` (all of them
    without a decision).  CRCs are checked only when asked: in pure Python
    they would cost more than the decode."""
    n = decision.num_shards if decision else 1
    mine = decision.shard_index if decision else 0
    idx = 0
    for src in sources:
        for rec in read_records(src, verify=verify_crc):
            if idx % n == mine:
                yield rec
            idx += 1


def batched_ctr_batches(
    records: Iterator[bytes], *, batch_size: int, field_size: int,
    drop_remainder: bool = True,
) -> Iterator[dict]:
    """Records -> ``{"feat_ids" int64 [B, F], "feat_vals" f32 [B, F],
    "label" f32 [B]}`` numpy batches; a short tail batch only when
    ``drop_remainder`` is false."""
    buf: list[bytes] = []
    for rec in records:
        buf.append(rec)
        if len(buf) == batch_size:
            yield _decode(buf, field_size)
            buf = []
    if buf and not drop_remainder:
        yield _decode(buf, field_size)


def _decode(buf: list[bytes], field_size: int) -> dict:
    feats, labels = decode_ctr_batch(buf, field_size)
    return {"feat_ids": feats["feat_ids"], "feat_vals": feats["feat_vals"],
            "label": labels}


def make_input_pipeline(
    cfg: DataConfig, topo: WorkerTopology | None = None, *, field_size: int,
    data_dir: str | None = None, num_epochs: int | None = None, seed: int = 0,
) -> Iterator[dict]:
    """Training batches of this worker's shard (``topo``; None is one
    worker): ``num_epochs`` (default ``cfg.num_epochs``) passes over the
    files of ``data_dir`` (default ``cfg.training_data_dir``) in one seeded
    order."""
    decision = None if topo is None else shard_plan(
        topo, stream_mode=False, pre_sharded=cfg.s3_shard)
    base_dir = data_dir if data_dir is not None else cfg.training_data_dir
    files = discover_files(base_dir, cfg.file_patterns, shuffle=cfg.shuffle_files,
                           seed=seed)
    if not files:
        raise FileNotFoundError(
            f"no {tuple(cfg.file_patterns)}*.tfrecords under {base_dir!r}"
        )
    epochs = cfg.num_epochs if num_epochs is None else num_epochs
    for _ in range(max(1, epochs)):
        yield from batched_ctr_batches(
            record_stream(files, decision=decision), batch_size=cfg.batch_size,
            field_size=field_size, drop_remainder=cfg.drop_remainder)


def eval_batches(cfg: DataConfig, topo: WorkerTopology | None = None, *,
                 field_size: int, data_dir: str | None = None) -> Iterator[dict]:
    """The ``va*``/``val*``/``eval*`` records under ``data_dir`` (default
    ``cfg.val_data_dir``) of this worker's shard (``topo``; None is one
    worker, which reads every record), once, in file order, the tail batch
    kept.  Across the workers every record is read once."""
    base = data_dir if data_dir is not None else cfg.val_data_dir
    files = discover_files(base, EVAL_PATTERNS, shuffle=False)
    if not files:
        raise FileNotFoundError(f"no va*/val*/eval* tfrecords under {base!r}")
    decision = None if topo is None else shard_plan(
        topo, stream_mode=False, pre_sharded=cfg.s3_shard)
    return batched_ctr_batches(record_stream(files, decision=decision),
                               batch_size=cfg.batch_size, field_size=field_size,
                               drop_remainder=False)


class Prefetcher:
    """Runs ``batches`` on a daemon reader thread, ``depth`` items ahead of
    the consumer.  An exception in the reader is raised from ``next``.
    Call ``close()`` (or use as a context manager) when stopping early, or
    the reader stays blocked on its full queue."""

    _DONE = object()

    def __init__(self, batches: Iterator[dict], *, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: BaseException | None = None
        self._stop = threading.Event()

        def offer(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in batches:
                    if not offer(b):
                        return
            except BaseException as e:  # raised by __next__ on the consumer
                self._err = e
            finally:
                offer(self._DONE)

        self._thread = threading.Thread(target=worker, name="input-prefetch",
                                        daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            # keep the sentinel: next() after exhaustion raises again
            self._q.put(item)
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the reader and drop the batches it holds."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
