"""Host input pipeline, file mode: a trimmed copy of
``deepfm_tpu/data/pipeline.py``.

``make_input_pipeline`` globs ``<pattern>*.tfrecords`` under the training
directory, shuffles the FILE list with a seeded RNG (the reference shuffles
no records; every rank draws the same order) and reads it epoch after
epoch through ``ctr_batches_from_sources``: round-robin record sharding
(record i to shard i % n, ``dataset.shard`` semantics: data/sharding.py's
``shard_plan`` for the worker's topology), batches, and the decode of
each whole batch.  That decode runs in the C++ reader (``native/``), on
several files at once where it can (``parallel_ingest.py``); the
pure-Python reader and decoder (``record_stream``,
``batched_ctr_batches``) give the same batches and run only when asked
for (``DEEPFM_NO_NATIVE=1`` or ``native=False``).  ``skip_batches`` is
the resume skip: it passes over the batches a run already trained on,
undecoded, on every route.  ``eval_batches`` reads ``va*``/``val*``/
``eval*`` files in order, sharded the same way, and keeps the tail batch.
``Prefetcher`` runs any batch iterator ahead on a reader thread.

``permute_vocab`` (the callers pass ``model.feature_size`` when
``data.permute_ids`` is set) maps every batch's ids through the bijection
``parallel/embedding.py permute_ids`` on the host, as JAX's
``ctr_batches_from_sources`` does, on every route.

Not ported yet (ROADMAP A6): object-store URLs (they raise), FIFO stream
mode and record-level shuffling (``shuffle_buffer``); the config refuses
both (``core/config.py JAX_ONLY_FIELDS``).
"""

from __future__ import annotations

import glob as globlib
import os
import queue
import random
import threading
from typing import Iterable, Iterator

from .. import native as native_reader
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
    if "://" in data_dir:
        raise NotImplementedError(
            f"{data_dir!r}: object-store URLs are not ported yet (ROADMAP A6); "
            f"give a local directory")
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
    drop_remainder: bool = True, skip_counter: list[int] | None = None,
) -> Iterator[dict]:
    """Records -> ``{"feat_ids" int64 [B, F], "feat_vals" f32 [B, F],
    "label" f32 [B]}`` numpy batches; a short tail batch only when
    ``drop_remainder`` is false.

    ``skip_counter`` is the input-position resume: a one-element list of
    whole batches to pass over without decoding them, decremented as they
    go by; the caller shares it across epochs to spread a skip over them."""
    n_skipped = 0
    buf: list[bytes] = []
    for rec in records:
        if skip_counter is not None and skip_counter[0] > 0:
            n_skipped += 1
            if n_skipped == batch_size:
                skip_counter[0] -= 1
                n_skipped = 0
            continue
        buf.append(rec)
        if len(buf) == batch_size:
            yield _decode(buf, field_size)
            buf = []
    if not drop_remainder:
        # a kept tail is a step, so a skip that ends inside it takes it
        if skip_counter is not None and skip_counter[0] > 0 and n_skipped:
            skip_counter[0] -= 1
        elif buf:
            yield _decode(buf, field_size)


def _decode(buf: list[bytes], field_size: int) -> dict:
    feats, labels = decode_ctr_batch(buf, field_size)
    return {"feat_ids": feats["feat_ids"], "feat_vals": feats["feat_vals"],
            "label": labels}


def _host_cpu_count() -> int:
    """The cores this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        return os.cpu_count() or 1


def ctr_batches_from_sources(
    sources: Iterable[str | os.PathLike], *, batch_size: int, field_size: int,
    decision: ShardDecision | None = None, drop_remainder: bool = True,
    verify_crc: bool | None = None, skip_counter: list[int] | None = None,
    parallel_readers: int = 1, native: bool | None = None,
) -> Iterator[dict]:
    """The decoded batches of ``sources``, this worker's records only
    (``decision``), by one of three routes that give the same batches:

    * the C++ reader (``native.NativeCtrReader``): framing, CRC, sharding
      and decode in one native call per batch;
    * several C++ readers at once (``parallel_ingest.py``) when there are
      several sources, one shard and ``parallel_readers`` > 1, capped at
      the host's cores;
    * the pure-Python reader and decoder (``record_stream`` then
      ``batched_ctr_batches``), only when asked for: ``native=False``, or
      ``native=None`` (the default) with ``DEEPFM_NO_NATIVE`` set.

    ``skip_counter`` works on every route.  ``verify_crc=None`` checks the
    CRCs natively (nearly free) and not in Python (dearer than the
    decode)."""
    sources = [os.fspath(s) for s in sources]
    if native is None:
        native = native_reader.enabled()
    if not native:
        yield from batched_ctr_batches(
            record_stream(sources, decision=decision, verify_crc=bool(verify_crc)),
            batch_size=batch_size, field_size=field_size,
            drop_remainder=drop_remainder, skip_counter=skip_counter)
        return
    shard_n = decision.num_shards if decision else 1
    shard_i = decision.shard_index if decision else 0
    verify = True if verify_crc is None else verify_crc
    threads = min(parallel_readers, _host_cpu_count())
    # under record sharding the sequential reader skips decoding the other
    # shards' records, which the parallel merger would decode: it stays
    if threads > 1 and len(sources) > 1 and shard_n == 1:
        from .parallel_ingest import parallel_ctr_batches

        yield from parallel_ctr_batches(
            sources, batch_size=batch_size, field_size=field_size,
            drop_remainder=drop_remainder, verify=verify, skip_counter=skip_counter,
            num_threads=threads)
        return
    yield from native_reader.NativeCtrReader(
        sources, batch_size=batch_size, field_size=field_size, shard_n=shard_n,
        shard_i=shard_i, drop_remainder=drop_remainder, verify=verify,
        skip_counter=skip_counter)


def _permuted(batches: Iterator[dict], vocab: int) -> Iterator[dict]:
    from ..parallel.embedding import permute_ids

    for b in batches:
        b["feat_ids"] = permute_ids(b["feat_ids"], vocab, True)
        yield b


def make_input_pipeline(
    cfg: DataConfig, topo: WorkerTopology | None = None, *, field_size: int,
    data_dir: str | None = None, num_epochs: int | None = None, seed: int = 0,
    skip_batches: int = 0, native: bool | None = None, permute_vocab: int = 0,
) -> Iterator[dict]:
    """Training batches of this worker's shard (``topo``; None is one
    worker): ``num_epochs`` (default ``cfg.num_epochs``) passes over the
    files of ``data_dir`` (default ``cfg.training_data_dir``) in one seeded
    order.  ``skip_batches`` passes over the first batches a run already
    trained on (resume), spread over the epochs, undecoded."""
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
    skip_counter = [max(0, skip_batches)]
    for _ in range(max(1, epochs)):
        batches = ctr_batches_from_sources(
            files, batch_size=cfg.batch_size, field_size=field_size,
            decision=decision, drop_remainder=cfg.drop_remainder,
            skip_counter=skip_counter, parallel_readers=cfg.parallel_readers,
            native=native)
        yield from _permuted(batches, permute_vocab) if permute_vocab else batches


def eval_batches(cfg: DataConfig, topo: WorkerTopology | None = None, *,
                 field_size: int, data_dir: str | None = None,
                 patterns: Iterable[str] = EVAL_PATTERNS,
                 native: bool | None = None, permute_vocab: int = 0) -> Iterator[dict]:
    """The ``va*``/``val*``/``eval*`` records (or ``patterns``') under
    ``data_dir`` (default ``cfg.val_data_dir``) of this worker's shard
    (``topo``; None is one worker, which reads every record), once, in file
    order, the tail batch kept.  Across the workers every record is read
    once."""
    base = data_dir if data_dir is not None else cfg.val_data_dir
    files = discover_files(base, patterns, shuffle=False)
    if not files:
        raise FileNotFoundError(
            f"no {'*/'.join(patterns)}* tfrecords under {base!r}")
    decision = None if topo is None else shard_plan(
        topo, stream_mode=False, pre_sharded=cfg.s3_shard)
    batches = ctr_batches_from_sources(files, batch_size=cfg.batch_size,
                                       field_size=field_size, decision=decision,
                                       drop_remainder=False, native=native)
    return _permuted(batches, permute_vocab) if permute_vocab else batches


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
