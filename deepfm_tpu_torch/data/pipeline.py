"""Host input pipeline: the port's copy of ``deepfm_tpu/data/pipeline.py``.

File mode.  ``make_input_pipeline`` globs ``<pattern>*.tfrecords`` under the
training directory (a local directory or an object-store prefix, listed with
ListObjectsV2), shuffles the FILE list with a seeded RNG (every rank draws
the same order) and reads it epoch after epoch through
``ctr_batches_from_sources``: round-robin record sharding (record i to shard
i % n, ``dataset.shard`` semantics: data/sharding.py's ``shard_plan`` for the
worker's topology), batches, and the decode of each whole batch.  That
decode runs in the C++ reader (``native/``), on several files at once where
it can (``parallel_ingest.py``); an object URL reaches it through a
``FifoBridge``, a named FIFO its writer thread fills from a streaming GET.
The pure-Python reader and decoder (``record_stream``,
``batched_ctr_batches``) give the same batches and run only when asked for
(``DEEPFM_NO_NATIVE=1`` or ``native=False``); they read URLs through a
resuming stream.  ``skip_batches`` is the resume skip: it passes over the
batches a run already trained on, undecoded, on every route.

Stream (Pipe) mode (``data.stream_mode``).  The training input is the
channel ``<dir>/<channel>`` (``-<k>`` added for local worker k under
``multi_path``), a FIFO that SageMaker's Pipe mode (or any writer) fills,
read once; a URL directory streams the channel object over HTTP.  A live
FIFO never repeats data, so stream mode ignores ``skip_batches``.

``shuffle_buffer`` > 0 shuffles records in windows (``shuffle_batches``,
seeded by ``seed + 7919 * epoch``) in both modes.  ``eval_batches`` reads
``va*``/``val*``/``eval*`` files in order, sharded the same way, and keeps
the tail batch.  ``InMemoryDataset`` decodes files once into arrays.
``Prefetcher`` runs any batch iterator ahead on a reader thread.

``permute_vocab`` (the callers pass ``model.feature_size`` when
``data.permute_ids`` is set) maps every batch's ids through the bijection
``parallel/embedding.py permute_ids`` on the host, as JAX's
``ctr_batches_from_sources`` does, on every route.
"""

from __future__ import annotations

import contextlib
import glob as globlib
import itertools
import os
import queue
import random
import threading
from typing import Iterable, Iterator

import numpy as np

from .. import native as native_reader
from ..core.config import DataConfig
from .example_proto import decode_ctr_batch
from .object_store import get_store, is_url
from .sharding import ShardDecision, WorkerTopology, shard_plan
from .tfrecord import read_records

EVAL_PATTERNS = ("va", "val", "eval")


def discover_files(
    data_dir: str, patterns: Iterable[str] = ("tr", "train"), *, shuffle: bool = True,
    seed: int | None = None,
) -> list[str]:
    """Recursive glob for ``<pattern>*.tfrecords`` / ``*.tfrecord``, sorted,
    then shuffled by ``random.Random(seed)`` when ``shuffle``.  An
    object-store ``data_dir`` (``http(s)://host/bucket/prefix``, the S3
    channel) is listed with ListObjectsV2 under the same name filter and
    the same seeded shuffle, so every host enumerates the same order."""
    files: list[str] = []
    patterns = tuple(patterns)
    if is_url(data_dir):
        base = data_dir.rstrip("/") + "/"
        for url in get_store().list_prefix(base):
            name = url.rsplit("/", 1)[-1]
            if name.startswith(patterns) and name.endswith((".tfrecords", ".tfrecord")):
                files.append(url)
    else:
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
    """The records of every source (files, FIFOs, object URLs), in order,
    record i kept when ``i % decision.num_shards == decision.shard_index``
    (all of them without a decision).  A URL streams through a live,
    drop-resuming HTTP body.  CRCs are checked only when asked: in pure
    Python they would cost more than the decode."""
    n = decision.num_shards if decision else 1
    mine = decision.shard_index if decision else 0
    idx = 0
    for src in sources:
        stream = get_store().open_read_resuming(src) if is_url(src) else None
        try:
            for rec in read_records(src if stream is None else stream, verify=verify_crc):
                if idx % n == mine:
                    yield rec
                idx += 1
        finally:
            if stream is not None:
                stream.close()


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
    decode).

    Object URLs among ``sources`` reach the C++ readers through one
    :class:`~deepfm_tpu_torch.data.object_store.FifoBridge` each.  A
    bridge's writer waits until a reader opens its FIFO, so the live HTTP
    streams are as many as the readers read at once, and memory is the
    pipe buffer.  After a complete read every bridge is finished (a
    transfer error that the reader took for EOF raises there); after an
    early exit each is closed quietly."""
    sources = [os.fspath(s) for s in sources]
    if native is None:
        native = native_reader.enabled()
    if native and any(is_url(s) for s in sources):
        yield from _bridged(sources, batch_size=batch_size, field_size=field_size,
                            decision=decision, drop_remainder=drop_remainder,
                            verify_crc=verify_crc, skip_counter=skip_counter,
                            parallel_readers=parallel_readers)
        return
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


def _bridged(sources: list[str], **kw) -> Iterator[dict]:
    """``ctr_batches_from_sources`` on the C++ route with each URL of
    ``sources`` behind a FIFO bridge in a temporary directory."""
    import tempfile

    from .object_store import FifoBridge

    with tempfile.TemporaryDirectory(prefix="deepfm_remote_") as td:
        bridges: list[FifoBridge] = []
        mapped: list[str] = []
        for i, src in enumerate(sources):
            if is_url(src):
                bridges.append(FifoBridge(src, td, f"{i:05d}_" + src.rsplit("/", 1)[-1]))
                mapped.append(bridges[-1].path)
            else:
                mapped.append(src)
        completed = False
        try:
            yield from ctr_batches_from_sources(mapped, native=True, **kw)
            completed = True
        finally:
            for b in bridges:
                if completed:
                    b.finish()
                else:
                    b.close()


def _permuted(batches: Iterator[dict], vocab: int) -> Iterator[dict]:
    from ..parallel.embedding import permute_ids

    for b in batches:
        b["feat_ids"] = permute_ids(b["feat_ids"], vocab, True)
        yield b


def shuffle_batches(batches: Iterator[dict], *, buffer_records: int,
                    seed: int = 0) -> Iterator[dict]:
    """The windowed record shuffle (``tf.data.shuffle(buffer_size)``; the
    reference declared ``perform_shuffle`` and never wired it): gather about
    ``buffer_records`` records, permute them with
    ``np.random.default_rng(seed)``, emit the front half as whole batches
    and keep the rest to mix with the next window; at the end every
    record left goes out.  Each record comes out exactly once, in batches
    of the input's size (the last may be short)."""
    rng = np.random.default_rng(seed)
    pool: list[dict] = []
    pooled = 0
    batch_size = None

    def drain(keep_tail: bool) -> Iterator[dict]:
        nonlocal pool, pooled
        if not pool:
            return
        merged = {k: np.concatenate([b[k] for b in pool]) for k in pool[0]}
        n = next(iter(merged.values())).shape[0]
        order = rng.permutation(n)
        emit = (n // 2 // batch_size) * batch_size if keep_tail else n
        for i in range(0, emit, batch_size):
            idx = order[i:i + batch_size]
            yield {k: v[idx] for k, v in merged.items()}
        tail = order[emit:]
        pool = [{k: v[tail] for k, v in merged.items()}] if tail.size else []
        pooled = tail.size

    for b in batches:
        if batch_size is None:
            batch_size = int(b["label"].shape[0])
        pool.append(b)
        pooled += int(b["label"].shape[0])
        if pooled >= buffer_records + batch_size:
            yield from drain(keep_tail=True)
    yield from drain(keep_tail=False)


class InMemoryDataset:
    """The decoded records of some files as three arrays: batches are
    slices, epochs cost nothing, and a record shuffle is a permutation
    (``np.random.default_rng(seed + epoch)``)."""

    def __init__(self, feat_ids: np.ndarray, feat_vals: np.ndarray, label: np.ndarray):
        self.feat_ids = feat_ids
        self.feat_vals = feat_vals
        self.label = label

    @classmethod
    def from_files(cls, files: Iterable[str], field_size: int, *,
                   decision: ShardDecision | None = None, permute_vocab: int = 0,
                   native: bool | None = None) -> "InMemoryDataset":
        batches = list(ctr_batches_from_sources(files, batch_size=8192,
                                                field_size=field_size, decision=decision,
                                                drop_remainder=False, native=native))
        if permute_vocab:
            batches = list(_permuted(iter(batches), permute_vocab))
        if not batches:
            return cls(np.zeros((0, field_size), np.int64),
                       np.zeros((0, field_size), np.float32), np.zeros((0,), np.float32))
        return cls(*(np.concatenate([b[k] for b in batches])
                     for k in ("feat_ids", "feat_vals", "label")))

    def __len__(self) -> int:
        return self.label.shape[0]

    def batches(self, batch_size: int, *, num_epochs: int = 1, drop_remainder: bool = True,
                shuffle: bool = False, seed: int = 0) -> Iterator[dict]:
        n = len(self)
        for epoch in range(num_epochs):
            order = np.arange(n)
            if shuffle:
                np.random.default_rng(seed + epoch).shuffle(order)
            end = n - (n % batch_size) if drop_remainder else n
            for i in range(0, end, batch_size):
                idx = order[i:i + batch_size]
                yield {"feat_ids": self.feat_ids[idx], "feat_vals": self.feat_vals[idx],
                       "label": self.label[idx]}


def channel_path(base_dir: str, channel: str, decision: ShardDecision | None = None) -> str:
    """A stream channel: ``<base_dir>/<channel>``, with ``-<k>`` for local
    worker k's own channel under ``multi_path`` (the reference's channel
    naming, hvd notebook cell 8); an object-URL base names the object."""
    k = decision.channel_index if decision is not None else 0
    name = f"{channel}-{k}" if k else channel
    if is_url(base_dir):
        return base_dir.rstrip("/") + "/" + name
    return os.path.join(base_dir, name)


def make_input_pipeline(
    cfg: DataConfig, topo: WorkerTopology | None = None, *, field_size: int,
    data_dir: str | None = None, num_epochs: int | None = None, seed: int = 0,
    skip_batches: int = 0, native: bool | None = None, permute_vocab: int = 0,
) -> Iterator[dict]:
    """Training batches of this worker's shard (``topo``; None is one
    worker).  File mode: ``num_epochs`` (default ``cfg.num_epochs``) passes
    over the files of ``data_dir`` (default ``cfg.training_data_dir``) in
    one seeded order, ``skip_batches`` passing over the first batches a run
    already trained on (resume), spread over the epochs, undecoded.
    Stream mode: one read of the channel ``cfg.training_channel_name``
    until its writer closes it;
    ``skip_batches`` is ignored.  ``cfg.shuffle_buffer`` shuffles the
    records of each epoch in both."""
    topo = topo or WorkerTopology(num_hosts=1, host_rank=0, workers_per_host=1,
                                  local_rank=0)
    decision = shard_plan(topo, stream_mode=cfg.stream_mode, pre_sharded=cfg.s3_shard,
                          multi_path=cfg.multi_path)
    base_dir = data_dir if data_dir is not None else cfg.training_data_dir

    def read(sources: list[str], epoch: int, skip_counter=None) -> Iterator[dict]:
        batches = ctr_batches_from_sources(
            sources, batch_size=cfg.batch_size, field_size=field_size,
            decision=decision, drop_remainder=cfg.drop_remainder,
            skip_counter=skip_counter, parallel_readers=cfg.parallel_readers,
            native=native)
        if permute_vocab:
            batches = _permuted(batches, permute_vocab)
        if cfg.shuffle_buffer > 0:
            batches = shuffle_batches(batches, buffer_records=cfg.shuffle_buffer,
                                      seed=seed + 7919 * epoch)
        return batches

    if cfg.stream_mode:
        yield from read([channel_path(base_dir, cfg.training_channel_name, decision)], 0)
        return
    files = discover_files(base_dir, cfg.file_patterns, shuffle=cfg.shuffle_files,
                           seed=seed)
    if not files:
        raise FileNotFoundError(
            f"no {tuple(cfg.file_patterns)}*.tfrecords under {base_dir!r}"
        )
    epochs = cfg.num_epochs if num_epochs is None else num_epochs
    skip_counter = [max(0, skip_batches)]
    for epoch in range(max(1, epochs)):
        yield from read(files, epoch, skip_counter)


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


def channel_eval_batches(cfg: DataConfig, path: str, *, field_size: int,
                         decision: ShardDecision | None = None, native: bool | None = None,
                         permute_vocab: int = 0) -> Iterator[dict]:
    """The batches of one read of the stream channel ``path`` (this worker's
    records, ``decision``), the tail batch kept, until the writer closes it
    or after ``cfg.eval_max_batches`` batches when that is > 0: then the
    reader lets go of the channel at once, so its writer sees the pipe
    closed."""
    batches = ctr_batches_from_sources([path], batch_size=cfg.batch_size,
                                       field_size=field_size, decision=decision,
                                       drop_remainder=False, native=native)
    with contextlib.closing(batches):
        if permute_vocab:
            batches = _permuted(batches, permute_vocab)
        if cfg.eval_max_batches > 0:
            batches = itertools.islice(batches, cfg.eval_max_batches)
        yield from batches


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
