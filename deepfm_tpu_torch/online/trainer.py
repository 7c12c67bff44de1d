"""Online training over an event log: the port's copy of
``deepfm_tpu/online/trainer.py``.

A long-lived trainer tails the event log (``online/stream.py``) in batches
through the same single-card step as the train task (``train/step.py
train_step``: dense, or lazy Adam on the tables under
``optimizer.lazy_embedding_updates``; on the card its forward and backward
launch the B1 and B1′ kernels), and periodically

* **commits** ``{train state, stream cursor}`` as one checkpoint step
  (:class:`OnlinePayload`, ``checkpoint/ckpt.py``): the save blocks until
  the file is synced and renamed, and the step must then be listed, so a
  restart restores weights and position from the same snapshot — a batch
  the committed weights contain is never applied again, and one consumed
  after the commit is replayed;
* **publishes** a versioned servable with its manifest written last
  (``online/publisher.py``), which a running server's ``HotSwapper``
  swaps in (``serve/reload.py``).

Commit precedes publish: a crash between the two leaves a committed cursor
and no manifest, and the next publish carries more steps.  A stop (SIGTERM
or SIGINT under :func:`run_online_train`) flushes the reader's partial
batch (``EventLogReader.batches``), trains it, then commits and publishes:
a stopped and resumed run equals one pass over the same records cut at the
committed cursor (:func:`replay_to_state` with ``cuts``).

Single process by design (one logical writer): the trainer raises at a
world size above 1, as JAX's does with more than one process; the elastic
trainer (elastic/controller.py) is the grid's online trainer.
:func:`commit_payload` takes JAX's ``fence`` (elastic/coord.py ``Fence``):
a stale token is refused before the save, the payload records the
token (0: the unfenced single writer), and the root's mark advances
after.  Left out: JAX's ``_LegacyOnlinePayload`` (commits written before
JAX's fencing token; the port never wrote one).  The event log, the
``model_dir`` and the publish root may be object-store URLs.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from ..checkpoint import make_checkpointer
from ..core.config import Config
from ..core.platform import resolve_device
from ..ops import fused_ctr
from ..train.step import TrainState, create_train_state, train_step
from ..utils.logging import MetricLogger
from .publisher import ModelPublisher
from .stream import EventLogReader, StreamCursor, open_tail

# a fixed-width cursor: the segment name rides in a padded uint8 buffer
_CURSOR_BYTES = 256


def cursor_to_arrays(cursor: StreamCursor) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    raw = cursor.segment.encode()
    if len(raw) > _CURSOR_BYTES:
        raise ValueError(f"segment name {cursor.segment!r} exceeds {_CURSOR_BYTES} bytes")
    seg = np.zeros((_CURSOR_BYTES,), np.uint8)
    seg[:len(raw)] = np.frombuffer(raw, np.uint8)
    return seg, np.asarray(len(raw), np.int32), np.asarray(cursor.record, np.int64)


def cursor_from_arrays(seg: np.ndarray, length: np.ndarray, record: np.ndarray) -> StreamCursor:
    raw = bytes(np.asarray(seg, np.uint8)[:int(length)])
    return StreamCursor(segment=raw.decode(), record=int(record))


class OnlinePayload(NamedTuple):
    """The unit of online durability: the train state and the stream
    position it already contains, saved and restored together.  ``step``
    mirrors ``train.step``; ``fence_token`` is the writer's fencing token
    (0: the unfenced single writer)."""

    step: int
    train: TrainState
    cursor_segment: np.ndarray   # uint8 [256], zero-padded
    cursor_len: np.ndarray       # int32 scalar
    cursor_record: np.ndarray    # int64 scalar
    fence_token: np.ndarray      # int64 scalar; 0 = unfenced

    @classmethod
    def wrap(cls, train: TrainState, cursor: StreamCursor, *,
             fence_token: int = 0) -> "OnlinePayload":
        seg, length, record = cursor_to_arrays(cursor)
        return cls(step=train.step, train=train, cursor_segment=seg, cursor_len=length,
                   cursor_record=record, fence_token=np.asarray(int(fence_token), np.int64))

    def cursor(self) -> StreamCursor:
        return cursor_from_arrays(self.cursor_segment, self.cursor_len, self.cursor_record)


def commit_payload(ckpt, state: TrainState, cursor: StreamCursor, *, fence=None) -> None:
    """Persist {weights, optimizer state, cursor} as one step: the
    exactly-once boundary.  The save waits for the card, the write, the
    fsync and the rename, then the step must be among the checkpointer's
    steps: a save that never landed raises here, before any later batch is
    consumed.  A kill during the write leaves a temporary directory that is
    never listed.  ``fence`` (elastic/coord.py ``Fence``) refuses a stale
    writer first (``StaleFencingTokenError``), the payload records its
    token, and a durable commit advances the root's mark."""
    step = int(state.step)
    token = 0
    if fence is not None:
        fence.check()
        token = fence.token
    ckpt.save(OnlinePayload.wrap(state, cursor, fence_token=token), block=True)
    if step not in ckpt.all_steps():
        raise RuntimeError(
            f"commit at step {step} did not become durable (committed steps: "
            f"{ckpt.all_steps()}) — refusing to consume past an unpersisted cursor")
    if fence is not None:
        fence.advance()


def restore_latest_payload(ckpt, template: OnlinePayload) -> OnlinePayload:
    """The newest readable payload, falling back across unreadable steps (a
    step renamed into place but torn by the storage); each skipped step is
    logged.  Raises when no step is readable."""
    steps = sorted(ckpt.all_steps(), reverse=True)
    if not steps:
        raise FileNotFoundError("no checkpoint to restore")
    last_err: Exception | None = None
    for s in steps:
        try:
            return ckpt.restore(template, step=s)
        except Exception as e:  # an unreadable step: try the one before
            last_err = e
            logging.getLogger(__name__).warning(
                "checkpoint step %d unreadable (%s: %s) — falling back to the previous "
                "complete payload", s, type(e).__name__, e)
    raise RuntimeError(f"every checkpoint step {steps} is unreadable; last error: "
                       f"{type(last_err).__name__}: {last_err}") from last_err


def _on_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _ms_stats(values: list[float], name: str) -> dict:
    if not values:
        return {f"{name}_p50": None, f"{name}_max": None}
    return {f"{name}_p50": float(np.percentile(values, 50)), f"{name}_max": max(values)}


class OnlineTrainer:
    """Drive the single-card train step over a tailed event log.

      * event log    = ``cfg.data.training_data_dir``
      * checkpoints  = ``cfg.run.model_dir`` (the cursor rides inside)
      * publish root = ``cfg.run.servable_model_dir`` (versioned manifests,
        ``max(2, run.keep_checkpoints)`` kept, or
        ``regions.publish_keep_window`` where larger)

    ``device`` is the card unless the caller passes ``"cpu"``."""

    def __init__(self, cfg: Config, *, device=None):
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise ValueError("online training is single-process (one logical writer); "
                             "multi-host serving scales on the read side instead")
        if cfg.model.model_name == "two_tower":
            raise ValueError("online training covers the CTR families; the two-tower "
                             "ratings feed has no event-log schema yet")
        self.cfg = cfg
        if not cfg.data.training_data_dir:
            raise ValueError("online training needs data.training_data_dir "
                             "(the event-log directory or URL)")
        if not cfg.run.servable_model_dir:
            raise ValueError("online training needs run.servable_model_dir "
                             "(the versioned publish root)")
        self.device = resolve_device(device)
        self.reader = EventLogReader(open_tail(cfg.data.training_data_dir),
                                     field_size=cfg.model.field_size,
                                     batch_size=cfg.data.batch_size)
        self.publisher = ModelPublisher(cfg.run.servable_model_dir,
                                        keep=max(2, cfg.run.keep_checkpoints),
                                        keep_window=cfg.regions.publish_keep_window)
        self._log = MetricLogger(log_steps=cfg.run.log_steps)
        self.commit_ms: list[float] = []
        self.publish_ms: list[float] = []

    def _commit(self, ckpt, state: TrainState, cursor: StreamCursor) -> None:
        t0 = time.perf_counter()
        commit_payload(ckpt, state, cursor)
        self.commit_ms.append(1e3 * (time.perf_counter() - t0))

    def _publish(self, state: TrainState, cursor: StreamCursor) -> None:
        t0 = time.perf_counter()
        manifest = self.publisher.publish(
            self.cfg, state.model.state_dict(), step=state.step,
            cursor={"segment": cursor.segment, "record": cursor.record},
            watermark=self.reader.watermark())
        self.publish_ms.append(1e3 * (time.perf_counter() - t0))
        self._log.event("publish", version=manifest.version, step=manifest.step,
                        param_hash=manifest.param_hash[:12], publish_ms=self.publish_ms[-1])

    def run(self, *, follow: bool = True, max_batches: int = 0,
            stop: threading.Event | None = None, idle_timeout_secs: float = 0.0,
            publish_every_steps: int | None = None,
            on_commit: Callable[[TrainState, StreamCursor], None] | None = None
            ) -> TrainState:
        """Consume the stream until it ends (``follow=False``), ``stop`` is
        set, ``idle_timeout_secs`` pass with no new event, or
        ``max_batches`` were applied; returns the final state, committed and
        published.  ``on_commit`` runs after every durable commit, before
        its publish (the crash window the resume tests exercise).

        The ``online_done`` event carries, from the start of the loop to
        its last step (the final wait for the stream's end, a stop or the
        idle timeout left out), the examples/s and the share of that time
        spent waiting on the reader (record reads and decode, and polls for
        new segments when following); the commit and publish times; and the
        B1/B1′ kernel launches of this run (0 on the CPU)."""
        cfg = self.cfg
        publish_every = (cfg.run.online_publish_every_steps
                         if publish_every_steps is None else publish_every_steps)
        ckpt_every = max(1, cfg.run.checkpoint_every_steps)
        ckpt = make_checkpointer(cfg.run.model_dir, max_to_keep=cfg.run.keep_checkpoints)
        state = create_train_state(cfg, self.device)
        cursor = StreamCursor()
        if ckpt.latest_step() is not None:
            # weights and cursor roll back together: the replayed tail
            # applies exactly once
            cursor = restore_latest_payload(ckpt, OnlinePayload.wrap(state, cursor)).cursor()
            self._log.event("online_resume", step=state.step, segment=cursor.segment,
                            record=cursor.record)
        step = state.step
        self._log.seed_step(step)
        applied = examples = 0
        last_committed, last_published = step, -1
        launches0 = fused_ctr.launches, fused_ctr.backward_launches
        batches: Iterator = self.reader.batches(cursor, follow=follow, stop=stop,
                                                idle_timeout_secs=idle_timeout_secs,
                                                max_batches=max_batches)
        wait_s = 0.0
        t_start = t_last = time.perf_counter()
        try:
            while True:
                item = next(batches, None)
                if item is None:
                    break
                wait_s += time.perf_counter() - t_last
                batch, cursor = item
                n = int(batch["label"].shape[0])
                metrics = train_step(state, _on_device(batch, self.device))
                step = state.step
                applied += 1
                examples += n
                self._log.step(step, n, metrics)
                publish_now = bool(publish_every) and step % publish_every == 0
                if step % ckpt_every == 0 or publish_now:
                    self._commit(ckpt, state, cursor)
                    last_committed = step
                    if on_commit is not None:
                        on_commit(state, cursor)
                if publish_now:
                    self._publish(state, cursor)
                    last_published = step
                t_last = time.perf_counter()
            # the end of the stream, a stop or the idle timeout: make the
            # tail durable, then visible
            if step != last_committed:
                self._commit(ckpt, state, cursor)
                if on_commit is not None:
                    on_commit(state, cursor)
            if applied and step != last_published:
                self._publish(state, cursor)
            seconds = t_last - t_start
            self._log.event(
                "online_done", step=step, applied=applied, segment=cursor.segment,
                record=cursor.record, examples=examples, seconds=seconds,
                examples_per_sec=examples / seconds if seconds > 0 else 0.0,
                input_wait_share=wait_s / seconds if seconds > 0 else 0.0,
                commits=len(self.commit_ms), **_ms_stats(self.commit_ms, "commit_ms"),
                publishes=len(self.publish_ms), **_ms_stats(self.publish_ms, "publish_ms"),
                forward_launches=fused_ctr.launches - launches0[0],
                backward_launches=fused_ctr.backward_launches - launches0[1])
        finally:
            batches.close()
            ckpt.close()
        return state


def run_online_train(cfg: Config, *, device=None) -> TrainState:
    """The ``online-train`` task (launch/cli.py): tail the event log until
    SIGTERM/SIGINT (the final commit and publish happen before the return,
    and the command exits 0), ``run.online_max_batches`` or
    ``run.online_idle_timeout_secs``."""
    import signal

    trainer = OnlineTrainer(cfg, device=device)
    stop = threading.Event()
    restore: list[tuple] = []
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            restore.append((sig, signal.signal(sig, lambda *_: stop.set())))
    try:
        return trainer.run(follow=True, stop=stop, max_batches=cfg.run.online_max_batches,
                           idle_timeout_secs=cfg.run.online_idle_timeout_secs)
    finally:
        for sig, prev in restore:
            signal.signal(sig, prev)


def _cut_batches(reader: EventLogReader, cuts, max_batches: int
                 ) -> Iterator[tuple[dict, StreamCursor]]:
    """The log as it stands in batches of the reader's size, each batch
    also ending at every cursor of ``cuts``."""
    cuts = set(cuts)
    buf: list = []
    yielded = 0
    for rec, cursor in reader._records_from(StreamCursor()):
        buf.append((rec, cursor))
        if len(buf) >= reader._batch or cursor in cuts:
            yield reader._decode(buf)
            buf = []
            yielded += 1
            if max_batches and yielded >= max_batches:
                return
    if buf:
        yield reader._decode(buf)


def replay_to_state(cfg: Config, *, max_batches: int = 0, cuts=(), device=None
                    ) -> TrainState:
    """Reference oracle: train from scratch over the whole log in one pass
    (no checkpoint, no publish).  ``cuts`` are cursors at which a batch
    ends short: a run stopped by a signal trains its partial batch up to
    its committed cursor, and its resume starts a fresh batch there, so it
    equals this pass with ``cuts=[that cursor]``.  A crash after a commit
    (no flush) equals it with no cuts."""
    reader = EventLogReader(open_tail(cfg.data.training_data_dir),
                            field_size=cfg.model.field_size, batch_size=cfg.data.batch_size)
    state = create_train_state(cfg, device)
    dev = state.model.fm_v.device
    for batch, _ in _cut_batches(reader, cuts, max_batches):
        train_step(state, _on_device(batch, dev))
    return state


__all__ = [
    "OnlinePayload",
    "OnlineTrainer",
    "commit_payload",
    "cursor_from_arrays",
    "cursor_to_arrays",
    "replay_to_state",
    "restore_latest_payload",
    "run_online_train",
]
