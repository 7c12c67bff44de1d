"""Elastic online training with a live N -> M reshard: the port's
counterpart of ``deepfm_tpu/elastic/controller.py`` (``ElasticTrainer``,
``run_elastic_train``).

JAX's trainer is one controller over the devices it sees.  The port runs
its grid with one process a rank (parallel/mesh.py), so this is JAX's
multi-process form: **one ElasticTrainer in every rank process**.

* **Devices.**  A device id is the process's launch index
  (``ELASTIC_DEVICE_ID``), given once.  Each process wraps its local
  registry in the coordinator's ``CoordinatedRegistry`` (elastic/coord.py)
  and reads its view from the rendezvous store's device board
  (elastic/registry.py ``DeviceBoard``).  A world of one process needs no
  coordinator: it trains at ``[1, 1]`` without a group.
* **An epoch's grid.**  A rank's place is the position of its id in the
  consensus device tuple; ``choose_mesh(len(devices),
  prefer_model_parallel)`` gives ``[dp, mp]`` and rank ``r`` sits at
  ``(r // mp, r % mp)``.  The group of epoch ``e`` is
  ``init_process_group(store=PrefixStore("epoch-e/", store))``, after an
  arrival count in the store shows every rank of the epoch there (a rank
  that sees a newer epoch first calls the epoch off for all, and so does
  one that waited ``ARRIVAL_TTLS`` lease TTLs, which then raises); then
  the model and data groups, in ``parallel/mesh.py``'s order.  The group
  is gloo on the CPU and where the epoch's ranks outnumber the cards
  (NCCL refuses two ranks a card), NCCL otherwise.
* **Lockstep.**  Before every batch the ranks all-reduce four flags: some
  rank has no batch, some rank's registry moved to another epoch, some
  rank was asked to stop, and the batch sizes.  So every rank drains at
  the same batch, ends the stream at the same point and applies the same
  batches (every rank reads the same batches from the committed cursor
  and keeps its data index's rows, as JAX's ``shard_batch`` does).
* **The transition** (JAX's ``_reshard``): detect -> drain (the last
  step is done; every rank saves the commit, the ranks at data index 0
  their ``rows-<i>.pt``, rank 0 ``state.pt``) -> ``ack_drain`` -> the
  group is destroyed -> wait for the consensus -> the new group -> replan
  (elastic/plan.py) -> ``restore_resharded_payload`` (each rank reads its
  new row window of the commit, checkpoint/reshard.py) -> ``ack_topology``
  -> publish.  A rank whose own device left its view drains and commits
  with the others, acks, releases its lease and returns: it never enters
  the new epoch's rendezvous.  A step that fails in a collective (a rank
  died without notice; the group's timeout is ``elastic.lease_ttl_secs``)
  leaves a state that is not trusted: no drain commit, and the survivors
  wait for an epoch after the broken one.  The dead rank's lease owns its
  device (elastic/coord.py), so once the lease expires the coordinator
  opens that epoch without it, though the board still lists it; the
  survivors resume from the last periodic commit, replaying the tail
  exactly once (JAX's "drain commit failed" path).  The coordinator flips
  the epoch on every change of its trainer leases, so a transition may
  keep the device set (a joiner's lease lands before the views that add
  its device; a leaving rank releases after the survivors re-formed): the
  ranks then re-form the group and go on with their live state, which
  records no reshard and moves nothing (``reform`` in the lifecycle).
* **An idle tail** polls the registry at each of the reader's waits: the
  lease stays held, and a transition drains the ranks without a new
  batch.
* **Fences.**  Every commit carries the coordinator's cohort token
  (``online/trainer.py commit_payload(fence=)``), every publish rank 0's
  (``ModelPublisher.publish(fence=)``): a stale token is refused.
* **Publishing.**  Rank 0 publishes at the true vocabulary, after
  ``spmd.servable_state_dict`` gathers the tables, so every version has
  the same shapes whatever grid trained it.  With
  ``elastic.publisher_split`` the trainer only commits and a
  ``--task_type publish`` process publishes (elastic/mpmd.py).

Observables are JAX's: ``reshards`` (from/to mesh, moved bytes,
steps replayed, seconds), ``lifecycle`` (detect, drain_commit, replan,
reshard, resume, publish, done, ...; and the port's reform),
``cursor_lineage`` (the batch-end cursor of every batch applied along the
surviving lineage, strictly increasing), and the ``deepfm_elastic_*`` families with
:meth:`ElasticTrainer.metrics_snapshot`.  The steps are the grid's eager
steps (parallel/spmd.py): on the card they launch the B1 and B1' kernels
on the exchange's compact rows.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import make_checkpointer, restore_resharded_payload
from ..core.config import Config
from ..core.platform import resolve_device
from ..models.deepfm import window_multiple
from ..obs import flight as obs_flight
from ..obs.metrics import MetricsRegistry
from ..ops import fused_ctr
from ..online.publisher import ModelPublisher
from ..online.stream import EventLogReader, StreamCursor, open_tail
from ..online.trainer import OnlinePayload, commit_payload
from ..parallel import spmd
from ..parallel.mesh import DistContext, _with_grid
from ..train.step import LAZY_TABLE_KEYS, TrainState
from ..utils.logging import MetricLogger
from .coord import CoordClient, CoordinatedRegistry, Fence, StaleFencingTokenError
from .plan import Grid, choose_mesh, plan_reshard, state_leaves
from .registry import (DeviceBoard, LiveDeviceRegistry, board_backend,
                       own_card_backend)


class Topology(NamedTuple):
    """One generation of the trainer: the epoch, this rank's context, the
    grid (shape, padded rows, device ids in rank order) and the config
    with that grid's mesh."""

    epoch: int
    ctx: DistContext
    grid: Grid
    cfg: Config

    @property
    def shape(self) -> tuple[int, int]:
        return self.grid.shape


class _Silent:
    def step(self, *args, **kwargs) -> None:
        pass

    def seed_step(self, step: int) -> None:
        pass

    def event(self, *args, **kwargs) -> None:
        pass


# a group waits this many lease TTLs for its ranks to arrive: a dead rank's
# lease has expired by then and called the epoch off
ARRIVAL_TTLS = 3

# gloo raises a plain RuntimeError whose message starts with the source
# location inside gloo, e.g. "[.../gloo/transport/tcp/pair.cc:553]
# Connection closed by peer"
_GLOO_ERROR = re.compile(r"^\[[^\]]*\bgloo/[^\]]*\]")


class _GroupFailed(RuntimeError):
    """A collective of the current group failed (a rank died)."""


def _collective_failure(e: BaseException) -> bool:
    """Whether ``e`` was raised by the process group (a peer gone or timed
    out: ``torch.distributed``'s own errors, NCCL's among them, or gloo's),
    not by the step itself."""
    return (isinstance(e, (_GroupFailed, dist.DistError))
            or bool(_GLOO_ERROR.match(str(e))))


def group_backend(card: torch.device, world: int) -> str:
    """gloo on the CPU and where the ranks outnumber this host's cards (NCCL
    refuses two ranks on one card), NCCL otherwise."""
    if card.type != "cuda" or world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


class _Tail:
    """The reader's stop event for one epoch: set when the caller's stop is
    set, or when a poll of the registry at one of the reader's idle waits
    finds the epoch moved (so an idle tail keeps its lease and drains)."""

    def __init__(self, stop: threading.Event | None, moved: Callable[[], bool]):
        self._stop, self._moved, self.moved = stop, moved, False

    def is_set(self) -> bool:
        return self.moved or (self._stop is not None and self._stop.is_set())

    def wait(self, secs: float) -> bool:
        self.moved = self._moved()
        if self._stop is not None:
            return self._stop.wait(secs) or self.moved
        time.sleep(secs)
        return self.moved


class ElasticTrainer:
    """Continuous training over an event log on a grid of rank processes
    with a live reshard (module docstring).  ``device_id`` is this
    process's launch index; ``store`` the rendezvous store every rank
    reaches (None: a world of one process); ``registry`` replaces the
    default (the store's device board, or this process's own card)."""

    def __init__(self, cfg: Config, *, device_id: int = 0, device=None, store=None,
                 registry=None, stream_root: str | None = None,
                 publish_root: str | None = None, metrics: MetricsRegistry | None = None):
        if store is not None and not cfg.elastic.coordinator_url:
            raise ValueError(
                "multi-process elastic training needs elastic.coordinator_url: "
                "without the coordinator's epoch consensus and lease fencing there "
                "is no single enforced logical writer over the event log "
                "(elastic/coord.py)")
        if cfg.model.model_name == "two_tower":
            raise ValueError("elastic training covers the CTR families (the event-log "
                             "schema; online/trainer.py has the same boundary)")
        self.cfg = cfg
        self.device_id = int(device_id)
        self.card = resolve_device(device)
        self.store = store
        el = cfg.elastic
        if registry is None:
            backend_fn = (board_backend(DeviceBoard(store), self.device_id, self.card)
                          if store is not None else own_card_backend(self.device_id, self.card))
            registry = LiveDeviceRegistry(backend_fn, debounce_polls=el.registry_debounce_polls)
        if el.coordinator_url and not hasattr(registry, "ack_drain"):
            registry = CoordinatedRegistry(
                registry,
                CoordClient(el.coordinator_url, f"d{self.device_id}-p{os.getpid()}",
                            role="train", lease_ttl_secs=el.lease_ttl_secs,
                            owns=(self.device_id,)),
                heartbeat_interval_secs=el.heartbeat_interval_secs)
        self.registry = registry
        self._stream_root = stream_root or cfg.data.training_data_dir
        self._publish_root = publish_root or cfg.run.servable_model_dir
        if not self._stream_root:
            raise ValueError("elastic training needs data.training_data_dir "
                             "(the event-log directory or URL)")
        if not self._publish_root:
            raise ValueError("elastic training needs run.servable_model_dir "
                             "(the versioned publish root)")
        self.reader = EventLogReader(open_tail(self._stream_root),
                                     field_size=cfg.model.field_size,
                                     batch_size=cfg.data.batch_size)
        self.publisher = ModelPublisher(self._publish_root,
                                        keep=max(2, cfg.run.keep_checkpoints),
                                        keep_window=cfg.regions.publish_keep_window)
        self._log = MetricLogger(log_steps=cfg.run.log_steps)
        self.reshards: list[dict] = []
        self.lifecycle: list[dict] = []
        self.cursor_lineage: list[StreamCursor] = []
        # the host ms of each step by mesh, the drain commits and re-forms
        self.step_ms: dict[str, list[float]] = {}
        self.drain_commit_ms: list[float] = []
        self.reform_ms: list[float] = []
        self.left = False
        m = metrics or MetricsRegistry()
        self.metrics = m
        self._m_epoch = m.gauge("deepfm_elastic_epoch", "membership epoch the trainer is on")
        self._m_reshard = m.histogram(
            "deepfm_elastic_reshard_seconds",
            "detect->drain->commit->replan->restore wall time", window=256)
        self._m_drain_failed = m.counter(
            "deepfm_elastic_drain_commit_failed_total",
            "drain commits that failed (resume falls back to the last periodic commit)")
        self._m_reshards = m.counter("deepfm_elastic_reshards_total",
                                     "completed topology changes")
        self._m_replayed = m.counter("deepfm_elastic_steps_replayed_total",
                                     "optimizer steps replayed from the resume commit")
        self._m_frozen = m.gauge("deepfm_elastic_frozen",
                                 "1 while training on a frozen topology (coordinator "
                                 "unreachable)")
        self._m_fence_refused = m.counter("deepfm_elastic_fence_refused_total",
                                          "writes refused by a stale fencing token")
        self._m_lifecycle = m.counter("deepfm_elastic_lifecycle_total",
                                      "lifecycle transitions by kind", labels=("kind",))

    # -- bookkeeping ---------------------------------------------------------

    def _event(self, kind: str, **fields) -> None:
        self.lifecycle.append({"kind": kind, **fields})
        self._log.event(f"elastic_{kind}", **fields)
        self._m_lifecycle.labels(kind).inc()
        obs_flight.record(f"elastic_{kind}", subsystem="elastic", **fields)

    def metrics_snapshot(self) -> dict:
        """The ``elastic`` metrics section, rendered from the registry."""
        return {
            "epoch": int(self._m_epoch.value),
            "reshards": self._m_reshard.snapshot(include_max=True),
            "reshards_total": int(self._m_reshards.value),
            "drain_commit_failed": int(self._m_drain_failed.value),
            "steps_replayed": int(self._m_replayed.value),
            "frozen": bool(self._m_frozen.value),
            "fence_refused": int(self._m_fence_refused.value),
            "lifecycle": {kind: int(child.value) for (kind,), child in
                          sorted(self._m_lifecycle.children().items())},
        }

    def _fence_for(self, root: str) -> Fence | None:
        token = getattr(self.registry, "fence_token", None)
        if not token:
            return None
        return Fence(root, token, holder=getattr(getattr(self.registry, "_client", None),
                                                 "pid", ""))

    def _current_epoch(self) -> int:
        """The registry's epoch; a polling registry re-reads its view (and
        heartbeats it to the coordinator) here."""
        poll = getattr(self.registry, "poll", None)
        epoch = poll() if poll is not None else self.registry.epoch
        self._m_frozen.set(1.0 if getattr(self.registry, "frozen", False) else 0.0)
        return epoch

    def _leaving(self) -> bool:
        """Whether this process's own device left its local view (advance
        notice: drain, commit with the others, then go)."""
        local = getattr(self.registry, "_local", self.registry)
        poll = getattr(local, "poll", None)
        if poll is not None:
            poll()
        return self.device_id not in {d.id for d in local.devices()}

    # -- topology ------------------------------------------------------------

    def _wait_for_capacity(self, stop: threading.Event | None,
                           after: int | None) -> tuple[int, tuple]:
        """Block until the registry offers at least ``min_devices``, this
        process's own among them, on an epoch after ``after`` (None: any)."""
        el = self.cfg.elastic
        deadline = (time.time() + el.wait_for_capacity_secs
                    if el.wait_for_capacity_secs > 0 else None)
        while True:
            poll = getattr(self.registry, "poll", None)
            if poll is not None:
                poll()
            epoch, devices = self.registry.snapshot()
            ids = [d.id for d in devices]
            if (len(devices) >= el.min_devices and self.device_id in ids
                    and (after is None or epoch > after)):
                return epoch, devices
            if stop is not None and stop.is_set():
                raise RuntimeError(f"stopped while waiting for capacity "
                                   f"({len(devices)}/{el.min_devices} devices)")
            if deadline is not None and time.time() >= deadline:
                raise RuntimeError(
                    f"no capacity after {el.wait_for_capacity_secs}s: {len(devices)} "
                    f"devices available, elastic.min_devices={el.min_devices}")
            time.sleep(el.poll_interval_secs)

    def _arrive(self, epoch: int, world: int) -> bool:
        """The epoch's arrival count in the store: True once all ``world``
        ranks are there, False when a newer epoch called this one off.  A
        rank that waited ``ARRIVAL_TTLS`` lease TTLs calls it off and
        raises (a rank holds its lease but never comes)."""
        if self.store is None:
            return True
        key = f"elastic/epoch-{epoch}"
        self.store.add(f"{key}/arrived", 1)
        wait = ARRIVAL_TTLS * self.cfg.elastic.lease_ttl_secs
        deadline = time.monotonic() + wait
        while True:
            arrived = self.store.add(f"{key}/arrived", 0)
            if arrived >= world:
                word = self.store.compare_set(f"{key}/go", "", "1")
            elif self._current_epoch() != epoch or time.monotonic() > deadline:
                word = self.store.compare_set(f"{key}/go", "", "0")
                if word.decode() == "0" and self._current_epoch() == epoch:
                    raise RuntimeError(f"epoch {epoch}: {arrived} of {world} ranks arrived "
                                       f"in {wait:.0f} s ({ARRIVAL_TTLS} lease TTLs)")
            else:
                time.sleep(self.cfg.elastic.poll_interval_secs / 5)
                continue
            return word.decode() == "1"

    def _topology(self, epoch: int, devices) -> Topology | None:
        """This rank's context on the grid of ``devices`` (its group formed
        and its state not yet built), or None when the epoch was called off
        or its group failed to form (a rank died after it arrived)."""
        ids = tuple(d.id for d in devices)
        dp, mp = choose_mesh(len(ids), prefer_model_parallel=(
            self.cfg.elastic.prefer_model_parallel or self.cfg.mesh.model_parallel))
        rank = ids.index(self.device_id)
        if not self._arrive(epoch, len(ids)):
            return None
        t0 = time.perf_counter()
        if self.store is None:
            ctx = DistContext(1, 0, 0, 1, self.card)
        else:
            try:
                dist.init_process_group(
                    group_backend(self.card, len(ids)),
                    store=dist.PrefixStore(f"epoch-{epoch}/", self.store),
                    rank=rank, world_size=len(ids),
                    timeout=datetime.timedelta(seconds=self.cfg.elastic.lease_ttl_secs))
                ctx = DistContext(len(ids), rank, rank, len(ids), self.card,
                                  dist.group.WORLD, owns_group=True)
                ctx = (_with_grid(ctx, mp) if mp > 1
                       else dataclasses.replace(ctx, data_group=ctx.group))
            except RuntimeError as e:
                if not _collective_failure(e):
                    raise
                if dist.is_initialized():
                    dist.destroy_process_group()
                self._event("group_failed", epoch=epoch,
                            error=f"{type(e).__name__}: {e}"[:200])
                return None
        self.reform_ms.append(1e3 * (time.perf_counter() - t0))
        cfg = self.cfg.with_overrides(mesh={"model_parallel": mp, "data_parallel": dp})
        pv = spmd.padded_vocab(self.cfg.model.feature_size, mp, window_multiple(cfg.model))
        return Topology(epoch, ctx, Grid((dp, mp), pv, ids), cfg)

    def _close_group(self, topo: Topology) -> None:
        if topo.ctx.owns_group and dist.is_initialized():
            dist.destroy_process_group()

    def _admit(self, topo: Topology) -> None:
        """Complete the coordinator's reshard barrier and take the roots'
        fences to this lease's token."""
        self._m_epoch.set(topo.epoch)
        ack = getattr(self.registry, "ack_topology", None)
        if ack is not None:
            ack(topo.epoch)
        if topo.ctx.rank == 0:
            fence = self._fence_for(self.cfg.run.model_dir)
            if fence is not None:
                fence.advance()
            if not self.cfg.elastic.publisher_split:
                pub = self._fence_for(self._publish_root)
                if pub is not None:
                    pub.advance()

    def _leaves(self, topo: Topology, state: TrainState) -> list:
        """JAX's leaves of ``state`` on ``topo`` (elastic/plan.py)."""
        params = {n: ((topo.grid.padded_vocab,) + tuple(p.shape[1:])
                      if n in LAZY_TABLE_KEYS else tuple(p.shape), p.element_size())
                  for n, p in state.model.named_parameters()}
        buffers = {n: b for n, b in state.model.named_buffers()
                   if n.endswith(("moving_mean", "moving_var"))}
        zero = state.sharding is not None and state.sharding.zero
        return state_leaves(params, dp=topo.grid.shape[0], lazy=state.lazy is not None,
                            zero=zero, buffers=buffers)

    # -- durability ----------------------------------------------------------

    def _checkpointer(self, topo: Topology):
        return make_checkpointer(self.cfg.run.model_dir,
                                 max_to_keep=self.cfg.run.keep_checkpoints, ctx=topo.ctx)

    def _commit(self, ckpt, state: TrainState, cursor: StreamCursor) -> None:
        try:
            commit_payload(ckpt, state, cursor, fence=self._fence_for(self.cfg.run.model_dir))
        except StaleFencingTokenError:
            self._m_fence_refused.inc()
            self._event("fence_refused", root="model_dir", step=int(state.step))
            raise

    def _on_rank0(self, topo: Topology, fn):
        """``fn()`` on rank 0, its failure told to every rank (one
        broadcast), so that no rank goes on alone."""
        err, out = None, None
        if topo.ctx.rank == 0:
            try:
                out = fn()
            except Exception as e:
                err = e
        if topo.ctx.group is not None:
            word = torch.tensor([float(err is not None),
                                 float(isinstance(err, StaleFencingTokenError))])
            if dist.get_backend(topo.ctx.group) == "nccl":
                word = word.to(topo.ctx.device)
            dist.broadcast(word, src=0, group=topo.ctx.group)
            failed, stale = word.tolist()
            if failed and err is None:
                if stale:
                    raise StaleFencingTokenError("rank 0's publish was refused: a newer "
                                                 "holder advanced the publish root's fence")
                raise RuntimeError("rank 0's publish failed")
        if err is not None:
            raise err
        return out

    def _publish(self, topo: Topology, state: TrainState, cursor: StreamCursor):
        """Rank 0 publishes the tables at the true vocabulary (every rank
        gathers them), unless the publish task owns the root."""
        if self.cfg.elastic.publisher_split:
            return None
        sd = spmd.servable_state_dict(state, self.cfg.model)

        def publish():
            return self.publisher.publish(
                self.cfg, sd, step=state.step,
                cursor={"segment": cursor.segment, "record": cursor.record},
                watermark=self.reader.watermark(),
                extra={"elastic": {"mesh": list(topo.shape), "epoch": topo.epoch}},
                fence=self._fence_for(self._publish_root))

        try:
            manifest = self._on_rank0(topo, publish)
        except StaleFencingTokenError:
            self._m_fence_refused.inc()
            self._event("fence_refused", root="publish", step=int(state.step))
            raise
        if manifest is not None:
            self._event("publish", version=manifest.version, step=manifest.step,
                        mesh=list(topo.shape))
        return manifest

    # -- the reshard ---------------------------------------------------------

    def _enter(self, stop, prior: tuple | None = None, live: tuple | None = None):
        """Form the group of the next epoch that includes this rank (waiting
        for capacity) and restore its state: the latest commit (re-cut to
        this rank's window), or a fresh state committed at step 0 when there
        is none.  ``prior`` is ``(topology, plan leaves)`` of a reshard, None
        at the start; after a reshard only an epoch later than the prior
        topology's is taken (a broken group's epoch never forms again).
        ``live`` is the drained ``(state, cursor)`` when it is trusted (no
        collective failed, the drain commit holds it): if the new epoch has
        the prior grid and every rank of the new group holds such a state,
        the group is a re-form (:meth:`_reforms`), and the live state goes
        on, moved onto the new group.
        Returns ``(topology, state, cursor, published, plan)``: every rank
        of the new group learns (one all-reduce) whether any of them comes
        from a reshard, and then all publish once, so a rank joining a
        running job takes part in the survivors' post-reshard publish;
        ``plan`` is the reshard's, None at the start and on a re-form."""
        after = prior[0].epoch if prior is not None else None
        while True:
            epoch, devices = self._wait_for_capacity(stop, after)
            topo = self._topology(epoch, devices)
            if topo is not None:
                break
            after = epoch
        self._log = (MetricLogger(log_steps=self.cfg.run.log_steps) if topo.ctx.rank == 0
                     else _Silent())
        if self._reforms(topo, prior, live):
            state, cursor = live
            spmd.rebind_state(state, topo.cfg, topo.ctx)
            self._admit(topo)
            self._event("reform", epoch=topo.epoch, mesh=list(topo.shape),
                        step=int(state.step))
            return topo, state, cursor, False, None
        plan = None
        if prior is not None:
            plan = plan_reshard(prior[0].grid, topo.grid, prior[1])
            self._event("replan", to_mesh=list(topo.shape), moved_bytes=plan.moved_bytes,
                        naive_bytes=plan.naive_bytes)
        ckpt = self._checkpointer(topo)
        state = spmd.create_dp_train_state(topo.cfg, topo.ctx)
        cursor = StreamCursor()
        if ckpt.latest_step() is None:
            # a durable step-0 payload before the first event: a reshard in
            # the first batches then has a resume point
            self._admit(topo)
            self._commit(ckpt, state, cursor)
        else:
            payload = restore_resharded_payload(ckpt, OnlinePayload.wrap(state, cursor),
                                                plan=plan, grid=topo.grid)
            state, cursor = payload.train, payload.cursor()
            self._admit(topo)
            if prior is None:
                self._event("resume", step=int(state.step), segment=cursor.segment,
                            record=cursor.record, mesh=list(topo.shape))
        ckpt.close()
        word = self._agree(topo, has_batch=True, changed=prior is not None, stop=False, n=0)
        if word["changed"]:
            self._publish(topo, state, cursor)
        return topo, state, cursor, word["changed"], plan

    def _reshard(self, topo: Topology, state: TrainState, cursor: StreamCursor, stop,
                 *, broken: bool = False):
        """detect -> drain -> commit -> replan -> reshard -> resume ->
        publish.  Returns the new ``(topology, state, cursor, steps
        replayed)``, or None when this rank left.  ``broken``: a collective
        failed, so the state is not committed.  A transition to the grid
        it left (the coordinator flips the epoch on every change of its
        trainer leases, elastic/coord.py, and a lease may land before the
        views that would change the device set) re-forms the group and
        goes on with the live state: no reshard is recorded, no state
        moves, no step replays."""
        t0 = time.perf_counter()
        step_before = int(state.step)
        self._event("detect", epoch=self._current_epoch(), from_mesh=list(topo.shape))
        fenced = bool(getattr(self.registry, "fenced", False))
        trusted = not (fenced or broken)
        if self.cfg.elastic.drain_commit and not fenced and not broken:
            try:
                t = time.perf_counter()
                ckpt = self._checkpointer(topo)
                self._commit(ckpt, state, cursor)
                ckpt.close()
                self.drain_commit_ms.append(1e3 * (time.perf_counter() - t))
                self._event("drain_commit", step=step_before, segment=cursor.segment,
                            record=cursor.record)
            except Exception as e:
                trusted = False
                self._m_drain_failed.inc()
                self._event("drain_commit_failed", error=f"{type(e).__name__}: {e}"[:200])
        elif fenced:
            self._event("self_fenced", step=step_before)
        else:
            self._m_drain_failed.inc()
            self._event("drain_commit_failed", error="a collective of the old group failed")
        leaving = self._leaving()
        ack_drain = getattr(self.registry, "ack_drain", None)
        if ack_drain is not None and not fenced:
            ack_drain()
        leaves = self._leaves(topo, state)
        self._close_group(topo)
        if leaving:
            release = getattr(self.registry, "release", None)
            if release is not None:
                release()
            self._event("leave", step=step_before, device=self.device_id)
            self.left = True
            return None
        new, state, cursor, _, plan = self._enter(stop, (topo, leaves),
                                                  (state, cursor) if trusted else None)
        if plan is None:  # a re-form
            return new, state, cursor, 0
        # batches past the committed cursor were applied only to the
        # discarded state and replay: along the surviving lineage each once
        while self.cursor_lineage and self.cursor_lineage[-1] > cursor:
            self.cursor_lineage.pop()
        wall = time.perf_counter() - t0
        record = {**plan.summary(), "wall_secs": round(wall, 4),
                  "steps_replayed": step_before - int(state.step),
                  "resume_step": int(state.step)}
        self.reshards.append(record)
        self._m_reshard.observe(wall)
        self._m_reshards.inc()
        self._m_replayed.inc(max(0, record["steps_replayed"]))
        self._event("reshard", **{k: record[k] for k in (
            "from_mesh", "to_mesh", "wall_secs", "steps_replayed", "moved_bytes")})
        return new, state, cursor, record["steps_replayed"]

    def _reforms(self, topo: Topology, prior: tuple | None, live: tuple | None) -> bool:
        """Whether the new group is a re-form: every rank of it comes from
        the prior topology's grid (the same device ids in the same order)
        with a trusted live state.  One all-reduce (MIN) on every entry to
        a group, so that a rank that starts or joins answers too."""
        mine = float(prior is not None and live is not None and topo.grid == prior[0].grid)
        if topo.ctx.group is None:
            return mine > 0
        word = torch.tensor([mine])
        if dist.get_backend(topo.ctx.group) == "nccl":
            word = word.to(topo.ctx.device)
        try:
            dist.all_reduce(word, op=dist.ReduceOp.MIN, group=topo.ctx.group)
        except Exception as e:
            raise _GroupFailed(str(e)) from e
        return float(word.item()) > 0

    # -- the loop ------------------------------------------------------------

    def _agree(self, topo: Topology, *, has_batch: bool, changed: bool, stop: bool,
               n: int) -> dict:
        """One all-reduce (MAX) of every rank's word: some rank has no
        batch, some rank's epoch moved, some rank stops, and the batch
        sizes (their max and min)."""
        word = torch.tensor([float(not has_batch), float(changed), float(stop),
                             float(n), -float(n)])
        if topo.ctx.group is not None:
            if dist.get_backend(topo.ctx.group) == "nccl":
                word = word.to(topo.ctx.device)
            try:
                dist.all_reduce(word, op=dist.ReduceOp.MAX, group=topo.ctx.group)
            except Exception as e:
                raise _GroupFailed(str(e)) from e
        missing, moved, stopping, n_max, neg_min = word.tolist()
        return {"missing": missing > 0 or n_max != -neg_min, "changed": moved > 0,
                "stop": stopping > 0}

    def _local_batch(self, topo: Topology, batch: dict) -> dict:
        """This rank's rows of the global batch (its data index's share, as
        JAX's ``shard_batch`` splits it), on its card."""
        dp, d = topo.ctx.data_parallel, topo.ctx.data_index
        n = int(batch["label"].shape[0])
        if n % dp:
            raise ValueError(f"a batch of {n} records does not split over {dp} data "
                             f"indices (JAX's shard_batch refuses it too)")
        sl = slice(d * n // dp, (d + 1) * n // dp)
        return {k: torch.from_numpy(np.ascontiguousarray(v[sl])).to(topo.ctx.device)
                for k, v in batch.items()}

    def run(self, *, follow: bool = True, max_batches: int = 0,
            stop: threading.Event | None = None, idle_timeout_secs: float = 0.0,
            publish_every_steps: int | None = None,
            on_commit: Callable[[TrainState, StreamCursor], None] | None = None
            ) -> TrainState:
        """Consume the stream with the online trainer's termination contract,
        resharding live whenever the epoch moves; returns the final state
        (committed and published), or the state at the drain when this rank
        left."""
        cfg = self.cfg
        publish_every = (cfg.run.online_publish_every_steps if publish_every_steps is None
                         else publish_every_steps)
        ckpt_every = max(1, cfg.run.checkpoint_every_steps)
        topo, state, cursor, published, _ = self._enter(stop)
        step = int(state.step)
        self._log.seed_step(step)
        applied = 0
        last_committed, last_published = step, step if published else -1
        launches0 = fused_ctr.launches, fused_ctr.backward_launches
        while True:
            remaining = (max_batches - applied) if max_batches else 0
            if max_batches and remaining <= 0:
                break
            epoch = topo.epoch
            tail = _Tail(stop, lambda: self._current_epoch() != epoch)
            batches = self.reader.batches(cursor, follow=follow, stop=tail,
                                          idle_timeout_secs=idle_timeout_secs,
                                          max_batches=remaining)
            moved = broken = False
            ckpt = self._checkpointer(topo)
            try:
                while True:
                    item = next(batches, None)
                    n = int(item[0]["label"].shape[0]) if item is not None else 0
                    try:
                        word = self._agree(topo, has_batch=item is not None,
                                           changed=self._current_epoch() != topo.epoch,
                                           stop=stop is not None and stop.is_set(), n=n)
                        if word["changed"]:
                            moved = True
                            break
                        if word["missing"]:
                            break
                        batch, batch_cursor = item
                        local = self._local_batch(topo, batch)
                        t0 = time.perf_counter()
                        metrics = spmd.train_step(state, local, topo.ctx)
                    except RuntimeError as e:
                        if topo.ctx.group is None or not _collective_failure(e):
                            raise
                        self._event("group_failed", step=step,
                                    error=f"{type(e).__name__}: {e}"[:200])
                        broken = True
                        break
                    self.step_ms.setdefault("x".join(map(str, topo.shape)), []).append(
                        1e3 * (time.perf_counter() - t0))
                    cursor = batch_cursor
                    self.cursor_lineage.append(cursor)
                    step = int(state.step)
                    applied += 1
                    self._log.step(step, n, {k: v for k, v in metrics.items()
                                             if k in ("loss", "ce")})
                    if step % ckpt_every == 0 or (publish_every and step % publish_every == 0):
                        self._commit(ckpt, state, cursor)
                        last_committed = step
                        if on_commit is not None:
                            on_commit(state, cursor)
                    if publish_every and step % publish_every == 0:
                        self._publish(topo, state, cursor)
                        last_published = step
            finally:
                batches.close()
                ckpt.close()
            if not (moved or broken):
                break
            out = self._reshard(topo, state, cursor, stop, broken=broken)
            if out is None:  # this rank left the grid
                return state
            topo, state, cursor, replayed = out
            step = int(state.step)
            applied = max(0, applied - replayed)
            last_committed = last_published = step
        ckpt = self._checkpointer(topo)
        try:
            if step != last_committed:
                self._commit(ckpt, state, cursor)
                if on_commit is not None:
                    on_commit(state, cursor)
            if applied and step != last_published:
                self._publish(topo, state, cursor)
        finally:
            ckpt.close()
        self._event("done", step=step, applied=applied, reshards=len(self.reshards),
                    mesh=list(topo.shape),
                    forward_launches=fused_ctr.launches - launches0[0],
                    backward_launches=fused_ctr.backward_launches - launches0[1])
        self._close_group(topo)
        return state


def run_elastic_train(cfg: Config, *, device=None) -> TrainState:
    """The ``online-train`` task with ``elastic.enabled`` (train/loop.py):
    this process is the rank of launch index ``ELASTIC_DEVICE_ID`` (default
    0).  With ``MASTER_ADDR``/``MASTER_PORT`` set it joins the rendezvous
    store there (the coordinator's ``--store-port``) and needs
    ``elastic.coordinator_url``; without, it is a world of one process.
    It tails the log until SIGTERM/SIGINT, ``run.online_max_batches`` or
    ``run.online_idle_timeout_secs``."""
    import signal

    store = None
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        store = dist.TCPStore(os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]),
                              is_master=False, timeout=datetime.timedelta(seconds=60))
    trainer = ElasticTrainer(cfg, device_id=int(os.environ.get("ELASTIC_DEVICE_ID", "0")),
                             device=device, store=store)
    stop = threading.Event()
    restore: list[tuple] = []
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            restore.append((sig, signal.signal(sig, lambda *_: stop.set())))
    try:
        return trainer.run(follow=True, stop=stop, max_batches=cfg.run.online_max_batches,
                           idle_timeout_secs=cfg.run.online_idle_timeout_secs)
    finally:
        release = getattr(trainer.registry, "release", None)
        if release is not None:
            release()
        for sig, prev in restore:
            signal.signal(sig, prev)
