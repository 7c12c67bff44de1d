"""Checkpoints of the train state: counterpart of
``deepfm_tpu/checkpoint/ckpt.py``, in a torch-native format (Orbax needs
JAX).

One directory per step under the model directory, ``<model_dir>/<step>/``,
holds ``state.pt`` (``torch.save``, read back with ``weights_only=True``):

    {"step": int,
     "model": the model's state_dict (parameters and BN moving statistics),
     "optimizer": Optimizer.state_dict() (count, every slot),
     "lazy": LazyAdamState.state_dict() or None,
     "generators": [the dropout generator state of each rank],
     "world_size": int,
     "grid": [data_parallel, model_parallel]}

A run on a ``[data x model]`` grid saves the same layout
(parallel/spmd.py ``full_state``): the row-sharded tables and their
moments gathered whole over each model group (padded as trained), the
ZeRO windows gathered over the data group at their parameters' shapes.
It restores on a grid with the same ``model_parallel`` (each rank takes
its rows and windows back); restoring onto another row split is the
resharding restore, ROADMAP A15, and raises.  A checkpoint without
``grid`` was written at ``model_parallel`` 1.

An online commit (``online/trainer.py OnlinePayload``: the train state,
the stream cursor and the writer's fencing token) adds one entry to the
same file, so weights and cursor land in one atomic step directory:

     "online": {"cursor_segment": uint8 [256], "cursor_len": int32,
                "cursor_record": int64, "fence_token": int64}

A plain train checkpoint has no ``online`` entry and keeps its format.

The step is written under a temporary name and renamed into place once
the file is synced, so a crash never leaves a half checkpoint that
:meth:`Checkpointer.latest_step` would pick.

Saves are asynchronous, as in JAX: :meth:`Checkpointer.save` returns once
every tensor is copied to the host (pinned memory, then a synchronize),
because the optimizer updates the state in place on the next step; the
file is written on a writer thread, and the next ``save``, ``restore`` or
``close`` waits for it.  ``save(..., block=True)`` writes, syncs and
renames before it returns (the online commit).  In a data-parallel run
every rank calls ``save`` (the ranks' generator states and the shards
reach rank 0 through the group) and rank 0 alone writes; every rank
restores from the same directory.  Restored at another world size, the weights and moments
are the checkpoint's, but each rank keeps its fresh dropout generator:
the dropout masks then cannot match the original run's.

The cadence is the caller's (the train loop's ``checkpoint_every_steps``);
a step already on disk is not written again.
"""

from __future__ import annotations

import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import spmd
from ..parallel.mesh import DistContext
from ..train.step import TrainState

STATE_FILE = "state.pt"
# the leaves an online payload adds to a train state (online/trainer.py)
ONLINE_KEYS = ("cursor_segment", "cursor_len", "cursor_record", "fence_token")
_A15 = ("object-store model directories are not ported yet "
        "(ROADMAP A15, checkpoint/remote.py); give a local directory")
_FM_V_HINT = (
    "Hint: checkpoints written with model.fused_kernel != 'off' store a "
    "window-padded fm_v (rows rounded up to a multiple of 128 // "
    "embedding_size when feature_size does not divide it); restoring under "
    "a different fused_kernel setting changes the expected shape.  Restore "
    "with the fused_kernel value the checkpoint was trained with.  A "
    "checkpoint of another table shape (another mesh) needs the resharding "
    "restore, not ported yet (ROADMAP A15).")


def _is_url(path) -> bool:
    return "://" in os.fspath(path)


def _split(payload) -> tuple[TrainState, dict | None]:
    """A train state, or an online payload's train state and its
    ``ONLINE_KEYS`` leaves."""
    if isinstance(payload, TrainState):
        return payload, None
    return payload.train, {k: getattr(payload, k) for k in ONLINE_KEYS}


def _to_host(tree, pinned: list):
    """A copy of every tensor of ``tree`` on the CPU: CUDA tensors into
    pinned memory without waiting (``pinned`` collects them for the one
    synchronize), CPU tensors cloned."""
    if isinstance(tree, dict):
        return {k: _to_host(v, pinned) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v, pinned) for v in tree]
    if not isinstance(tree, torch.Tensor):
        return tree
    t = tree.detach()
    if t.device.type == "cpu":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    pinned.append(t.device)
    return out


class Checkpointer:
    """Saves and restores :class:`TrainState` under ``directory``, keeping
    the newest ``max_to_keep`` steps.  ``ctx`` is the process's place in a
    data-parallel run (None: one process)."""

    def __init__(self, directory: str | os.PathLike, *, max_to_keep: int = 3,
                 ctx: DistContext | None = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._rank = ctx.rank if ctx is not None else 0
        self._world = ctx.world_size if ctx is not None else 1
        self._group = ctx.group if ctx is not None else None
        self._device = ctx.device if ctx is not None else None
        self._grid = ([ctx.data_parallel, ctx.model_parallel] if ctx is not None
                      else [1, 1])
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        # the last save's {"step", "blocking_s", "write_s", "bytes"}
        self.last_save: dict | None = None

    # -- steps on disk -------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Every complete step on disk, oldest first."""
        self.wait_until_finished()
        return self._steps()

    def _steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.directory, name, STATE_FILE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------

    def _generator_states(self, state: TrainState) -> list[torch.Tensor]:
        """Every rank's dropout generator state (a collective in a group)."""
        mine = state.generator.get_state()
        if self._group is None:
            return [mine]
        on = mine.to(self._device)
        out = [torch.empty_like(on) for _ in range(self._world)]
        dist.all_gather(out, on, group=self._group)
        return [t.cpu() for t in out]

    def save(self, state, *, block: bool = False) -> bool:
        """Save ``state`` (a :class:`TrainState` or an online payload) at
        its train step; returns whether this process wrote it (False on
        ranks other than 0, and for a step already on disk).  Returns once
        the state is on the host; ``block=True`` also waits for the write.
        In a data-parallel run every rank calls it."""
        self.wait_until_finished()
        t0 = time.perf_counter()
        state, online = _split(state)
        generators = self._generator_states(state)
        step = int(state.step)
        full = spmd.full_state(state)  # a collective on a grid: every rank
        if self._rank != 0 or step in self._steps():
            return False
        pinned: list = []
        tree = {
            "step": step,
            **full,
            "generators": generators,
            "world_size": self._world,
            "grid": self._grid,
        }
        if online is not None:
            tree["online"] = {k: torch.from_numpy(np.array(v)) for k, v in online.items()}
        payload = _to_host(tree, pinned)
        for dev in set(pinned):
            torch.cuda.synchronize(dev)
        self.last_save = {"step": step, "blocking_s": time.perf_counter() - t0,
                          "write_s": None, "bytes": None}
        if block:
            self._write(step, payload)
            return True
        self._writer = threading.Thread(target=self._write_guarded, args=(step, payload),
                                        name=f"checkpoint-{step}", daemon=True)
        self._writer.start()
        return True

    def _write_guarded(self, step: int, payload: dict) -> None:
        try:
            self._write(step, payload)
        except BaseException as e:  # raised by the next wait_until_finished
            self._error = e

    def _write(self, step: int, payload: dict) -> None:
        t0 = time.perf_counter()
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, STATE_FILE)
        with open(path, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.directory, str(step)))
        for old in self._steps()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        self.last_save.update(write_s=time.perf_counter() - t0,
                              bytes=os.path.getsize(os.path.join(
                                  self.directory, str(step), STATE_FILE)))

    def wait_until_finished(self) -> None:
        """Wait for the write in flight, if any; raises its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"checkpoint write to {self.directory} failed") from error

    # -- restore -------------------------------------------------------------

    def restore(self, target, step: int | None = None):
        """Load step ``step`` (default: the latest) into ``target`` in place
        (its tensors keep their devices) and return it.  ``target`` is a
        :class:`TrainState`, or an online payload, which comes back with the
        checkpoint's cursor and fencing token beside the restored state.
        Raises FileNotFoundError without a checkpoint, and names the
        mismatch when the checkpoint's shapes, optimizer or kind (train
        checkpoint or online commit) are not ``target``'s."""
        self.wait_until_finished()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        payload = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                             map_location="cpu", weights_only=True)
        full, online = target, None
        if not isinstance(target, TrainState):
            target, online = target.train, payload.get("online")
            if online is None:
                raise ValueError(f"checkpoint {step} is a train checkpoint, not an online "
                                 f"commit: it holds no stream cursor")
        grid = payload.get("grid", [payload.get("world_size", 1), 1])
        if grid[1] != self._grid[1]:
            raise NotImplementedError(
                f"checkpoint {step} was written on a [{grid[0]}, {grid[1]}] grid; "
                f"restoring it with mesh.model_parallel={self._grid[1]} needs the "
                f"resharding restore, not ported yet (ROADMAP A15)")
        if (payload["lazy"] is None) != (target.lazy is None):
            raise ValueError(
                f"checkpoint {step} was written with optimizer."
                f"lazy_embedding_updates={payload['lazy'] is not None}; restore "
                f"it with the same setting")
        try:
            spmd.load_full_state(target, payload)
        except RuntimeError as e:
            if "fm_v" in str(e):
                raise RuntimeError(f"checkpoint {step} does not fit the model: "
                                   f"{e}\n{_FM_V_HINT}") from e
            raise
        target.step = int(payload["step"])
        generators = payload["generators"]
        if len(generators) == self._world:
            target.generator.set_state(generators[self._rank])
        if online is None:
            return target
        return full._replace(step=target.step, train=target,
                             **{k: online[k].numpy() for k in ONLINE_KEYS})

    def close(self) -> None:
        self.wait_until_finished()


def maybe_clear(directory: str | os.PathLike, enabled: bool) -> None:
    """``clear_existing_model``: delete the model directory first."""
    if not enabled:
        return
    if _is_url(directory):
        raise NotImplementedError(f"{directory!r}: {_A15}")
    if os.path.isdir(directory):
        shutil.rmtree(directory)


def make_checkpointer(directory: str | os.PathLike, **kwargs) -> Checkpointer:
    """The checkpointer for ``directory``: a local directory gets a
    :class:`Checkpointer`; an object-store URL raises (ROADMAP A15)."""
    if _is_url(directory):
        raise NotImplementedError(f"{directory!r}: {_A15}")
    return Checkpointer(directory, **kwargs)
