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

A run on a ``[data x model]`` grid at ``model_parallel`` M > 1 writes
each table row range once, by the rank that holds it, so that no rank
ever holds more rows than its own (parallel/spmd.py ``local_state``,
``split_tables``).  The ranks at data index 0 (one per model index ``i``)
each write ``rows-<i>.pt``:

    {"model_index": i, "offset": int, "rows": int,
     "model": {"fm_w", "fm_v"}: rows [offset, offset + rows) as trained
              (pad rows included),
     "optimizer": {"fm_w": {slot: rows}, "fm_v": {...}} (dense Adam;
                  empty with lazy Adam),
     "lazy": {"m": {"fm_w", "fm_v"}, "v": {...}} or None}

and rank 0 writes the replicated rest into ``state.pt`` (the layout above
without the tables' leaves: the MLP, batch norm, the other optimizer
slots, the ZeRO windows gathered over the data group at their
parameters' shapes), with the manifest of the row files:

     "rows": [{"file": "rows-<i>.pt", "offset": int, "rows": int}, ...]

A restore reads ``state.pt`` and only its own row file, both memory-mapped
(``torch.load(..., mmap=True)``).  The writers share no collective: each
drops a marker ``.done-<i>`` beside its row file in the step's temporary
directory, and rank 0's writer renames the directory into place once it
has seen every marker (it raises after ``MARKER_TIMEOUT_S`` without them).
The step's directory is shared, so the grid runs on one host or on a
``model_dir`` that every rank sees.  A grid checkpoint restores on a grid
with the same ``model_parallel``; another row split is the resharding
restore, ROADMAP A15, and raises.  A checkpoint without ``grid`` was
written at ``model_parallel`` 1; one with ``grid`` and whole tables in
``state.pt`` (the grid's first layout) restores too, each rank cutting out
its rows.

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
# a grid's row files and their writers' completion markers, by model index
ROWS_FILE = "rows-{}.pt"
MARKER = ".done-{}"
# how long rank 0's writer waits for the other row files of a grid step
MARKER_TIMEOUT_S = 600.0
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


def _on_host(tree):
    """``_to_host`` of ``tree``, waiting for its device copies."""
    pinned: list = []
    out = _to_host(tree, pinned)
    for dev in set(pinned):
        torch.cuda.synchronize(dev)
    return out


def _save_synced(payload, path: str) -> None:
    """``torch.save`` (bytes as they are) into ``path``, flushed and synced."""
    with open(path, "wb") as f:
        if isinstance(payload, bytes):
            f.write(payload)
        else:
            torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())


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
        self._model_index = ctx.model_index if ctx is not None else 0
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

    def _agree(self, step: int) -> tuple[bool, int]:
        """Rank 0's word to every rank: whether ``step`` is on disk already,
        and the nonce of the step's temporary directory."""
        word = torch.tensor([int(step in self._steps()),
                             int.from_bytes(os.urandom(7), "little")],
                            dtype=torch.int64, device=self._device)
        dist.broadcast(word, src=0, group=self._group)
        on_disk, nonce = word.tolist()
        return bool(on_disk), nonce

    def save(self, state, *, block: bool = False) -> bool:
        """Save ``state`` (a :class:`TrainState` or an online payload) at
        its train step; returns whether this process wrote a file (rank 0;
        on a grid also the other ranks at data index 0; never for a step
        already on disk).  Returns once the state is on the host;
        ``block=True`` also waits for the write.  In a data-parallel run
        or on a grid every rank calls it."""
        self.wait_until_finished()
        t0 = time.perf_counter()
        state, online = _split(state)
        generators = self._generator_states(state)
        step = int(state.step)
        if self._grid[1] > 1:
            return self._save_rows(state, online, generators, step, t0, block)
        full = spmd.full_state(state)  # a collective with ZeRO: every rank
        if self._rank != 0 or step in self._steps():
            return False
        tree = self._tree(step, full, generators, online)
        self._start(step, block, t0, self._write, (step, _on_host(tree)))
        return True

    def _tree(self, step: int, layout: dict, generators, online) -> dict:
        tree = {"step": step, **layout, "generators": generators,
                "world_size": self._world, "grid": self._grid}
        if online is not None:
            tree["online"] = {k: torch.from_numpy(np.array(v)) for k, v in online.items()}
        return tree

    def _start(self, step: int, block: bool, t0: float, write, args) -> None:
        """Record the blocking time, then run ``write(*args)`` here
        (``block``) or on the writer thread."""
        self.last_save = {"step": step, "blocking_s": time.perf_counter() - t0,
                          "write_s": None, "bytes": None}
        if block:
            write(*args)
            return
        self._writer = threading.Thread(target=self._write_guarded, args=(write, args),
                                        name=f"checkpoint-{step}", daemon=True)
        self._writer.start()

    def _save_rows(self, state: TrainState, online, generators, step: int, t0: float,
                   block: bool) -> bool:
        """The grid's save (module docstring): this rank's rows into
        ``rows-<model index>.pt`` at data index 0, the rest and the
        manifest into ``state.pt`` on rank 0."""
        on_disk, nonce = self._agree(step)
        if on_disk:
            return False
        sh = state.sharding
        rest, rows = spmd.split_tables(spmd.local_state(state), spmd.table_keys(state))
        if sh.ctx.data_index != 0:
            return False
        tmp = os.path.join(self.directory, f".tmp-{step}-{nonce:x}")
        rows_tree = _on_host({"model_index": sh.ctx.model_index, "offset": sh.offset,
                              "rows": sh.rows, **rows})
        if self._rank != 0:
            self._start(step, block, t0, self._write_row_file, (tmp, rows_tree))
            return True
        manifest = [{"file": ROWS_FILE.format(i), "offset": i * sh.rows, "rows": sh.rows}
                    for i in range(sh.mp)]
        tree = _on_host({**self._tree(step, rest, generators, online), "rows": manifest})
        self._start(step, block, t0, self._write_grid, (step, tmp, rows_tree, tree))
        return True

    def _write_guarded(self, write, args) -> None:
        try:
            write(*args)
        except BaseException as e:  # raised by the next wait_until_finished
            self._error = e

    def _write(self, step: int, payload: dict) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _save_synced(payload, os.path.join(tmp, STATE_FILE))
        self._publish(step, tmp, t0)

    def _write_row_file(self, tmp: str, rows: dict) -> None:
        """A rank's row file, then its marker for rank 0's writer."""
        t0 = time.perf_counter()
        os.makedirs(tmp, exist_ok=True)
        path = os.path.join(tmp, ROWS_FILE.format(rows["model_index"]))
        _save_synced(rows, path)
        # before the marker: once it is there, rank 0 may rename the directory
        self.last_save.update(write_s=time.perf_counter() - t0, bytes=os.path.getsize(path))
        _save_synced(b"", os.path.join(tmp, MARKER.format(rows["model_index"])))

    def _write_grid(self, step: int, tmp: str, rows: dict, tree: dict) -> None:
        """Rank 0's writer on a grid: its row file and ``state.pt``, then
        the rename once every model index's marker is there."""
        t0 = time.perf_counter()
        os.makedirs(tmp, exist_ok=True)
        _save_synced(rows, os.path.join(tmp, ROWS_FILE.format(0)))
        _save_synced(tree, os.path.join(tmp, STATE_FILE))
        waiting = [MARKER.format(i) for i in range(1, len(tree["rows"]))]
        deadline = time.monotonic() + MARKER_TIMEOUT_S
        while waiting:
            waiting = [m for m in waiting if not os.path.exists(os.path.join(tmp, m))]
            if waiting and time.monotonic() > deadline:
                raise TimeoutError(
                    f"checkpoint {step}: no {', '.join(waiting)} in {tmp} after "
                    f"{MARKER_TIMEOUT_S} s: the ranks at data index 0 of those "
                    f"model indices did not finish their row files")
            if waiting:
                time.sleep(0.01)
        for m in os.listdir(tmp):
            if m.startswith(".done-"):
                os.remove(os.path.join(tmp, m))
        self._publish(step, tmp, t0)

    def _publish(self, step: int, tmp: str, t0: float) -> None:
        """Rename the step's finished directory into place, then keep only
        the newest ``max_to_keep`` steps."""
        final = os.path.join(self.directory, str(step))
        os.replace(tmp, final)
        for old in self._steps()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        self.last_save.update(write_s=time.perf_counter() - t0, bytes=sum(
            os.path.getsize(os.path.join(final, f)) for f in os.listdir(final)))

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
                             map_location="cpu", weights_only=True,
                             mmap=self._grid[1] > 1)
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
            if "rows" in payload:
                rows = self._row_file(step, payload["rows"], target)
                spmd.load_local_state(target, spmd.join_tables(payload, rows))
            else:
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

    def _row_file(self, step: int, manifest: list[dict], target: TrainState) -> dict:
        """This rank's row file of a grid checkpoint, memory-mapped; raises
        when it is missing or holds other rows than the rank's."""
        sh = target.sharding
        entry = manifest[self._model_index]
        path = os.path.join(self.directory, str(step), entry["file"])
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"checkpoint {step}: the row file {entry['file']} of model index "
                f"{self._model_index} (rows [{entry['offset']}, "
                f"{entry['offset'] + entry['rows']})) is missing from "
                f"{os.path.dirname(path)}")
        rows = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        want = (self._model_index, sh.offset, sh.rows)
        got = (rows["model_index"], rows["offset"], rows["rows"])
        if got != want or (entry["offset"], entry["rows"]) != want[1:]:
            raise ValueError(
                f"checkpoint {step}: {entry['file']} holds model index {got[0]}'s rows "
                f"[{got[1]}, {got[1] + got[2]}); this rank (model index {want[0]}) "
                f"holds [{want[1]}, {want[1] + want[2]}): the table's vocabulary or "
                f"padding differs from the checkpoint's")
        return rows

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
