"""The cross-topology restore: the port's counterpart of
``deepfm_tpu/checkpoint/reshard.py``.

A checkpoint holds the tables at the padded vocabulary of the grid it was
written on (``padded_vocab(feature_size, model_parallel,
window_multiple)``, parallel/spmd.py), cut into one row file a model index
(``rows-<i>.pt``, its ``[offset, offset + rows)`` in ``state.pt``'s
manifest) or whole in ``state.pt`` (a world of one process, or the grid's
first layout).  Restored on a grid of another ``model_parallel``, each
rank computes its new window and reads, memory-mapped
(``torch.load(..., mmap=True)``), only the overlapping slices of the old
files: the weights, their Adam slots or their lazy moments.  Rows of the
new window past the old padding are zero-filled.  Old rows that the new
padding drops must be all zero (pad rows, never data): every rank checks
them, a window's worth at a time, and raises :class:`ReshardDataLossError`
otherwise, so no rank goes on alone.  The rest of the state (the MLP,
batch norm, the other optimizer slots at their parameters' shapes, the
count) is the same on every grid and loads as it is.

No rank copies more table rows out of a file at once than its new window
holds: ``last_restore["slices"]`` lists every copy ``(leaf, rows)``.

:func:`restore_resharded` and :func:`restore_resharded_payload` are JAX's
entry points: a train state, or an online payload whose cursor and
fencing token come from the same step as its weights (the elastic
trainer's resume point, falling back past an unreadable step).
"""

from __future__ import annotations

import logging
import os

import torch

from ..parallel import spmd
from ..train.step import LAZY_TABLE_KEYS, TrainState

# the last restore's record: {"step", "slices": [(leaf, rows copied)], "dropped_rows"}
last_restore: dict = {}


class ReshardDataLossError(ValueError):
    """The new padding would drop a non-zero row: the target vocabulary is
    smaller than the checkpoint's data.  Not a torn checkpoint, so the
    step fallback propagates it."""


def _window(sources, leaf: str, offset: int, rows: int, dtype, tail: tuple, slices: list
            ) -> torch.Tensor:
    """Rows ``[offset, offset + rows)`` of the table leaf cut into
    ``sources`` (``[(source offset, tensor)]``), zeros past them."""
    out = torch.zeros((rows,) + tail, dtype=dtype)
    for off, t in sources:
        lo, hi = max(offset, off), min(offset + rows, off + t.shape[0])
        if lo < hi:
            out[lo - offset:hi - offset] = t[lo - off:hi - off]
            slices.append((leaf, hi - lo))
    return out


def _check_dropped(sources, leaf: str, total: int, chunk: int, slices: list) -> int:
    """Raise when a source row at or past ``total`` is not zero; returns
    how many such rows there were."""
    dropped = 0
    for off, t in sources:
        start = max(total, off)
        for lo in range(start, off + t.shape[0], max(1, chunk)):
            hi = min(lo + chunk, off + t.shape[0])
            part = t[lo - off:hi - off]
            slices.append((leaf, hi - lo))
            dropped += hi - lo
            if bool((part != 0).any()):
                raise ReshardDataLossError(
                    f"restoring {leaf} at {total} rows would drop non-zero data in rows "
                    f"[{lo}, {hi}) of the checkpoint: the target vocabulary is smaller "
                    f"than the checkpoint's")
    return dropped


def _leaf_sources(payload: dict, step_dir: str) -> dict:
    """``{leaf path: [(offset, tensor)]}`` of every table leaf: the row
    files of a grid checkpoint (memory-mapped), or the whole tables of
    ``state.pt`` at offset 0."""
    out: dict = {}

    def add(tree: dict, offset: int) -> None:
        for k, t in tree.get("model", {}).items():
            if k in LAZY_TABLE_KEYS:
                out.setdefault(("model", k), []).append((offset, t))
        for k, d in tree.get("optimizer", {}).get("slots", tree.get("optimizer", {})).items():
            if k in LAZY_TABLE_KEYS:
                for s, t in d.items():
                    out.setdefault(("optimizer", k, s), []).append((offset, t))
        for m, d in (tree.get("lazy") or {}).items():
            for k, t in d.items():
                if k in LAZY_TABLE_KEYS:
                    out.setdefault(("lazy", m, k), []).append((offset, t))

    if "rows" in payload:
        for entry in payload["rows"]:
            path = os.path.join(step_dir, entry["file"])
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"the row file {entry['file']} (rows [{entry['offset']}, "
                    f"{entry['offset'] + entry['rows']})) is missing from {step_dir}")
            add(torch.load(path, map_location="cpu", weights_only=True, mmap=True),
                int(entry["offset"]))
    else:
        add(payload, 0)
    return out


def load_resharded(state: TrainState, payload: dict, step_dir: str, step: int) -> None:
    """Load ``payload`` (``state.pt``, memory-mapped) of any grid into
    ``state`` in place, each table leaf cut to this rank's window."""
    sh = state.sharding
    mp = sh.mp if sh is not None else 1
    offset = sh.offset if sh is not None and mp > 1 else 0
    model = state.model
    keys = tuple(k for k in LAZY_TABLE_KEYS if hasattr(model, k))
    params = dict(model.named_parameters())
    sources = _leaf_sources(payload, step_dir)
    slices: list = []
    dropped = 0
    tables = {"model": {}, "optimizer": {"count": None, "slots": {}}, "lazy": None}
    if state.lazy is not None:
        tables["lazy"] = {"m": {}, "v": {}}
    for path, srcs in sorted(sources.items()):
        key = path[1] if path[0] != "lazy" else path[2]
        target = params[key]
        rows = target.shape[0]
        name = "/".join(path)
        dropped += _check_dropped(srcs, name, rows * mp, rows, slices)
        win = _window(srcs, name, offset, rows, srcs[0][1].dtype, tuple(srcs[0][1].shape[1:]),
                      slices)
        if path[0] == "model":
            tables["model"][key] = win
        elif path[0] == "optimizer":
            tables["optimizer"]["slots"].setdefault(key, {})[path[2]] = win
        elif tables["lazy"] is not None:
            tables["lazy"][path[1]][key] = win
    rest, _ = spmd.split_tables({"model": payload["model"], "optimizer": payload["optimizer"],
                                 "lazy": payload["lazy"]}, keys)
    spmd.load_local_state(state, spmd.join_tables(rest, tables))
    last_restore.clear()
    last_restore.update(step=step, slices=slices, dropped_rows=dropped)


def restore_resharded(ckpt, state: TrainState, step: int | None = None, *, plan=None,
                      grid=None) -> TrainState:
    """Restore ``ckpt``'s latest (or ``step``) checkpoint, written on any
    grid, into ``state`` (a fresh state on this rank's grid).  ``plan`` (an
    ``elastic.plan.ReshardPlan``) is checked against ``grid`` first."""
    if plan is not None and grid is not None:
        plan.validate_target(grid)
    return ckpt.restore(state, step=step)


def restore_resharded_payload(ckpt, template, step: int | None = None, *, plan=None,
                              grid=None):
    """The online payload (train state, cursor and fencing token of one
    step) of ``step``, or of the newest readable step, restored into
    ``template``'s state on this rank's grid.  An unreadable step falls
    back to the one before; :class:`ReshardDataLossError` propagates."""
    if plan is not None and grid is not None:
        plan.validate_target(grid)
    if step is not None:
        return ckpt.restore(template, step=step)
    steps = sorted(ckpt.all_steps(), reverse=True)
    if not steps:
        raise FileNotFoundError("no checkpoint to restore")
    last_err: Exception | None = None
    for s in steps:
        try:
            return ckpt.restore(template, step=s)
        except ReshardDataLossError:
            raise
        except Exception as e:  # an unreadable step: try the one before
            last_err = e
            logging.getLogger(__name__).warning(
                "checkpoint step %d unreadable (%s: %s): falling back to the previous "
                "payload", s, type(e).__name__, e)
    raise RuntimeError(f"every checkpoint step {steps} is unreadable; last error: "
                       f"{type(last_err).__name__}: {last_err}") from last_err
