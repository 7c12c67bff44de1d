"""The grid policy and the minimal-traffic N -> M plan: the port's
counterpart of ``deepfm_tpu/elastic/plan.py``.

:func:`choose_mesh` keeps the row-shard width as stable as the device
count allows: a stable ``model_parallel`` keeps the padded vocabulary, so
a same-width shrink moves no table row.

:func:`plan_reshard` is shape arithmetic over two grids: each model index
owns a contiguous row window of the padded tables; after the change a
device fetches only the rows of its new window it did not hold
(``moved_bytes``), keeps the rest (``kept_bytes``), and a device that
joined needs a replica of every dense leaf (``dense_bytes``).
``naive_bytes`` is a gather of everything to one place and back.  The
leaves are those of JAX's train state for the same model and optimizer
(:func:`state_leaves`: the tables, their Adam slots or lazy moments, the
ZeRO windows' flat form at more than one data index, the dense rest and
the PRNG key), so the port's plan and JAX's give the same numbers for
the same moves.

:func:`reshard_state` takes a gathered state (``spmd.full_state``) and
returns a rank's local state on the new grid: the elastic trainer itself
resumes from the committed payload instead (checkpoint/reshard.py reads
each window from the commit's row files), because exactly-once needs the
durable snapshot.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import torch

from ..train.step import LAZY_TABLE_KEYS

TABLE_KEYS = LAZY_TABLE_KEYS


def choose_mesh(n_devices: int, *, prefer_model_parallel: int = 1) -> tuple[int, int]:
    """``(data_parallel, model_parallel)`` for ``n_devices``: the largest
    divisor of the device count not above the preferred row-shard width.
    [8, prefer 4] -> (2, 4); [6, 4] -> (2, 3); [3, 4] -> (1, 3)."""
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    prefer = max(1, prefer_model_parallel)
    mp = max(d for d in range(1, min(prefer, n_devices) + 1) if n_devices % d == 0)
    return n_devices // mp, mp


@dataclass(frozen=True)
class Grid:
    """One topology: ``(dp, mp)``, the tables' padded rows, and the device
    ids in rank order (rank ``r`` at ``(r // mp, r % mp)``)."""

    shape: tuple[int, int]
    padded_vocab: int
    devices: tuple = ()


def _windows(rows: int, mp: int) -> list[tuple[int, int]]:
    per = rows // mp
    return [(m * per, (m + 1) * per) for m in range(mp)]


def _overlap(a: tuple[int, int], b: tuple[int, int]) -> int:
    return max(0, min(a[1], b[1]) - max(a[0], b[0]))


def state_leaves(params: dict, *, dp: int, lazy: bool, zero: bool,
                 slots: Sequence[str] = ("mu", "nu"), buffers: dict | None = None
                 ) -> list[tuple[str, tuple, int]]:
    """``(path, shape, itemsize)`` of JAX's train state for ``params``
    (``{name: tensor or (shape, itemsize)}`` in the one-card layout, tables
    at their padded rows): the parameters, the optimizer slots (at the
    parameter's shape, or the ZeRO flat window ``ceil(n / dp) * dp`` when
    ``zero``; the tables' lazy moments ``m``/``v`` apart under ``lazy``),
    the model state (``buffers``) and the 2-word PRNG key.  Paths are
    JAX's ``keystr`` for the table leaves."""
    def spec(v):
        if isinstance(v, torch.Tensor):
            return tuple(v.shape), v.element_size()
        return tuple(v[0]), int(v[1])

    out = [(f".params['{k}']", *spec(v)) for k, v in params.items()]
    opt = {k: v for k, v in params.items() if not (lazy and k in TABLE_KEYS)}
    prefix = ".opt_state" + ("[0]" if lazy else "")
    for slot in slots:
        for k, v in opt.items():
            shape, size = spec(v)
            if zero:
                n = 1
                for d in shape:
                    n *= int(d)
                out.append((f"{prefix}.zero_dp[0].{slot}['{k}']", (-(-n // dp) * dp,), size))
            else:
                out.append((f"{prefix}[0].{slot}['{k}']", shape, size))
    if lazy:
        for m in ("m", "v"):
            for k in TABLE_KEYS:
                if k in params:
                    out.append((f".opt_state[1].{m}['{k}']", *spec(params[k])))
    for k, v in (buffers or {}).items():
        out.append((f".model_state['{k}']", *spec(v)))
    out.append((".rng", (2,), 4))
    return out


@dataclass(frozen=True)
class ReshardPlan:
    """The planned redistribution, bytes accounted per leaf class (JAX's
    fields).  ``host_round_trip`` is False as in JAX: the plan stages no
    table row through one place (the port restores each rank's window
    from the commit's row files, checkpoint/reshard.py)."""

    from_shape: tuple[int, int]
    to_shape: tuple[int, int]
    from_padded_vocab: int
    to_padded_vocab: int
    tables: dict[str, dict] = field(default_factory=dict)
    moved_bytes: int = 0
    kept_bytes: int = 0
    dense_bytes: int = 0
    joined_devices: int = 0
    naive_bytes: int = 0
    host_round_trip: bool = False

    def validate_target(self, grid: Grid) -> None:
        """Fail before any byte moves when ``grid`` is not the topology this
        plan was drawn for."""
        if tuple(grid.shape) != tuple(self.to_shape):
            raise ValueError(f"reshard plan targets mesh {list(self.to_shape)} but the "
                             f"restore grid is {list(grid.shape)}")
        if grid.padded_vocab != self.to_padded_vocab:
            raise ValueError(f"reshard plan targets padded vocab {self.to_padded_vocab} "
                             f"but the restore grid pads to {grid.padded_vocab}")

    def summary(self) -> dict:
        return {"from_mesh": list(self.from_shape), "to_mesh": list(self.to_shape),
                "from_padded_vocab": self.from_padded_vocab,
                "to_padded_vocab": self.to_padded_vocab, "moved_bytes": self.moved_bytes,
                "kept_bytes": self.kept_bytes, "dense_bytes": self.dense_bytes,
                "joined_devices": self.joined_devices, "naive_bytes": self.naive_bytes,
                "host_round_trip": self.host_round_trip, "tables": self.tables}


def plan_reshard(old: Grid, new: Grid, leaves: Sequence[tuple[str, tuple, int]]
                 ) -> ReshardPlan:
    """The minimal-traffic plan from ``old`` to ``new`` over ``leaves``
    (:func:`state_leaves` of the old grid): a table leaf (a path naming
    fm_w/fm_v whose first dimension is the old padded rows) moves each new
    window's real rows its device did not hold; rows in the padding gap are
    zero fill, never traffic.  Every other leaf costs one replica per
    joined device."""
    pv_old, pv_new = old.padded_vocab, new.padded_vocab
    old_mp, new_mp = old.shape[1], new.shape[1]
    held = {d: w for d, w in zip(old.devices, [_windows(pv_old, old_mp)[i % old_mp]
                                               for i in range(len(old.devices))])}
    new_wins = _windows(pv_new, new_mp)
    joined = sum(1 for d in new.devices if d not in held)
    tables: dict[str, dict] = {}
    moved = kept = dense = naive = 0
    for path, shape, itemsize in leaves:
        if not shape:
            continue
        row_bytes = itemsize
        for dim in shape[1:]:
            row_bytes *= int(dim)
        if any(f"['{k}']" in path for k in TABLE_KEYS) and shape[0] == pv_old:
            t_moved = t_kept = 0
            for i, d in enumerate(new.devices):
                win = new_wins[i % new_mp]
                want = _overlap(win, (0, pv_old))
                have = min(_overlap(win, held[d]) if d in held else 0, want)
                t_moved += want - have
                t_kept += have
            tables[path] = {"rows_from": pv_old, "rows_to": pv_new, "row_bytes": row_bytes,
                            "moved_bytes": t_moved * row_bytes,
                            "kept_bytes": t_kept * row_bytes}
            moved += t_moved * row_bytes
            kept += t_kept * row_bytes
            naive += 2 * pv_old * row_bytes
        else:
            b = int(shape[0]) * row_bytes
            dense += b * joined
            naive += 2 * b
    return ReshardPlan(from_shape=tuple(old.shape), to_shape=tuple(new.shape),
                       from_padded_vocab=pv_old, to_padded_vocab=pv_new, tables=tables,
                       moved_bytes=moved, kept_bytes=kept, dense_bytes=dense,
                       joined_devices=joined, naive_bytes=naive)


def reshard_state(full: dict, keys: Sequence[str], *, offset: int, rows: int) -> dict:
    """A rank's local state on a new grid from a gathered one
    (``spmd.full_state``'s layout): every leaf of a table in ``keys`` cut
    to ``[offset, offset + rows)``, zero-filled past the old rows; the rest
    as it is.  Load it with ``spmd.load_local_state``."""
    from ..parallel import spmd

    def window(t: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t)
        out = t.new_zeros((rows,) + tuple(t.shape[1:]))
        n = max(0, min(t.shape[0], offset + rows) - offset)
        if n:
            out[:n] = t[offset:offset + n]
        return out

    return spmd.map_tables(full, tuple(keys), window)
