"""A checkpoint of the ``[data x model]`` grid writes each table row range
once, from the rank that holds it (checkpoint/ckpt.py), on gloo CPU ranks
spawned through ``_torch_grid.spawn`` (rank bodies:
``_torch_dist_worker.grid_ckpt``).

At ``[1, 2]`` and ``[2, 2]``, dense Adam (ZeRO at two data indices) and
lazy Adam: during the save and during the restore no rank writes, loads or
gathers over its model group a table tensor (fm_w, fm_v, their slots or
lazy moments) of more rows than its own range; the restored state is
bit-equal to the saved one on every rank; each row file holds its rank's
rows.  A checkpoint in the grid's first layout (whole tables in
``state.pt``) still restores; a missing row file and another
``model_parallel`` raise, naming the cause (and ROADMAP A15)."""

import os

import pytest
import torch

import _torch_dist_worker as worker
from _torch_grid import V, grid_batches, jax_cfg, port_cfg, spawn
from deepfm_tpu_torch.checkpoint import Checkpointer

MODES = {"dense": {}, "lazy": {"lazy_embedding_updates": True}}


def _job(tmp_path, dp, mp, mode, **extra):
    cfg = port_cfg(jax_cfg(dp, mp, model={"shard_exchange": "alltoall"},
                           optimizer=MODES[mode], keep=0.5))
    d = tmp_path / f"ckpt-{dp}x{mp}-{mode}-{len(extra)}-{'-'.join(map(str, extra.values()))}"
    return {"cfg": cfg, "batches": grid_batches(2, seed=dp * 10 + mp), "dir": str(d),
            **extra}


def _assert_bit_equal(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys(), what
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), f"{what} {k}"
        else:
            assert a[k] == b[k], f"{what} {k}"


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_each_rank_saves_and_restores_only_its_rows(tmp_path, dp, mp, mode):
    runs = [r[0] for r in spawn(worker.grid_ckpt, tmp_path, dp * mp,
                                [_job(tmp_path, dp, mp, mode)])]
    for r in runs:
        rows, what = r["rows"], f"rank {r['grid']}"
        assert r["error"] is None, r["error"]
        assert r["rows"] * mp == r["total_rows"] >= V
        for phase in ("save", "restore"):
            assert r[f"{phase}_gathers"] == [], f"{what}: {phase} gathered tables"
            too_big = [(p, n) for p, n in r[f"{phase}_tables"] if n > rows]
            assert not too_big, f"{what}: {phase} held {too_big} (own rows {rows})"
        # a row file was written and read back (the recorder saw its tables)
        assert r["restore_tables"] and all(n == rows for _, n in r["restore_tables"])
        assert r["wrote"] == (r["grid"][0] == 0)
        _assert_bit_equal(r["saved"], r["restored"], what)
        assert r["files"] == ["rows-0.pt", "rows-1.pt", "state.pt"]
    for r in runs:
        if r["grid"][0] != 0:
            continue
        rf, (d, m) = r["row_file"], r["grid"]
        assert (rf[".model_index"], rf[".offset"], rf[".rows"]) == (m, m * r["rows"], r["rows"])
        tables = {k: v for k, v in r["saved"].items() if {"fm_w", "fm_v"} & set(k.split("."))}
        assert len(tables) == 6  # the weights, and two Adam slots or lazy moments each
        for k, v in tables.items():
            path = k.removeprefix(".state")
            assert torch.equal(rf[path], v), f"row file {m}: {path}"


def test_the_first_grid_layout_still_restores(tmp_path):
    runs = [r[0] for r in spawn(worker.grid_ckpt, tmp_path, 2,
                                [_job(tmp_path, 1, 2, "dense", legacy=True)])]
    for r in runs:
        assert r["error"] is None, r["error"]
        assert r["files"] == ["state.pt"]
        _assert_bit_equal(r["saved"], r["restored"], f"rank {r['grid']}")


def test_a_missing_row_file_or_another_model_parallel_raises(tmp_path):
    jobs = [_job(tmp_path, 1, 2, "lazy", drop="rows-1.pt"),
            _job(tmp_path, 1, 2, "dense", restore_mp=1)]
    ranks = spawn(worker.grid_ckpt, tmp_path, 2, jobs)
    dropped = {r[0]["grid"][1]: r[0]["error"] for r in ranks}
    assert dropped[0] is None
    assert dropped[1].startswith("FileNotFoundError") and "rows-1.pt" in dropped[1] \
        and "missing" in dropped[1]
    for r in ranks:
        err = r[1]["error"]
        assert err.startswith("NotImplementedError") and "[1, 2] grid" in err \
            and "A15" in err


def test_rank_0_waits_for_every_row_file_then_gives_up(tmp_path, monkeypatch):
    """Rank 0's writer renames the step only after every model index's
    marker; without one it raises after ``MARKER_TIMEOUT_S``, and no step
    appears."""
    from deepfm_tpu_torch.checkpoint import ckpt as ckpt_module

    monkeypatch.setattr(ckpt_module, "MARKER_TIMEOUT_S", 0.2)
    ckpt = Checkpointer(tmp_path)
    ckpt.last_save = {}
    tmp = tmp_path / ".tmp-7-ab"
    rows = {"model_index": 0, "offset": 0, "rows": 4, "model": {"fm_w": torch.zeros(4)}}
    tree = {"step": 7, "rows": [{"file": "rows-0.pt"}, {"file": "rows-1.pt"}]}
    with pytest.raises(TimeoutError, match=r"\.done-1"):
        ckpt._write_grid(7, str(tmp), rows, tree)
    assert ckpt.all_steps() == []
    (tmp / ".done-1").write_bytes(b"")
    ckpt._write_grid(7, str(tmp), rows, tree)
    assert ckpt.all_steps() == [7] and sorted(os.listdir(tmp_path / "7")) == [
        "rows-0.pt", "state.pt"]
