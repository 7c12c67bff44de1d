"""The cross-topology restore (deepfm_tpu_torch/checkpoint/reshard.py) on
gloo CPU ranks spawned through ``_torch_grid.spawn`` (rank bodies:
``_torch_elastic_worker.reshard_save``/``reshard_restore``), at the grid
tests' widths (V = 301, F = 6, K = 8, MLP 16/8).

Grid checkpoints written at ``[1, 2]`` and ``[2, 2]`` (dense Adam, with
ZeRO at two data indices, and lazy Adam) restore at ``[1, 4]``, ``[4, 1]``
and ``[1, 1]``: each rank's tables, slots and moments equal the rows of
the gathered state at its new window (zeros past the old padding), the
rest of the state equals it, and no slice the reshard copied out of a
file holds more rows than the rank's window.  A non-zero row that the
new padding drops raises ``ReshardDataLossError``.  The same weights
through JAX's ``restore_resharded`` give the same whole tables.  A lazy
``[2, 2]`` checkpoint of xDeepFM and of DCN-v2 (fm_v alone) restores at
``[1, 4]`` and ``[1, 1]`` the same way."""

import os

import jax
import numpy as np
import pytest
import torch

import _torch_elastic_worker as worker
from _torch_grid import V, grid_batches, jax_cfg, port_cfg, spawn, variant_widths
from deepfm_tpu.checkpoint import Checkpointer as JaxCheckpointer
from deepfm_tpu.checkpoint import restore_resharded as jax_restore_resharded
from deepfm_tpu.core.config import MeshConfig as JaxMeshConfig
from deepfm_tpu.parallel import build_mesh, create_spmd_state, make_context
from deepfm_tpu_torch.checkpoint import (Checkpointer, ReshardDataLossError,
                                        restore_resharded)
from deepfm_tpu_torch.convert import params_to_jax
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.train.step import create_train_state

MODES = {"dense": {}, "lazy": {"lazy_embedding_updates": True}}
SAVED = {(1, 2): ("dense", "lazy"), (2, 2): ("dense", "lazy")}
TARGETS = [(1, 4), (4, 1)]
SAVED_KEYS = sorted((g, m) for g, ms in SAVED.items() for m in ms)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Every (grid, mode) checkpoint, written by its own grid's ranks after
    two steps."""
    root = tmp_path_factory.mktemp("reshard")
    out = {}
    for (dp, mp), modes in SAVED.items():
        jobs = []
        for mode in modes:
            d = str(root / f"{dp}x{mp}-{mode}")
            cfg = port_cfg(jax_cfg(dp, mp, model={"shard_exchange": "alltoall"},
                                   optimizer=MODES[mode]))
            jobs.append({"cfg": cfg, "batches": grid_batches(2, seed=dp * 10 + mp), "dir": d})
            out[(dp, mp, mode)] = d
        spawn(worker.reshard_save, root, dp * mp, jobs)
    return out


def _restore_cfg(dp, mp, mode) -> dict:
    return port_cfg(jax_cfg(dp, mp, model={"shard_exchange": "alltoall"},
                            optimizer=MODES[mode]))


def _assert_window(local: dict, full: dict, offset: int, rows: dict, what: str) -> None:
    """``local`` (a rank's ``local_state``) against the gathered ``full``:
    table leaves at ``[offset, offset + rows)`` (zero past the saved rows),
    the rest equal."""
    def check(a, b, key, name):
        if key in ("fm_w", "fm_v"):
            want = torch.zeros((rows[key],) + tuple(b.shape[1:]), dtype=b.dtype)
            n = max(0, min(rows[key], b.shape[0] - offset))
            want[:n] = b[offset:offset + n]
            assert torch.equal(a, want), f"{what} {name}"
        else:
            assert torch.equal(a, b), f"{what} {name}"

    for k, t in full["model"].items():
        check(local["model"][k], t, k, f"model.{k}")
    assert local["optimizer"]["count"] == full["optimizer"]["count"]
    for k, slots in full["optimizer"]["slots"].items():
        for s, t in slots.items():
            check(local["optimizer"]["slots"][k][s], t, k, f"slot {k}.{s}")
    if full["lazy"] is not None:
        for m, d in full["lazy"].items():
            for k, t in d.items():
                check(local["lazy"][m][k], t, k, f"lazy {m}.{k}")


@pytest.mark.parametrize("to", TARGETS, ids=[f"to{a}x{b}" for a, b in TARGETS])
def test_a_grid_checkpoint_restores_on_another_grid(tmp_path, saved, to):
    dp, mp = to
    jobs = [{"cfg": _restore_cfg(dp, mp, mode), "dir": d}
            for (_, _, mode), d in sorted(saved.items())]
    ranks = spawn(worker.reshard_restore, tmp_path, dp * mp, jobs)
    for j, key in enumerate(sorted(saved)):
        ref = torch.load(os.path.join(saved[key], "full.pt"), weights_only=True)
        for rank, results in enumerate(ranks):
            r = results[j]
            what = f"{key} -> {to} rank {rank}"
            assert r["resharded"] and r["step"] == ref["step"] == 2, what
            _assert_window(r["local"], ref["full"], r["offset"], r["rows"], what)
            window = max(r["rows"].values())
            assert r["slices"] and max(n for _, n in r["slices"]) <= window, what


@pytest.mark.parametrize("key", SAVED_KEYS, ids=[f"{a}x{b}-{m}" for (a, b), m in SAVED_KEYS])
def test_a_grid_checkpoint_restores_on_one_card(saved, key):
    (dp, mp), mode = key
    d = saved[(dp, mp, mode)]
    cfg = Config.from_dict(_restore_cfg(1, 1, mode))
    fresh = create_train_state(cfg.with_overrides(run={"seed": 99}), "cpu")
    ckpt = Checkpointer(d)
    assert restore_resharded(ckpt, fresh) is fresh and ckpt.last_restore["resharded"]
    ref = torch.load(os.path.join(d, "full.pt"), weights_only=True)
    from deepfm_tpu_torch.parallel import spmd

    rows = {k: getattr(fresh.model, k).shape[0] for k in ("fm_w", "fm_v")}
    _assert_window(spmd.local_state(fresh), ref["full"], 0, rows, f"{key} -> [1, 1]")


def test_a_dropped_non_zero_row_raises(saved, tmp_path):
    """fm_w at one card holds V rows; the [1, 2] checkpoint holds V + 1
    (302): its last row is a pad row, and a non-zero value there is data
    the restore would lose."""
    import shutil

    d = str(tmp_path / "ck")
    shutil.copytree(saved[(1, 2, "dense")], d)
    path = os.path.join(d, "2", "rows-1.pt")
    rows = torch.load(path, weights_only=True)
    rows["model"]["fm_w"][-1] = 0.5
    torch.save(rows, path)
    cfg = Config.from_dict(_restore_cfg(1, 1, "dense"))
    with pytest.raises(ReshardDataLossError, match="non-zero"):
        Checkpointer(d).restore(create_train_state(cfg, "cpu"))


def test_jax_restore_resharded_gives_the_same_tables(saved, tmp_path):
    """The [1, 2] dense checkpoint's weights saved by JAX at model_parallel
    2 and restored by JAX's ``restore_resharded`` at model_parallel 4 equal
    the port's [1, 4] restore of the same weights, table for table (JAX's
    meshes span its eight virtual devices, [4, 2] and [2, 4]: the padding
    is the model axis's)."""
    ref = torch.load(os.path.join(saved[(1, 2, "dense")], "full.pt"), weights_only=True)
    sd = ref["full"]["model"]
    jcfg = jax_cfg(1, 2, model={"shard_exchange": "alltoall"})
    ctx = make_context(jcfg, build_mesh(JaxMeshConfig(data_parallel=4, model_parallel=2)))
    pcfg = Config.from_dict(ctx.cfg.to_dict())
    params, _ = params_to_jax(sd, pcfg.model)
    state = create_spmd_state(ctx)
    state = state._replace(params=jax.tree_util.tree_map(
        lambda a, s: jax.device_put(np.asarray(a), s), params, ctx.state_shardings.params))
    ck = JaxCheckpointer(tmp_path / "jax")
    ck.save(state, block=True)
    new = make_context(jcfg, build_mesh(JaxMeshConfig(data_parallel=2, model_parallel=4)))
    got = jax_restore_resharded(ck, new)
    ck.close()
    ranks = spawn(worker.reshard_restore, tmp_path, 4,
                  [{"cfg": _restore_cfg(1, 4, "dense"), "dir": saved[(1, 2, "dense")],
                    "gather": True}])
    tables = ranks[0][0]["tables"]
    for k in ("fm_w", "fm_v"):
        want = np.asarray(jax.device_get(got.params[k]))
        assert tables[k].shape[0] == want.shape[0] == 304 and V < 304
        np.testing.assert_array_equal(tables[k].numpy(), want, err_msg=k)


@pytest.mark.parametrize("name", ["xdeepfm", "dcnv2"])
def test_a_variant_grid_checkpoint_restores_on_another_grid(tmp_path, name):
    """A lazy [2, 2] checkpoint of the family after two steps restores at
    [1, 4] on four ranks and at [1, 1] here: every table the family has,
    its lazy moments, its Adam slots at the new window; the CIN or cross
    weights as saved."""
    model = {"shard_exchange": "alltoall", **variant_widths(name)}
    d = str(tmp_path / "saved")
    spawn(worker.reshard_save, tmp_path, 4,
          [{"cfg": port_cfg(jax_cfg(2, 2, model=model, optimizer=MODES["lazy"])),
            "batches": grid_batches(2, seed=5), "dir": d}])
    ref = torch.load(os.path.join(d, "full.pt"), weights_only=True)
    tables = {"xdeepfm": {"fm_w", "fm_v"}, "dcnv2": {"fm_v"}}[name]
    assert set(ref["full"]["lazy"]["m"]) == tables
    ranks = spawn(worker.reshard_restore, tmp_path, 4,
                  [{"cfg": port_cfg(jax_cfg(1, 4, model=model, optimizer=MODES["lazy"])),
                    "dir": d}])
    for rank, (r,) in enumerate(ranks):
        assert r["resharded"] and r["step"] == 2 and set(r["rows"]) == tables
        _assert_window(r["local"], ref["full"], r["offset"], r["rows"], f"{name} rank {rank}")
    cfg = Config.from_dict(port_cfg(jax_cfg(1, 1, model=model, optimizer=MODES["lazy"])))
    fresh = create_train_state(cfg.with_overrides(run={"seed": 99}), "cpu")
    restore_resharded(Checkpointer(d), fresh)
    from deepfm_tpu_torch.parallel import spmd

    rows = {k: getattr(fresh.model, k).shape[0] for k in tables}
    _assert_window(spmd.local_state(fresh), ref["full"], 0, rows, f"{name} -> [1, 1]")
