"""The port's train steps on a ``[data x model]`` grid (parallel/spmd.py,
train/lazy.py, train/optimizer.py ZeroOptimizer) against JAX
``make_spmd_train_step`` on the same mesh, on the CPU: gloo ranks spawned
with ``torch.multiprocessing`` (``_torch_dist_worker.grid_steps``), JAX on
the virtual CPU devices, at the widths of ``_torch_grid.py``, from JAX's
init carried across.

On ``[1, 2]``, ``[2, 2]`` and ``[1, 4]``, 3 steps each of: the dense step
under psum; under alltoall with ZeRO as "auto" makes it (on at two data
indices, where fm_w's 151-row shard is the ineligible leaf); under
alltoall; under alltoall at a capacity that overflows (the psum fallback,
which must also equal the no-overflow run within 1e-6); the lazy step
under psum and under alltoall (where every data index's distinct ids
overflow the default pack and every step takes update_full), and at more
than one data index under alltoall at a capacity of 0.9, where every step
takes the unique pack (update_dedup).  On the pure data-parallel grids
``[2, 1]`` and ``[4, 1]``, the lazy modes alone: whole tables, whose rows
the step assembles by a local sort with the sentinel id.
Held to JAX: metrics within 1e-5 relative, parameters and moments within
1e-5 absolute in the one-card layout the checkpoint writes (the FM sums
and gradient scatters change order, so not bit for bit); the pad rows
stay zero; every rank holds the same layout.  With dropout keep 0.5 the
replicas of a model group stay bit-identical.  Ids out of range follow
each path's rule: the dense step refuses them on every rank at the same
step, the lazy step trains no row with them.
"""

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from _torch_grid import B, V, JaxRun, assert_state_close, grid_batches, jax_cfg, port_cfg, spawn
from deepfm_tpu.parallel import padded_vocab as jax_padded_vocab

STEP_MODES = {
    "dense_psum": ({"shard_exchange": "psum"}, {"zero_sharding": "off"}),
    "dense_alltoall_zero": ({"shard_exchange": "alltoall"}, {"zero_sharding": "auto"}),
    "dense_overflow": ({"shard_exchange": "alltoall", "shard_exchange_capacity": 0.1},
                       {"zero_sharding": "off"}),
    "dense_alltoall": ({"shard_exchange": "alltoall"}, {"zero_sharding": "off"}),
    "lazy_psum": ({"shard_exchange": "psum"}, {"lazy_embedding_updates": True}),
    "lazy_alltoall": ({"shard_exchange": "alltoall"}, {"lazy_embedding_updates": True}),
    "lazy_alltoall_pack": ({"shard_exchange": "alltoall", "shard_exchange_capacity": 0.9},
                           {"lazy_embedding_updates": True}),
}
GRIDS_BY_WORLD = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4), (4, 1)]}


def grid_modes(grid) -> list[str]:
    """At one model index only the lazy step differs from the data-parallel
    step of test_torch_dist.py; the pack runs at more than one data index."""
    modes = [m for m in STEP_MODES if grid[1] > 1 or m.startswith("lazy")]
    return [m for m in modes if grid[0] > 1 or not m.endswith("pack")]


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """Every (grid, mode) of STEP_MODES through JAX and the port (one spawn
    a world size), plus the port's dropout runs."""
    tmp = tmp_path_factory.mktemp("steps")
    batches = grid_batches(3, seed=7)
    runs = {}
    for world, grids in GRIDS_BY_WORLD.items():
        jobs, keys = [], []
        for dp, mp_ in grids:
            for mode in grid_modes((dp, mp_)):
                model, opt = STEP_MODES[mode]
                jrun = JaxRun(jax_cfg(dp, mp_, model, opt))
                metrics = jrun.steps(batches)
                jobs.append({"cfg": port_cfg(jrun.jcfg), "weights": jrun.weights,
                             "batches": batches})
                keys.append(((dp, mp_), mode, (metrics, jrun.params(), jrun.moments())))
            for mode in ("dense_alltoall_zero", "lazy_alltoall") if mp_ > 1 else ():
                model, opt = STEP_MODES[mode]
                jobs.append({"cfg": port_cfg(jax_cfg(dp, mp_, model, opt, keep=0.5)),
                             "batches": batches})
                keys.append(((dp, mp_), mode + "_dropout", None))
                # the last data index's rows hold an id in the padding gap, one
                # past the padded table and a negative one
                bad = [{k: v.copy() for k, v in b.items()} for b in batches[:2]]
                bad[1]["feat_ids"][-1, :3] = [V + 1, 10_000, -3]
                jobs.append({"cfg": port_cfg(jax_cfg(dp, mp_, model, opt)), "batches": bad})
                keys.append(((dp, mp_), mode + "_bad_ids", None))
        ranks = spawn(worker.grid_steps, tmp, world, jobs)
        for j, (grid, mode, ref) in enumerate(keys):
            runs[(grid, mode)] = {"jax": ref, "ranks": [r[j] for r in ranks]}
    return runs


GRID_MODES = [(g, m) for g in [(1, 2), (2, 2), (1, 4), (2, 1), (4, 1)]
              for m in grid_modes(g)]


@pytest.mark.parametrize("grid,mode", GRID_MODES,
                         ids=[f"{g[0]}x{g[1]}-{m}" for g, m in GRID_MODES])
def test_steps_match_make_spmd_train_step(step_runs, grid, mode):
    run = step_runs[(grid, mode)]
    jmetrics, jparams, jmoments = run["jax"]
    r0 = run["ranks"][0]
    assert r0["step"] == 3
    for got, want in zip(r0["metrics"], jmetrics):
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=1e-5, err_msg=key)
        assert got["examples"] == B  # each data index counted once
    assert_state_close(r0["full"], jparams, jmoments, 1e-5, f"{grid} {mode}")
    pv = jax_padded_vocab(V, grid[1])
    for name in ("fm_w", "fm_v"):  # pad rows stay zero
        assert r0["full"]["model"][name].shape[0] == pv
        assert not r0["full"]["model"][name][V:].any()
    for r in run["ranks"][1:]:
        for name, t in r["full"]["model"].items():
            assert torch.equal(t, r0["full"]["model"][name]), name
    counters = r0["counters"]
    if mode.startswith("lazy"):
        packed = mode.endswith("pack")
        assert r0["lazy_updates"] == {"dedup": 3 * packed, "full": 3 * (not packed)}
    if grid[1] == 1:  # whole tables: no exchange; the pack's mode stays
        assert counters["lookups"] == 0 and r0["exchange"] == mode.split("_")[1]
    elif mode == "dense_overflow":
        assert counters["fallbacks"] >= 1 and r0["exchange"] == "alltoall"
        base = step_runs[(grid, "dense_alltoall")]["ranks"][0]
        for name, t in base["full"]["model"].items():
            np.testing.assert_allclose(r0["full"]["model"][name].numpy(), t.numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
    elif "alltoall" in mode:
        assert counters["fallbacks"] == 0 and counters["alltoall_bytes"] > 0
    else:
        assert counters["alltoall_bytes"] == 0 and counters["allreduce_bytes"] > 0


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("mode", ["dense_alltoall_zero", "lazy_alltoall"])
def test_model_replicas_stay_bit_identical_with_dropout(step_runs, grid, mode):
    ranks = step_runs[(grid, mode + "_dropout")]["ranks"]
    by_data = {}
    for r in ranks:
        by_data.setdefault(r["grid"][0], []).append(r)
    assert len(by_data) == grid[0]
    for group in by_data.values():
        assert len(group) == grid[1]
        for r in group[1:]:  # the replicated leaves, bit for bit
            for name, t in r["local"].items():
                if name not in ("fm_w", "fm_v"):
                    assert torch.equal(t.view(torch.int32),
                                       group[0]["local"][name].view(torch.int32)), name
            assert r["metrics"] == group[0]["metrics"]
            # one dropout stream a data index, as JAX folds the data index
            assert torch.equal(r["generator"], group[0]["generator"])
    firsts = [group[0]["generator"] for group in by_data.values()]
    assert all(not torch.equal(g, firsts[0]) for g in firsts[1:])


@pytest.mark.parametrize("grid", [(1, 2), (2, 2), (1, 4)], ids=["1x2", "2x2", "1x4"])
def test_out_of_range_ids_follow_each_path_rule(step_runs, grid):
    """The dense step refuses them on every rank at the same step (JAX's
    shard_batch check); the lazy step maps them to its sentinel: they train
    no row, the pad rows stay zero."""
    for r in step_runs[(grid, "dense_alltoall_zero_bad_ids")]["ranks"]:
        assert len(r["metrics"]) == 1 and r["step"] == 1
        assert "feat_ids out of range [0, 301)" in r["error"]
    lazy = step_runs[(grid, "lazy_alltoall_bad_ids")]["ranks"]
    for r in lazy:
        assert r["error"] is None and r["step"] == 2
        assert all(np.isfinite(m["loss"]) for m in r["metrics"])
    model, before = lazy[0]["full"]["model"], lazy[0]["carried"]["model"]
    for name in ("fm_w", "fm_v"):
        assert not model[name][V:].any()
        assert torch.equal(model[name][-1], before[name][-1])  # clipped ids hit no row
