"""Row-sharded fm_w/fm_v over a ``[data x model]`` grid in the port
(parallel/embedding.py) against the JAX package, on the CPU.  Ranks are
processes started with ``torch.multiprocessing`` (spawn) in a gloo group
over a ``FileStore`` (the rank bodies are in ``_torch_dist_worker.py``);
JAX runs on ``[1, 2]``, ``[2, 2]`` and ``[1, 4]`` meshes of the virtual CPU
devices (``tests/conftest.py``), at the widths of ``_torch_grid.py``.

* ``exchange_plan``, ``permute_ids``, ``exchange_capacity``,
  ``exchange_wire_bytes_est``, ``padded_vocab`` equal to JAX's;
* the exchange's forward rows bit-equal to JAX ``sharded_lookup`` and to
  the dense gather (zero rows for ids out of range), under psum and
  alltoall, with raw and permuted ids, 2-D and 1-D tables; its table
  gradient (M times the one-card gradient, as JAX's) within 1e-6
  (absolute) of JAX's psum gradient for ``table_grad`` scatter and
  segsum; a capacity small enough to overflow takes the psum fallback and
  gives the same rows and gradients;
* at ``[2, 2]`` eval's AUC, loss and example count equal one process's
  over the same records, and the infer task writes one row a record.

The train steps are held to JAX in ``test_torch_sharded_steps.py``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as worker
from _torch_grid import B, F, K, V, grid_ids, jax_cfg, jax_mesh, spawn
from deepfm_tpu.core.compat import shard_map
from deepfm_tpu.ops.embedding import dense_lookup
from deepfm_tpu.parallel import DATA_AXIS, MODEL_AXIS
from deepfm_tpu.parallel import embedding as jemb
from deepfm_tpu.parallel import padded_vocab as jax_padded_vocab
from deepfm_tpu_torch.core.config import Config
from deepfm_tpu_torch.data.libsvm import generate_synthetic_ctr
from deepfm_tpu_torch.models.deepfm import DeepFM
from deepfm_tpu_torch.parallel import embedding as E
from deepfm_tpu_torch.parallel import spmd
from deepfm_tpu_torch.parallel.mesh import initialize_distributed
from deepfm_tpu_torch.train.loop import run_eval


# -- pure functions ------------------------------------------------------------

@pytest.mark.parametrize("m,cap", [(2, 48), (4, 24), (4, 3)])
def test_exchange_plan_matches_jax(m, cap):
    ids = grid_ids(np.random.default_rng(m), 16, oor=True).reshape(-1)
    rows = 304 // m
    got = E.exchange_plan(torch.from_numpy(ids), rows, m, cap)
    want = jemb.exchange_plan(jnp.asarray(ids.astype(np.int32)), rows, m, cap)
    for name in E.ExchangePlan._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert bool(got.overflow) == (cap == 3)


def test_host_helpers_match_jax():
    ids = np.random.default_rng(0).integers(0, 117_581, (64, 39))
    for vocab in (117_581, 300, 301, 1024):
        np.testing.assert_array_equal(E.permute_ids(ids % vocab, vocab, True),
                                      jemb.permute_ids(ids % vocab, vocab, True))
    assert E.permute_ids(ids, 10, False) is not None
    for n, m, frac in [(96, 2, 0.0), (96, 4, 0.05), (1024 * 39, 4, 0.0), (5, 8, 0.0)]:
        assert E.exchange_capacity(n, m, frac) == jemb.exchange_capacity(n, m, frac)
        for ex in ("alltoall", "psum"):
            assert E.exchange_wire_bytes_est(n, m, frac, (K, 1), exchange=ex) == \
                jemb.exchange_wire_bytes_est(n, m, frac, (K, 1), exchange=ex)
    for v, m, w in [(117_581, 2, 4), (117_581, 4, 4), (301, 2, 16), (301, 4, 1), (1, 8, 1)]:
        assert spmd.padded_vocab(v, m, w) == jax_padded_vocab(v, m, w)
    assert spmd.padded_vocab(117_581, 2, 4) == spmd.padded_vocab(117_581, 4, 4) == 117_584


def test_resolve_shard_exchange():
    def cfg(mp_, mode="auto", lazy=False):
        return Config.from_dict({"model": {"shard_exchange": mode},
                                 "optimizer": {"lazy_embedding_updates": lazy},
                                 "mesh": {"model_parallel": mp_}})
    assert E.resolve_shard_exchange(cfg(2), 2, "cuda") == "alltoall"
    assert E.resolve_shard_exchange(cfg(2), 2, "cpu") == "psum"
    assert E.resolve_shard_exchange(cfg(1), 2, "cuda") == "psum"
    assert E.resolve_shard_exchange(cfg(1, lazy=True), 2, "cuda") == "alltoall"
    assert E.resolve_shard_exchange(cfg(2, "alltoall"), 1, "cpu") == "alltoall"


# -- the exchange --------------------------------------------------------------

MODES = [("psum", "scatter", 0.0), ("psum", "segsum", 0.0), ("alltoall", "scatter", 0.0),
         ("alltoall", "segsum", 0.0), ("alltoall", "scatter", 0.05)]
GRIDS_BY_WORLD = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}


def _jax_lookup(table, ids, dp, mp_, exchange, table_grad, capacity):
    """JAX's assembled rows [B, F(, K)] and per-data-index table gradient
    [dp, pv(, K)] of ½Σrows²."""
    two_d = table.ndim == 2
    tspec = P(MODEL_AXIS, None) if two_d else P(MODEL_AXIS)

    def local(t, i):
        def loss(t):
            out = jemb.sharded_lookup(t, i, exchange=exchange, table_grad=table_grad,
                                      capacity=capacity)
            return jnp.sum(out * out * 0.5), out
        (_, out), g = jax.value_and_grad(loss, has_aux=True)(t)
        return out, g[None]

    fn = shard_map(local, mesh=jax_mesh(dp, mp_), in_specs=(tspec, P(DATA_AXIS, None)),
                   out_specs=(P(DATA_AXIS, None, None) if two_d else P(DATA_AXIS, None),
                              P(DATA_AXIS, MODEL_AXIS, None) if two_d
                              else P(DATA_AXIS, MODEL_AXIS)),
                   check_vma=False)
    rows, g = jax.jit(fn)(table, ids)
    return np.asarray(rows), np.asarray(g)


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_matches_jax_and_the_dense_gather(tmp_path, world):
    rng = np.random.default_rng(world)
    jobs, refs = [], []
    for dp, mp_ in GRIDS_BY_WORLD[world]:
        pv = jax_padded_vocab(V, mp_)
        table = rng.normal(size=(pv, K)).astype(np.float32)
        raw = grid_ids(rng, B, oor=True)
        for ids in (raw, E.permute_ids(raw.clip(0, V - 1), V, True)):
            jobs.append({"mp": mp_, "table": table, "ids": ids, "modes": MODES})
            refs.append((dp, mp_, table, ids))
    ranks = spawn(worker.grid_exchange, tmp_path, world, jobs)
    for j, (dp, mp_, table, ids) in enumerate(refs):
        clean = (ids >= 0) & (ids < table.shape[0])
        for name, t in (("v", table), ("w", np.ascontiguousarray(table[:, 0]))):
            dense = np.array(dense_lookup(jnp.asarray(t), jnp.asarray(ids.clip(0))))
            dense[~clean] = 0.0
            psum_g = {}
            for tg in ("scatter", "segsum"):
                psum_g[tg] = _jax_lookup(t, ids, dp, mp_, "psum", tg, 0.0)[1]
            for mode in MODES:
                want_rows, want_g = _jax_lookup(t, ids, dp, mp_, *mode)
                for r in ranks:
                    res = r[j]
                    d, m, rows = res["data_index"], res["model_index"], res["rows"]
                    b = B // dp
                    got_rows, got_g = res["got"][(mode, name)]
                    what = f"{dp}x{mp_} {mode} {name} rank ({d},{m})"
                    np.testing.assert_array_equal(got_rows.numpy(),
                                                  want_rows[d * b:(d + 1) * b], err_msg=what)
                    np.testing.assert_array_equal(got_rows.numpy(), dense[d * b:(d + 1) * b],
                                                  err_msg=what)
                    shard = slice(m * rows, (m + 1) * rows)
                    np.testing.assert_allclose(got_g.numpy(), psum_g[mode[1]][d, shard],
                                               rtol=0, atol=1e-6, err_msg=what)
                    np.testing.assert_allclose(got_g.numpy(), want_g[d, shard], rtol=0,
                                               atol=1e-6, err_msg=what)
        for r in ranks:
            fallbacks = {mode: r[j]["got"][(mode, "fallbacks")] for mode in MODES}
            assert fallbacks[("alltoall", "scatter", 0.05)] == 2  # both tables
            assert fallbacks[("alltoall", "scatter", 0.0)] == 0


def test_eval_and_infer_count_each_record_once(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    generate_synthetic_ctr(data / "val-0.tfrecords", num_records=45, feature_size=V,
                           field_size=F, seed=3)
    generate_synthetic_ctr(data / "val-1.tfrecords", num_records=38, feature_size=V,
                           field_size=F, seed=4)
    jcfg = jax_cfg(2, 2)
    d = jcfg.to_dict()
    d["data"].update(batch_size=8, val_data_dir=str(data))
    d["run"].update(model_dir=str(tmp_path / "model"), servable_model_dir="")
    cfg = Config.from_dict(d)
    pcfg = spmd.sharded_model_config(cfg, 2)
    whole = DeepFM(pcfg.model, device="cpu", generator=torch.Generator().manual_seed(5))
    weights = {k: v.clone() for k, v in whole.state_dict().items()}
    weights["fm_w"][V:] = 0.0
    weights["fm_v"][V:] = 0.0
    ranks = spawn(worker.grid_eval_infer, tmp_path, 4, cfg.to_dict(), weights)
    one_model = DeepFM(pcfg.model, device="cpu")
    one_model.load_state_dict(weights)
    one_cfg = cfg.with_overrides(mesh={"model_parallel": 1, "data_parallel": -1})
    one = run_eval(one_model, one_cfg, ctx=initialize_distributed(one_cfg.mesh, "cpu"))
    for r in ranks:
        assert r["eval"]["examples"] == 83
        assert r["eval"]["auc"] == pytest.approx(one["auc"], abs=1e-6)
        assert r["eval"]["loss"] == pytest.approx(one["loss"], rel=1e-5)
    lines = Path(ranks[0]["pred"]).read_text().splitlines()
    assert len(lines) == 83
    # only data index 0's model group scores: 83 records in batches of 8
    assert [r["scored"] for r in ranks] == [11 if r["data_index"] == 0 else 0
                                            for r in ranks]
    assert sorted(r["data_index"] for r in ranks) == [0, 0, 1, 1]
