"""The ZeRO weight update (train/optimizer.py ``ZeroOptimizer``) and the
conversion of a JAX ``[dp, mp]`` train state (``convert.
train_state_from_jax(..., ctx=)``), on the CPU: gloo ranks spawned with
``torch.multiprocessing`` (``_torch_dist_worker.grid_steps``), JAX on the
virtual CPU devices, at the widths of ``_torch_grid.py``.

* 3 dense steps with ZeRO at ``[2, 1]`` and ``[4, 1]`` against the port's
  replicated data-parallel step from the same weights: bit for bit at
  two data indices (a sum of two gradients is the same in either order),
  within 1e-6 at four (the reduce-scatter and the all-reduce may add in
  other orders; the metrics ride a smaller all-reduce buffer there, which
  gloo may add in another order too); and against JAX ``zero_sharded`` (``zero_sharding``
  "auto") within 1e-5 relative on the metrics and 1e-5 absolute on the
  parameters and moments;
* the moments partitioned 1/dp: each rank's slot is its window
  (``ceil(n/dp)`` of a dense leaf, the padding tail zero; ``n/dp`` of a
  row shard's flatten);
* the ineligible-leaf rule at ``[2, 2]``: fm_w's 151-row shard does not
  split in 2 and keeps the replicated update, as JAX's
  ``zero_layout_size`` says;
* a JAX ``[2, 2]`` state after 2 steps, dense with ``ZeroDpState`` and lazy
  with ZeRO on the rest, carried onto the port's grid by ``convert``
  (equal to JAX's, bit for bit) and stepped once more beside JAX (1e-5).
"""

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from _torch_grid import B, JaxRun, assert_state_close, grid_batches, jax_cfg, port_cfg, spawn
from deepfm_tpu.train.optimizer import zero_layout_size
from deepfm_tpu_torch.core.config import OptimizerConfig
from deepfm_tpu_torch.train import optimizer as port_opt

ZERO = {"zero_sharding": "auto"}
OFF = {"zero_sharding": "off"}


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    batches = grid_batches(3, seed=11)
    runs = {}
    for world, dp in ((2, 2), (4, 4)):
        jrun = JaxRun(jax_cfg(dp, 1, optimizer=ZERO))
        jax_ref = (jrun.steps(batches), jrun.params(), jrun.moments())
        jobs = [{"cfg": port_cfg(jax_cfg(dp, 1, optimizer=opt)), "weights": jrun.weights,
                 "batches": batches} for opt in (ZERO, OFF)]
        keys = [((dp, 1), "zero"), ((dp, 1), "replicated")]
        refs = {}
        if world == 4:
            for lazy in (False, True):
                opt = {**ZERO, "lazy_embedding_updates": lazy}
                model = {"shard_exchange": "alltoall"}
                carry = JaxRun(jax_cfg(2, 2, model, opt))
                carry.steps(batches[:2])
                before = (carry.params(), carry.moments())
                jobs.append({"cfg": port_cfg(carry.jcfg), "jax_state": carry.numpy_state(),
                             "batches": batches[2:]})
                metrics = carry.steps(batches[2:])
                keys.append(((2, 2), f"carried_lazy{lazy}"))
                refs[keys[-1]] = (before, (metrics, carry.params(), carry.moments()))
        ranks = spawn(worker.grid_steps, tmp, world, jobs)
        for j, key in enumerate(keys):
            runs[key] = {"ranks": [r[j] for r in ranks], "jax": jax_ref,
                         "carry": refs.get(key)}
    return runs


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("dp", [2, 4])
def test_zero_equals_the_replicated_step_and_jax(zero_runs, dp):
    zero = zero_runs[((dp, 1), "zero")]["ranks"]
    repl = zero_runs[((dp, 1), "replicated")]["ranks"]
    jmetrics, jparams, jmoments = zero_runs[((dp, 1), "zero")]["jax"]
    for z, r in zip(zero, repl):
        assert z["plans"] is not None and r["plans"] is None
        for name, t in z["full"]["model"].items():
            want = r["full"]["model"][name]
            if dp == 2:
                assert torch.equal(_bits(t), _bits(want)), name
            else:
                np.testing.assert_allclose(t.numpy(), want.numpy(), rtol=0, atol=1e-6,
                                           err_msg=name)
        zm, rm = z["full"]["optimizer"]["slots"], r["full"]["optimizer"]["slots"]
        for name in rm:
            for slot in ("mu", "nu"):
                if dp == 2:
                    assert torch.equal(_bits(zm[name][slot]), _bits(rm[name][slot]))
                else:
                    np.testing.assert_allclose(zm[name][slot].numpy(),
                                               rm[name][slot].numpy(), rtol=0, atol=1e-6)
        if dp == 2:
            assert z["metrics"] == r["metrics"]
        for zm_, rm_ in zip(z["metrics"], r["metrics"]):  # one buffer or another
            for key, w in rm_.items():
                np.testing.assert_allclose(zm_[key], w, rtol=1e-6, err_msg=key)
    for got, want in zip(zero[0]["metrics"], jmetrics):
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=1e-5, err_msg=key)
        assert got["examples"] == B
    assert_state_close(zero[0]["full"], jparams, jmoments, 1e-5, f"zero dp={dp}")


@pytest.mark.parametrize("dp", [2, 4])
def test_zero_moments_are_partitioned(zero_runs, dp):
    ranks = zero_runs[((dp, 1), "zero")]["ranks"]
    full = ranks[0]["full"]["model"]
    for r in ranks:
        d = r["grid"][0]
        for name, (n, chunk) in r["plans"].items():
            assert n == full[name].numel() and chunk == -(-n // dp)
            for slot in ("mu", "nu"):
                win = r["slots"][name][slot]
                assert win.shape == (chunk,)
                live = max(0, min(chunk, n - d * chunk))
                assert not win[live:].any()  # the padding tail stays zero
                flat = ranks[0]["full"]["optimizer"]["slots"][name][slot].reshape(-1)
                assert torch.equal(win[:live], flat[d * chunk:d * chunk + live])


def test_the_ineligible_leaf_keeps_the_replicated_update(zero_runs):
    for r in zero_runs[((2, 2), "carried_lazyFalse")]["ranks"]:
        plans = r["plans"]
        pv = r["full"]["model"]["fm_w"].shape[0]
        rows = pv // 2
        assert rows % 2 == 1 and plans["fm_w"] is None
        assert zero_layout_size(pv, 2, 2) is None
        assert port_opt.zero_layout_size(pv, 2, 2) is None
        assert plans["fm_v"] == (rows * 8, rows * 4)
        assert port_opt.zero_layout_size(pv * 8, 2, 2) == zero_layout_size(pv * 8, 2, 2)
        assert r["slots"]["fm_w"]["mu"].shape == (rows,)  # whole: replicated
        assert r["slots"]["fm_v"]["mu"].shape == (rows * 4,)
        assert plans["mlp.out.kernel"] == (8, 4)
    for n, shards, dp in [(37, 1, 4), (302, 2, 2), (2416, 2, 2), (1, 1, 8)]:
        assert port_opt.zero_layout_size(n, shards, dp) == zero_layout_size(n, shards, dp)
    for mode, dp, on in [("off", 4, False), ("on", 1, False), ("auto", 2, True),
                         ("on", 2, True)]:
        cfg = OptimizerConfig(zero_sharding=mode)
        assert port_opt.resolve_zero_sharding(cfg, dp) is on


@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
def test_a_jax_grid_state_carries_into_the_port(zero_runs, lazy):
    run = zero_runs[((2, 2), f"carried_lazy{lazy}")]
    (params, moments), (jmetrics, jparams, jmoments) = run["carry"]
    for r in run["ranks"]:
        assert r["carried"]["optimizer"]["count"] == 2
        for name, w in params.items():
            assert torch.equal(r["carried"]["model"][name], w), name
        assert_state_close(r["carried"], params, moments, 0.0, "carried")
        for got, want in zip(r["metrics"], jmetrics):
            for key, w in want.items():
                np.testing.assert_allclose(got[key], w, rtol=1e-5, err_msg=key)
        assert r["step"] == 3
        assert_state_close(r["full"], jparams, jmoments, 1e-5, f"carried lazy={lazy}")
