"""Parent-side helpers of the grid tests (tests/test_torch_sharded*.py,
tests/test_torch_zero.py): spawning gloo ranks (their bodies are in
``_torch_dist_worker.py``), the test's ids and batches, and JAX's side of
a train-step comparison on a ``[dp, mp]`` mesh of the virtual CPU devices
(``tests/conftest.py``), with its state in the port's one-card layout.

Small widths: V = 301 (padded to 302 or 304 on a grid), F = 6, K = 8, a
global batch of 32, MLP 16/8, float32, fused_kernel "off" (JAX's CPU
forward is unfused either way), L2 1e-3, Adam at 1e-3; DeepFM, or xDeepFM
and DCN-v2 with ``variant_widths``."""

import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from deepfm_tpu.core.config import Config as JaxConfig
from deepfm_tpu.core.config import MeshConfig as JaxMeshConfig
from deepfm_tpu.parallel import build_mesh, create_spmd_state, make_context
from deepfm_tpu.parallel import make_spmd_train_step, shard_batch
from deepfm_tpu_torch.convert import (_find_adam_state, _flat_params, expected_shapes,
                                      params_from_jax)
from deepfm_tpu_torch.core.config import Config

V, F, K, B = 301, 6, 8, 32
TIMEOUT_S = 150


def spawn(fn, tmp_path, world, *args):
    """Run ``fn(rank, world, store, out, *args)`` on ``world`` spawned ranks;
    fail (and kill them) if they have not all ended within TIMEOUT_S."""
    out = tmp_path / f"out-{fn.__name__}-{world}"
    out.mkdir(exist_ok=True)
    store = str(tmp_path / f"store-{fn.__name__}-{world}")
    ctx = mp.start_processes(fn, args=(world, store, str(out), *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"{fn.__name__}: ranks still running after {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def grid_ids(rng, b, oor=False):
    """Ids with heavy duplicates (half of them among 12 hot rows); with
    ``oor`` three of them out of range."""
    ids = np.where(rng.random((b, F)) < 0.5, rng.integers(0, 12, (b, F)),
                   rng.integers(0, V, (b, F))).astype(np.int64)
    if oor:
        ids[0, 0], ids[2, 2], ids[3, 1] = -1, 10_000, -7
    return ids


def grid_batches(n, seed):
    rng = np.random.default_rng(seed)
    return [{"feat_ids": grid_ids(rng, B), "feat_vals": rng.random((B, F)).astype(np.float32),
             "label": (rng.random(B) < 0.3).astype(np.float32)} for _ in range(n)]


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def jax_mesh(dp, mp_):
    return build_mesh(JaxMeshConfig(data_parallel=dp, model_parallel=mp_),
                      devices=jax.devices()[:dp * mp_])


def jax_cfg(dp, mp_, model=None, optimizer=None, keep=1.0):
    return JaxConfig.from_dict({
        "model": dict(feature_size=V, field_size=F, embedding_size=K, deep_layers=(16, 8),
                      dropout_keep=(keep, keep), compute_dtype="float32",
                      fused_kernel="off", l2_reg=1e-3, **(model or {})),
        "optimizer": {"learning_rate": 1e-3, **(optimizer or {})},
        "mesh": {"data_parallel": dp, "model_parallel": mp_},
        "data": {"batch_size": B},
    })


def variant_widths(name: str) -> dict:
    """The model fields of another CTR family at these widths (xDeepFM's
    CIN 8/8, DCN-v2's 2 cross layers), for ``jax_cfg``'s ``model``."""
    return {"model_name": name, "cin_layers": (8, 8), "cross_layers": 2}


def port_cfg(jcfg) -> dict:
    """The port's config dict of a JAX config: its batch is per data index."""
    d = jcfg.to_dict()
    d["data"]["batch_size"] = B // jcfg.mesh.data_parallel
    return Config.from_dict(d).to_dict()


def jax_moments(opt_state, lazy: bool, pcfg) -> dict:
    """JAX's Adam moments (and lazy m/v) by ``(state_dict key, slot)`` at
    the port's parameter shapes: the ZeRO layout's flattened leaves cut
    and reshaped."""
    shapes = expected_shapes(pcfg.model)
    out = {}
    rest, lazy_state = opt_state if lazy else (opt_state, None)
    node = _find_adam_state(rest)
    for slot in ("mu", "nu"):
        for name, arr in _flat_params(getattr(node, slot), pcfg.model).items():
            n = int(np.prod(shapes[name]))
            out[(name, slot)] = np.asarray(arr).reshape(-1)[:n].reshape(shapes[name])
    if lazy_state is not None:
        for slot in ("m", "v"):
            for key, arr in getattr(lazy_state, slot).items():
                out[(key, slot)] = np.asarray(arr)
    return out


def port_moments(full) -> dict:
    """The same from the port's one-card layout (``spmd.full_state``)."""
    out = {(n, s): t.numpy() for n, d in full["optimizer"]["slots"].items()
           for s, t in d.items()}
    if full["lazy"] is not None:
        out.update({(n, s): t.numpy() for s, d in full["lazy"].items()
                    for n, t in d.items()})
    return out


class JaxRun:
    """JAX ``make_spmd_train_step`` on ``jcfg``'s mesh: ``weights`` (the
    init, as the port's padded ``state_dict``), ``steps(batches)``, and the
    state now as ``params()``, ``moments()`` or ``numpy_state()``."""

    def __init__(self, jcfg):
        self.jcfg = jcfg
        self.ctx = make_context(jcfg, jax_mesh(jcfg.mesh.data_parallel,
                                               jcfg.mesh.model_parallel))
        self.state = create_spmd_state(self.ctx)
        self.pcfg = Config.from_dict(self.ctx.cfg.to_dict())
        self.step = make_spmd_train_step(self.ctx, donate=False)
        self.weights = self.params()

    def steps(self, batches) -> list[dict]:
        metrics = []
        for batch in batches:
            self.state, m = self.step(self.state, shard_batch(self.ctx, batch))
            metrics.append({k: float(m[k]) for k in ("loss", "ce", "pred_mean",
                                                     "label_mean")})
        return metrics

    def numpy_state(self):
        return to_numpy(self.state)

    def params(self) -> dict:
        s = self.numpy_state()
        return params_from_jax(s.params, s.model_state, self.pcfg.model)

    def moments(self) -> dict:
        return jax_moments(self.numpy_state().opt_state,
                           self.jcfg.optimizer.lazy_embedding_updates, self.pcfg)


def assert_state_close(full, params: dict, moments: dict, atol: float, what: str = ""):
    """A port one-card layout against JAX's parameters and moments."""
    for name, w in params.items():
        np.testing.assert_allclose(full["model"][name].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=f"{what} {name}")
    got = port_moments(full)
    assert got.keys() == moments.keys(), what
    for key, w in moments.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=atol, err_msg=f"{what} {key}")
