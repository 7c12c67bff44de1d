"""The port's optimizers (deepfm_tpu_torch/train/optimizer.py) stepped beside
the JAX package's optax chains from ``build_optimizer``: 10 steps on the
same random gradients, every optimizer, every schedule with warmup, and the
embedding lr multiplier.

Tolerance: 1e-6 absolute and relative on the parameters after every step
and on the optimizer state at the end.  The arithmetic is the same
float32 elementwise sequence; XLA and torch may round sqrt, rsqrt and pow
differently in the last bit, and the schedules are evaluated in float64
here and in float32 by optax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.core.config import OptimizerConfig as JaxOptimizerConfig
from deepfm_tpu.train.optimizer import build_lr_schedule as jax_build_lr_schedule
from deepfm_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from deepfm_tpu_torch.core.config import Config, OptimizerConfig
from deepfm_tpu_torch.train.optimizer import (build_lr_schedule, build_optimizer,
                                              schedule_value)
from deepfm_tpu_torch.train.step import init_opt_state

TOL = 1e-6
SHAPES = {"fm_w": (40,), "fm_v": (40, 4), "mlp": {"layer_0": {"kernel": (4, 3),
                                                              "bias": (3,)}}}
NAMES = ("fm_w", "fm_v", "mlp.layer_0.kernel", "mlp.layer_0.bias")
SLOTS = {"Adam": ("mu", "nu"), "Adagrad": ("sum_of_squares",),
         "Momentum": ("trace",), "Ftrl": ("z", "n")}


def _flat(tree):
    return [tree["fm_w"], tree["fm_v"], tree["mlp"]["layer_0"]["kernel"],
            tree["mlp"]["layer_0"]["bias"]]


def _tree(leaves):
    w, v, k, b = leaves
    return {"fm_w": w, "fm_v": v, "mlp": {"layer_0": {"kernel": k, "bias": b}}}


def _random(rng, scale=1.0):
    return [(scale * rng.normal(size=s)).astype(np.float32)
            for s in (SHAPES["fm_w"], SHAPES["fm_v"], (4, 3), (3,))]


def _jax_slots(opt_state, name):
    """The optax state's per-parameter leaves for the port's slot names."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "_fields")):
        fields = getattr(node, "_fields", ())
        if name == "Adam" and "mu" in fields:
            return {"mu": _flat(node.mu), "nu": _flat(node.nu)}
        if name == "Adagrad" and "sum_of_squares" in fields:
            return {"sum_of_squares": _flat(node.sum_of_squares)}
        if name == "Momentum" and "trace" in fields:
            return {"trace": _flat(node.trace)}
        if name == "Ftrl" and "z" in fields:
            return {"z": _flat(node.z), "n": _flat(node.n)}
    raise AssertionError(f"no {name} state in {opt_state}")


CASES = [
    ("Adam", {}),
    ("Adam", {"embedding_lr_multiplier": 3.0}),
    ("Adam", {"lr_schedule": "constant", "warmup_steps": 4}),
    ("Adam", {"lr_schedule": "cosine", "warmup_steps": 3, "decay_steps": 8,
              "lr_end_fraction": 0.1}),
    ("Adam", {"lr_schedule": "linear", "warmup_steps": 2, "decay_steps": 7,
              "lr_end_fraction": 0.2}),
    ("Adam", {"adam_b1": 0.8, "adam_b2": 0.99, "adam_eps": 1e-6,
              "scale_lr_by_data_parallel": True}),
    ("Adagrad", {}),
    ("Adagrad", {"embedding_lr_multiplier": 0.5, "lr_schedule": "cosine",
                 "warmup_steps": 2, "decay_steps": 9}),
    ("Momentum", {}),
    ("Momentum", {"embedding_lr_multiplier": 2.0, "lr_schedule": "linear",
                  "warmup_steps": 3, "decay_steps": 10}),
    ("Ftrl", {}),
]


@pytest.mark.parametrize("name,extra", CASES,
                         ids=[f"{n}-{'-'.join(e) or 'default'}" for n, e in CASES])
def test_optimizer_matches_optax(name, extra):
    fields = dict(name=name, learning_rate=0.05, **extra)
    tx = jax_build_optimizer(JaxOptimizerConfig(**fields))
    rng = np.random.default_rng(0)
    init = _random(rng)
    jparams = _tree([jnp.asarray(a) for a in init])
    jstate = tx.init(jparams)
    params = {n: torch.from_numpy(a.copy()) for n, a in zip(NAMES, init)}
    opt = build_optimizer(OptimizerConfig(**fields), params)
    for _ in range(10):
        grads = _random(rng)
        updates, jstate = tx.update(_tree([jnp.asarray(g) for g in grads]), jstate,
                                    jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        opt.step(params, {n: torch.from_numpy(g) for n, g in zip(NAMES, grads)})
        for n, want in zip(NAMES, _flat(jparams)):
            np.testing.assert_allclose(params[n].numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL, err_msg=n)
    assert opt.count == 10
    want_slots = _jax_slots(jstate, name)
    for slot in SLOTS[name]:
        for n, want in zip(NAMES, want_slots[slot]):
            np.testing.assert_allclose(opt.slots[n][slot].numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL, err_msg=f"{n} {slot}")


@pytest.mark.parametrize("extra", [
    {"lr_schedule": "constant", "warmup_steps": 5},
    {"lr_schedule": "cosine", "warmup_steps": 5, "decay_steps": 20, "lr_end_fraction": 0.1},
    {"lr_schedule": "cosine", "warmup_steps": 0, "decay_steps": 7},
    {"lr_schedule": "linear", "warmup_steps": 4, "decay_steps": 12, "lr_end_fraction": 0.3},
])
def test_schedules_match_optax(extra):
    cfg = dict(learning_rate=0.01, **extra)
    want = jax_build_lr_schedule(JaxOptimizerConfig(**cfg))
    got = build_lr_schedule(OptimizerConfig(**cfg))
    for step in range(25):
        np.testing.assert_allclose(schedule_value(got, step), float(want(step)),
                                   rtol=1e-6, atol=1e-9)


def test_rejections():
    params = {"fm_w": torch.zeros(3)}
    with pytest.raises(ValueError, match="constant lr only"):
        build_optimizer(OptimizerConfig(name="Ftrl", warmup_steps=2), params)
    with pytest.raises(ValueError, match="embedding_lr_multiplier"):
        build_optimizer(OptimizerConfig(name="Ftrl", embedding_lr_multiplier=2.0), params)
    with pytest.raises(ValueError, match="decay_steps > warmup_steps"):
        build_lr_schedule(OptimizerConfig(lr_schedule="cosine", warmup_steps=4,
                                          decay_steps=4))
    with pytest.raises(ValueError, match="unknown optimizer"):
        OptimizerConfig(name="Lamb")
    lazy = Config().with_overrides(optimizer={"name": "Momentum",
                                              "lazy_embedding_updates": True})
    with pytest.raises(ValueError, match="Adam optimizer only"):
        init_opt_state(lazy, params)
    assert build_lr_schedule(OptimizerConfig(learning_rate=0.1)) == 0.1
