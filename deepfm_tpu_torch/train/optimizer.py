"""Optimizers: counterpart of ``deepfm_tpu/train/optimizer.py``
(``build_optimizer``, ``build_lr_schedule``, ``schedule_value``, ``ftrl``,
the embedding lr split), in optax's semantics, as dense in-place updates
of named parameters.

* **Adam** - optax ``adam``: ``m̂/(√v̂ + ε)`` with ε outside the root of the
  bias-corrected v (as ``torch.optim.Adam`` computes it), bias correction
  from the optimizer's own count;
* **Adagrad** - TF form: the accumulator starts at ``adagrad_init_accum``,
  ε = 0;
* **Momentum** - optax ``sgd(momentum, nesterov=False)``:
  ``trace = g + μ·trace``;
* **Ftrl** - the JAX package's hand-written FTRL-Proximal (TF defaults:
  lr power -0.5, initial accumulator 0.1, no L1/L2), constant lr only.

Every update is scaled by ``-lr`` with ``lr`` the schedule's value at the
pre-increment count, then multiplied by ``embedding_lr_multiplier`` for
``fm_w``/``fm_v``, then added to the parameter (``p + u``, as
``optax.apply_updates``).  ZeRO sharding waits for data-parallel training
(ROADMAP A9).
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np
import torch

from ..core.config import OptimizerConfig

# params whose updates embedding_lr_multiplier scales (by their last name
# component): the CTR tables
EMBEDDING_PARAM_KEYS = ("fm_w", "fm_v")


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule``: init -> end over ``steps``, then end."""
    def schedule(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule`` (exponent 1)."""
    def schedule(count: int) -> float:
        c = min(count, steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / steps)) + alpha)
    return schedule


def _join(first: Callable, then: Callable, boundary: int) -> Callable[[int], float]:
    """optax ``join_schedules`` of two schedules."""
    return lambda count: first(count) if count < boundary else then(count - boundary)


def build_lr_schedule(cfg: OptimizerConfig, *, data_parallel_size: int = 1):
    """A float for a constant lr, or a schedule ``count -> lr`` when warmup
    or decay is configured (the same schedules as the JAX package's)."""
    peak = cfg.learning_rate
    if cfg.scale_lr_by_data_parallel:
        peak = peak * data_parallel_size
    name = cfg.lr_schedule.lower()
    warmup = cfg.warmup_steps
    if name == "constant":
        if warmup <= 0:
            return peak
        return _join(_linear(0.0, peak, warmup), lambda count: peak, warmup)
    if cfg.decay_steps <= warmup:
        raise ValueError(
            f"lr_schedule={name!r} needs decay_steps > warmup_steps "
            f"(got {cfg.decay_steps} <= {warmup}); decay_steps is the TOTAL "
            f"schedule horizon including warmup"
        )
    end = peak * cfg.lr_end_fraction
    if name == "cosine":
        alpha = 0.0 if peak == 0.0 else end / peak
        return _join(_linear(0.0, peak, warmup),
                     _cosine(peak, cfg.decay_steps - warmup, alpha), warmup)
    return _join(_linear(0.0, peak, warmup),
                 _linear(peak, end, cfg.decay_steps - warmup), warmup)


def schedule_value(lr_sched, step: int) -> float:
    """A ``build_lr_schedule`` result at an optimizer step."""
    return float(lr_sched(step)) if callable(lr_sched) else float(lr_sched)


def _f32_bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """Dense update of a dict of named float32 parameters, in place.

    ``count`` is the number of updates applied (optax's count); ``slots``
    maps each parameter's name to its state tensors.  Subclasses give the
    slots' initial values and the update direction before the lr."""

    slot_names: tuple[str, ...] = ()

    def __init__(self, cfg: OptimizerConfig, params: Mapping[str, torch.Tensor],
                 *, data_parallel_size: int = 1):
        self.cfg = cfg
        self.lr = build_lr_schedule(cfg, data_parallel_size=data_parallel_size)
        self.multiplier = cfg.embedding_lr_multiplier
        self.count = 0
        self.slots = {name: self._init_slots(p.detach()) for name, p in params.items()}

    def _init_slots(self, p: torch.Tensor) -> dict[str, torch.Tensor]:
        return {name: torch.zeros_like(p) for name in self.slot_names}

    def _direction(self, slots: dict, g: torch.Tensor, p: torch.Tensor,
                   lr: float, count: int) -> torch.Tensor:
        """The update for one parameter, lr applied; updates ``slots``."""
        raise NotImplementedError

    def state_dict(self) -> dict:
        """``{"count": int, "slots": {param: {slot: tensor}}}``: the live
        slot tensors, not copies (as ``torch.optim``'s ``state_dict``)."""
        return {"count": self.count, "slots": self.slots}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` into this optimizer's slots, in place
        and onto their device; the parameters, slots and shapes must be
        this optimizer's."""
        load_slots(self.slots, state["slots"], "optimizer")
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> None:
        """One update of every parameter from its gradient."""
        lr = schedule_value(self.lr, self.count)
        for name, p in params.items():
            u = self._direction(self.slots[name], grads[name], p, lr, self.count)
            if self.multiplier != 1.0 and name.rsplit(".", 1)[-1] in EMBEDDING_PARAM_KEYS:
                u = u * self.multiplier
            p.add_(u)
        self.count += 1


class Adam(Optimizer):
    slot_names = ("mu", "nu")

    def _direction(self, slots, g, p, lr, count):
        c = self.cfg
        mu = slots["mu"].mul_(c.adam_b1).add_((1 - c.adam_b1) * g)
        nu = slots["nu"].mul_(c.adam_b2).add_((1 - c.adam_b2) * g.square())
        mu_hat = mu / _f32_bias_correction(c.adam_b1, count + 1)
        nu_hat = nu / _f32_bias_correction(c.adam_b2, count + 1)
        return (mu_hat / (nu_hat.sqrt() + c.adam_eps)) * -lr


class Adagrad(Optimizer):
    slot_names = ("sum_of_squares",)

    def _init_slots(self, p):
        return {"sum_of_squares": torch.full_like(p, self.cfg.adagrad_init_accum)}

    def _direction(self, slots, g, p, lr, count):
        sos = slots["sum_of_squares"]
        sos.copy_(g.square() + sos)
        inv = torch.where(sos > 0, torch.rsqrt(sos), torch.zeros_like(sos))  # eps = 0
        return (inv * g) * -lr


class Momentum(Optimizer):
    slot_names = ("trace",)

    def _direction(self, slots, g, p, lr, count):
        trace = slots["trace"]
        trace.copy_(g + self.cfg.momentum * trace)
        return trace * -lr


class Ftrl(Optimizer):
    """FTRL-Proximal (McMahan et al.) with ``tf.train.FtrlOptimizer``'s
    defaults.  It rewrites each weight from its own state, so its update is
    ``w_new - w``."""

    slot_names = ("z", "n")
    lr_power = -0.5
    initial_accumulator_value = 0.1
    l1 = 0.0
    l2 = 0.0

    def __init__(self, cfg, params, *, data_parallel_size: int = 1):
        super().__init__(cfg, params, data_parallel_size=data_parallel_size)
        if callable(self.lr):
            raise ValueError(
                "Ftrl supports constant lr only (its z-state accumulates "
                "1/lr-weighted terms; a schedule would change past state)"
            )
        if self.multiplier != 1.0:
            raise ValueError(
                "embedding_lr_multiplier: Ftrl updates are full weight "
                "rewrites, not lr-linear steps - the multiplier would not "
                "be an lr split; use Adam/Adagrad/Momentum"
            )

    def _init_slots(self, p):
        return {"z": torch.zeros_like(p),
                "n": torch.full_like(p, self.initial_accumulator_value)}

    def _direction(self, slots, g, p, lr, count):
        power = -self.lr_power
        z, n = slots["z"], slots["n"]
        n_new = n + g.square()
        z_new = z + g - (n_new.pow(power) - n.pow(power)) / lr * p
        w_new = torch.where(
            z_new.abs() <= self.l1, torch.zeros_like(p),
            -(z_new - torch.sign(z_new) * self.l1)
            / (n_new.pow(power) / lr + 2.0 * self.l2))
        z.copy_(z_new)
        n.copy_(n_new)
        return w_new - p


def load_slots(dst: dict, src: dict, what: str) -> None:
    """Copy ``src`` (nested dicts of tensors) into the same-shaped nested
    dict of tensors ``dst``, in place; raises naming the first mismatch."""
    if dst.keys() != src.keys():
        raise ValueError(f"{what} state holds {sorted(src)}, expected {sorted(dst)}")
    for key, d in dst.items():
        if isinstance(d, dict):
            load_slots(d, src[key], f"{what}.{key}")
            continue
        t = torch.as_tensor(src[key])
        if t.shape != d.shape:
            raise ValueError(f"{what}.{key}: shape {tuple(t.shape)}, expected "
                             f"{tuple(d.shape)}")
        d.copy_(t)


_OPTIMIZERS = {"adam": Adam, "adagrad": Adagrad, "momentum": Momentum, "ftrl": Ftrl}


def build_optimizer(cfg: OptimizerConfig, params: Mapping[str, torch.Tensor],
                    *, data_parallel_size: int = 1) -> Optimizer:
    """The configured optimizer over ``params`` (name -> tensor)."""
    return _OPTIMIZERS[cfg.name.lower()](cfg, params,
                                         data_parallel_size=data_parallel_size)
