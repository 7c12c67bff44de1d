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
``optax.apply_updates``).

The numbers that change from step to step (lr and Adam's two bias
corrections, computed on the host from the count, the corrections in
float32 as optax computes them) reach the update as float32 device
scalars (:meth:`Optimizer.host_scalars`, :meth:`Optimizer.update`), never
as Python numbers baked into its kernels: a CUDA graph of the train step
(train/step.py) replays the update with each step's values.

:class:`ZeroOptimizer` is JAX's ``zero_sharded`` (ZeRO, arxiv 2004.13336)
over ``torch.distributed``: each rank of a data group owns a 1/dp window
of every flattened parameter and of its moments; a step reduce-scatters
each raw gradient over the data group (``reduce_scatter_tensor``, then
/dp; a replicated leaf's window then comes from model index 0 by
broadcast over the model group, the exact form of JAX's ``pmean`` of
identical values), updates
the window with the inner optimizer, and all-gathers the fresh windows
(``all_gather_into_tensor``).  The layout is JAX's canonical one
(``zero_layout_size``): a dense leaf's flatten padded at its tail to
``dp·ceil(n/dp)``; a row-sharded table leaf's local flatten split in dp
exact windows, and a table leaf whose local size dp does not divide
keeps the replicated update (all_reduce over the data group, full
moments).
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import OptimizerConfig
from ..parallel.branch import arm

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


def adam_bias_corrections(cfg: OptimizerConfig, count: int) -> tuple[float, float]:
    """Adam's two bias corrections at the 1-based update ``count``, in
    float32 as optax computes them (the dense and the lazy step's)."""
    return (_f32_bias_correction(cfg.adam_b1, count),
            _f32_bias_correction(cfg.adam_b2, count))


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
                   scalars: torch.Tensor) -> torch.Tensor:
        """The update for one parameter, lr (``scalars[0]``) applied;
        updates ``slots``."""
        raise NotImplementedError

    def bias_corrections(self, count: int) -> tuple[float, float]:
        """The two bias corrections of update ``count`` (1-based): 1 but
        for Adam."""
        return 1.0, 1.0

    def host_scalars(self) -> tuple[float, float, float]:
        """(lr, first and second bias correction) of the next update, from
        the host count."""
        return (schedule_value(self.lr, self.count),
                *self.bias_corrections(self.count + 1))

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
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], scalars: torch.Tensor) -> None:
        """One update of every parameter from its gradient, reading lr and
        the bias corrections from ``scalars`` (float32 ``[3]`` on the
        parameters' device, :meth:`host_scalars`); the count is the
        caller's to advance."""
        for name, p in params.items():
            u = self._direction(self.slots[name], grads[name], p, scalars)
            if self.multiplier != 1.0 and name.rsplit(".", 1)[-1] in EMBEDDING_PARAM_KEYS:
                u = u * self.multiplier
            p.add_(u)

    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> None:
        """One update of every parameter from its gradient, with this
        count's scalars; advances the count.  On the card the scalars go up
        from a pinned stage by an asynchronous copy (the caching host
        allocator keeps the stage until the copy has run): a plain upload
        from pageable memory waits for the card, which the ZeRO update's
        sync guard refuses (analysis/trace_audit.py ``audit_zero_update``)."""
        if params:
            dev = next(iter(params.values())).device
            scalars = torch.tensor(self.host_scalars(), dtype=torch.float32)
            if dev.type == "cuda":
                scalars = scalars.pin_memory().to(dev, non_blocking=True)
            self.update(params, grads, scalars.to(dev))
        self.count += 1


class Adam(Optimizer):
    slot_names = ("mu", "nu")

    def bias_corrections(self, count):
        return adam_bias_corrections(self.cfg, count)

    def _direction(self, slots, g, p, scalars):
        c = self.cfg
        mu = slots["mu"].mul_(c.adam_b1).add_((1 - c.adam_b1) * g)
        nu = slots["nu"].mul_(c.adam_b2).add_((1 - c.adam_b2) * g.square())
        mu_hat = mu / scalars[1]
        nu_hat = nu / scalars[2]
        return (mu_hat / (nu_hat.sqrt() + c.adam_eps)) * -scalars[0]


class Adagrad(Optimizer):
    slot_names = ("sum_of_squares",)

    def _init_slots(self, p):
        return {"sum_of_squares": torch.full_like(p, self.cfg.adagrad_init_accum)}

    def _direction(self, slots, g, p, scalars):
        sos = slots["sum_of_squares"]
        sos.copy_(g.square() + sos)
        inv = torch.where(sos > 0, torch.rsqrt(sos), torch.zeros_like(sos))  # eps = 0
        return (inv * g) * -scalars[0]


class Momentum(Optimizer):
    slot_names = ("trace",)

    def _direction(self, slots, g, p, scalars):
        trace = slots["trace"]
        trace.copy_(g + self.cfg.momentum * trace)
        return trace * -scalars[0]


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

    def _direction(self, slots, g, p, scalars):
        lr = scalars[0]
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


def resolve_zero_sharding(cfg: OptimizerConfig, data_parallel_size: int) -> bool:
    """Whether the ZeRO update runs: never with "off", else exactly when
    the grid has more than one data index."""
    if cfg.zero_sharding == "off":
        return False
    return data_parallel_size > 1


def zero_chunk(n_local: int, dp: int) -> int:
    """A dense leaf's window: ``ceil(n_local / dp)``."""
    return -(-max(1, n_local) // max(1, dp))


def zero_layout_size(n_total: int, shards: int, dp: int) -> int | None:
    """The flattened global length of a leaf's ZeRO moment, or None for an
    ineligible leaf (a row-sharded table whose per-shard size dp does not
    divide): a table's is its exact flatten, a dense leaf's is padded to
    ``dp·zero_chunk``."""
    n_local, rem = divmod(max(1, n_total), shards)
    if rem:
        return None
    if shards > 1:
        return n_total if n_local % dp == 0 else None
    return zero_chunk(n_local, dp) * dp


class ZeroOptimizer:
    """The ZeRO weight update around an :class:`Optimizer` (module
    docstring).  ``params`` are this rank's parameters (a table leaf its
    row shard); ``sharded`` names the row-sharded leaves (empty at
    ``model_parallel`` 1); ``data_group``/``model_group`` are this rank's
    groups (``model_group`` None at ``model_parallel`` 1).  The inner
    optimizer holds the window slots: ``slots[name]`` is a window for an
    eligible leaf and full for an ineligible one."""

    def __init__(self, cfg: OptimizerConfig, params: Mapping[str, torch.Tensor], *,
                 dp: int, data_index: int, data_group, sharded=(), mp: int = 1,
                 model_group=None, model_src: int = 0, data_parallel_size: int = 1):
        self.dp, self.d = dp, data_index
        self.data_group, self.model_group, self.mp = data_group, model_group, mp
        self.model_src = model_src
        self.sharded = frozenset(sharded)
        self.plans: dict[str, tuple[int, int] | None] = {}
        windows = {}
        for name, p in params.items():
            n = p.numel()
            shards = mp if name in self.sharded else 1
            size = zero_layout_size(n * shards, shards, dp)
            if size is None:
                self.plans[name] = None
                windows[name] = p.detach()
                continue
            chunk = size // (shards * dp)
            self.plans[name] = (n, chunk)
            windows[name] = self._window(p.detach(), n, chunk)
        self.inner = build_optimizer(cfg, windows, data_parallel_size=data_parallel_size)
        # the padding tail stays zero whatever the slots' initial value
        for name, plan in self.plans.items():
            if plan is not None:
                live = self._live(*plan)
                for t in self.inner.slots[name].values():
                    t[live:] = 0.0

    @property
    def lr(self):
        return self.inner.lr

    @property
    def multiplier(self):
        return self.inner.multiplier

    @property
    def cfg(self):
        return self.inner.cfg

    @property
    def count(self) -> int:
        return self.inner.count

    @count.setter
    def count(self, value: int) -> None:
        self.inner.count = value

    @property
    def slots(self) -> dict:
        return self.inner.slots

    def _live(self, n: int, chunk: int) -> int:
        """How many entries of this rank's window are real (not padding)."""
        return max(0, min(chunk, n - self.d * chunk))

    def _window(self, t: torch.Tensor, n: int, chunk: int) -> torch.Tensor:
        flat = t.reshape(-1)
        start = self.d * chunk
        win = flat[start:start + chunk]
        if win.numel() < chunk:
            win = torch.cat([win, win.new_zeros(chunk - win.numel())])
        return win.clone()

    def _padded(self, t: torch.Tensor, chunk: int) -> torch.Tensor:
        flat = t.reshape(-1)
        pad = chunk * self.dp - flat.numel()
        return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat.contiguous()

    def full_slots(self, params: Mapping[str, torch.Tensor]) -> dict:
        """Every slot at its parameter's shape (the windows gathered over
        the data group): a collective."""
        out = {}
        for name, p in params.items():
            plan = self.plans[name]
            out[name] = {}
            for slot, t in self.inner.slots[name].items():
                if plan is None:
                    out[name][slot] = t
                    continue
                n, chunk = plan
                full = t.new_empty(chunk * self.dp)
                dist.all_gather_into_tensor(full, t.contiguous(), group=self.data_group)
                out[name][slot] = full[:n].view_as(p)
        return out

    @torch.no_grad()
    def load_full_slots(self, slots: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
        """Take this rank's windows of slots at their parameters' shapes."""
        for name, plan in self.plans.items():
            for slot, t in self.inner.slots[name].items():
                src = torch.as_tensor(slots[name][slot]).to(t.device)
                if plan is None:
                    t.copy_(src.view_as(t))
                    continue
                n, chunk = plan
                if src.numel() != n:
                    raise ValueError(f"optimizer.{name}.{slot}: {src.numel()} "
                                     f"entries, expected {n}")
                t.copy_(self._window(src, n, chunk))

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> None:
        """One update from this rank's RAW gradients (not yet averaged)."""
        g_win, p_win = {}, {}
        for name, p in params.items():
            g = grads[name]
            plan = self.plans[name]
            if plan is None:  # ineligible: the replicated update
                g = g.clone()
                with arm("zero.ineligible"):
                    dist.all_reduce(g, group=self.data_group)
                g_win[name], p_win[name] = g / self.dp, p
                continue
            n, chunk = plan
            win = g.new_empty(chunk)
            dist.reduce_scatter_tensor(win, self._padded(g, chunk), group=self.data_group)
            win = win / self.dp
            if name not in self.sharded and self.model_group is not None:
                dist.broadcast(win, src=self.model_src, group=self.model_group)
            g_win[name], p_win[name] = win, self._window(p, n, chunk)
        self.inner.step(p_win, g_win)
        for name, p in params.items():
            plan = self.plans[name]
            if plan is None:
                continue
            n, chunk = plan
            full = p.new_empty(chunk * self.dp)
            dist.all_gather_into_tensor(full, p_win[name], group=self.data_group)
            p.copy_(full[:n].view_as(p))


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
