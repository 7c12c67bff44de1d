"""Train, eval and predict steps: counterpart of ``deepfm_tpu/train/step.py``
(``TrainState``, ``sigmoid_cross_entropy``, ``make_loss_fn``,
``_check_lazy``, ``init_opt_state``, ``make_train_step`` with its lazy
variant, ``jitted_train_step``, ``make_eval_step``, ``make_predict_step``).

**One body, eager or graphed.**  A step is one function,
:func:`resident_body` (dense or lazy), of the state, the batch and the
step's scalars: a float32 device buffer (:data:`SCALARS`) that
:func:`load_scalars` fills from the host counts before each step (the lr
at the optimizer's count, optax's float32 bias corrections, the lazy
rows' lr and corrections), so nothing that changes from step to step is a
Python number inside the body.  :func:`train_step` runs the body eagerly;
:func:`graphed_train_step`, the counterpart of JAX's jitted step with its
state donated, runs it through a :class:`StepGraph`: real warm-up steps
on a side stream, one capture (forward, ``torch.autograd.grad``, the
optimizer and the lazy row update, under
``set_sync_debug_mode("error")``, the dropout generator registered), then
replays, the batch copied into static buffers from the loop's pinned host
batch.  Both advance the host counts the same way after the body.  The
train task's single-card step is graphed on the card
(``parallel/spmd.py``); the CPU, the grid and the online trainer run the
body eagerly.

The JAX functions are pure over an explicit state; here the state holds the
model and optimizer, which the train step updates in place, and the eval
and predict steps take the model alone.  A batch is a
dict of tensors on the model's device: ``feat_ids [B, F]`` (int32 or int64),
``feat_vals [B, F]`` float32 and ``label [B]``.

With ``optimizer.lazy_embedding_updates`` the tables fm_w and fm_v train
with lazy Adam (train/lazy.py) and the rest of the parameters with the
dense optimizer and its own count.  The lazy step runs the model on COMPACT
tables: the batch's B·F ids are sorted into segments at a fixed shape
(``sort_segments``), ``fm_v[row_id]`` and ``fm_w[row_id]`` are gathered
into ``[N, K]`` and ``[N]`` tables, and the forward runs through
``fused_ctr_interaction`` with each lookup's segment as its id.  On the
card that launches the forward kernel, and its backward kernel then writes
the per-segment gradient sums, exactly the sums ``segment_rows`` forms, into
``[N, K]`` and ``[N]`` (zero on padding segments): no ``[V, K]`` gradient
exists and no dense pass over the table runs.

Metrics stay on the device, so a step never waits for the card; the caller
reads them (``float(...)``) only where it logs.  The optimizer update runs
under the ``torch.profiler`` label ``train.optimizer`` (the lazy step's
sort, segments and compact gathers under ``train.lazy_segments`` and its
row update under ``train.lazy_rows``), so a profile can tell their kernels
from the rest of the step.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass

import torch
from torch import nn
from torch.profiler import record_function

from ..core.config import Config
from ..core.platform import resolve_device
from ..models.base import get_model
from ..ops.auc import AUCState, auc_update
from ..ops.embedding import sort_segments
from ..ops import fused_ctr
from ..ops.fused_ctr import fused_ctr_interaction
from .lazy import LazyAdamState, init_lazy_state, lazy_adam_rows
from .optimizer import Optimizer, adam_bias_corrections, build_optimizer, schedule_value

# tables eligible for lazy updates: the CTR families gather fm_w (1-D) and
# fm_v (2-D) once per lookup
LAZY_TABLE_KEYS = ("fm_w", "fm_v")
METRIC_KEYS = ("loss", "ce", "pred_mean", "label_mean")
# the step's per-step numbers, one float32 device buffer (step_scalars):
# the dense optimizer's lr and bias corrections, the lazy rows' lr and
# bias corrections
SCALARS = ("lr", "bc1", "bc2", "embedding_lr", "lazy_bc1", "lazy_bc2")


@dataclass
class TrainState:
    """What training carries from step to step.  ``step`` counts optimizer
    steps; ``generator`` is the model's dropout generator (the JAX state's
    per-step folded PRNG key).  With lazy embedding updates ``optimizer``
    holds the non-table parameters only and ``lazy`` the tables' moments
    (the JAX ``(rest_opt, LazyAdamState)`` pair); otherwise ``lazy`` is
    None.  ``sharding`` (parallel/spmd.py ``Sharding``) says how a state
    of a ``[data x model]`` grid lies over it: row-sharded tables, the ZeRO
    update or the lazy step at more than one data index; None for a
    replicated state.  ``scalars`` is the step's device buffer of per-step
    numbers (:func:`step_scalars`) and ``graph`` the single-card step's
    :class:`StepGraph` once the card runs it, both made at first use."""

    step: int
    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    lazy: LazyAdamState | None = None
    sharding: object | None = None
    scalars: torch.Tensor | None = None
    graph: object | None = None


def _lazy_keys(params) -> list[str]:
    return [k for k in LAZY_TABLE_KEYS if k in params]


def _check_lazy(cfg: Config, params) -> bool:
    """Whether the lazy update is on; raises where it cannot run: another
    optimizer than Adam, no CTR table, or ``fused_kernel="on"`` (JAX
    refuses it: the lazy step substitutes its own row lookup)."""
    if not cfg.optimizer.lazy_embedding_updates:
        return False
    if cfg.optimizer.name.lower() != "adam":
        raise ValueError("lazy_embedding_updates supports the Adam optimizer only")
    if not _lazy_keys(params):
        raise ValueError(
            f"lazy_embedding_updates needs at least one of {LAZY_TABLE_KEYS} "
            f"(CTR model families); {cfg.model.model_name!r} has {sorted(params)}"
        )
    if cfg.model.fused_kernel == "on":
        raise ValueError(
            "fused_kernel='on' requires the dense single-table lookup path; "
            "lazy_embedding_updates substitutes its own row lookup: use "
            "fused_kernel='auto' (or 'off') with it"
        )
    return True


def init_opt_state(cfg: Config, params: dict, *, data_parallel_size: int = 1
                   ) -> tuple[Optimizer, LazyAdamState | None]:
    """The optimizer over ``params``, or, with lazy embedding updates, the
    dense optimizer over the non-table parameters and the tables'
    ``LazyAdamState``."""
    if not _check_lazy(cfg, params):
        return build_optimizer(cfg.optimizer, params,
                               data_parallel_size=data_parallel_size), None
    keys = _lazy_keys(params)
    rest = {k: p for k, p in params.items() if k not in keys}
    return (build_optimizer(cfg.optimizer, rest, data_parallel_size=data_parallel_size),
            init_lazy_state({k: params[k].detach() for k in keys}))


def create_train_state(cfg: Config, device=None, *, data_parallel_size: int = 1
                       ) -> TrainState:
    """A fresh model (weights drawn from a generator seeded ``run.seed``) on
    ``device`` (default: the card) and its optimizer state;
    ``data_parallel_size`` scales the lr when
    ``optimizer.scale_lr_by_data_parallel`` is set."""
    device = resolve_device(device)
    model = get_model(cfg.model).build(
        cfg.model, device=device,
        generator=torch.Generator().manual_seed(cfg.run.seed))
    optimizer, lazy = init_opt_state(cfg, dict(model.named_parameters()),
                                     data_parallel_size=data_parallel_size)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      generator=model.dropout_generator, lazy=lazy)


def sigmoid_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise ``tf.nn.sigmoid_cross_entropy_with_logits``."""
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))


def loss_terms(model: nn.Module, logits: torch.Tensor, labels: torch.Tensor):
    """(loss, ce): ce is the mean cross-entropy, loss adds the model
    family's L2 penalty."""
    labels = labels.reshape(-1).to(torch.float32)
    ce = torch.mean(sigmoid_cross_entropy(logits, labels))
    return ce + get_model(model.cfg).l2_penalty(model, model.cfg.l2_reg), ce


def _metrics(loss, ce, logits, labels) -> dict:
    with torch.no_grad():
        return {"loss": loss.detach(), "ce": ce.detach(),
                "pred_mean": torch.sigmoid(logits).mean(),
                "label_mean": labels.to(torch.float32).mean()}


def dense_grads(state: TrainState, batch: dict) -> tuple[dict, dict]:
    """The dense step's forward and backward in train mode (dropout and
    batch statistics): ``({name: gradient}, metrics)``."""
    model = state.model
    model.train()
    params = dict(model.named_parameters())
    logits = model(batch["feat_ids"], batch["feat_vals"])
    loss, ce = loss_terms(model, logits, batch["label"])
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, grads)), _metrics(loss, ce, logits, batch["label"])


def apply_dense(state: TrainState, grads: dict) -> None:
    """The optimizer update of every parameter from ``grads``, with the
    optimizer's own scalars (the grid's steps)."""
    with record_function("train.optimizer"):
        state.optimizer.step(dict(state.model.named_parameters()), grads)
    state.step += 1


# -- the one step body, eager or captured -------------------------------------

def step_scalars(state) -> list[float]:
    """The step's per-step numbers, from the host counts, in the order of
    :data:`SCALARS`: the dense optimizer's lr and bias corrections at its
    count; the lazy row update's lr (the schedule at ``state.step`` times
    ``embedding_lr_multiplier``) and bias corrections at ``step + 1``
    (unused, 0 and 1, without lazy Adam).  ``state`` is a
    :class:`TrainState` or a paged state (tiered/step.py)."""
    opt = state.optimizer
    lazy = [0.0, 1.0, 1.0]
    if state.lazy is not None:
        lazy = [schedule_value(opt.lr, state.step) * opt.multiplier,
                *adam_bias_corrections(opt.cfg, state.step + 1)]
    return [*opt.host_scalars(), *lazy]


def load_scalars(state, out: torch.Tensor) -> None:
    """Write :func:`step_scalars` into the float32 device buffer ``out``
    from pinned host memory, without waiting (the caching host allocator
    keeps that memory until the copy has run)."""
    host = torch.tensor(step_scalars(state), dtype=torch.float32,
                        pin_memory=out.device.type == "cuda")
    out.copy_(host, non_blocking=True)


def _scalar_buffer(state) -> torch.Tensor:
    if state.scalars is None:
        state.scalars = torch.zeros(len(SCALARS), dtype=torch.float32,
                                    device=state.model.fm_b.device)
    return state.scalars


def _advance(state) -> None:
    """The host counts after a step: the train step and the dense
    optimizer's count."""
    state.step += 1
    state.optimizer.count += 1


def dense_body(state: TrainState, batch: dict, scalars: torch.Tensor) -> dict:
    """The dense step on ``batch``: forward, gradients and the optimizer
    update, reading lr and the bias corrections from ``scalars``."""
    grads, metrics = dense_grads(state, batch)
    with record_function("train.optimizer"):
        state.optimizer.update(dict(state.model.named_parameters()), grads, scalars[:3])
    return metrics


def lazy_body(model: nn.Module, optimizer: Optimizer, tables: dict, moments,
              ids: torch.Tensor, vals: torch.Tensor, labels: torch.Tensor,
              scalars: torch.Tensor) -> dict:
    """The lazy step (counterpart of ``_make_lazy_train_step``,
    ``train/step.py:173-270``) on ``tables`` (``{"fm_w", "fm_v"}``: the
    model's own, or the tiered store's hot cache) with their moments
    (``m``, ``v``) and ``ids [B, F]`` that are rows of them.

    The ids are clipped to the smallest table's rows (fm_w's: fm_v may
    carry pad rows, which so never train) and sorted into segments; the
    forward and backward run on the compact tables, the loss is the CE
    alone (the table L2 is the ``l2·w`` term of the row update), the
    model's other parameters take a dense step with their own count, and
    the tables' touched rows a lazy-Adam step, lr and bias corrections
    read from ``scalars``."""
    model.train()
    rest = {k: p for k, p in model.named_parameters() if k not in LAZY_TABLE_KEYS}
    b, f = ids.shape
    min_rows = min(t.shape[0] for t in tables.values())
    with record_function("train.lazy_segments"):
        order, seg, row_id, valid = sort_segments(ids.reshape(-1).clamp(0, min_rows - 1))
        slot = torch.empty_like(seg).scatter_(0, order, seg).to(torch.int32).view(b, f)
        compact = {k: t.detach()[row_id].requires_grad_() for k, t in tables.items()}
    logits = model.head(*fused_ctr_interaction(compact["fm_w"], compact["fm_v"],
                                               slot, vals))
    ce = torch.mean(sigmoid_cross_entropy(logits, labels.reshape(-1).to(torch.float32)))
    grads = torch.autograd.grad(ce, [*rest.values(), *compact.values()])
    with record_function("train.optimizer"):
        optimizer.update(rest, dict(zip(rest, grads)), scalars[:3])
    with record_function("train.lazy_rows"):
        for (key, table), gsum in zip(tables.items(), grads[len(rest):]):
            lazy_adam_rows(table, moments.m[key], moments.v[key], row_id, gsum, valid,
                           scalars[4:6], optimizer.cfg, learning_rate=scalars[3],
                           l2_reg=model.cfg.l2_reg, p_r=compact[key].detach())
    return _metrics(ce, ce, logits, labels)


def resident_body(state: TrainState, batch: dict, scalars: torch.Tensor) -> dict:
    """The single-card step's body, dense or lazy by the state: what the
    eager step runs and what :class:`StepGraph` captures."""
    if state.lazy is None:
        return dense_body(state, batch, scalars)
    model = state.model
    tables = {k: getattr(model, k) for k in _lazy_keys(dict(model.named_parameters()))}
    ids, vals = model.prepare(batch["feat_ids"], batch["feat_vals"])
    return lazy_body(model, state.optimizer, tables, state.lazy, ids, vals,
                     batch["label"], scalars)


def train_step(state: TrainState, batch: dict) -> dict:
    """One optimizer step on ``batch`` in train mode, dense or lazy by the
    state, run eagerly; returns ``loss``, ``ce``, ``pred_mean`` and
    ``label_mean`` as device scalars (the lazy step's loss is the CE
    alone)."""
    scalars = _scalar_buffer(state)
    load_scalars(state, scalars)
    dev = scalars.device
    metrics = resident_body(state, {k: v.to(dev, non_blocking=True)
                                    for k, v in batch.items()}, scalars)
    _advance(state)
    return metrics


# -- the graphed step (counterpart of ``jitted_train_step``) ------------------

# real steps run eagerly on a side stream before the capture (the cuBLAS
# workspace, the kernels' first launches, autograd's buffers)
WARMUP_STEPS = 3

# B1 and B1' runs through step-graph replays since import (or since a
# caller reset them): each replay adds the launches its capture recorded
graph_kernel_runs = {"forward": 0, "backward": 0}


class StepGraph:
    """One CUDA graph of a train step's body, replayed step after step:
    the port's counterpart of JAX's jitted train step with its state
    donated.

    ``body(state, inputs, scalars) -> metrics`` is the very function the
    eager step runs.  Its inputs come through static device buffers, each
    filled from the caller's (pinned host or device) tensor by one
    asynchronous copy before a replay, and its per-step numbers through
    the state's scalar buffer (:func:`load_scalars`).  The first
    ``WARMUP_STEPS`` calls are real steps run eagerly on a side stream;
    the next one captures the body (the capture runs nothing, under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host sync in the
    body raises) and every call from it on replays.  The dropout
    generator is registered with the graph, so a replay draws the masks
    the eager step would draw and advances the generator as it would.
    The state's tensors are updated in place and never rebound, so a
    replay writes where a restore (``Checkpointer.restore``, in place) or
    a save (a copy on the current stream, then a synchronize) reads.  A
    capture failure raises; nothing falls back to the eager step.

    ``replays`` counts the replays and ``per_replay`` the B1 and B1′
    launches that the capture recorded (ops/fused_ctr.py counts those as
    captured, not launched): their runs through the graph are the product,
    which each replay adds to :data:`graph_kernel_runs`."""

    def __init__(self, body, state, inputs: dict):
        self.body = body
        self.device = _scalar_buffer(state).device
        self.static = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                       for k, v in inputs.items()}
        self.graph: torch.cuda.CUDAGraph | None = None
        self.side: torch.cuda.Stream | None = None
        self.out: torch.Tensor | None = None
        self.warm = 0
        self.replays = 0
        self.per_replay = (0, 0)

    def _check(self, inputs: dict) -> None:
        if inputs.keys() != self.static.keys():
            raise ValueError(f"the graphed step takes {sorted(self.static)}, got "
                             f"{sorted(inputs)}")
        for k, t in inputs.items():
            want = self.static[k]
            if t.shape != want.shape or t.dtype != want.dtype:
                raise ValueError(
                    f"the graphed step was built for {k} {tuple(want.shape)} "
                    f"{want.dtype}, got {tuple(t.shape)} {t.dtype}: its shapes are "
                    f"fixed (the train pipeline drops remainders)")

    def __call__(self, state, inputs: dict) -> dict:
        """One step of ``state`` on ``inputs`` (the host counts are the
        caller's to advance); returns the metrics as device scalars."""
        self._check(inputs)
        scalars = _scalar_buffer(state)
        load_scalars(state, scalars)
        for k, t in inputs.items():
            self.static[k].copy_(t, non_blocking=True)
        current = torch.cuda.current_stream(self.device)
        if self.graph is None:
            self.side = self.side or torch.cuda.Stream(self.device)
            self.side.wait_stream(current)
            with torch.cuda.stream(self.side):
                if self.warm < WARMUP_STEPS:
                    out = _stack(self.body(state, self.static, scalars))
                else:
                    self._capture(state, scalars)
            current.wait_stream(self.side)
            if self.graph is None:
                out.record_stream(current)
                self.warm += 1
                return _unstack(out)
        self.graph.replay()
        self.replays += 1
        graph_kernel_runs["forward"] += self.per_replay[0]
        graph_kernel_runs["backward"] += self.per_replay[1]
        return _unstack(self.out.clone())

    def _capture(self, state, scalars: torch.Tensor) -> None:
        """The capture, on the side stream (``capture_begin``/``end``
        without ``torch.cuda.graph``'s garbage collection and cache
        emptying, which a train loop would pay again in allocations)."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        forward, backward = fused_ctr.captured, fused_ctr.backward_captured
        prev = torch.cuda.get_sync_debug_mode()
        # no cyclic collection inside the capture: it could free another
        # object's graphs there, which a capture does not permit
        collecting = gc.isenabled()
        gc.disable()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            torch.cuda.set_sync_debug_mode("error")
            self.out = _stack(self.body(state, self.static, scalars))
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            graph.capture_end()
            if collecting:
                gc.enable()
        self.per_replay = (fused_ctr.captured - forward,
                           fused_ctr.backward_captured - backward)
        self.graph = graph


def _stack(metrics: dict) -> torch.Tensor:
    return torch.stack([metrics[k].to(torch.float32) for k in METRIC_KEYS])


def _unstack(out: torch.Tensor) -> dict:
    return dict(zip(METRIC_KEYS, out.unbind(0)))


BATCH_KEYS = ("feat_ids", "feat_vals", "label")


def graphed_train_step(state: TrainState, batch: dict) -> dict:
    """One single-card step through the state's :class:`StepGraph` when
    the state is on the card (``batch``: pinned host or device tensors,
    copied into the graph's static buffers), else the same body eagerly
    (:func:`train_step`).  Returns the metrics as :func:`train_step`
    does."""
    if state.model.fm_b.device.type != "cuda":
        return train_step(state, batch)
    inputs = {k: batch[k] for k in BATCH_KEYS}
    if state.graph is None:
        state.graph = StepGraph(resident_body, state, inputs)
    metrics = state.graph(state, inputs)
    _advance(state)
    return metrics


@torch.no_grad()
def eval_step(model: nn.Module, auc_state: AUCState, batch: dict
              ) -> tuple[AUCState, dict]:
    """Loss and streaming-AUC accumulation in eval mode."""
    model.eval()
    logits = model(batch["feat_ids"], batch["feat_vals"])
    loss, _ = loss_terms(model, logits, batch["label"])
    labels = batch["label"].reshape(-1)
    return (auc_update(auc_state, labels, torch.sigmoid(logits)),
            {"loss": loss, "count": labels.shape[0]})


@torch.no_grad()
def predict_step(model: nn.Module, batch: dict) -> torch.Tensor:
    """Probabilities [B] in eval mode: the serving path."""
    model.eval()
    return torch.sigmoid(model(batch["feat_ids"], batch["feat_vals"]))
