"""One run of one cell (README.md): set-up, the measured window, the
traced segment, then the comparison with the reference, and the result
line.

Set-up builds the port's train state once, loads the benchmark's weights
into it, and drives it through the cell's warm-up steps (the single-card
step's eager steps and its graph capture), then starts it again from the
same weights (``Program.load``, in place: the graph keeps its buffers)
and drives it through the compared steps, through the same call and
feed as the window.  The window then goes on from that state.
"""

from __future__ import annotations

import contextlib
import gc
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch
from torch.profiler import record_function

from . import compare, feed
from . import trace as tracing
from .cell import Cell, reader
from .program import Prefetcher, Program
from .reference import Trainer
from .weights import make_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "deepfm_tpu")


class Refused(Exception):
    """A run that prints no result (no card, a forbidden module)."""


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false: the benchmark measures the "
                      "card and never falls back to the CPU")
    if torch.cuda.device_count() < n:
        raise Refused(f"the cell asks for {n} cards, torch.cuda.device_count() is "
                      f"{torch.cuda.device_count()}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unread: {e}"


def forbidden_modules() -> list[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_program(cell: Cell, seed: int, seconds: float, trace: bool, device_type: str,
                t_start: float, plant=None) -> dict:
    """Set-up, window and traced segment; returns what the line and the
    comparison need.  ``plant`` (a module-level function returning a
    context manager) is entered around it: the tests' broken program."""
    with plant() if plant else contextlib.nullcontext():
        return _run_program(cell, seed, seconds, trace, device_type, t_start)


def _run_program(cell: Cell, seed: int, seconds: float, trace: bool, device_type: str,
                 t_start: float) -> dict:
    tr = cell.traffic
    b = tr["batch_size"]
    program = Program(cell.model, cell.optimizer, b, "cuda:0" if device_type == "cuda" else "cpu")
    dev = program.device
    ring = feed.host_ring(feed.make_records(tr, cell.model, seed, dev), b,
                          pin=dev.type == "cuda")
    w0 = make_weights(cell.model, seed, dev, _prior(cell))
    dropout_seed = feed.sub_seed(seed, feed.DROPOUT)
    program.load(w0, dropout_seed)
    out = {"tables": program.table_shapes()}
    with Prefetcher(feed.Ring(ring), depth=tr["prefetch_batches"]) as src:
        taken = 0

        def take() -> dict:
            nonlocal taken
            taken += 1
            return next(src)

        for _ in range(tr["warmup_steps"]):
            program.step(take())
        _sync(dev)
        program.load(w0, dropout_seed)
        out["compared"], losses = [], []
        for s in range(tr["compare_steps"]):
            out["compared"].append(taken % len(ring))
            losses.append(float(program.step(take())["loss"]))
            if s == 0:
                out["grad_norms"] = program.grad_norms()
        leaves = program.leaves()
        out["losses"] = losses
        out["change_norms"] = {k: float((v.double() - _padded(w0[k], v)).norm())
                               for k, v in leaves.items()}
        del w0, leaves
        _sync(dev)
        out["setup_s"] = time.perf_counter() - t_start
        if dev.type == "cuda":
            # the window's peak is of what it holds: the graph's private pool
            # counts as reserved, never as allocated; set-up's cache goes
            out["setup_peak"] = torch.cuda.max_memory_reserved(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        wait = 0.0
        steps = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            tw = time.perf_counter()
            batch = take()
            wait += time.perf_counter() - tw
            m = program.step(batch)
            steps += 1
            if time.perf_counter() >= deadline:
                break
        _sync(dev)
        out["window_s"] = time.perf_counter() - t0
        out.update(steps=steps, wait_s=wait)
        out["peak_window"] = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
        out["last_loss"] = float(m["loss"])
        out["trace"] = None
        if trace:
            n = tr["trace_steps"]
            out["traced"] = []
            with tracing.profiled(dev) as prof:
                with record_function(tracing.WINDOW):
                    for _ in range(n):
                        out["traced"].append(taken % len(ring))
                        with record_function("ctrbench.feed"):
                            batch = take()
                        with record_function("ctrbench.step"):
                            m = program.step(batch)
                    _sync(dev)
            out["trace"] = tracing.reduce(prof, n)
            if dev.type == "cuda" and out["trace"].busy_s <= 0:
                raise RuntimeError("torch.profiler recorded no device operation in the "
                                   "traced window: no device metric is measured")
        out["finite"] = math.isfinite(out["last_loss"]) and all(
            bool(torch.isfinite(p).all()) for p in program.leaves().values())
    out["ring"] = ring
    out["device"] = dev
    program.close()
    return out


def _prior(cell: Cell) -> float | None:
    """The click rate the global bias starts at, where the configuration
    asks for it (``weights.py``)."""
    return cell.traffic["label_rate"] if cell.config.get("fm_b_init") == "click_prior" else None


def _padded(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    w = w.to(like.device).double()
    if w.shape == like.shape:
        return w
    return torch.cat([w, w.new_zeros((like.shape[0] - w.shape[0],) + tuple(w.shape[1:]))])


def reference_readings(cell: Cell, seed: int, compared: list[int], device: torch.device, *,
                       prec=None, fault: str | None = None) -> dict:
    """The reference (or, with ``prec``/``fault``, a control) over the
    compared steps, from the same weights, batches and dropout seeds."""
    params = make_weights(cell.model, seed, device, _prior(cell))
    p0 = {k: v.clone() for k, v in params.items()}
    b = cell.traffic["batch_size"]
    rec = feed.make_records(cell.traffic, cell.model, seed, device)
    batches = [{k: t[i * b:(i + 1) * b].clone() for k, t in rec.items()} for i in compared]
    del rec
    trainer = Trainer(cell.model, cell.optimizer, params, prec=prec, fault=fault,
                      dropout_seed=feed.sub_seed(seed, feed.DROPOUT))
    losses = []
    for s, batch in enumerate(batches):
        losses.append(trainer.step(batch))
        if s == 0:
            grads = trainer.grad_norms()
    change = {k: float((params[k].double() - p0[k].double()).norm()) for k in params}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, t_start: float,
        device_type: str = "cuda", plant=None) -> tuple[dict, list[str]]:
    """One run: ``(result line, check lines)``.  Raises :class:`Refused`
    where the contract says the run prints no result.  ``plant``: see
    :func:`run_program`."""
    if device_type == "cuda":
        require_cards(cell.chips)
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
    out = run_program(cell, seed, seconds, trace, device_type, t_start, plant)
    dev = out["device"]
    run_in = SimpleNamespace(
        cell=cell, setup_s=out["setup_s"], steps=out["steps"],
        examples=out["steps"] * cell.traffic["batch_size"],
        window_s=out["window_s"], wait_s=out["wait_s"], peak_window_bytes=out["peak_window"],
        trace=out["trace"], device=dev, tables=out["tables"],
        traced_batches=[out["ring"][i] for i in out.get("traced", [])],
        flops_per_example=cell.counts().forward_flops_per_example(cell.model))
    metrics = {}
    for m in cell.metrics(trace):
        v = reader(cell.root, m["name"])(run_in)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1,
              "memory_peak_bytes": max(out.get("setup_peak", 0), out["peak_window"])}
    line = {"correct": False, "attempted": out["steps"],
            "failed": 0, "metrics": metrics, "device": device}
    if trace:
        t = out["trace"]
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        line["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.top_gaps()}
    finite = out["finite"]
    if not finite:
        line["failed"] = out["steps"]
    # the program's state is freed: the reference runs now
    compared, program_side = out["compared"], {k: out[k] for k in (
        "losses", "grad_norms", "change_norms")}
    out.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell, seed, compared, dev)
    values = compare.readings(program_side, ref)
    ok, checks = compare.judge(values, compare.load_limits(cell.root, cell.name))
    line["correct"] = ok and finite
    checks["finite"] = {"value": int(finite), "limit": 1}
    line["checks"] = _plain(checks)
    lines = [f"worst leaves: grad {values['grad_leaf']}, change {values['change_leaf']}"]
    lines += [f"check {k}: {c['value']} limit {c['limit']}" for k, c in checks.items()]
    bad = forbidden_modules()
    if bad:
        raise Refused(f"loaded in this process: {', '.join(bad)}")
    return line, lines


def _plain(x):
    """JSON-safe: a non-finite float as its name."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x
