#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero; nothing is caught; they
run in the order 1, 2, 3, 7, 4, 5, 6, 9, 10, 8):

1. card     - the card's name and power limit, from nvidia-smi;
2. build    - every kernel under deepfm_tpu_torch/csrc, built from source;
3. kernel   - each kernel's wrapper against its plain PyTorch version on the
              card, at the shapes its main paths give it: the forward at
              the flagship table (117,584 x 32) for every serving bucket,
              the funnel's rank rows (256, 2,048) and the train batches;
              the backward at the train batches with the 13 hot numeric
              rows of every Criteo record, on uniform ids and with every
              lookup on one row; with the kernel's time, the plain
              version's time and the least time the card could take (CUDA
              events, median over repetitions), the forward's layout and
              share of that bound, and the time of a one-element add (the
              launch floor);
4. serve    - the full-width DeepFM (117,581 x 39 x 32, MLP 256/128/64,
              bf16, random weights from --seed) exported, loaded on the card
              behind the HTTP server, and sent :predict requests of 1, 8 and
              100 instances; the predictions must be finite and agree with
              the plain-version forward of the same weights, and the forward
              kernel's launch count must have risen during this phase;
5. parity   - one loss.backward() of the full-width float32 model on a batch
              of 1,024 synthetic records through the kernels and through
              the plain versions, from the same weights: the loss and every
              gradient must agree;
6. train    - `python -m deepfm_tpu_torch --task_type train` in-process at
              full width (bf16, dropout 0.5, Adam, batch 1,024) on synthetic
              TFRecords written from --seed: losses finite and falling, both
              kernels launched at least once per step, eval AUC in [0, 1],
              and the exported servable's probabilities equal to the trained
              model's; then examples/s, the input-wait share, one step's
              device time and its split by kernel, and peak memory;
7. b2       - kernel B2 (int8 retrieval score + top-k) against its plain
              version at the served corpus (117,581 rows) and the benchmark
              corpus (2,000,000), D 32, kos 128, B 8 and 64, on a mix
              with equal rows and pad ids, and on inputs that fill or
              starve its select (all scores equal, 100 live rows, kos 1
              and 1,024, D 16 and 128): scores within the stated
              tolerance, rows equal but for near-ties (counted); with its
              device and call time, its split by kernel, the plain time,
              the least time and the torch.topk composition's time;
8. funnel   - the full-width recommendation funnel (the flagship ranker,
              a two-tower query encoder, an int8 index of 117,581 items,
              top 32 -> 8) built on the card, exported through the recall
              gate, served over HTTP and sent /v1/recommend with 1, 8 and
              64 users; the answers must agree with the same payload run
              through the plain B2 and plain B1 (near-ties counted), both
              kernels' launch counts must have risen; then the stage
              times, latency and the device recall@32 against exact f32;
9. lazy     - the train task of phase 6 with lazy Adam on the tables
              (optimizer.lazy_embedding_updates): losses finite and
              falling, both kernels launched at least once per step; one
              lazy step of the float32 model through the kernels and
              through the plain versions from the same state (loss, the
              touched rows' step, m and v agree; every untouched row of
              the tables, m and v bit for bit as before); B1 and B1' on
              the compact tables against their plain versions, with B1''s
              time, bound and zero fill; the lazy step's device time and
              split beside the dense step's;
10. ddp     - data-parallel training at world size 1 over NCCL in this
              process: steps through parallel/spmd.py and through the
              single-card step from the same weights agree; the fused
              all-reduce's time on the full-width gradient buffer.

The last three lines of standard output are the kernels' JSON line, the
card's name and power limit, and {"ok": true, "device": {...}}.  With no
CUDA device, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet), for the least-time bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BUCKETS = (8, 32, 128, 512)
# the train path's batch (DataConfig.batch_size) and a larger one
TRAIN_BATCHES = (1024, 4096)
# the funnel's rank stage: buckets 8 and 64 users x top 32 candidates
RANK_ROWS = (256, 2048)
# kernel vs plain, max abs error: emb is the same float32 product in both
# (exact); y_w and y_v differ only in summation order, relative to magnitude
TOL_EMB = 1e-6
TOL_YW_REL = 1e-5
TOL_YV_REL = 1e-4
# served probabilities vs the plain forward on the same padded bucket: the
# MLP input is bit-equal, only the FM sums' order differs
TOL_PROB = 1e-4
# sequential repeats of each :predict, for its latency
SERVE_REPEATS = 30
# backward kernel vs plain, and the parity step's gradients: max abs error
# relative to the output's largest magnitude.  The kernel sums duplicate
# rows with float32 atomics in an order that changes from run to run, the
# plain version in index order
TOL_GRAD_REL = 1e-5
# parity step loss: the same float32 arithmetic, FM sums in another order
TOL_LOSS_REL = 1e-6
# the train phase's synthetic data: 48 train batches in 4 files, 8 val
# batches, the JAX package's Criteo-shaped generator
TRAIN_FILES, TRAIN_RECORDS_PER_FILE = 4, 12 * 1024
VAL_RECORDS = 8 * 1024
LOG_STEPS = 8
# kernel B2 at the funnel's shapes: the served corpus (117,581 items) and
# benchmarks/funnel.py's 2e6-row corpus, tower dim 32, the serving buckets
# 8 and 64, top 32 x oversample 4
B2_CORPORA, B2_BATCHES, B2_DIM, B2_KOS = (117_581, 2_000_000), (8, 64), 32, 128
# kernel vs plain scores, position by position: one float32 dot per row
# summed in another order than cuBLAS's, dots of unit vectors (|s| <= 1)
TOL_B2_RTOL, TOL_B2_ATOL = 1e-4, 1e-5
# the served funnel (benchmarks/funnel.py's geometry at the flagship
# ranker): two-tower query encoder, int8 index of every ranker item
FUNNEL_USER_VOCAB, FUNNEL_FIELDS, FUNNEL_TOWER_EMB = 100_000, 3, 16
FUNNEL_TOWER_LAYERS, FUNNEL_TOWER_DIM = (64,), 32
FUNNEL_TOP_K, FUNNEL_RETURN_N, FUNNEL_OVERSAMPLE = 32, 8, 4
FUNNEL_BUCKETS = (8, 64)
FUNNEL_REQUESTS = (1, 8, 64)
FUNNEL_REPEATS = 10
# served retrieval scores vs the plain pipeline's: the same exact f32
# rescore of the same rows, rounded to 6 decimals in the response
TOL_RETR = 1e-5
# device recall@32 of the int8 path against the exact f32 top-32
RECALL_USERS = 256


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def _median_event_ms(run, per: int, groups: int) -> float:
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return float(np.median(times))


def time_ms(fn, reps: int = 50, groups: int = 7) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn``, each the median over
    ``groups`` of the mean over ``reps`` calls, from CUDA events.

    Device ms replays ``reps`` calls captured in one CUDA graph, so it is
    the GPU's time for the work without the host's launch cost.  Call ms
    times ``reps`` back-to-back Python calls, which is what an eager caller
    pays when the host, not the GPU, is the limit."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device_ms = _median_event_ms(graph.replay, reps, groups)

    def eager():
        for _ in range(reps):
            fn()

    return device_ms, _median_event_ms(eager, reps, groups)


def make_ids(rng: np.random.Generator, b: int, f: int, feature_size: int) -> np.ndarray:
    """Half uniform, half Zipf-skewed ids, with a few out of range and
    negative, as int64."""
    uniform = rng.integers(0, feature_size, size=(b, f))
    zipf = (rng.zipf(1.2, size=(b, f)) - 1) % feature_size
    ids = np.where(rng.random((b, f)) < 0.5, uniform, zipf)
    bad = rng.random((b, f))
    ids = np.where(bad < 0.01, feature_size + rng.integers(0, 10**6, (b, f)), ids)
    ids = np.where(bad > 0.99, -rng.integers(1, 10**6, (b, f)), ids)
    return ids.astype(np.int64)


def make_train_ids(rng: np.random.Generator, b: int, f: int, feature_size: int) -> np.ndarray:
    """make_ids with the 13 numeric fields set to the ids 1..13 that every
    Criteo record (and generate_synthetic_ctr) carries: 13 hot rows."""
    ids = make_ids(rng, b, f, feature_size)
    ids[:, :13] = np.arange(1, 14)
    return ids


def fused_ctr_bound_ms(fm_w, fm_v, ids32, b: int, f: int) -> tuple[float, str, dict]:
    """Least time for this call: each input read once (only the table rows
    this batch touches, each once), each output written once, over the
    HBM rate; or its float32 operations over the f32 peak."""
    k = fm_v.shape[1]
    rows = ids32.long().clamp(0, fm_v.shape[0] - 1)
    uniq_v = int(torch.unique(rows).numel())
    uniq_w = int(torch.unique(rows.clamp(max=fm_w.shape[0] - 1)).numel())
    nbytes = (b * f * 4 * 2                 # ids (int32) + vals
              + uniq_v * k * 4 + uniq_w * 4  # distinct table rows
              + b * f * k * 4 + 2 * b * 4)   # emb, y_w, y_v
    flops = 4 * b * f * k + 2 * b * f        # e = v*x, Σe, Σe² (fma), w*x
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": flops, "unique_rows": uniq_v,
              "lookups": b * f, "bytes_per_lookup_no_dedup": 4 + 4 + 4 + 2 * k * 4}
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", detail


def phase_kernel(seed: int) -> dict:
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.models.deepfm import fm_v_rows
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.ops.embedding import narrow_ids

    cfg = ModelConfig(fused_kernel="auto")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    v_rows, k, f = fm_v_rows(cfg), cfg.embedding_size, cfg.field_size
    fm_v = torch.randn((v_rows, k), generator=g, device=dev) * 0.05
    fm_v[cfg.feature_size:] = 0.0
    fm_w = torch.randn((cfg.feature_size,), generator=g, device=dev) * 0.05
    rng = np.random.default_rng(seed)
    result = {"per_bucket": {}}
    worst = 0.0
    for b in BUCKETS + RANK_ROWS + TRAIN_BATCHES:
        mk = make_train_ids if b in TRAIN_BATCHES else make_ids
        ids64 = torch.from_numpy(mk(rng, b, f, cfg.feature_size)).to(dev)
        vals = torch.from_numpy(rng.random((b, f)).astype(np.float32)).to(dev)
        # the serving path's ids: narrowed int32, clipped to feature_size-1
        ids32 = narrow_ids(ids64, cfg.feature_size)
        # and raw int32 ids past the padded rows, which clip inside the kernel
        raw32 = ids64.clamp(-2**31, 2**31 - 1).to(torch.int32)
        errs = {}
        for tag, ids in (("int32_narrowed", ids32), ("int32_raw", raw32), ("int64_raw", ids64)):
            got = fused_ctr.fused_ctr_interaction(fm_w, fm_v, ids, vals)
            want = fused_ctr.fused_ctr_plain(fm_w, fm_v, ids, vals)
            torch.cuda.synchronize()
            e = [float((a - w).abs().max()) for a, w in zip(got, want)]
            scale_w = 1.0 + float(want[1].abs().max())
            scale_v = 1.0 + float(want[2].abs().max())
            if not (e[0] <= TOL_EMB and e[1] <= TOL_YW_REL * scale_w
                    and e[2] <= TOL_YV_REL * scale_v):
                fail(f"fused_ctr_forward disagrees with its plain version at "
                     f"B={b} ({tag}): max abs err emb {e[0]}, y_w {e[1]}, y_v {e[2]}")
            errs[tag] = {"emb": e[0], "y_w": e[1], "y_v": e[2]}
            worst = max(worst, *e)
        ms, call_ms = time_ms(
            lambda: fused_ctr.fused_ctr_interaction(fm_w, fm_v, ids32, vals))
        plain_ms, plain_call_ms = time_ms(
            lambda: fused_ctr.fused_ctr_plain(fm_w, fm_v, ids32, vals))
        bound_ms, bound_by, detail = fused_ctr_bound_ms(fm_w, fm_v, ids32, b, f)
        row = {"max_abs_err": errs, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms, "layout": fused_ctr.forward_layout(fm_v, b),
               "call_ms": call_ms, "plain_call_ms": plain_call_ms, **detail}
        result["per_bucket"][b] = row
        print("kernel fused_ctr_forward B=%d %s" % (b, json.dumps(row)))
    # the launch floor: one in-place add on one element, timed the same way,
    # is what any kernel launch costs here, whatever its work
    one = torch.zeros(1, device=dev)
    floor_ms, floor_call_ms = time_ms(lambda: one.add_(1.0))
    result["launch_floor"] = {"ms": floor_ms, "call_ms": floor_call_ms}
    print("kernel launch_floor %s" % json.dumps(result["launch_floor"]))
    result["max_abs_err"] = worst
    return result


def fused_ctr_backward_bound_ms(fm_w, fm_v, ids, b: int, f: int,
                                want_vals: bool) -> tuple[float, str, dict]:
    """Least time for one backward: g_emb, ids, vals, g_yw, g_yv and each
    distinct fm_v/fm_w row read once, each distinct gradient row (and
    d_vals) written once, over the HBM rate; or its float32 operations
    over the f32 peak.  The wrapper's zero fill is left out (timed on its
    own line)."""
    k = fm_v.shape[1]
    rows = ids.long().clamp(0, fm_v.shape[0] - 1)
    uniq, counts = torch.unique(rows, return_counts=True)
    uniq_v = int(uniq.numel())
    uniq_w = int(torch.unique(rows.clamp(max=fm_w.shape[0] - 1)).numel())
    nbytes = (b * f * k * 4                          # g_emb
              + b * f * (ids.element_size() + 4)     # ids, vals
              + 2 * b * 4                            # g_yw, g_yv
              + 2 * (uniq_v * k * 4 + uniq_w * 4)    # rows read, grads written
              + (b * f * 4 if want_vals else 0))     # d_vals
    # per element: e (1), sum_f e (1), g_e (3), g_e*val (1), the add (1),
    # d_vals' product and sum (2); per lookup: the fm_w term (2)
    flops = b * f * k * (7 + (2 if want_vals else 0)) + 2 * b * f
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": flops, "unique_rows": uniq_v,
              "lookups": b * f, "max_row_multiplicity": int(counts.max())}
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", detail


def backward_kernel_only(lib, g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals,
                         d_fm_w, d_fm_v, d_vals) -> None:
    """The backward kernel alone into preallocated outputs (no zero fill,
    no launch count): for timing the kernel apart from its wrapper."""
    b, f = ids.shape
    rc = lib.fused_ctr_backward(
        g_emb.data_ptr(), g_yw.data_ptr(), g_yv.data_ptr(), fm_w.data_ptr(),
        fm_w.shape[0], fm_v.data_ptr(), fm_v.shape[0], fm_v.shape[1],
        ids.data_ptr(), int(ids.dtype == torch.int64), vals.data_ptr(), b, f,
        d_fm_w.data_ptr(), d_fm_v.data_ptr(),
        None if d_vals is None else d_vals.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail(f"fused_ctr_backward launch failed: CUDA error {rc}")


def backward_same_row(lib, g_emb, g_yw, g_yv, fm_w, fm_v, vals, d_fm_w, d_fm_v):
    """The backward with every lookup on one row (row 7), int32 and int64
    ids, with d_vals: held to the plain version run in float64, since the
    B·F float32 terms of that one row sum with a rounding error near the
    tolerance in any float32 order (the plain version's atomics included).
    Returns (kernel ms on int32 ids without d_vals, largest abs error)."""
    from deepfm_tpu_torch.ops import fused_ctr

    b, f = vals.shape
    worst = 0.0
    want = fused_ctr.fused_ctr_backward_plain(
        *(t.double() for t in (g_emb, g_yw, g_yv, fm_w, fm_v)),
        torch.full((b, f), 7, device=vals.device), vals.double())
    for dtype in (torch.int32, torch.int64):
        ids = torch.full((b, f), 7, device=vals.device, dtype=dtype)
        got = fused_ctr.fused_ctr_backward(g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals)
        torch.cuda.synchronize()
        for name, a, w in zip(("d_fm_w", "d_fm_v", "d_vals"), got, want):
            err, scale = float((a.double() - w).abs().max()), float(w.abs().max())
            if not err <= TOL_GRAD_REL * scale:
                fail(f"fused_ctr_backward disagrees with its plain version with every "
                     f"lookup on one row (B={b}, {dtype}): {name} max abs err {err}, "
                     f"scale {scale}")
            worst = max(worst, err)
    ids = torch.full((b, f), 7, device=vals.device, dtype=torch.int32)
    ms, _ = time_ms(lambda: backward_kernel_only(
        lib, g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals, d_fm_w, d_fm_v, None))
    return ms, worst


def phase_backward(seed: int) -> dict:
    """fused_ctr_backward against fused_ctr_backward_plain at the train
    batches, full-width table: three id types of the train mix (13 hot
    rows), uniform ids (timed) and every lookup on one row."""
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.models.deepfm import fm_v_rows
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.ops.embedding import narrow_ids

    cfg = ModelConfig(fused_kernel="auto")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    v_rows, k, f = fm_v_rows(cfg), cfg.embedding_size, cfg.field_size
    fm_v = torch.randn((v_rows, k), generator=g, device=dev) * 0.05
    fm_v[cfg.feature_size:] = 0.0
    fm_w = torch.randn((cfg.feature_size,), generator=g, device=dev) * 0.05
    rng = np.random.default_rng(seed + 2)
    lib = fused_ctr._library()
    result = {"per_batch": {}}
    worst = 0.0
    for b in TRAIN_BATCHES:
        ids64 = torch.from_numpy(make_train_ids(rng, b, f, cfg.feature_size)).to(dev)
        vals = torch.from_numpy(rng.random((b, f)).astype(np.float32)).to(dev)
        g_emb = torch.randn((b, f, k), generator=g, device=dev)
        g_yw = torch.randn((b,), generator=g, device=dev)
        g_yv = torch.randn((b,), generator=g, device=dev)
        ids32 = narrow_ids(ids64, cfg.feature_size)
        raw32 = ids64.clamp(-2**31, 2**31 - 1).to(torch.int32)
        errs = {}
        for tag, ids in (("int32_narrowed", ids32), ("int32_raw", raw32), ("int64_raw", ids64)):
            got = fused_ctr.fused_ctr_backward(g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals)
            want = fused_ctr.fused_ctr_backward_plain(g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals)
            torch.cuda.synchronize()
            e = {}
            for name, a, w in zip(("d_fm_w", "d_fm_v", "d_vals"), got, want):
                e[name] = float((a - w).abs().max())
                scale = float(w.abs().max())
                if not e[name] <= TOL_GRAD_REL * scale:
                    fail(f"fused_ctr_backward disagrees with its plain version at "
                         f"B={b} ({tag}): {name} max abs err {e[name]}, scale {scale}")
                worst = max(worst, e[name])
            errs[tag] = e
        # the train path's call: narrowed ids, no d_vals (vals take no grad)
        d_fm_w, d_fm_v = torch.zeros_like(fm_w), torch.zeros_like(fm_v)
        d_vals = torch.empty((b, f), device=dev)
        ms, call_ms = time_ms(lambda: backward_kernel_only(
            lib, g_emb, g_yw, g_yv, fm_w, fm_v, ids32, vals, d_fm_w, d_fm_v, None))
        vals_ms, _ = time_ms(lambda: backward_kernel_only(
            lib, g_emb, g_yw, g_yv, fm_w, fm_v, ids32, vals, d_fm_w, d_fm_v, d_vals))
        wrapper_ms, wrapper_call_ms = time_ms(lambda: fused_ctr.fused_ctr_backward(
            g_emb, g_yw, g_yv, fm_w, fm_v, ids32, vals, False))
        fill_ms, _ = time_ms(lambda: (torch.zeros_like(fm_w), torch.zeros_like(fm_v)))
        plain_ms, plain_call_ms = time_ms(lambda: fused_ctr.fused_ctr_backward_plain(
            g_emb, g_yw, g_yv, fm_w, fm_v, ids32, vals, False), reps=20)
        # the same call on uniform ids: no hot rows, so no atomic collisions
        # beyond chance; the difference is what the hot rows cost
        uniform = torch.randint(0, cfg.feature_size, (b, f), generator=g, device=dev,
                                dtype=torch.int32)
        uniform_ms, _ = time_ms(lambda: backward_kernel_only(
            lib, g_emb, g_yw, g_yv, fm_w, fm_v, uniform, vals, d_fm_w, d_fm_v, None))
        uniform_bound_ms = fused_ctr_backward_bound_ms(fm_w, fm_v, uniform, b, f, False)[0]
        same_ms, same_err = backward_same_row(lib, g_emb, g_yw, g_yv, fm_w, fm_v, vals,
                                              d_fm_w, d_fm_v)
        worst = max(worst, same_err)
        bound_ms, bound_by, detail = fused_ctr_backward_bound_ms(
            fm_w, fm_v, ids32, b, f, False)
        vals_bound_ms, _, _ = fused_ctr_backward_bound_ms(fm_w, fm_v, ids32, b, f, True)
        fill_bound_ms = (fm_w.numel() + fm_v.numel()) * 4 / HBM_BYTES_PER_S * 1e3
        row = {"max_abs_err": errs, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "call_ms": call_ms,
               "plain_call_ms": plain_call_ms, "with_d_vals_ms": vals_ms,
               "with_d_vals_bound_ms": vals_bound_ms,
               "wrapper_ms": wrapper_ms, "wrapper_call_ms": wrapper_call_ms,
               "zero_fill_ms": fill_ms, "zero_fill_bound_ms": fill_bound_ms,
               "uniform_ids_ms": uniform_ms, "uniform_ids_bound_ms": uniform_bound_ms,
               "train_over_uniform": ms / uniform_ms,
               "same_row_ms": same_ms, "same_row_max_abs_err": same_err, **detail}
        result["per_batch"][b] = row
        print("kernel fused_ctr_backward B=%d %s" % (b, json.dumps(row)))
    result["max_abs_err"] = worst
    return result


def write_synthetic(seed: int, train_dir: str, val_dir: str) -> None:
    """The train phase's TFRecords, from the port's copy of the JAX
    package's generator."""
    from deepfm_tpu_torch.data.libsvm import generate_synthetic_ctr

    t0 = time.perf_counter()
    for i in range(TRAIN_FILES):
        generate_synthetic_ctr(os.path.join(train_dir, f"train-{i}.tfrecords"),
                               num_records=TRAIN_RECORDS_PER_FILE, seed=seed * 100 + i)
    generate_synthetic_ctr(os.path.join(val_dir, "val-0.tfrecords"),
                           num_records=VAL_RECORDS, seed=seed * 100 + 99)
    print(f"data: wrote {TRAIN_FILES * TRAIN_RECORDS_PER_FILE} train and "
          f"{VAL_RECORDS} val records in {time.perf_counter() - t0:.2f} s")


def first_batch(data_dir: str, pattern: str, batch: int, dev) -> dict:
    from deepfm_tpu_torch.data.pipeline import batched_ctr_batches, discover_files, record_stream

    files = discover_files(data_dir, (pattern,), shuffle=False)
    b = next(batched_ctr_batches(record_stream(files), batch_size=batch, field_size=39))
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def phase_parity(seed: int, train_dir: str) -> dict:
    """One loss.backward() through the kernels and one through the plain
    versions (plain forward, autograd backward), same weights, same card."""
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.models import DeepFM
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.train.step import loss_terms

    cfg = ModelConfig(fused_kernel="auto", compute_dtype="float32",
                      dropout_keep=(1.0, 1.0, 1.0))
    model = DeepFM(cfg, device="cuda", generator=torch.Generator().manual_seed(seed))
    model.train()
    batch = first_batch(train_dir, "train", 1024, "cuda")
    params = dict(model.named_parameters())
    out = []
    for fused in (fused_ctr.fused_ctr_interaction, fused_ctr.fused_ctr_plain):
        ids, vals = model.prepare(batch["feat_ids"], batch["feat_vals"])
        logits = model.head(*fused(model.fm_w, model.fm_v, ids, vals))
        loss, _ = loss_terms(model, logits, batch["label"])
        out.append((loss, torch.autograd.grad(loss, list(params.values()))))
    torch.cuda.synchronize()
    (loss_k, grads_k), (loss_p, grads_p) = out
    loss_k, loss_p = float(loss_k.detach()), float(loss_p.detach())
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    if not (np.isfinite(loss_k) and loss_err <= TOL_LOSS_REL):
        fail(f"parity: loss through the kernels {loss_k} vs plain {loss_p} "
             f"(relative {loss_err})")
    errs = {}
    for name, a, w in zip(params, grads_k, grads_p):
        err, scale = float((a - w).abs().max()), float(w.abs().max())
        if not err <= TOL_GRAD_REL * scale:
            fail(f"parity: gradient of {name} max abs err {err}, scale {scale}")
        errs[name] = err / scale if scale else err
    print("parity %s" % json.dumps({"loss": loss_k, "loss_rel_err": loss_err,
                                    "grad_rel_err": errs}))
    return {"loss_rel_err": loss_err, "max_grad_rel_err": max(errs.values())}


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.lines = out, io.StringIO()

    def write(self, s):
        self.lines.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase_train(seed: int, train_dir: str, val_dir: str, servable: str) -> dict:
    """The main path of this slice: the CLI's train task at full width."""
    from deepfm_tpu_torch.launch import cli
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.serve.export import load_servable
    from deepfm_tpu_torch.train.step import predict_step

    argv = train_argv(train_dir, val_dir, servable, seed)
    print("train: python -m deepfm_tpu_torch " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    # the main path: counts from 0, then the train task, then read
    fused_ctr.launches = fused_ctr.backward_launches = 0
    with contextlib.redirect_stdout(tee):
        state = cli.run(argv)
    launches, backward_launches = fused_ctr.launches, fused_ctr.backward_launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    records = [json.loads(x) for x in tee.lines.getvalue().splitlines()
               if x.startswith("{")]
    train = [r for r in records if r["kind"] == "train"]
    done = next(r for r in records if r["kind"] == "train_done")
    ev = next(r for r in records if r["kind"] == "eval")
    steps = done["steps"]
    if not train or not all(np.isfinite(r["loss"]) and np.isfinite(r["ce"]) for r in train):
        fail(f"train: a logged loss is not finite: {train}")
    if not train[-1]["ce"] < train[0]["ce"]:
        fail(f"train: the last window's ce {train[-1]['ce']} is not below the "
             f"first's {train[0]['ce']}")
    if launches < steps or backward_launches < steps:
        fail(f"train: {steps} steps launched fused_ctr_forward {launches} and "
             f"fused_ctr_backward {backward_launches} times")
    if not (0.0 <= ev["auc"] <= 1.0 and np.isfinite(ev["loss"])):
        fail(f"train: eval gave {ev}")
    print(f"train: {steps} steps; launches on the main path: fused_ctr_forward "
          f"{launches} (= {steps} train + {launches - steps} eval), "
          f"fused_ctr_backward {backward_launches}; ce {train[0]['ce']} -> "
          f"{train[-1]['ce']}; eval auc {ev['auc']} loss {ev['loss']} over "
          f"{ev['examples']} examples")
    print("train: end to end %s" % json.dumps({
        "examples_per_sec": done["examples_per_sec"],
        "input_wait_share": done["input_wait_share"], "seconds": done["seconds"],
        "peak_memory_gib": peak_gb}))

    # the servable against the trained model, on one val batch
    predict, _ = load_servable(servable, device="cuda")
    batch = first_batch(val_dir, "val", 1024, "cuda")
    want = predict_step(state.model, batch).cpu().numpy()
    got = predict(batch["feat_ids"].cpu().numpy(), batch["feat_vals"].cpu().numpy())
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.all(np.isfinite(got)) or err > TOL_PROB:
        fail(f"train: the servable's probabilities differ from the trained "
             f"model's by {err} (tolerance {TOL_PROB})")
    print(f"train: servable probabilities vs the trained model's predict step: "
          f"max abs diff {err}")
    decode_ms(train_dir)
    split = {b: step_breakdown(state, first_batch(train_dir, "train", b, "cuda"))
             for b in TRAIN_BATCHES}
    return {"launches": launches, "backward_launches": backward_launches,
            "steps": steps, "auc": ev["auc"], "breakdown": split}


def decode_ms(train_dir: str, reps: int = 5) -> None:
    """Host time to decode one batch of 1,024 records with the pipeline's
    pure-Python decoder (median, host clock), alone on the host."""
    from deepfm_tpu_torch.data.example_proto import decode_ctr_batch
    from deepfm_tpu_torch.data.pipeline import discover_files, record_stream

    records = []
    for rec in record_stream(discover_files(train_dir, ("train",), shuffle=False)):
        records.append(rec)
        if len(records) == 1024:
            break
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        decode_ctr_batch(records, 39)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"train: host decode of one 1,024-record batch: median {np.median(times):.3f} ms "
          f"over {reps} (host clock, no other thread running)")


def step_breakdown(state, batch: dict, reps: int = 20) -> dict:
    """One train step with its batch already on the card: device time from
    CUDA events (median of single steps), and its split by kernel from
    torch.profiler.  Returns the printed numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepfm_tpu_torch.train.step import train_step

    for _ in range(3):
        train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = _median_event_ms(lambda: train_step(state, batch), 1, reps)
    n = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            train_step(state, batch)
        torch.cuda.synchronize()
    kernels = {"forward_kernel": 0.0, "backward_kernel": 0.0, "zero_fill": 0.0}
    total = 0.0
    for row in prof.key_averages():
        if row.device_type != DeviceType.CUDA or row.key == "train.optimizer":
            continue
        us = row.device_time_total
        total += us
        if "fused_ctr_forward_kernel" in row.key:
            kernels["forward_kernel"] += us
        elif "fused_ctr_backward_kernel" in row.key:
            kernels["backward_kernel"] += us
        elif "FillFunctor" in row.key or "Memset" in row.key:
            kernels["zero_fill"] += us
    optimizer = sum(e.device_time_total for e in prof.events()
                    if e.name == "train.optimizer" and e.device_type == DeviceType.CPU)
    split = {k: v / n / 1e3 for k, v in kernels.items()}
    split["optimizer_update"] = optimizer / n / 1e3
    split["mlp_fwd_bwd_and_rest"] = (total - sum(kernels.values()) - optimizer) / n / 1e3
    busy_ms = total / n / 1e3
    if total == 0.0:
        fail("torch.profiler saw no device time in the train steps")
    rows = batch["feat_ids"].clamp(0, state.model.cfg.feature_size - 1)
    multiplicity = int(torch.unique(rows, return_counts=True)[1].max())
    result = {"step_device_ms": step_ms, "kernel_busy_ms": busy_ms,
              "max_row_multiplicity": multiplicity,
              "idle_share": 1.0 - busy_ms / step_ms, "split_ms": split}
    print("train step breakdown B=%d %s" % (batch["label"].shape[0], json.dumps(result)))
    return result


def train_argv(train_dir: str, val_dir: str, servable: str, seed: int) -> list[str]:
    return ["--task_type", "train", "--training_data_dir", train_dir,
            "--val_data_dir", val_dir, "--servable_model_dir", servable,
            "--num_epochs", "1", "--log_steps", str(LOG_STEPS),
            "--set", "model.fused_kernel=auto", "--set", f"run.seed={seed}"]


def phase_lazy(seed: int, train_dir: str, val_dir: str, servable: str,
               dense: dict) -> dict:
    """The train task at full width with lazy Adam on the tables: the
    losses, both kernels launched every step, one lazy step through the
    kernels against the plain versions, and the lazy step's device time
    and split beside the dense step's (``dense``: the train phase's
    breakdown at B=1,024)."""
    from deepfm_tpu_torch.launch import cli
    from deepfm_tpu_torch.ops import fused_ctr

    argv = train_argv(train_dir, val_dir, servable, seed) + [
        "--set", "optimizer.lazy_embedding_updates=true"]
    print("lazy: python -m deepfm_tpu_torch " + " ".join(argv))
    tee = _Tee(sys.stdout)
    # the main path: counts from 0, then the train task, then read
    fused_ctr.launches = fused_ctr.backward_launches = 0
    with contextlib.redirect_stdout(tee):
        state = cli.run(argv)
    launches, backward_launches = fused_ctr.launches, fused_ctr.backward_launches
    records = [json.loads(x) for x in tee.lines.getvalue().splitlines()
               if x.startswith("{")]
    train = [r for r in records if r["kind"] == "train"]
    done = next(r for r in records if r["kind"] == "train_done")
    ev = next(r for r in records if r["kind"] == "eval")
    steps = done["steps"]
    if state.lazy is None:
        fail("lazy: the train task did not build the lazy state")
    if not train or not all(np.isfinite(r["loss"]) and r["loss"] == r["ce"] for r in train):
        fail(f"lazy: a logged loss is not finite or not the CE alone: {train}")
    if not train[-1]["ce"] < train[0]["ce"]:
        fail(f"lazy: the last window's ce {train[-1]['ce']} is not below the "
             f"first's {train[0]['ce']}")
    if launches < steps or backward_launches < steps:
        fail(f"lazy: {steps} steps launched fused_ctr_forward {launches} and "
             f"fused_ctr_backward {backward_launches} times")
    print(f"lazy: {steps} steps; launches on the main path: fused_ctr_forward "
          f"{launches} (= {steps} train + {launches - steps} eval), "
          f"fused_ctr_backward {backward_launches}; ce {train[0]['ce']} -> "
          f"{train[-1]['ce']}; eval auc {ev['auc']}; examples/s "
          f"{done['examples_per_sec']}, input-wait share {done['input_wait_share']}")
    lazy_parity(seed, train_dir)
    batch = first_batch(train_dir, "train", TRAIN_BATCHES[0], "cuda")
    compact = compact_kernels(state, batch, seed)
    lazy_breakdown(state, batch, dense)
    return {"launches": launches, "backward_launches": backward_launches,
            "steps": steps, **compact}


def compact_kernels(state, batch: dict, seed: int) -> dict:
    """B1 and B1' at the shapes the lazy step gives them: the compact tables
    fm_v[row_id] [B·F, K] and fm_w[row_id] [B·F], each lookup's segment as
    its id.  Each against its plain version (the forward's tolerances, the
    backward's TOL_GRAD_REL), then B1''s time (kernel alone, CUDA graph),
    its plain version's, its bound and the compact zero fill's."""
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.ops.embedding import sort_segments

    model = state.model
    ids, vals = model.prepare(batch["feat_ids"], batch["feat_vals"])
    b, f = ids.shape
    k = model.fm_v.shape[1]
    order, seg, row_id, valid = sort_segments(ids.reshape(-1).clamp(0, model.fm_w.shape[0] - 1))
    slot = torch.empty_like(seg).scatter_(0, order, seg).to(torch.int32).view(b, f)
    fm_w_c, fm_v_c = model.fm_w.detach()[row_id], model.fm_v.detach()[row_id]
    got = fused_ctr.fused_ctr_interaction(fm_w_c, fm_v_c, slot, vals)
    want = fused_ctr.fused_ctr_plain(fm_w_c, fm_v_c, slot, vals)
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    g_emb = torch.randn((b, f, k), generator=g, device="cuda")
    g_yw = torch.randn((b,), generator=g, device="cuda")
    g_yv = torch.randn((b,), generator=g, device="cuda")
    got_b = fused_ctr.fused_ctr_backward(g_emb, g_yw, g_yv, fm_w_c, fm_v_c, slot, vals, False)
    want_b = fused_ctr.fused_ctr_backward_plain(g_emb, g_yw, g_yv, fm_w_c, fm_v_c, slot,
                                                vals, False)
    torch.cuda.synchronize()
    e = [float((a - w).abs().max()) for a, w in zip(got, want)]
    if not (e[0] <= TOL_EMB and e[1] <= TOL_YW_REL * (1.0 + float(want[1].abs().max()))
            and e[2] <= TOL_YV_REL * (1.0 + float(want[2].abs().max()))):
        fail(f"lazy: fused_ctr_forward on the compact tables disagrees with its plain "
             f"version: max abs err emb {e[0]}, y_w {e[1]}, y_v {e[2]}")
    eb = []
    for name, a, w in zip(("d_fm_w", "d_fm_v"), got_b, want_b):
        err, scale = float((a - w).abs().max()), float(w.abs().max())
        if not err <= TOL_GRAD_REL * scale:
            fail(f"lazy: fused_ctr_backward on the compact tables: {name} max abs err "
                 f"{err}, scale {scale}")
        eb.append(err)
    if got_b[1][~valid].any():
        fail("lazy: fused_ctr_backward wrote into a padding segment")
    lib = fused_ctr._library()
    d_w, d_v = torch.zeros_like(fm_w_c), torch.zeros_like(fm_v_c)
    ms, call_ms = time_ms(lambda: backward_kernel_only(
        lib, g_emb, g_yw, g_yv, fm_w_c, fm_v_c, slot, vals, d_w, d_v, None))
    plain_ms, _ = time_ms(lambda: fused_ctr.fused_ctr_backward_plain(
        g_emb, g_yw, g_yv, fm_w_c, fm_v_c, slot, vals, False), reps=20)
    fill_ms, _ = time_ms(lambda: (torch.zeros_like(fm_w_c), torch.zeros_like(fm_v_c)))
    fwd_ms, _ = time_ms(lambda: fused_ctr.fused_ctr_interaction(fm_w_c, fm_v_c, slot, vals))
    bound_ms, bound_by, detail = fused_ctr_backward_bound_ms(fm_w_c, fm_v_c, slot, b, f,
                                                             False)
    row = {"forward_max_abs_err": e, "backward_max_abs_err": eb,
           "compact_rows": int(row_id.numel()), "distinct_rows": int(valid.sum()),
           "forward_ms": fwd_ms, "backward_ms": ms, "backward_call_ms": call_ms,
           "backward_plain_ms": plain_ms, "backward_bound_ms": bound_ms,
           "backward_bound_by": bound_by, "zero_fill_ms": fill_ms,
           "zero_fill_mb": (fm_w_c.numel() + fm_v_c.numel()) * 4 / 1e6, **detail}
    print("lazy compact kernels B=%d %s" % (b, json.dumps(row)))
    return {"forward_max_abs_err": max(e), "backward_max_abs_err": max(eb)}


def _tables(state) -> dict:
    return {"fm_w": state.model.fm_w, "fm_v": state.model.fm_v,
            **{f"{s}.{k}": getattr(state.lazy, s)[k] for s in ("m", "v")
               for k in ("fm_w", "fm_v")}}


def lazy_parity(seed: int, train_dir: str) -> None:
    """One lazy step of the full-width float32 model (dropout off) through
    the kernels and through the plain versions (plain forward, autograd
    backward), from the same state after one warm-up step: the loss within
    TOL_LOSS_REL, fm_w, fm_v, m and v within TOL_GRAD_REL of each tensor's
    largest magnitude (Adam turns a rounding difference in a near-zero
    gradient into a step of up to lr, so a row is not held alone), and
    every untouched row of each bit for bit as before the step."""
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.data.pipeline import batched_ctr_batches, discover_files, record_stream
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.train import step as step_mod

    cfg = Config.from_dict({
        "model": {"fused_kernel": "auto", "compute_dtype": "float32",
                  "dropout_keep": (1.0, 1.0, 1.0)},
        "optimizer": {"lazy_embedding_updates": True}, "run": {"seed": seed}})
    files = discover_files(train_dir, ("train",), shuffle=False)
    warm, batch = (
        {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        for _, b in zip(range(2), batched_ctr_batches(record_stream(files),
                                                      batch_size=1024, field_size=39)))
    kernel = step_mod.create_train_state(cfg, "cuda")
    step_mod.train_step(kernel, warm)
    plain = step_mod.create_train_state(cfg, "cuda")
    plain.model.load_state_dict(kernel.model.state_dict())
    plain.step, plain.optimizer.count = kernel.step, kernel.optimizer.count
    for name, slots in kernel.optimizer.slots.items():
        for slot, t in slots.items():
            plain.optimizer.slots[name][slot].copy_(t)
    for key, t in _tables(kernel).items():
        if "." in key:
            _tables(plain)[key].copy_(t)
    before = {k: t.detach().clone() for k, t in _tables(kernel).items()}
    m_k = step_mod.train_step(kernel, batch)
    saved = step_mod.fused_ctr_interaction
    step_mod.fused_ctr_interaction = fused_ctr.fused_ctr_plain
    try:
        m_p = step_mod.train_step(plain, batch)
    finally:
        step_mod.fused_ctr_interaction = saved
    torch.cuda.synchronize()
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    if not (np.isfinite(loss_k) and loss_err <= TOL_LOSS_REL):
        fail(f"lazy: loss through the kernels {loss_k} vs plain {loss_p}")
    touched = torch.zeros(before["fm_v"].shape[0], dtype=torch.bool, device="cuda")
    touched[batch["feat_ids"].clamp(0, cfg.model.feature_size - 1).reshape(-1)] = True
    untouched_rows = 0
    for state in (kernel, plain):
        for name, t in _tables(state).items():
            rows = ~touched[:t.shape[0]]
            if not torch.equal(t.detach()[rows].view(torch.int32),
                               before[name][rows].view(torch.int32)):
                fail(f"lazy: an untouched row of {name} changed")
            untouched_rows = int(rows.sum())
    errs = {}
    for name, a in _tables(kernel).items():
        a, w = a.detach(), _tables(plain)[name].detach()
        err, scale = float((a - w).abs().max()), float(w.abs().max())
        if not err <= TOL_GRAD_REL * scale:
            fail(f"lazy: {name} through the kernels vs plain: max abs err {err}, "
                 f"scale {scale}")
        errs[name] = err / scale if scale else err
    print("lazy parity %s" % json.dumps({
        "loss": loss_k, "loss_rel_err": loss_err, "rel_err": errs,
        "touched_rows": int(touched.sum()), "untouched_rows_bit_equal": untouched_rows}))


def lazy_breakdown(state, batch: dict, dense: dict, reps: int = 20) -> None:
    """The lazy step with its batch on the card: device time (CUDA events,
    median of single steps) and its split from torch.profiler: B1 and B1'
    on the compact tables, the sort/segments/compact gathers, the row
    update, the rest optimizer, and the MLP with the rest; beside the dense
    step's at the same batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepfm_tpu_torch.train.step import train_step

    for _ in range(3):
        train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = _median_event_ms(lambda: train_step(state, batch), 1, reps)
    n = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            train_step(state, batch)
        torch.cuda.synchronize()
    labels = {"train.lazy_segments": "sort_segments_gathers",
              "train.lazy_rows": "row_update", "train.optimizer": "rest_optimizer"}
    split = {"forward_kernel": 0.0, "backward_kernel": 0.0}
    total = 0.0
    for row in prof.key_averages():
        if row.device_type != DeviceType.CUDA or row.key in labels:
            continue
        total += row.device_time_total
        if "fused_ctr_forward_kernel" in row.key:
            split["forward_kernel"] += row.device_time_total
        elif "fused_ctr_backward_kernel" in row.key:
            split["backward_kernel"] += row.device_time_total
    for label, name in labels.items():
        split[name] = sum(e.device_time_total for e in prof.events()
                          if e.name == label and e.device_type == DeviceType.CPU)
    split = {k: v / n / 1e3 for k, v in split.items()}
    busy_ms = total / n / 1e3
    if total == 0.0:
        fail("torch.profiler saw no device time in the lazy steps")
    split["mlp_fills_and_rest"] = busy_ms - sum(split.values())
    print("lazy step breakdown B=%d %s" % (batch["label"].shape[0], json.dumps({
        "step_device_ms": step_ms, "kernel_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / step_ms, "split_ms": split,
        "dense_step_device_ms": dense["step_device_ms"],
        "dense_optimizer_ms": dense["split_ms"]["optimizer_update"],
        "dense_backward_kernel_ms": dense["split_ms"]["backward_kernel"],
        "dense_zero_fill_ms": dense["split_ms"]["zero_fill"]})))


DDP_STEPS = 4


def phase_ddp(seed: int, workdir: str) -> dict:
    """Data-parallel training at world size 1 over NCCL, in this process:
    DDP_STEPS steps of the full-width model through parallel/spmd.py's step
    and the same through the single-card step, from the same weights, on
    batches of distinct ids (B1' then adds no two terms into one row, so
    both runs are deterministic): the parameters must agree within
    TOL_GRAD_REL of their largest magnitude.  Then the fused all-reduce's
    time on the full-width gradient buffer, and both steps' device time."""
    import torch.distributed as dist

    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.parallel import spmd
    from deepfm_tpu_torch.parallel.mesh import initialize_distributed
    from deepfm_tpu_torch.train.step import create_train_state, train_step

    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(workdir, "store"), 1),
                            rank=0, world_size=1, device_id=dev)
    try:
        cfg = Config.from_dict({"model": {"fused_kernel": "auto"}, "run": {"seed": seed}})
        ctx = initialize_distributed(cfg.mesh, "cuda")
        if ctx.group is None or ctx.world_size != 1:
            fail(f"ddp: expected a one-rank group, got {ctx}")
        dp = spmd.create_dp_train_state(cfg, ctx)
        one = create_train_state(cfg, "cuda")
        g = torch.Generator(device="cuda").manual_seed(seed + 5)
        batches = []
        for _ in range(DDP_STEPS):
            ids = torch.randperm(cfg.model.feature_size, generator=g, device="cuda")
            batches.append({
                "feat_ids": ids[:1024 * 39].view(1024, 39),
                "feat_vals": torch.rand((1024, 39), generator=g, device="cuda"),
                "label": (torch.rand((1024,), generator=g, device="cuda") < 0.25).float()})
        # the main path: counts from 0, then the data-parallel steps, then read
        fused_ctr.launches = fused_ctr.backward_launches = 0
        losses = [float(spmd.train_step(dp, b, ctx)["loss"]) for b in batches]
        launches, backward_launches = fused_ctr.launches, fused_ctr.backward_launches
        if launches < DDP_STEPS or backward_launches < DDP_STEPS:
            fail(f"ddp: {DDP_STEPS} steps launched fused_ctr_forward {launches} and "
                 f"fused_ctr_backward {backward_launches} times")
        ref = [float(train_step(one, b)["loss"]) for b in batches]
        torch.cuda.synchronize()
        errs = {}
        for (name, a), w in zip(dp.model.state_dict().items(),
                                one.model.state_dict().values()):
            err, scale = float((a - w).abs().max()), float(w.abs().max())
            if not err <= TOL_GRAD_REL * scale:
                fail(f"ddp: {name} after {DDP_STEPS} steps: max abs err {err}, "
                     f"scale {scale}")
            errs[name] = err / scale if scale else err
        if not all(np.isfinite(losses)):
            fail(f"ddp: losses {losses}")
        grads = sum(p.numel() for p in dp.model.parameters())
        flat = torch.zeros(grads + 6, device="cuda")
        for _ in range(3):
            dist.all_reduce(flat)
        torch.cuda.synchronize()
        allreduce_ms = _median_event_ms(lambda: dist.all_reduce(flat), 1, 20)
        dp_ms = _median_event_ms(lambda: spmd.train_step(dp, batches[0], ctx), 1, 10)
        one_ms = _median_event_ms(lambda: train_step(one, batches[0]), 1, 10)
        print("ddp %s" % json.dumps({
            "world_size": ctx.world_size, "backend": dist.get_backend(), "steps": DDP_STEPS,
            "losses": losses, "single_card_losses": ref, "max_rel_err": max(errs.values()),
            "allreduce_buffer_mb": flat.numel() * 4 / 1e6, "allreduce_ms": allreduce_ms,
            "dp_step_ms": dp_ms, "single_step_ms": one_ms,
            "launches": {"fused_ctr_forward": launches,
                         "fused_ctr_backward": backward_launches}}))
    finally:
        dist.destroy_process_group()
    return {"launches": launches, "backward_launches": backward_launches}


def b2_corpus(rows: int, seed: int, ties_and_pads: bool = False, dim: int = B2_DIM,
              all_equal: bool = False, live: int | None = None):
    """An int8 corpus on the card: random unit rows, quantized per row as
    funnel/quant.py does (codes = round(emb / scale), scale = max|row| /
    127).  With ``ties_and_pads``: ten equal rows, a tie far apart, and
    pad ids; with ``all_equal``: every row the same; with ``live``: only
    that many rows, spread over the corpus, have an id (the rest pads)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn((rows, dim), generator=g, device=dev)
    emb /= emb.norm(dim=1, keepdim=True)
    ids = torch.arange(rows, device=dev, dtype=torch.int32)
    if ties_and_pads:
        emb[20:30] = emb[7]
        emb[rows - 12] = emb[5]
        ids[-1000:] = -1
        ids[3::97] = -5
    if all_equal:
        emb[:] = emb[0]
    if live is not None:
        keep = torch.zeros(rows, dtype=torch.bool, device=dev)
        keep[torch.linspace(0, rows - 1, live, device=dev).long()] = True
        ids = torch.where(keep, ids, torch.full_like(ids, -1))
    scales = emb.abs().amax(dim=1) / 127.0
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    codes = torch.round(emb / safe[:, None]).clamp(-127, 127).to(torch.int8)
    return codes.contiguous(), scales.contiguous(), ids, emb


def b2_queries(b: int, seed: int, emb=None, dim: int = B2_DIM) -> torch.Tensor:
    """Unit queries, as the user tower gives them; with ``emb``, query 0
    is row 7 (the ten equal rows of the tie mix)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((b, dim), generator=g, device="cuda")
    if emb is not None:
        u[0] = emb[7]
    return (u / u.norm(dim=1, keepdim=True)).contiguous()


def retrieval_bound_ms(rows: int, b: int, kos: int) -> tuple[float, str, dict]:
    """Least time for one call: codes, scales and ids read once, the
    queries read and the [B, kos] pair written once, over the HBM rate; or
    the dequantizing multiply and 2·B·R·D FMA flops over the f32 peak."""
    nbytes = rows * (B2_DIM + 4 + 4) + b * B2_DIM * 4 + b * kos * 8
    flops = 2 * b * rows * B2_DIM + rows * B2_DIM
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            {"bytes": nbytes, "flops": flops})


# B2's kernels by the names torch.profiler gives them: the counting scans
# (histogram levels 0-3), the filter scan, the per-query selects, the rank
B2_KERNELS = {"scan_count": ("scan_kernel<", ", false>"),
              "scan_filter": ("scan_kernel<", ", true>"),
              "select": ("select_kernel", ""), "rank": ("rank_kernel", "")}


def b2_pass_split(fn, n: int = 10) -> dict:
    """Device ms per call of each of B2's kernels (and its workspace
    memset), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(B2_KERNELS, 0.0)
    split["memset"] = 0.0
    for row in prof.key_averages():
        if row.device_type != DeviceType.CUDA:
            continue
        for name, (stem, mode) in B2_KERNELS.items():
            if stem in row.key and mode in row.key:
                split[name] += row.device_time_total / n / 1e3
        if "Memset" in row.key:
            split["memset"] += row.device_time_total / n / 1e3
    if not all(split[name] for name in B2_KERNELS):
        fail(f"torch.profiler saw no time in one of B2's kernels: {split}")
    return split


def phase_b2(seed: int) -> dict:
    """Kernel B2 (retrieval_topk) against its plain version on the card at
    the funnel's corpus (117,581 rows) and the benchmark's (2,000,000),
    D 32, kos 128, B 8 and 64, plus a mix with ties and pads; with the
    kernel's device and call time, the plain version's, the least time and
    one PyTorch composition of the same function, torch.topk(q @ (codes ·
    scale)^T), which the port never calls."""
    from deepfm_tpu_torch.ops import retrieval

    def check(tag, u, codes, scales, ids):
        got = retrieval.retrieval_topk(u, codes, scales, ids, B2_KOS)
        want = retrieval.retrieval_topk_plain(u, codes, scales, ids, B2_KOS)
        torch.cuda.synchronize()
        agree = retrieval.topk_agreement(u, codes, scales, ids, got, want,
                                         TOL_B2_RTOL, TOL_B2_ATOL)
        if not agree["ok"]:
            fail(f"retrieval_topk disagrees with its plain version ({tag}): {agree}")
        print(f"b2 check {tag}: {json.dumps(agree)} (near-ties: {agree['swapped']} "
              f"swapped in place, {agree['boundary']} traded at the kos-th score)")
        return agree, got

    result = {"per_shape": {}, "max_abs_err": 0.0}
    for rows in B2_CORPORA:
        codes, scales, ids, emb = b2_corpus(rows, seed + 3)
        for b in B2_BATCHES:
            u = b2_queries(b, seed + b)
            tag = f"R={rows} B={b}"
            agree, _ = check(tag, u, codes, scales, ids)
            result["max_abs_err"] = max(result["max_abs_err"], agree["max_abs_err"])

            def library():
                s = u @ (codes.to(torch.float32) * scales[:, None]).T
                s = torch.where(ids[None, :] >= 0, s, float("-inf"))
                return torch.topk(s, B2_KOS, dim=1)

            ms, call_ms = time_ms(
                lambda: retrieval.retrieval_topk(u, codes, scales, ids, B2_KOS))
            plain_ms, _ = time_ms(
                lambda: retrieval.retrieval_topk_plain(u, codes, scales, ids, B2_KOS),
                reps=5, groups=3)
            library_ms, _ = time_ms(library, reps=10, groups=5)
            bound_ms, bound_by, detail = retrieval_bound_ms(rows, b, B2_KOS)
            row = {"rows": rows, "dim": B2_DIM, "queries": b, "kos": B2_KOS,
                   "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms, "max_abs_err": agree["max_abs_err"],
                   "pass_ms": b2_pass_split(
                       lambda: retrieval.retrieval_topk(u, codes, scales, ids, B2_KOS)),
                   **detail}
            result["per_shape"][(rows, b)] = row
            print("kernel retrieval_topk %s %s" % (tag, json.dumps(row)))
        del codes, scales, ids, emb
    codes, scales, ids, emb = b2_corpus(B2_CORPORA[0], seed + 4, ties_and_pads=True)
    u = b2_queries(8, seed + 5, emb)
    agree, got = check("ties and pads", u, codes, scales, ids)
    top = got[1][0, :10].tolist()
    if top != sorted(top):
        fail(f"retrieval_topk: the ten equal rows came back out of row order: {top}")
    result["max_abs_err"] = max(result["max_abs_err"], agree["max_abs_err"])
    result["max_abs_err"] = max(result["max_abs_err"], b2_adversarial(seed))
    return result


def b2_adversarial(seed: int) -> float:
    """B2 on inputs that fill the select's threshold bin or empty it, at
    the served corpus, B 8: every score equal (the first kos rows, in row
    order), fewer live rows than kos, kos 1 and 1,024, D 16 and 128.  Each
    is held to the plain version by topk_agreement and timed."""
    from deepfm_tpu_torch.ops import retrieval

    rows, worst = B2_CORPORA[0], 0.0
    cases = (("all scores equal", {"all_equal": True}, B2_KOS),
             ("100 live rows", {"live": 100}, B2_KOS),
             ("kos 1", {}, 1), ("kos 1024", {}, 1024),
             ("D 16", {"dim": 16}, B2_KOS), ("D 128", {"dim": 128}, B2_KOS))
    for i, (tag, kw, kos) in enumerate(cases):
        codes, scales, ids, _ = b2_corpus(rows, seed + 20 + i, **kw)
        u = b2_queries(8, seed + 30 + i, dim=codes.shape[1])
        got = retrieval.retrieval_topk(u, codes, scales, ids, kos)
        want = retrieval.retrieval_topk_plain(u, codes, scales, ids, kos)
        torch.cuda.synchronize()
        agree = retrieval.topk_agreement(u, codes, scales, ids, got, want,
                                         TOL_B2_RTOL, TOL_B2_ATOL)
        if not agree["ok"]:
            fail(f"retrieval_topk disagrees with its plain version ({tag}): {agree}")
        if kw.get("all_equal") and got[1].tolist() != [list(range(kos))] * 8:
            fail(f"retrieval_topk ({tag}): not the first {kos} rows in row order")
        if "live" in kw and int(torch.isfinite(got[0]).sum()) != 8 * kw["live"]:
            fail(f"retrieval_topk ({tag}): {int(torch.isfinite(got[0]).sum())} finite "
                 f"slots, not {8 * kw['live']}")
        ms, call_ms = time_ms(lambda: retrieval.retrieval_topk(u, codes, scales, ids, kos))
        print(f"b2 check {tag} (R={rows} B=8 D={codes.shape[1]} kos={kos}): "
              f"{json.dumps(agree)} ms {ms} call_ms {call_ms}")
        worst = max(worst, agree["max_abs_err"])
    return worst


def post(url: str, body: bytes, timeout: float = 120.0) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.load(r)


def phase_serve(seed: int, workdir: str) -> dict:
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.models import DeepFM
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.serve.batcher import pick_bucket
    from deepfm_tpu_torch.serve.export import export_servable, load_model
    from deepfm_tpu_torch.serve.server import serve_forever

    cfg = ModelConfig(fused_kernel="auto")
    t0 = time.perf_counter()
    model = DeepFM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    export_servable(cfg, model.state_dict(), workdir)
    del model
    print(f"serve: exported the full-width servable in {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(seed + 1)
    requests = []
    for n in (1, 8, 100):
        ids = make_ids(rng, n, cfg.field_size, cfg.feature_size)
        vals = rng.random((n, cfg.field_size)).astype(np.float32)
        requests.append((ids, vals))

    # the main path: counts from 0, then load + warm-up + requests
    fused_ctr.launches = 0
    ready = threading.Event()
    errors = []

    def run():
        try:
            serve_forever(workdir, port=0, buckets=BUCKETS, max_wait_ms=2.0,
                          device="cuda", ready=ready)
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            ready.set()

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, name="chip-smoke-server", daemon=True)
    thread.start()
    if not ready.wait(timeout=600) or errors:
        fail(f"server did not come up: {errors}")
    print(f"serve: server up on port {ready.port} in {time.perf_counter() - t0:.2f} s "
          f"(load + bucket warm-up)")
    base = f"http://127.0.0.1:{ready.port}"
    served = []
    try:
        # readiness first: the client's own first-use cost stays out of
        # the first :predict's time
        if not get(f"{base}/readyz").get("ready"):
            fail("/readyz is not ready")
        for ids, vals in requests:
            body = json.dumps({"instances": [
                {"feat_ids": i.tolist(), "feat_vals": v.tolist()}
                for i, v in zip(ids, vals)]}).encode()
            lat_ms = []
            for rep in range(1 + SERVE_REPEATS):
                t1 = time.perf_counter()
                code, doc = post(f"{base}/v1/models/deepfm:predict", body)
                lat_ms.append((time.perf_counter() - t1) * 1e3)
                if code != 200:
                    fail(f":predict with {len(ids)} instances answered {code}: {doc}")
                probs = np.asarray(doc["predictions"], np.float32)
                if rep == 0:
                    served.append(probs)
                elif not np.array_equal(probs, served[-1]):
                    fail(f":predict with {len(ids)} instances is not repeatable")
            print(f"serve: :predict {len(ids)} instances -> 200; first "
                  f"{lat_ms[0]:.3f} ms, then over {SERVE_REPEATS} sequential "
                  f"repeats p50 {np.percentile(lat_ms[1:], 50):.3f} ms, "
                  f"max {max(lat_ms[1:]):.3f} ms (host clock, client to client)")
        code, doc = post(f"{base}/v1/models/deepfm:predict",
                         b'{"instances": [{"feat_ids": [1, 2], "feat_vals": [1.0]}]}')
        if code != 400:
            fail(f"a ragged body answered {code}, not 400")
        metrics = get(f"{base}/v1/metrics")
        if get(f"{base}/healthz").get("status") != "alive":
            fail("/healthz is not alive")
    finally:
        ready.server.shutdown()
        thread.join(timeout=60)
    launches = fused_ctr.launches
    if thread.is_alive():
        fail("server thread did not stop")
    if launches <= 0:
        fail("the served path launched fused_ctr_forward no time")
    print(f"serve: fused_ctr_forward launches on the main path: {launches}; "
          f"dispatches by bucket: {metrics['batch_size_hist']}; "
          f"latency_ms: {metrics['latency_ms']}")

    # check: the plain forward of the same weights on the same padded bucket
    ref = load_model(workdir, device="cuda")
    max_err = 0.0
    for (ids, vals), got in zip(requests, served):
        n = len(ids)
        if got.shape != (n,) or not np.all(np.isfinite(got)):
            fail(f"predictions for {n} instances: shape {got.shape}, finite "
                 f"{bool(np.all(np.isfinite(got)))}")
        b = pick_bucket(BUCKETS, n)
        pid = np.zeros((b, cfg.field_size), np.int64)
        pval = np.zeros((b, cfg.field_size), np.float32)
        pid[:n], pval[:n] = ids, vals
        with torch.inference_mode():
            i, v = ref.prepare(torch.from_numpy(pid).cuda(), torch.from_numpy(pval).cuda())
            want = torch.sigmoid(ref.head(*fused_ctr.fused_ctr_plain(ref.fm_w, ref.fm_v, i, v)))
        err = float(np.abs(want.cpu().numpy()[:n] - got).max())
        max_err = max(max_err, err)
        if err > TOL_PROB:
            fail(f"served predictions for {n} instances differ from the plain "
                 f"forward by {err} (tolerance {TOL_PROB})")
    print(f"serve: predictions finite; max abs diff vs the plain forward {max_err}")
    breakdown(ref, workdir, rng)
    return {"launches": launches, "max_prob_err": max_err}


def breakdown(model, workdir: str, rng: np.random.Generator) -> None:
    """Where a dispatch's time goes, per bucket: the whole forward on the
    device (graph replay) and as eager calls, and the servable's predict
    (numpy in, host-to-device copy, forward, sigmoid, copy back) on the
    host clock.  Compare with the kernel's own times above."""
    from deepfm_tpu_torch.serve.export import load_servable

    cfg = model.cfg
    predict, _ = load_servable(workdir, device="cuda")
    for b in BUCKETS:
        ids = make_ids(rng, b, cfg.field_size, cfg.feature_size)
        vals = rng.random((b, cfg.field_size)).astype(np.float32)
        tids, tvals = torch.from_numpy(ids).cuda(), torch.from_numpy(vals).cuda()
        with torch.inference_mode():
            fwd_ms, fwd_call_ms = time_ms(lambda: model(tids, tvals), reps=20)
        host = []
        for _ in range(30):
            t0 = time.perf_counter()
            predict(ids, vals)
            host.append((time.perf_counter() - t0) * 1e3)
        print("breakdown B=%d %s" % (b, json.dumps({
            "forward_ms": fwd_ms, "forward_call_ms": fwd_call_ms,
            "predict_p50_ms": float(np.percentile(host, 50))})))


def build_funnel(seed: int, workdir: str) -> str:
    """The full-width funnel servable: the flagship ranker (random weights
    from --seed) over an int8 index of all 117,581 ranker items, encoded on
    the card through a random two-tower item tower from seeded random item
    features; top 32 -> 8, oversample 4.  The int8 export runs the recall
    gate."""
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.funnel import build_index, export_funnel_servable
    from deepfm_tpu_torch.models import DeepFM, TwoTower

    rank_cfg = ModelConfig(fused_kernel="auto")
    n = rank_cfg.feature_size
    query_cfg = ModelConfig(
        model_name="two_tower", user_vocab_size=FUNNEL_USER_VOCAB, item_vocab_size=n,
        user_field_size=FUNNEL_FIELDS, item_field_size=FUNNEL_FIELDS,
        embedding_size=FUNNEL_TOWER_EMB, tower_layers=FUNNEL_TOWER_LAYERS,
        tower_dim=FUNNEL_TOWER_DIM, compute_dtype="float32")
    rank = DeepFM(rank_cfg, device="cpu", generator=torch.Generator().manual_seed(seed + 10))
    query = TwoTower(query_cfg, device="cuda",
                     generator=torch.Generator().manual_seed(seed + 11))
    rng = np.random.default_rng(seed + 12)
    feats = rng.integers(0, n, (n, FUNNEL_FIELDS))
    t0 = time.perf_counter()
    index = build_index(query, np.arange(n), feats, np.ones((n, FUNNEL_FIELDS), np.float32))
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    export_funnel_servable(workdir, rank_cfg, rank.state_dict(), query_cfg,
                           query.state_dict(), index, top_k=FUNNEL_TOP_K,
                           return_n=FUNNEL_RETURN_N, retrieval="int8",
                           oversample=FUNNEL_OVERSAMPLE)
    with open(os.path.join(workdir, "funnel.json")) as f:
        section = json.load(f)["retrieval"]
    print(f"funnel: index of {n} items built on the card in {t_index:.3f} s; "
          f"export with the recall gate {time.perf_counter() - t0:.3f} s; "
          f"funnel.json retrieval {json.dumps(section)}")
    return workdir


def funnel_requests(rng: np.random.Generator, n: int) -> tuple[np.ndarray, ...]:
    """n users: query ids over the user vocabulary (vals 1), and ranking
    rows drawn like the serve phase's."""
    uids = rng.integers(0, FUNNEL_USER_VOCAB, (n, FUNNEL_FIELDS))
    uvals = np.ones((n, FUNNEL_FIELDS), np.float32)
    fids = make_ids(rng, n, 39, 117_581)
    fvals = rng.random((n, 39)).astype(np.float32)
    return uids, uvals, fids, fvals


def phase_funnel(seed: int, workdir: str) -> dict:
    """The funnel served over HTTP on the card, at full width: /v1/recommend
    with 1, 8 and 64 users, checked against the same payload run through
    the plain versions of B2 and B1; stage times, latency, device recall."""
    from deepfm_tpu_torch.funnel.index import build_rank_topn_with, build_retrieve_with
    from deepfm_tpu_torch.funnel.recall import recall_at_k
    from deepfm_tpu_torch.models.two_tower import encode_queries
    from deepfm_tpu_torch.ops import fused_ctr, retrieval
    from deepfm_tpu_torch.serve.batcher import pick_bucket
    from deepfm_tpu_torch.serve.server import serve_forever

    servable = build_funnel(seed, workdir)
    rng = np.random.default_rng(seed + 13)
    requests = [funnel_requests(rng, n) for n in FUNNEL_REQUESTS]

    # the main path: counts from 0, then load + warm-up + requests
    fused_ctr.launches = retrieval.launches = 0
    ready = threading.Event()
    errors = []

    def run():
        try:
            serve_forever(servable, port=0, buckets=FUNNEL_BUCKETS, max_wait_ms=2.0,
                          device="cuda", ready=ready)
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            ready.set()

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, name="chip-smoke-funnel", daemon=True)
    thread.start()
    if not ready.wait(timeout=600) or errors:
        fail(f"funnel server did not come up: {errors}")
    print(f"funnel: server up on port {ready.port} in {time.perf_counter() - t0:.2f} s "
          f"(load, staging, bucket warm-up)")
    base = f"http://127.0.0.1:{ready.port}"
    served = []
    try:
        if not get(f"{base}/readyz").get("ready"):
            fail("funnel /readyz is not ready")
        for uids, uvals, fids, fvals in requests:
            n = len(uids)
            body = json.dumps({"instances": [
                {"user_ids": a.tolist(), "user_vals": b.tolist(),
                 "feat_ids": c.tolist(), "feat_vals": d.tolist()}
                for a, b, c, d in zip(uids, uvals, fids, fvals)]}).encode()
            lat_ms = []
            for rep in range(1 + FUNNEL_REPEATS):
                t1 = time.perf_counter()
                code, doc = post(f"{base}/v1/recommend", body)
                lat_ms.append((time.perf_counter() - t1) * 1e3)
                if code != 200:
                    fail(f"/v1/recommend with {n} users answered {code}: {doc}")
                if rep == 0:
                    served.append(doc)
                elif doc != served[-1]:
                    fail(f"/v1/recommend with {n} users is not repeatable")
            print(f"funnel: /v1/recommend {n} users -> 200; first {lat_ms[0]:.3f} ms, "
                  f"then over {FUNNEL_REPEATS} sequential repeats p50 "
                  f"{np.percentile(lat_ms[1:], 50):.3f} ms, max {max(lat_ms[1:]):.3f} ms "
                  f"(host clock, client to client)")
        code, doc = post(f"{base}/v1/recommend", json.dumps({"instances": [
            {"user_ids": [1], "user_vals": [1.0], "feat_ids": [1] * 39,
             "feat_vals": [1.0] * 39}]}).encode())
        if code != 400:
            fail(f"a mis-sized recommend body answered {code}, not 400")
        metrics = get(f"{base}/v1/metrics")
    finally:
        ready.server.shutdown()
        thread.join(timeout=60)
    fwd_launches, retr_launches = fused_ctr.launches, retrieval.launches
    if thread.is_alive():
        fail("funnel server thread did not stop")
    if fwd_launches <= 0 or retr_launches <= 0:
        fail(f"the funnel path launched retrieval_topk {retr_launches} and "
             f"fused_ctr_forward {fwd_launches} times")
    fm = metrics["funnel"]
    print(f"funnel: launches on the main path: retrieval_topk {retr_launches}, "
          f"fused_ctr_forward {fwd_launches}; dispatches by bucket "
          f"{metrics['batch_size_hist']}")
    print("funnel: stages (host clock per dispatch, /v1/metrics) %s" % json.dumps({
        "retrieval_ms": fm["retrieval_ms"], "rank_ms": fm["rank_ms"],
        "engine_latency_ms": metrics["latency_ms"],
        "candidates_per_sec": fm["candidates_per_sec"],
        "score_read_bytes": fm["score_read_bytes"]}))

    # check: the same payload through the plain versions of B2 and B1
    scorer = ready.scorer
    ctx, payload = scorer.ctx, scorer.payload
    fu = ctx.user_fields
    kernel_retrieve = build_retrieve_with(ctx)
    rank = build_rank_topn_with(ctx)
    # every candidate ranked, so a served item is found whatever its place
    rank_all = build_rank_topn_with(ctx._replace(return_n=ctx.top_k))
    kos = ctx.top_k * ctx.oversample
    index = payload["index"]
    stats = {"rows": 0, "rows_equal": 0, "near_tie_rows": 0, "shortlist_swapped": 0,
             "shortlist_boundary": 0, "max_rank_err": 0.0, "max_retr_err": 0.0}
    for (uids, uvals, fids, fvals), doc in zip(requests, served):
        n = len(uids)
        b = pick_bucket(FUNNEL_BUCKETS, n)
        ids = np.zeros((b, fu + 39), np.int64)
        vals = np.zeros((b, fu + 39), np.float32)
        ids[:n] = np.concatenate([uids, fids], axis=1)
        vals[:n] = np.concatenate([uvals, fvals], axis=1)
        tids, tvals = torch.from_numpy(ids).cuda(), torch.from_numpy(vals).cuda()
        with torch.inference_mode():
            u = encode_queries(payload["query"], tids[:, :fu], tvals[:, :fu])
            args = (u, index["item_codes"], index["item_scales"], index["item_ids"], kos)
            agree = retrieval.topk_agreement(
                *args[:4], retrieval.retrieval_topk(*args), retrieval.retrieval_topk_plain(*args),
                TOL_B2_RTOL, TOL_B2_ATOL)
            ks, kcand = kernel_retrieve(payload, tids[:, :fu], tvals[:, :fu])
            with plain_kernels():
                s, cand = kernel_retrieve(payload, tids[:, :fu], tvals[:, :fu])
                ref = rank(payload, tids[:, fu:], tvals[:, fu:], cand, s).cpu().numpy()
                # plain B1 on the candidates the kernel pipeline retrieved
                ref_k = rank_all(payload, tids[:, fu:], tvals[:, fu:], kcand, ks).cpu().numpy()
        torch.cuda.synchronize()
        if not agree["ok"]:
            fail(f"funnel: the served shortlist disagrees with plain B2 for {n} users: {agree}")
        stats["shortlist_swapped"] += agree["swapped"]
        stats["shortlist_boundary"] += agree["boundary"]
        cand_differs = (kcand != cand).any(dim=1).cpu().numpy()
        items = np.asarray(doc["items"])
        if items.shape != (n, ctx.return_n) or not np.isfinite(doc["scores"]).all():
            fail(f"funnel: {n} users answered items of shape {items.shape}")
        for q in range(n):
            stats["rows"] += 1
            if cand_differs[q] and agree["traded"][q] == 0:
                fail(f"funnel: user {q} of {n}: the kernel's candidates differ from plain "
                     f"B2's with no near-tie in the user's own shortlist")
            r_err, t_err = check_served_user(
                items[q], np.asarray(doc["scores"][q]), np.asarray(doc["retrieval_scores"][q]),
                ref_k[q], ctx.return_n, f"funnel: user {q} of {n}")
            stats["max_rank_err"] = max(stats["max_rank_err"], r_err)
            stats["max_retr_err"] = max(stats["max_retr_err"], t_err)
            if np.array_equal(items[q], ref[q, 0].astype(np.int64)):
                stats["rows_equal"] += 1
            else:
                # a near-tie in the user's own shortlist or among its ranked
                # probabilities (both held to their tolerances above)
                stats["near_tie_rows"] += 1
    print(f"funnel: served vs plain B2 + plain B1 on the same payload: {json.dumps(stats)}")

    funnel_breakdown(ctx, payload, kernel_retrieve, build_rank_topn_with(ctx), rng)

    # device recall@32 of the int8 path against the exact f32 top-32
    exact_retrieve = build_retrieve_with(ctx._replace(retrieval_mode="exact"))
    g = np.random.default_rng(seed + 14)
    uids = torch.from_numpy(g.integers(0, FUNNEL_USER_VOCAB, (RECALL_USERS, fu))).cuda()
    uvals = torch.ones((RECALL_USERS, fu), device="cuda")
    with torch.inference_mode():
        _, exact_ids = exact_retrieve(payload, uids, uvals)
        _, int8_ids = kernel_retrieve(payload, uids, uvals)
    per_user = recall_at_k(int8_ids.cpu().numpy(), exact_ids.cpu().numpy())
    print(f"funnel: device recall@{ctx.top_k} of int8 vs exact f32 over {RECALL_USERS} "
          f"users: mean {per_user.mean()}, worst {per_user.min()}")
    return {"retrieval_launches": retr_launches, "forward_launches": fwd_launches,
            "recall": float(per_user.mean())}


@contextlib.contextmanager
def plain_kernels():
    """The funnel's B2 and B1 calls swapped for their plain versions, on the
    same card, for a reference run of the served payload."""
    from deepfm_tpu_torch.funnel import index
    from deepfm_tpu_torch.models import deepfm
    from deepfm_tpu_torch.ops import fused_ctr, retrieval

    saved = index.retrieval_topk, deepfm.fused_ctr_interaction
    index.retrieval_topk = retrieval.retrieval_topk_plain
    deepfm.fused_ctr_interaction = fused_ctr.fused_ctr_plain
    try:
        yield
    finally:
        index.retrieval_topk, deepfm.fused_ctr_interaction = saved


def check_served_user(items, rank_s, retr_s, ranked, n: int, what: str) -> tuple[float, float]:
    """Hold one user's served top ``n`` to ``ranked`` [3, K], the plain
    ranking of all the candidates the kernel pipeline retrieved: distinct
    candidates, each with its own probability (TOL_PROB) and retrieval
    score (TOL_RETR), in non-increasing order, and none of them below the
    n-th plain probability by more than TOL_PROB (a rank near-tie may trade
    places).  Returns the largest probability and retrieval errors."""
    place = {int(c): j for j, c in enumerate(ranked[0])}
    if len(set(items.tolist())) != n or any(int(c) not in place for c in items):
        fail(f"{what} served {items.tolist()}, not {n} distinct retrieved candidates "
             f"{ranked[0].astype(np.int64).tolist()}")
    at = [place[int(c)] for c in items]
    r_err = float(np.abs(rank_s - ranked[1, at]).max())
    t_err = float(np.abs(retr_s - ranked[2, at]).max())
    if r_err > TOL_PROB or t_err > TOL_RETR:
        fail(f"{what}: rank score err {r_err}, retrieval score err {t_err}")
    if np.any(np.diff(rank_s) > 0) or ranked[1, at].min() < ranked[1, n - 1] - TOL_PROB:
        fail(f"{what} served {items.tolist()} with probabilities {rank_s.tolist()}; the "
             f"plain ranking's top {n} is {ranked[0, :n].astype(np.int64).tolist()} "
             f"with {ranked[1, :n].tolist()}")
    return r_err, t_err


def funnel_breakdown(ctx, payload, retrieve, rank, rng: np.random.Generator) -> None:
    """Where a funnel dispatch's time goes, per bucket: each stage on the
    device (graph replay) and as eager calls, kernels included."""
    fu = ctx.user_fields
    for b in FUNNEL_BUCKETS:
        uids, uvals, fids, fvals = (torch.from_numpy(a).cuda()
                                    for a in funnel_requests(rng, b))
        with torch.inference_mode():
            scores, cand = retrieve(payload, uids, uvals)
            retr_ms, retr_call_ms = time_ms(lambda: retrieve(payload, uids, uvals), reps=20)
            rank_ms, rank_call_ms = time_ms(
                lambda: rank(payload, fids, fvals, cand, scores), reps=20)
        print("funnel breakdown B=%d %s" % (b, json.dumps({
            "retrieval_ms": retr_ms, "retrieval_call_ms": retr_call_ms,
            "rank_ms": rank_ms, "rank_call_ms": rank_call_ms,
            "rank_rows": b * ctx.top_k})))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one Hopper card.")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "the port on an NVIDIA Hopper card", file=sys.stderr)
        return 2
    try:
        from deepfm_tpu_torch.core.platform import resolve_device
        from deepfm_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: {e}",
              file=sys.stderr)
        return 2

    dev = resolve_device("cuda")
    card = card_line()
    print(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {sorted(_build.sources())} in {time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        print(f"build {name}: {info['seconds']:.2f} s\n{info['log'].strip()}", file=sys.stderr)

    kernel = phase_kernel(args.seed)
    backward = phase_backward(args.seed)
    b2 = phase_b2(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        serve = phase_serve(args.seed, os.path.join(workdir, "serve"))
        train_dir, val_dir = (os.path.join(workdir, d) for d in ("train", "val"))
        os.makedirs(train_dir)
        os.makedirs(val_dir)
        write_synthetic(args.seed, train_dir, val_dir)
        phase_parity(args.seed, train_dir)
        train = phase_train(args.seed, train_dir, val_dir,
                            os.path.join(workdir, "trained_servable"))
        lazy = phase_lazy(args.seed, train_dir, val_dir,
                          os.path.join(workdir, "lazy_servable"),
                          train["breakdown"][TRAIN_BATCHES[0]])
        ddp = phase_ddp(args.seed, workdir)
        funnel = phase_funnel(args.seed, os.path.join(workdir, "funnel"))

    fwd = kernel["per_bucket"][TRAIN_BATCHES[0]]
    bwd = backward["per_batch"][TRAIN_BATCHES[0]]
    # B2 at the served corpus and the smaller serving bucket
    b2_row = b2["per_shape"][(B2_CORPORA[0], B2_BATCHES[0])]
    line = {"kernels": [{
        "name": "fused_ctr_forward",
        "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/fused_ctr.cu",
        "replaces": "deepfm_tpu/ops/pallas_ctr.py:133",
        "launches": (serve["launches"] + train["launches"] + lazy["launches"]
                     + ddp["launches"] + funnel["forward_launches"]),
        "max_abs_err": max(kernel["max_abs_err"], lazy["forward_max_abs_err"]),
        "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_ctr_backward",
        "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/fused_ctr.cu",
        "replaces": "deepfm_tpu/ops/pallas_ctr.py:317",
        "launches": (train["backward_launches"] + lazy["backward_launches"]
                     + ddp["backward_launches"]),
        "max_abs_err": max(backward["max_abs_err"], lazy["backward_max_abs_err"]),
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": None,
    }, {
        "name": "retrieval_topk",
        "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/retrieval_topk.cu",
        "replaces": "deepfm_tpu/ops/pallas_retrieval.py:173",
        "launches": funnel["retrieval_launches"],
        "max_abs_err": b2["max_abs_err"],
        "ms": b2_row["ms"],
        "plain_ms": b2_row["plain_ms"],
        "bound_ms": b2_row["bound_ms"],
        "bound_by": b2_row["bound_by"],
        "library_ms": b2_row["library_ms"],
    }]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
