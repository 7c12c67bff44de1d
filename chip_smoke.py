#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero; nothing is caught):

1. card   - the card's name and power limit, from nvidia-smi;
2. build  - every kernel under deepfm_tpu_torch/csrc, built from source;
3. kernel - each kernel's wrapper against its plain PyTorch version on the
            card, at the shapes the serving path gives it (the flagship
            table, 117,584 x 32, and every serving bucket), with the kernel's
            time, the plain version's time and the least time the card
            could take (CUDA events, median over repetitions);
4. serve  - the full-width DeepFM (117,581 x 39 x 32, MLP 256/128/64, bf16,
            random weights from --seed) exported, loaded on the card behind
            the HTTP server, and sent :predict requests of 1, 8 and 100
            instances; the predictions must be finite and agree with the
            plain-version forward of the same weights, and every kernel's
            launch count must have risen during this phase.

The last three lines of standard output are the kernels' JSON line, the
card's name and power limit, and {"ok": true, "device": {...}}.  With no
CUDA device, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
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
    for b in BUCKETS:
        ids64 = torch.from_numpy(make_ids(rng, b, f, cfg.feature_size)).to(dev)
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
               "call_ms": call_ms, "plain_call_ms": plain_call_ms, **detail}
        result["per_bucket"][b] = row
        print("kernel fused_ctr_forward B=%d %s" % (b, json.dumps(row)))
    result["max_abs_err"] = worst
    return result


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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        serve = phase_serve(args.seed, workdir)

    big = kernel["per_bucket"][max(BUCKETS)]
    line = {"kernels": [{
        "name": "fused_ctr_forward",
        "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/fused_ctr.cu",
        "replaces": "deepfm_tpu/ops/pallas_ctr.py:133",
        "launches": serve["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
    }]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
