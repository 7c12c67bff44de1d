"""How far apart two runs of chip_smoke.py's stream-phase train task land on
one card, within a route and across the routes: the train task of phase 20
(the flagship width, the train phase's first three files, the 8,192-record
shuffle, one epoch) run ``--repeats`` times from local disk and as many
times from the port's dev object store (FifoBridge into the C++ reader),
interleaved.  For every pair of runs (disk/disk, S3/S3, S3/disk) it prints
the final train and eval losses apart (relative) and the final eval AUCs
apart (absolute), and the largest of each, as one JSON line (also written
to ``chiprun_out/stream_route_spread.json``).  chip_smoke.py's
``TOL_ROUTE`` is set from these readings.

    python3 scripts/stream_route_spread.py --repeats 6

Needs one CUDA card (compute capability 9.0) and the repository's
sources beside it; builds the kernels and the native reader first.
"""

import argparse
import itertools
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "stream_route_spread.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_route_spread: no CUDA device is available", file=sys.stderr)
        return 2
    from deepfm_tpu_torch import native
    from deepfm_tpu_torch.core.platform import resolve_device
    from deepfm_tpu_torch.data import object_store
    from deepfm_tpu_torch.data.pipeline import discover_files
    from deepfm_tpu_torch.ops import _build

    resolve_device("cuda")
    _build.build()
    native.build()
    card = c.card_line()
    runs: dict[str, list] = {"disk": [], "s3": []}
    with tempfile.TemporaryDirectory(prefix="route_spread_") as work:
        tr, va = os.path.join(work, "train"), os.path.join(work, "val")
        os.makedirs(tr)
        os.makedirs(va)
        c.write_synthetic(args.seed, tr, va)
        files = sorted(discover_files(tr, ("train",), shuffle=False))[:c.STREAM_FILES]
        val = discover_files(va, ("val",), shuffle=False)[0]
        records = len(files) * c.TRAIN_RECORDS_PER_FILE
        proc, base = c.start_dev_store(work)
        try:
            prefix, local = f"{base}/bucket/s3", os.path.join(work, "local")
            c.upload_route_files(object_store.get_store(), prefix, local, files, val)
            for i in range(args.repeats):
                for route, data, model_dir in (
                        ("disk", local, os.path.join(work, f"model_disk{i}")),
                        ("s3", prefix, f"{base}/bucket/model_s3_{i}")):
                    r = c._route_run(c.route_argv(args.seed, data, model_dir,
                                                  os.path.join(work, f"servable_{route}_{i}")),
                                     f"{route} run {i}", records, c.VAL_RECORDS)
                    runs[route].append({"loss": r["loss"], "eval": r["eval"]})
        finally:
            proc.terminate()
            proc.wait(timeout=30)
    pairs = {"disk_vs_disk": list(itertools.combinations(runs["disk"], 2)),
             "s3_vs_s3": list(itertools.combinations(runs["s3"], 2)),
             "s3_vs_disk": list(itertools.product(runs["s3"], runs["disk"]))}
    diffs = {name: [c.route_diffs(a, b) for a, b in ps] for name, ps in pairs.items()}
    doc = {"card": card, "repeats": args.repeats, "records_a_run": records,
           "max": {name: {k: max(d[k] for d in ds) for k in ds[0]}
                   for name, ds in diffs.items()},
           "pairs": diffs,
           "runs": {route: [{"loss": r["loss"], "eval_loss": r["eval"]["loss"],
                             "eval_auc": r["eval"]["auc"]} for r in rs]
                    for route, rs in runs.items()}}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print("route_spread " + json.dumps({k: doc[k] for k in ("card", "repeats", "max")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
