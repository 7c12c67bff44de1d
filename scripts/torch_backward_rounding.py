#!/usr/bin/env python3
"""How far the fused backward (B1') and its plain float32 version each
round away from the exact sums, on the lazy step's compact tables.

    python3 scripts/torch_backward_rounding.py [--runs N] [--seed S]

Needs one card.  It writes chip_smoke.py's synthetic train data, takes
its first batch of 1,024 records through a fresh full-width DeepFM's
``prepare``, builds the compact tables the lazy step gives B1'
(``fm_w[row_id]``, ``fm_v[row_id]`` with each lookup's segment as its
id, as ``chip_smoke.compact_kernel_check`` does), and with the cotangents
of ``seed + 9``, ``+ 10`` and ``+ 11`` runs the kernel and the plain
version N times each on the same inputs.  Every run's largest error of
d_fm_w and d_fm_v is taken against the plain version run in float64 and
divided by that gradient's largest magnitude; one JSON line a seed and
gradient gives the p50, p99 and largest of those ratios for the kernel,
for the plain float32 version, and for the kernel against the plain
float32 version, with how many runs passed 1e-5 (``TOL_GRAD_REL``).  The
float32 atomics add in an order that changes from run to run, so the
spread is the point.  The last line is the card's name and power limit.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_backward_rounding: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.models import DeepFM
    from deepfm_tpu_torch.ops import _build, fused_ctr
    from deepfm_tpu_torch.ops.embedding import sort_segments

    _build.build()
    with tempfile.TemporaryDirectory() as d:
        train, val = os.path.join(d, "train"), os.path.join(d, "val")
        os.makedirs(train)
        os.makedirs(val)
        c.write_synthetic(args.seed, train, val)
        batch = c.first_batch(train, "train", c.TRAIN_BATCHES[0], "cuda")
    model = DeepFM(ModelConfig(fused_kernel="auto"), device="cuda")
    ids, vals = model.prepare(batch["feat_ids"], batch["feat_vals"])
    fm_w, fm_v = model.fm_w.detach(), model.fm_v.detach()
    b, f = ids.shape
    k = fm_v.shape[1]
    order, seg, row_id, _ = sort_segments(ids.reshape(-1).clamp(0, fm_w.shape[0] - 1))
    slot = torch.empty_like(seg).scatter_(0, order, seg).to(torch.int32).view(b, f)
    fm_w_c, fm_v_c = fm_w[row_id], fm_v[row_id]
    for seed in range(args.seed + 9, args.seed + 12):
        g = torch.Generator(device="cuda").manual_seed(seed)
        g_emb = torch.randn((b, f, k), generator=g, device="cuda")
        g_yw = torch.randn((b,), generator=g, device="cuda")
        g_yv = torch.randn((b,), generator=g, device="cuda")
        exact = fused_ctr.fused_ctr_backward_plain(
            *(t.double() for t in (g_emb, g_yw, g_yv, fm_w_c, fm_v_c)), slot,
            vals.double(), False)[:2]
        scale = [float(x.abs().max()) for x in exact]
        rel = {key: ([], []) for key in ("kernel", "plain", "kernel_vs_plain")}
        for _ in range(args.runs):
            got = fused_ctr.fused_ctr_backward(g_emb, g_yw, g_yv, fm_w_c, fm_v_c, slot,
                                               vals, False)
            plain = fused_ctr.fused_ctr_backward_plain(g_emb, g_yw, g_yv, fm_w_c, fm_v_c,
                                                       slot, vals, False)
            for i in range(2):
                rel["kernel"][i].append(
                    float((got[i].double() - exact[i]).abs().max()) / scale[i])
                rel["plain"][i].append(
                    float((plain[i].double() - exact[i]).abs().max()) / scale[i])
                rel["kernel_vs_plain"][i].append(
                    float((got[i] - plain[i]).abs().max()) / float(plain[i].abs().max()))
        for i, name in enumerate(("d_fm_w", "d_fm_v")):
            row = {"cotangent_seed": seed, "grad": name, "scale": scale[i], "runs": args.runs}
            for key, pair in rel.items():
                xs = np.asarray(pair[i])
                row[key] = {"p50": float(np.percentile(xs, 50)),
                            "p99": float(np.percentile(xs, 99)), "max": float(xs.max()),
                            "over_1e-5": int((xs > 1e-5).sum())}
            print(json.dumps(row))
    print(c.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
