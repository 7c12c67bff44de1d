"""The readings that the limits of a cell's comparison are set from
(``ctrbench/limits/<workload>.json``), in one process:

    python3 -m ctrbench.calibrate --workload <name> --seeds 1,2,3 \\
        --variants program,control,half_batch,unchanged

* ``program``: a whole run of the cell with a window of no length (its
  set-up, warm-up and compared steps), then the comparison;
* ``control``: the reference in the program's place, one precision down
  (``reference.common.Lowered``), against the float32 reference;
* ``half_batch``, ``unchanged``: the float32 reference
  in the program's place with that fault planted.

One JSON line a variant and seed, then one summary line: each number's
smallest and largest reading by variant."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .cell import Cell, load_cell
from .compare import NUMBERS, readings
from .harness import reference_readings, require_cards, run
from .reference.common import Lowered

VARIANTS = ("program", "control", "half_batch", "unchanged")


def compared_steps(cell: Cell) -> list[int]:
    """The ring positions of the compared steps (after the warm-up)."""
    tr = cell.traffic
    return [(tr["warmup_steps"] + s) % tr["ring_batches"] for s in range(tr["compare_steps"])]


def reading(cell: Cell, seed: int, variant: str) -> dict:
    if variant == "program":
        line, _ = run(cell, seed, 0.0, False, t_start=time.perf_counter())
        return {k: line["checks"][k]["value"] for k in NUMBERS}
    dev = torch.device("cuda", 0)
    steps = compared_steps(cell)
    ref = reference_readings(cell, seed, steps, dev)
    if variant == "control":
        other = reference_readings(cell, seed, steps, dev, prec=Lowered())
    else:
        other = reference_readings(cell, seed, steps, dev, fault=variant)
    return readings(other, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m ctrbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated run seeds")
    p.add_argument("--variants", default="program,control,half_batch,unchanged")
    args = p.parse_args(argv)
    cell = load_cell(os.getcwd(), args.workload)
    require_cards(cell.chips)
    summary: dict = {}
    for variant in args.variants.split(","):
        if variant not in VARIANTS:
            raise SystemExit(f"unknown variant {variant!r}; one of {VARIANTS}")
        for seed in (int(s) for s in args.seeds.split(",")):
            r = reading(cell, seed, variant)
            print(json.dumps({"variant": variant, "seed": seed, **r}), flush=True)
            for k in NUMBERS:
                lo, hi = summary.setdefault(variant, {}).get(k, (r[k], r[k]))
                summary[variant][k] = (min(lo, r[k]), max(hi, r[k]))
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
