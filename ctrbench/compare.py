"""The comparison that decides ``correct``: the timed path's first steps
against the reference's, by three numbers, each held to its limit
(``ctrbench/limits/<workload>.json``).

* ``loss_gap``: the largest ``|loss - loss_ref| / |loss_ref|`` over the
  compared steps (each step's loss as the step reported it, CE + L2).
* ``grad_gap``: each leaf's first gradient as the optimizer holds it after
  one step (Adam's ``mu / (1 - b1)``): the worst leaf's
  ``|‖g‖ - ‖g_ref‖|``, over the larger of ``‖g_ref‖`` and the median
  leaf's ``‖g_ref‖``.
* ``change_gap``: the same of each leaf's change ``‖p - p0‖`` after the
  compared steps.

A leaf whose reference gradient is under :data:`NOUGHT` of the median
leaf's moves by round-off alone under Adam: it is left out of both leaf
numbers by that rule, never by name.
"""

from __future__ import annotations

import json
import math
import os
import statistics

NOUGHT = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def loss_gap(losses: list[float], ref: list[float]) -> float:
    if len(losses) != len(ref):
        return math.inf
    return max(abs(a - b) / abs(b) for a, b in zip(losses, ref))


def leaf_gap(norms: dict, ref: dict, ref_grads: dict) -> tuple[float, str]:
    """(worst gap, its leaf) of one per-leaf norm against the reference's,
    over the leaves the :data:`NOUGHT` rule keeps."""
    if set(norms) != set(ref):
        return math.inf, "leaves differ: " + ",".join(sorted(set(norms) ^ set(ref)))
    g_med = statistics.median(ref_grads.values())
    kept = [k for k in ref if ref_grads[k] >= NOUGHT * g_med]
    med = statistics.median(ref[k] for k in kept)
    worst, leaf = 0.0, ""
    for k in kept:
        gap = abs(norms[k] - ref[k]) / max(ref[k], med)
        if not math.isfinite(norms[k]):
            gap = math.inf
        if gap >= worst:
            worst, leaf = gap, k
    return worst, leaf


def readings(program: dict, ref: dict) -> dict:
    """The three numbers from ``{"losses", "grad_norms", "change_norms"}``
    of the program (or a control) and of the reference."""
    grad, grad_leaf = leaf_gap(program["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    change, change_leaf = leaf_gap(program["change_norms"], ref["change_norms"],
                                   ref["grad_norms"])
    return {"loss_gap": loss_gap(program["losses"], ref["losses"]),
            "grad_gap": grad, "grad_leaf": grad_leaf,
            "change_gap": change, "change_leaf": change_leaf}


def load_limits(root: str, workload: str) -> dict | None:
    path = os.path.join(root, "ctrbench", "limits", f"{workload}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def judge(values: dict, limits: dict | None) -> tuple[bool, dict]:
    """``(correct, checks)``: each number beside its limit; a number with
    a null limit is shown and not compared; no limits file, no pass."""
    checks = {}
    ok = limits is not None
    for name in NUMBERS:
        limit = None if limits is None else limits[name]["limit"]
        v = values[name]
        checks[name] = {"value": v, "limit": limit}
        if limit is not None and not (math.isfinite(v) and v <= limit):
            ok = False
    return ok, checks
