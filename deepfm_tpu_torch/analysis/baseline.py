"""Baseline ratchet: the gate starts green and only tightens.  The port's
own copy of ``deepfm_tpu/analysis/baseline.py``; the port's baseline file
is ``deepfm_tpu_torch/analysis/baseline.json``.

The baseline file is a checked-in JSON snapshot of accepted findings
(fingerprint -> summary).  A run compares its findings against it:

* findings whose fingerprint is in the baseline are *accepted* (reported
  separately, never fail the gate);
* findings not in the baseline are *new* — the gate fails;
* baseline entries no findings matched are *stale* — reported so the file
  shrinks as debt is paid (``--write-baseline`` rewrites it), but they do
  not fail the gate (a refactor that deletes flagged code must not go red).

Fingerprints hash rule + path + source line (findings.py), so pure line
moves neither invalidate nor escape the baseline; identical findings share
one fingerprint and ratchet by COUNT, so fixing one of N identical lines
cannot resurface the survivors as "new".
"""

from __future__ import annotations

import json
import os

from .findings import Finding

SCHEMA_VERSION = 1


def load_baseline(path: str) -> dict[str, dict]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"baseline {path} has schema {data.get('schema')!r}, "
            f"this analyzer expects {SCHEMA_VERSION}"
        )
    return data.get("findings", {})


def write_baseline(path: str, findings: list[Finding]) -> None:
    entries: dict[str, dict] = {}
    for f in findings:
        e = entries.setdefault(f.fingerprint, {
            "rule": f.rule,
            "path": f.path,
            "line": f.line,
            "message": f.message,
            "count": 0,
        })
        e["count"] += 1
    payload = {
        "schema": SCHEMA_VERSION,
        "comment": (
            "Accepted pre-existing findings (ratchet). Entries exist to be "
            "deleted: fix the finding, rerun with --write-baseline."
        ),
        "findings": dict(sorted(entries.items())),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
        f.write("\n")


def partition(
    findings: list[Finding], baseline: dict[str, dict]
) -> tuple[list[Finding], list[Finding], list[str]]:
    """-> (new, accepted, stale_fingerprints).

    Count-aware: a fingerprint shared by N identical findings is accepted
    up to its baselined ``count`` — fixing one of N leaves the survivors
    accepted (and the shrunk count reported stale); an (N+1)-th occurrence
    is new."""
    budget = {fp: int(e.get("count", 1)) for fp, e in baseline.items()}
    new, accepted = [], []
    for f in findings:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
            accepted.append(f)
        else:
            new.append(f)
    stale = [fp for fp, left in budget.items() if left > 0]
    return new, accepted, stale
