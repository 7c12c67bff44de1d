"""The port's static-analysis suite (``python -m deepfm_tpu_torch.analysis``),
the counterpart of ``deepfm_tpu/analysis``'s three engines:

* **engine 1** (`ast_rules`, `guarded_by`) — a parse-only AST pass:
  tracer-host-op and traced-nondeterminism inside the functions a CUDA
  graph captures, int32-cast, swallowed-exception, and the guarded-by race
  lint for the threaded modules;
* **engine 2** (`trace_audit`, ``--trace-audit``) — runs the real entry
  points at a small width and holds their CUDA graphs to the trace-time
  contracts (in place, dtype, graphed = eager, buckets, the funnel, the
  elastic reshard, the observability of the captured bodies), and JAX's
  two collective contracts of the grid step on a record of its eager step
  (`collectives`);
* **engine 3** (`callgraph`, `concurrency`, ``--concurrency``) — a
  parse-only interprocedural concurrency pass: lock-order cycles,
  blocking-under-lock, signal-handler lock safety, thread lifecycle.

Findings carry file:line, rule id, fix hint and a stable fingerprint;
``deepfm_tpu_torch/analysis/baseline.json`` ratchets accepted debt
(baseline.py) and ``# da:allow[rule] reason`` suppresses inline
(findings.py).  JAX's ``prng-reuse`` is waived by name (``WAIVED``).
"""

from .ast_rules import analyze_modules
from .baseline import load_baseline, partition, write_baseline
from .callgraph import CallGraph
from .cli import main, run_ast_engine
from .concurrency import CONCURRENCY_RULES, run_concurrency_engine
from .findings import RULES, WAIVED, Finding, apply_suppressions, fingerprint_findings
from .guarded_by import check_guarded_by
from .trace_audit import run_trace_audit

__all__ = [
    "CONCURRENCY_RULES",
    "CallGraph",
    "Finding",
    "RULES",
    "WAIVED",
    "analyze_modules",
    "apply_suppressions",
    "check_guarded_by",
    "fingerprint_findings",
    "load_baseline",
    "main",
    "partition",
    "run_ast_engine",
    "run_concurrency_engine",
    "run_trace_audit",
    "write_baseline",
]
