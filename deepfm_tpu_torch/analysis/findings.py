"""The finding record: a trimmed copy of ``deepfm_tpu/analysis/findings.py``
(that module imports no JAX; the port keeps its own copy of the part it
needs).  A finding is one (rule, location, message) triple with a
fingerprint: a hash of the rule, the path and a stable per-contract token,
so one contract's finding keeps its fingerprint across runs."""

from __future__ import annotations

import hashlib
from dataclasses import asdict, dataclass

# the trace-time rules the port's audit reports (trace_audit.py)
RULES = {
    "trace-transfer": (
        "capturing a step into a CUDA graph synchronized with the host "
        "(torch.cuda.set_sync_debug_mode('error') tripped, or the capture "
        "failed): the step reads the host inside its body"),
    "trace-recompile": (
        "an admissible request size does not map onto a captured bucket "
        "graph, or a hot swap captured again"),
    "trace-donation": (
        "a train-step state tensor was rebound instead of updated in place: "
        "a graph replay would write freed memory and a save would read a "
        "stale tensor"),
    "trace-dtype": (
        "float64 in a step's state or metrics, or a state tensor whose dtype "
        "or shape a step changed"),
    "trace-parity": (
        "the graphed step is not the eager step bit for bit (or the paged "
        "step not the resident lazy step)"),
}


@dataclass
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int          # 1-based; 0 for a trace finding
    col: int
    message: str
    hint: str = ""
    fingerprint: str = ""
    source: str = ""   # the stable token of the contract

    def __post_init__(self):
        if not self.fingerprint:
            raw = "|".join((self.rule, self.path, self.source.strip()))
            self.fingerprint = hashlib.sha1(raw.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return asdict(self)

    def render(self) -> str:
        out = f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    fix: {self.hint}"
        return out
