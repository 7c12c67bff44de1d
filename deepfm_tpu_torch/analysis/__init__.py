"""Contract audits of the port: ``trace_audit.py`` restates engine 2 of
``deepfm_tpu/analysis`` (the trace-time contracts) for the port's CUDA
graphs; ``findings.py`` is the trimmed ``Finding`` record they report."""

from .findings import Finding
from .trace_audit import run_trace_audit

__all__ = ["Finding", "run_trace_audit"]
