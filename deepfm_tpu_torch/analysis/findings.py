"""The finding record, the rule table and the suppressions, shared by the
port's three engines: the port's own copy of ``deepfm_tpu/analysis/
findings.py`` (that module imports no JAX; the port keeps its own copy).

A finding is one (rule, location, message) triple with a *fingerprint*: a
hash of the rule id, the repo-relative path and the normalized source
line (engines 1 and 3), or a stable per-contract token (engine 2, the
trace audit).  A moved finding keeps its fingerprint, an edited line gets
a new one.  Identical findings share a fingerprint and the baseline
ratchets their count (baseline.py).

Suppression syntax (checked by :func:`load_suppressions`):

    something_flagged()  # da:allow[rule-id] one-line justification

The justification is mandatory: a suppression without one is itself a
finding (``suppression-missing-reason``).  The comment may also sit on the
line directly above the flagged statement.

Engine 1 reads "captured" (recorded into a CUDA graph) where JAX's reads
"jit-reachable".  JAX's ``prng-reuse`` has no torch counterpart and is
waived by name in :data:`WAIVED`.
"""

from __future__ import annotations

import hashlib
import io
import re
import tokenize
from dataclasses import asdict, dataclass, field

# rule-id -> one-line description; the CLI renders this as the rule table
RULES = {
    # engine 1 (ast_rules.py, guarded_by.py)
    "tracer-host-op": (
        "host operation (.item()/.tolist()/.numpy()/.cpu(), float()/int()/"
        "bool() of a tensor, np.*, a synchronize) inside a function that a "
        "CUDA graph captures: it syncs the capture (set_sync_debug_mode "
        "raises on the card) or reads a value once, at capture"
    ),
    "traced-nondeterminism": (
        "wall-clock / python-random call inside a captured function: it runs "
        "once, at capture, and every replay repeats its value"
    ),
    "int32-cast": (
        "overflow-prone int32 cast (.to(torch.int32), .int(), "
        "dtype=torch.int32, astype(int32)) of an arithmetic result, or a "
        "clip/clamp applied AFTER the cast (a >=2**31 value wraps before "
        "the clip can bound it)"
    ),
    "swallowed-exception": (
        "broad except (bare / Exception / BaseException) whose handler "
        "neither re-raises, logs, nor uses the exception — failures in "
        "retry/breaker/swap paths vanish silently"
    ),
    "guarded-by": (
        "attribute accessed under a self._lock-style context elsewhere in "
        "the class is mutated outside any lock-held region — data race "
        "with the thread that honors the lock"
    ),
    # engine 3 (concurrency.py, --concurrency)
    "lock-order-cycle": (
        "two locks are acquired in opposite orders on different paths (or "
        "a non-reentrant lock is re-acquired while held) — a potential "
        "deadlock the thread scheduler will eventually find"
    ),
    "blocking-under-lock": (
        "a blocking operation (HTTP, object-store verb, sleep, subprocess, "
        "blocking queue get/put, file I/O, join/wait, a wait on the card) is "
        "reached — possibly through helper calls — while a lock is held; "
        "every contending thread stalls behind it"
    ),
    "signal-unsafe-lock": (
        "a function registered as a signal handler / preemption stop-"
        "callback / excepthook acquires a non-reentrant lock also taken on "
        "normal paths — a signal landing while the main thread holds it "
        "deadlocks the handler"
    ),
    "thread-lifecycle": (
        "a started thread with no join/stop path in its owning scope, a "
        "fire-and-forget non-daemon thread, or a daemon thread owning "
        "durable state — leaked on shutdown or killed mid-write"
    ),
    "suppression-missing-reason": (
        "da:allow[...] suppression without a one-line justification"
    ),
    "unused-suppression": (
        "da:allow[...] comment that matched no finding — dead after a fix, "
        "and a silent trap for the NEXT finding on that line"
    ),
    # engine 2 (trace_audit.py, --trace-audit)
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
    "trace-collective": (
        "a sharded path moves more than its contract allows: a corpus-sized "
        "tensor crossing funnel shards, or an elastic reshard plan that is "
        "not minimal"),
    "trace-quantized": (
        "the int8 retrieve graph allocated a corpus-sized f32 result"),
    "trace-observability": (
        "observability instrumentation inside a captured body (a metrics, "
        "trace or flight call, or a host-timer read, which a graph records "
        "once and never repeats), or a body whose two runs from one state "
        "differ (a host value folded into a tensor bakes a different "
        "constant into each capture)"),
}

# JAX rule ids the port does not carry, and why
WAIVED = {
    "prng-reuse": (
        "a torch draw advances a stateful torch.Generator (the dropout "
        "generator is registered with the step's graph, train/step.py "
        "StepGraph._capture), so there is no key value to draw from twice"),
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
    source: str = ""   # stripped source line, or the trace contract's token

    def __post_init__(self):
        if not self.fingerprint:
            self.fingerprint = _fingerprint(self)

    def to_dict(self) -> dict:
        return asdict(self)

    def render(self) -> str:
        out = f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    fix: {self.hint}"
        return out


def _fingerprint(f: Finding) -> str:
    raw = "|".join((f.rule, f.path, f.source.strip()))
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def fingerprint_findings(findings: list[Finding]) -> None:
    """Assign stable fingerprints in place: rule + path + normalized source
    line, deliberately NOT occurrence-indexed — N identical lines share one
    fingerprint and the baseline ratchets their COUNT (baseline.py), so
    fixing the first of N cannot renumber (and un-baseline) the survivors."""
    for f in findings:
        f.fingerprint = _fingerprint(f)


_SUPPRESS_RE = re.compile(r"#\s*da:allow\[([A-Za-z0-9_,-]+)\]\s*(.*)$")


@dataclass
class Suppression:
    rules: tuple[str, ...]
    line: int
    reason: str
    used: bool = field(default=False)


def load_suppressions(src: str) -> list[Suppression]:
    """Parse ``da:allow`` comments — COMMENT tokens only, so a docstring
    *showing* the syntax is not itself a suppression."""
    out = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(src).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        tokens = []
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if m:
            rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
            out.append(Suppression(rules=rules, line=tok.start[0],
                                   reason=m.group(2).strip()))
    return out


def apply_suppressions(
    findings: list[Finding], by_path: dict[str, list[Suppression]],
    unchecked_rules: frozenset[str] = frozenset(),
) -> list[Finding]:
    """Drop findings covered by a same-line or line-above ``da:allow``;
    emit a finding for any suppression lacking a justification.

    ``unchecked_rules`` names real rules THIS run did not evaluate: a
    suppression whose every rule is in that set is left alone rather than
    reported unused — a ``da:allow[blocking-under-lock]`` comment must
    not read as dead in a run without ``--concurrency``.  (A misspelled
    rule name is in no engine's set, so it still reports.)"""
    kept: list[Finding] = []
    for f in findings:
        sups = by_path.get(f.path, [])
        hit = next((s for s in sups
                    if f.rule in s.rules and s.line in (f.line, f.line - 1)), None)
        if hit is None:
            kept.append(f)
        else:
            hit.used = True
    for path, sups in by_path.items():
        for s in sups:
            # fingerprint on the comment's own content (source field): with
            # an empty source every suppression finding of a file would share
            # one fingerprint, and one baselined entry would accept them all
            if not s.reason:
                kept.append(Finding(
                    rule="suppression-missing-reason",
                    path=path, line=s.line, col=0,
                    message=(f"da:allow[{','.join(s.rules)}] needs a one-line "
                             f"justification after the bracket"),
                    hint="write WHY the finding is acceptable, not that it is",
                    source=f"da:allow[{','.join(s.rules)}]",
                ))
            elif not s.used and any(r not in unchecked_rules for r in s.rules):
                # a dead inline comment is actionable at once: delete it, or
                # it silently swallows the next same-rule finding on its line
                kept.append(Finding(
                    rule="unused-suppression",
                    path=path, line=s.line, col=0,
                    message=(f"da:allow[{','.join(s.rules)}] matched no finding "
                             f"— the debt it justified is gone"),
                    hint="delete the comment (the analyzer re-flags if the "
                         "finding ever returns)",
                    source=f"da:allow[{','.join(s.rules)}] {s.reason}",
                ))
    return kept
