"""``python -m deepfm_tpu_torch.analysis`` — run the port's static-analysis
suite (the counterpart of ``python -m deepfm_tpu.analysis``).

    python -m deepfm_tpu_torch.analysis deepfm_tpu_torch/                # engine 1
    python -m deepfm_tpu_torch.analysis deepfm_tpu_torch/ --concurrency  # + engine 3
    python -m deepfm_tpu_torch.analysis deepfm_tpu_torch/ --trace-audit  # + engine 2, on the card
    python -m deepfm_tpu_torch.analysis deepfm_tpu_torch/ --trace-audit --device cpu
    python -m deepfm_tpu_torch.analysis deepfm_tpu_torch/ --format json
    python -m deepfm_tpu_torch.analysis deepfm_tpu_torch/ --format github  # CI annotations
    python -m deepfm_tpu_torch.analysis deepfm_tpu_torch/ --write-baseline

Exit codes: 0 — clean (or everything baselined/suppressed); 1 — new
findings vs the baseline; 2 — usage, syntax or internal error, or
``--trace-audit`` on the card where there is none.

Engines 1 and 3 parse only (no imports, safe anywhere).  Engine 2
(``--trace-audit``) imports torch and the real entry points and runs them
at a small width (trace_audit.py); like every entry point of the port it
runs on the card unless ``--device cpu`` is given.  The baseline is
``deepfm_tpu_torch/analysis/baseline.json`` under the root that the
finding paths anchor to: the first directory above the analyzed package
that is not itself a package (``_find_root``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .ast_rules import analyze_modules, parse_files
from .baseline import load_baseline, partition, write_baseline
from .callgraph import CallGraph
from .concurrency import CONCURRENCY_RULES, run_concurrency_engine
from .findings import (
    RULES,
    WAIVED,
    Finding,
    apply_suppressions,
    fingerprint_findings,
    load_suppressions,
)
from .guarded_by import check_guarded_by

DEFAULT_PATH = "deepfm_tpu_torch"
DEFAULT_BASELINE = "deepfm_tpu_torch/analysis/baseline.json"


def _find_root(paths: list[str]) -> str:
    """Anchor finding paths (and so fingerprints and the default baseline)
    inside the analyzed tree: from the first analyzed path's directory, up
    through the package directories (those holding ``__init__.py``) to the
    first that is not one.  For ``deepfm_tpu_torch/`` or any file in it
    that is the checkout holding the package, from whatever directory the
    CLI runs in, with or without a ``.git``; a checkout nested inside
    another repository stays its own root."""
    probe = os.path.abspath(paths[0]) if paths else os.getcwd()
    d = probe if os.path.isdir(probe) else os.path.dirname(probe)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        d = os.path.dirname(d)
    return d


def _collect_files(paths: list[str], root: str) -> dict[str, str]:
    files: dict[str, str] = {}
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isfile(ap) and ap.endswith(".py"):
            files[os.path.relpath(ap, root).replace(os.sep, "/")] = ap
        elif os.path.isdir(ap):
            for dirpath, dirnames, names in os.walk(ap):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git", "_build")]
                for n in sorted(names):
                    if n.endswith(".py"):
                        full = os.path.join(dirpath, n)
                        files[os.path.relpath(full, root).replace(os.sep, "/")] = full
        else:
            raise FileNotFoundError(f"no such file or directory: {p}")
    out = {}
    for rel, full in sorted(files.items()):
        with open(full, encoding="utf-8") as f:
            out[rel] = f.read()
    return out


def run_ast_engine(files: dict[str, str],
                   concurrency: bool = False) -> list[Finding]:
    """Engine 1 over {relpath: source}: AST rules + guarded-by (one shared
    parse and call graph), optionally engine 3 (``concurrency=True``), with
    da:allow suppressions applied ONCE over the pooled findings — so a
    single comment can cover rules from either engine, and an
    unused-suppression is only reported for rules this run evaluated."""
    trees = parse_files(files)
    graph = CallGraph(files, trees)
    findings = analyze_modules(files, trees, graph)
    for path, src in sorted(files.items()):
        findings.extend(check_guarded_by(path, src, trees[path]))
    unchecked = frozenset()
    if concurrency:
        findings.extend(run_concurrency_engine(files, trees, graph))
    else:
        unchecked = frozenset(CONCURRENCY_RULES)
    sups = {path: load_suppressions(src) for path, src in files.items()}
    findings = apply_suppressions(findings, sups, unchecked_rules=unchecked)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    fingerprint_findings(findings)
    return findings


def _render_text(new, accepted, stale, *, out=None) -> None:
    out = out or sys.stdout  # looked up per call: a caller may have replaced it
    for f in new:
        print(f.render(), file=out)
        print(f"    fingerprint: {f.fingerprint}", file=out)
    if accepted:
        print(f"-- {len(accepted)} baselined finding(s) (accepted debt):",
              file=out)
        for f in accepted:
            print(f"   {f.path}:{f.line}: [{f.rule}] {f.fingerprint}",
                  file=out)
    if stale:
        print(f"-- {len(stale)} stale baseline entr(ies) — debt paid; "
              f"rerun with --write-baseline to shrink the file", file=out)
    print(
        f"analysis: {len(new)} new, {len(accepted)} baselined, "
        f"{len(stale)} stale",
        file=out,
    )


def _gh_escape(s: str, *, prop: bool = False) -> str:
    # workflow-command data escaping per the Actions toolkit: %, CR, LF
    # always; property values additionally ':' and ','
    s = s.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")
    if prop:
        s = s.replace(":", "%3A").replace(",", "%2C")
    return s


def _render_github(new, accepted, stale, *, out=None) -> None:
    """GitHub workflow-command annotations: CI renders each NEW finding
    anchored to its file:line in the diff view.  Baselined debt is a
    notice (visible, non-blocking), matching the exit-code contract."""
    out = out or sys.stdout
    for f in new:
        print(
            f"::error file={_gh_escape(f.path, prop=True)},"
            f"line={f.line},col={f.col},"
            f"title={_gh_escape(f.rule, prop=True)}::"
            + _gh_escape(f.message + (f"  fix: {f.hint}" if f.hint else "")),
            file=out,
        )
    for f in accepted:
        print(
            f"::notice file={_gh_escape(f.path, prop=True)},"
            f"line={f.line},title={_gh_escape(f.rule, prop=True)}::"
            + _gh_escape(f"baselined (accepted debt): {f.message}"),
            file=out,
        )
    print(
        f"analysis: {len(new)} new, {len(accepted)} baselined, "
        f"{len(stale)} stale",
        file=out,
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepfm_tpu_torch.analysis",
        description="the port's static analysis: AST rules, concurrency, "
                    "and the trace-time audits of its CUDA graphs",
    )
    ap.add_argument("paths", nargs="*", default=[DEFAULT_PATH],
                    help=f"files/directories to analyze (default: {DEFAULT_PATH})")
    ap.add_argument("--format", choices=("text", "json", "github"), default="text",
                    help="github = workflow-command annotations "
                         "(::error file=...) so CI anchors findings to "
                         "file:line")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON (default: <root>/{DEFAULT_BASELINE} "
                         f"when present)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings as the new baseline")
    ap.add_argument("--trace-audit", action="store_true",
                    help="also run the trace-time contract audit (engine 2; "
                         "imports torch and runs the entry points)")
    ap.add_argument("--device", default="cuda",
                    help="where --trace-audit runs (default: cuda, the card)")
    ap.add_argument("--concurrency", action="store_true",
                    help="also run the interprocedural concurrency engine "
                         "(engine 3; parse-only): lock-order cycles, "
                         "blocking-under-lock, signal-handler safety, "
                         "thread lifecycle")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in RULES.items():
            print(f"{rule}: {desc}")
        for rule, why in WAIVED.items():
            print(f"{rule}: waived — {why}")
        return 0

    if args.trace_audit:
        import torch

        try:
            kind = torch.device(args.device).type
        except RuntimeError as e:
            print(f"analysis: --device {args.device!r}: {e}", file=sys.stderr)
            return 2
        if kind == "cuda" and not torch.cuda.is_available():
            # never a quiet audit on the CPU in place of the card
            print("analysis: --trace-audit runs on the card (cuda) and torch sees no "
                  "CUDA device; pass --device cpu to audit on the CPU", file=sys.stderr)
            return 2

    t0 = time.perf_counter()
    try:
        root = _find_root(args.paths)
        files = _collect_files(args.paths, root)
        findings = run_ast_engine(files, concurrency=args.concurrency)
    except (OSError, ValueError) as e:
        # unanalyzable input (missing/unreadable path, syntax error) is an
        # exit-2 analyzer failure, never conflated with exit-1 findings
        print(f"analysis: {e}", file=sys.stderr)
        return 2
    t_engines = time.perf_counter() - t0

    t_audit = 0.0
    if args.trace_audit:
        t0 = time.perf_counter()
        try:
            from .trace_audit import run_trace_audit

            findings.extend(run_trace_audit(args.device))
        except Exception as e:
            # a crashing audit (a broken install, a model import error) is an
            # analyzer failure (exit 2) — the audits report contract
            # VIOLATIONS as findings, never as exceptions
            print(f"analysis: trace audit crashed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 2
        fingerprint_findings(findings)
        t_audit = time.perf_counter() - t0
    print(f"analysis: {len(files)} files; engines {'1+3' if args.concurrency else '1'} "
          f"{t_engines:.3f} s; trace audit "
          + (f"{t_audit:.3f} s on {args.device}" if args.trace_audit else "not run"),
          file=sys.stderr)
    if args.trace_audit:
        from .trace_audit import WAIVERS

        print(f"analysis: trace audit waives {', '.join(sorted(WAIVERS))}",
              file=sys.stderr)

    # the default baseline lives under the ROOT the finding paths anchor to
    default_baseline = os.path.join(root, DEFAULT_BASELINE)
    baseline_path = args.baseline or (
        default_baseline if os.path.exists(default_baseline) else None)
    if args.write_baseline:
        path = args.baseline or default_baseline
        # a subset run must MERGE, not truncate: rewriting the baseline from
        # `analysis deepfm_tpu_torch/serve --write-baseline` would drop every
        # other file's accepted debt and fail the next full run
        analyzed_dirs = tuple(
            os.path.relpath(os.path.abspath(p), root).replace(os.sep, "/") + "/"
            for p in args.paths if os.path.isdir(p))

        def _outside_analyzed(entry_path: str | None) -> bool:
            # under an analyzed dir but absent from `files` = deleted file:
            # its debt is paid, drop it; genuinely outside the set = keep
            if entry_path is None or entry_path in files:
                return False
            return not entry_path.startswith(analyzed_dirs)

        preserved: list = []
        try:
            for fp, e in load_baseline(path).items():
                if _outside_analyzed(e.get("path")):
                    f = Finding(rule=e.get("rule", "?"), path=e.get("path", "?"),
                                line=int(e.get("line", 0)), col=0,
                                message=e.get("message", ""), source="")
                    f.fingerprint = fp
                    preserved.extend([f] * int(e.get("count", 1)))
        except (ValueError, OSError, json.JSONDecodeError):
            preserved = []  # unreadable old baseline: rewrite from scratch
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        write_baseline(path, findings + preserved)
        print(f"analysis: wrote {len(findings)} finding(s) to {path}"
              + (f" (+{len(preserved)} preserved outside the analyzed set)"
                 if preserved else ""))
        return 0
    try:
        baseline = load_baseline(baseline_path) if baseline_path else {}
    except (ValueError, OSError, json.JSONDecodeError) as e:
        # a corrupt/mismatched baseline is an analyzer failure (exit 2),
        # never "new findings" (exit 1)
        print(f"analysis: unreadable baseline {baseline_path}: {e}",
              file=sys.stderr)
        return 2
    new, accepted, stale = partition(findings, baseline)

    if args.format == "json":
        json.dump(
            {
                "schema": 1,
                "new": [f.to_dict() for f in new],
                "baselined": [f.to_dict() for f in accepted],
                "stale_baseline": stale,
                "counts": {"new": len(new), "baselined": len(accepted),
                           "stale": len(stale)},
            },
            sys.stdout, indent=2,
        )
        print()
    elif args.format == "github":
        _render_github(new, accepted, stale)
    else:
        _render_text(new, accepted, stale)
    return 1 if new else 0
