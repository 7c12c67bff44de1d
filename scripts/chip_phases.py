"""Phases of chip_smoke.py alone on one card, for a quicker check than the
whole script and to time phase 18 of two checkouts in turns.

    python3 scripts/chip_phases.py [pool] [families] [tests] [analysis]
    python3 scripts/chip_phases.py --ab OTHER_CHECKOUT [--rounds 1]
    python3 scripts/chip_phases.py --ab-analysis OTHER_CHECKOUT [--rounds 1]

The first form builds the kernels and the native reader, writes the
train phase's synthetic files and phase 8's funnel servable, then runs
phase 18 (``pool``) and phase 21 (``families``) of this checkout's
chip_smoke.py, each with its seconds and kernel runs on one line
(``phase18 seconds ...``, ``phase21 seconds ...``, phase 21's
``paths_s``), the ``cuda`` tests of the paths phase 21 drives, and the
analyser with the trace audit on the card; with no argument, all four.
Its exit code is the first failure's.

The second form runs phase 18 alone, in a fresh interpreter each time,
of OTHER_CHECKOUT (another commit's tree, e.g. unpacked from ``git
archive``) and of this one in turns: other, this, this, other, ``--rounds``
times over; one ``AB <which> phase18 seconds ...`` line a run, with the
card's name and power limit.  The third form does the same with phase 15's
analyser run (``python -m deepfm_tpu_torch.analysis deepfm_tpu_torch/
--concurrency --trace-audit`` from each checkout's root, its kernels built
first): one ``AB <which> analysis seconds ... rc ...`` line a run, with the
analyser's own timing lines.

Needs one CUDA card (compute capability 9.0).
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(root: str):
    """Import ``root``'s chip_smoke.py, build its kernels and reader, and
    return (module, card line, work dir, phase 8's funnel servable)."""
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as c
    from deepfm_tpu_torch import native
    from deepfm_tpu_torch.core.platform import resolve_device
    from deepfm_tpu_torch.ops import _build

    t = time.time()
    _build.build()
    native.build()
    print(f"build {time.time() - t:.1f}", flush=True)
    resolve_device("cuda")
    card = c.card_line()
    print(f"card: {card}", flush=True)
    c.start_watchdog(c.WATCHDOG_S)
    work = tempfile.mkdtemp(prefix="chip_phases_")
    return c, card, work, c.build_funnel(0, os.path.join(work, "funnel"))


def phases(what: list[str]) -> int:
    c, card, work, funnel = _setup(ROOT)
    rc = 0
    if "pool" in what:
        t = time.time()
        out = c.phase_pool(0, os.path.join(work, "pool"), card, funnel, {})
        print(f"phase18 seconds {time.time() - t:.1f} launches {out['forward_launches']} "
              f"{out['retrieval_launches']}", flush=True)
    if "families" in what:
        train, val = os.path.join(work, "train"), os.path.join(work, "val")
        os.makedirs(train)
        os.makedirs(val)
        c.write_synthetic(0, train, val)
        t = time.time()
        out = c.phase_families(0, os.path.join(work, "families"), card, train, val, funnel)
        print(f"phase21 seconds {time.time() - t:.1f} launches {out['launches']} "
              f"{out['backward_launches']} {out['retrieval_launches']} errs "
              f"{out['max_abs_err']} {out['backward_max_abs_err']}", flush=True)
        print(f"paths_s {out['line']['paths_s']} drill_s "
              f"{out['line']['two_tower']['grid']['seconds']:.1f}", flush=True)
    if "tests" in what:
        r = subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_cuda.py", "-m",
                            "cuda", "-q", "-k", "variant or xdeepfm or members_graphs or paged",
                            "-p", "no:cacheprovider"]).returncode
        print(f"cuda tests rc {r}", flush=True)
        rc = rc or r
    if "analysis" in what:
        r = subprocess.run([sys.executable, "-m", "deepfm_tpu_torch.analysis",
                            "deepfm_tpu_torch/", "--concurrency", "--trace-audit"]).returncode
        print(f"analysis rc {r}", flush=True)
        rc = rc or r
    return rc


def pool_alone(root: str, tag: str) -> None:
    c, card, work, funnel = _setup(root)
    t = time.time()
    out = c.phase_pool(0, os.path.join(work, "pool"), card, funnel, {})
    print(f"AB {tag} phase18 seconds {time.time() - t:.1f} launches "
          f"{out['forward_launches']} {out['retrieval_launches']} card {card}", flush=True)


def analysis_ab(other: str, rounds: int) -> int:
    """Phase 15's analyser run of ``other`` and of this checkout in turns."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    roots = {"other": os.path.abspath(other), "this": ROOT}
    for root in roots.values():
        subprocess.run([sys.executable, "-c", "from deepfm_tpu_torch.ops import _build; "
                        "_build.build()"], cwd=root, check=True)
    for tag in ["other", "this", "this", "other"] * rounds:
        t = time.time()
        proc = subprocess.run([sys.executable, "-m", "deepfm_tpu_torch.analysis",
                               "deepfm_tpu_torch/", "--concurrency", "--trace-audit"],
                              cwd=roots[tag], capture_output=True, text=True)
        lines = [x for x in proc.stderr.splitlines() if x.startswith("analysis:")]
        print(f"AB {tag} analysis seconds {time.time() - t:.1f} rc {proc.returncode} "
              f"card {card} | {' | '.join(lines)}", flush=True)
        if proc.returncode:
            print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
            return proc.returncode
    return 0


PHASES = ("pool", "families", "tests", "analysis")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="*", help=f"any of {', '.join(PHASES)} (default: all)")
    ap.add_argument("--ab", help="another checkout whose phase 18 runs in turns with this one's")
    ap.add_argument("--ab-analysis", metavar="OTHER",
                    help="another checkout whose analyser run alternates with this one's")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of other, this, this, other (with --ab, --ab-analysis)")
    ap.add_argument("--pool-alone", nargs=2, metavar=("ROOT", "TAG"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.pool_alone:
        pool_alone(*args.pool_alone)
        return 0
    if args.ab_analysis:
        return analysis_ab(args.ab_analysis, args.rounds)
    if args.ab:
        for root, tag in [(args.ab, "other"), (ROOT, "this"), (ROOT, "this"),
                          (args.ab, "other")] * args.rounds:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--pool-alone",
                                 os.path.abspath(root), tag]).returncode
            if rc:
                return rc
        return 0
    unknown = set(args.what) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    return phases(args.what or list(PHASES))


if __name__ == "__main__":
    sys.exit(main())
