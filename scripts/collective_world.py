"""The trace audit's collective world alone: one spawned ``[2, 2]`` world of
gloo ranks on DEVICE runs the audit's four grid steps (dense psum, dense
alltoall, lazy alltoall, dense ZeRO with its update under the sync guard)
with every ``torch.distributed`` call recorded, then both collective
contracts read the records (deepfm_tpu_torch/analysis/trace_audit.py
``grid_world``, ``grid_audits``).

    python3 scripts/collective_world.py [--device cuda|cpu]

Prints the card's name and power limit (on the card), then the analyser's
own lines on stderr (the world's seconds, its stages and its ranks' B1 and
B1' launches) and the findings; exits 1 when there is one.
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from deepfm_tpu_torch.analysis import trace_audit

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    findings = trace_audit.grid_audits(args.device, trace_audit.grid_world(args.device))
    for f in findings:
        print(f.render(), flush=True)
    print(f"findings {len(findings)}", flush=True)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
