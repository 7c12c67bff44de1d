#!/usr/bin/env python3
"""chip_smoke.py's sharded phase over NCCL, one rank a card.

    python3 scripts/torch_grid_nccl.py [--seed N]
    python3 scripts/torch_grid_nccl.py --one-card

Needs a machine with 4 cards (``chip_smoke.SHARD_RANKS``).  It builds the
kernels, then runs ``chip_smoke.phase_sharded`` with ``backend="nccl"``:
the same configurations (``chip_smoke.SHARD_CONFIGS``), the same checks against the single-card step (run on card 0
by this process), and one ``sharded`` JSON line a configuration, whose
times are NCCL's between the cards.  The last lines are each card's name
and power limit as nvidia-smi gives them.

With ``--one-card`` it asks instead whether NCCL takes two ranks of one
communicator on the same card, as the phase would need on a machine with
one card: two spawned ranks on ``cuda:0`` run one all_reduce, and it
prints each rank's result or the error NCCL gave (the phase runs over
gloo there, whose collectives on CUDA tensors it checks itself).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _one_card_rank(rank: int, store: str, out: str) -> None:
    """Rank ``rank`` of two NCCL ranks on cuda:0: one all_reduce."""
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(store, 2), rank=rank,
                                world_size=2)
        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        result = {"ok": True, "value": t.tolist()}
    except Exception as e:  # the finding: written out, printed by the parent
        result = {"ok": False, "error": f"{type(e).__name__}: {str(e).strip()[:600]}"}
    finally:
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def one_card(timeout_s: float = 90.0) -> list[dict]:
    """Each rank's result of :func:`_one_card_rank` (ranks still running
    after ``timeout_s`` are killed and read "timed out")."""
    with tempfile.TemporaryDirectory(prefix="one_card_") as workdir:
        ctx = mp.start_processes(_one_card_rank, args=(os.path.join(workdir, "store"),
                                                       workdir),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0) and time.monotonic() < deadline:
                pass
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(2):
            path = os.path.join(workdir, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    out.append(json.load(f))
            else:
                out.append({"ok": False, "error": "timed out"})
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one-card", action="store_true",
                    help="ask whether NCCL takes two ranks on one card")
    args = ap.parse_args()
    if args.one_card:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                          "card": torch.cuda.get_device_name(0),
                          "nccl_two_ranks_one_card": one_card()}))
        return 0
    if torch.cuda.device_count() < chip_smoke.SHARD_RANKS:
        print(f"needs {chip_smoke.SHARD_RANKS} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    from deepfm_tpu_torch.core.platform import resolve_device
    from deepfm_tpu_torch.ops import _build

    _build.build()
    resolve_device("cuda")
    with tempfile.TemporaryDirectory(prefix="grid_nccl_") as workdir:
        total = chip_smoke.phase_sharded(args.seed, workdir, backend="nccl")
    print(total)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
