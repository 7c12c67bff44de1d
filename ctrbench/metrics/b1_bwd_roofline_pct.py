"""``b1_bwd_roofline_pct``: kernel B1′'s least time over the traced steps
(the frozen byte bound, over each traced step's own ids, without the
wrapper's zero fill) as a share of its device time in the traced window
(its kernels inside the graph replays, from the profiler)."""

import torch

from ctrbench.bounds import b1_backward_seconds

KERNEL = "fused_ctr_backward_kernel"


def read(run):
    t = run.trace
    if t is None:
        return None
    spent = t.device_seconds(lambda n: KERNEL in n)
    if spent <= 0:
        return None
    if t.count(lambda n: KERNEL in n) != t.steps:
        return None  # not one launch a step: the bound below is of one
    fw, fv, k = run.tables
    bound = sum(b1_backward_seconds(b["feat_ids"].to(run.device).to(torch.int32), fw, fv, k)
                for b in run.traced_batches)
    return 100.0 * bound / spent
