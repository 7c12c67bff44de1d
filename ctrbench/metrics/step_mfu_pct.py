"""``step_mfu_pct``: the configuration's model operations a step
(forward + backward = 3 x forward, from its shapes) times the window's
steps, over the window's seconds, as a share of the bf16 dense peak."""

from ctrbench.bounds import BF16_FLOPS_PER_S


def read(run):
    flops = 3 * run.flops_per_example * run.examples
    return 100.0 * flops / run.window_s / BF16_FLOPS_PER_S
