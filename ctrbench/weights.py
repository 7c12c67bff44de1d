"""The initial weights of a run, made on the run's device from the seed in
two large calls (one normal, one uniform draw), float32, by the leaves
the reference family declares: glorot normal tables, glorot uniform
kernels and filters, zero biases.  Where the configuration says
``"fm_b_init": "click_prior"``, the global bias ``fm_b`` starts at the
logit of the traffic's click rate instead (the output bias set to the
class prior, as Lin et al., "Focal Loss", arXiv:1708.02002 section 4.1,
start theirs).  The program and the reference start from the same
tensors."""

from __future__ import annotations

import math

import torch

from .feed import WEIGHTS, sub_seed
from .reference import family


def make_weights(model: dict, seed: int, device: torch.device,
                 prior: float | None = None) -> dict:
    """The leaves by name; ``prior``, if given, the click rate whose logit
    ``fm_b`` starts at."""
    leaves = family(model["model_name"]).leaves(model)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))

    def numel(shape) -> int:
        n = 1
        for s in shape:
            n *= s
        return n

    draws = {kind: (torch.randn if kind == "normal" else torch.rand)(
        sum(numel(shape) for _, shape, init, *_ in leaves if init == kind),
        generator=g, device=device) for kind in ("normal", "uniform")}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, init, fan_in, fan_out in leaves:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
            if name == "fm_b" and prior is not None:
                out[name] += math.log(prior / (1.0 - prior))
            continue
        n = numel(shape)
        x = draws[init][at[init]:at[init] + n].view(shape)
        at[init] += n
        if init == "normal":
            out[name] = x * (2.0 / (fan_in + fan_out)) ** 0.5
        else:
            out[name] = (2.0 * x - 1.0) * (6.0 / (fan_in + fan_out)) ** 0.5
    return out
