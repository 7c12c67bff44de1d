"""Each configuration's operation counts and the kernels' bounds against
hand counts at small shapes, and the products' counts against PyTorch's
own FLOP counter on the reference."""

import importlib.util
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT
from ctrbench import bounds
from ctrbench.reference import common, family


def _counts(config: str):
    path = os.path.join(ROOT, "ctrbench", "configs", f"{config}_counts.py")
    spec = importlib.util.spec_from_file_location(f"counts_{config}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_deepfm_hand_count():
    m = {"field_size": 2, "embedding_size": 3, "deep_layers": [4]}
    emb = 2 * 3                      # e = v * x
    first = 2 * 2                    # w * x, summed
    second = 3 * 2 * 3 + 3 * 3       # Σe, Σe² (fma), then square, subtract, sum
    mlp = (2 * 6 * 4 + 4) + (2 * 4 * 1 + 1)
    assert _counts("deepfm_criteo").forward_flops_per_example(m) == (
        emb + first + second + mlp + 3) == 101


def test_xdeepfm_hand_count():
    m = {"field_size": 2, "embedding_size": 3, "cin_layers": [4, 2], "deep_layers": [4]}
    layer1 = 2 * 2 * 3 + 2 * 2 * 2 * 4 * 3 + 4 * 3   # outer, contraction, sum over K
    layer2 = 4 * 2 * 3 + 2 * 4 * 2 * 2 * 3 + 2 * 3
    cin = layer1 + layer2 + 2 * 6 + 1
    mlp = (2 * 6 * 4 + 4) + (2 * 4 * 1 + 1)
    assert _counts("xdeepfm_criteo").forward_flops_per_example(m) == (
        6 + 4 + cin + mlp + 3) == 333


@pytest.mark.parametrize("config, model", [
    ("deepfm_criteo", {"model_name": "deepfm", "feature_size": 50, "field_size": 5,
                       "embedding_size": 4, "deep_layers": [8, 6],
                       "dropout_keep": [1.0, 1.0]}),
    ("xdeepfm_criteo", {"model_name": "xdeepfm", "feature_size": 50, "field_size": 5,
                        "embedding_size": 4, "cin_layers": [6, 3], "deep_layers": [8, 6],
                        "dropout_keep": [1.0, 1.0]}),
])
def test_products_match_pytorch_counter(config, model):
    """The matmul and einsum part of the count equals what PyTorch counts
    on the reference's forward."""
    fam = family(model["model_name"])
    g = torch.Generator().manual_seed(0)
    p = {n: torch.randn(s, generator=g) for n, s, *_ in fam.leaves(model)}
    b = 8
    ids = torch.randint(0, 50, (b, 5), generator=g)
    vals = torch.rand((b, 5), generator=g)
    with FlopCounterMode(display=False) as fc:
        fam.logits(p, ids, vals, model, [None, None], common.Float32())
    f, k, dims = 5, 4, [20, *model["deep_layers"], 1]
    products = sum(2 * a * c for a, c in zip(dims[:-1], dims[1:]))
    h = f
    for h_out in model.get("cin_layers", []) if config == "xdeepfm_criteo" else []:
        products += 2 * h * f * h_out * k
        h = h_out
    if config == "xdeepfm_criteo":
        products += 2 * sum(model["cin_layers"])
    assert fc.get_total_flops() == b * products
    assert _counts(config).forward_flops_per_example(model) > products


def test_b1_bound_hand_count():
    ids = torch.tensor([[0, 1], [1, 2]], dtype=torch.int32)
    nbytes = (2 * 2 * 4 * 2          # ids, vals
              + 3 * 4 * 4 + 3 * 4    # 3 distinct fm_v rows of K=4, 3 fm_w rows
              + 2 * 2 * 4 * 4 + 2 * 2 * 4)   # emb, y_w, y_v
    flops = 4 * 2 * 2 * 4 + 2 * 2 * 2
    assert nbytes == 172
    assert bounds.b1_seconds(ids, 5, 5, 4) == max(nbytes / bounds.HBM_BYTES_PER_S,
                                                  flops / bounds.F32_FLOPS_PER_S)


def test_b1_backward_bound_hand_count():
    ids = torch.tensor([[0, 1], [1, 1]], dtype=torch.int32)
    nbytes = (2 * 2 * 4 * 4          # g_emb
              + 2 * 2 * (4 + 4)      # ids, vals
              + 2 * 2 * 4            # g_yw, g_yv
              + 2 * (2 * 4 * 4 + 2 * 4))     # 2 distinct rows read, written
    flops = 2 * 2 * 4 * 7 + 2 * 2 * 2
    assert bounds.b1_backward_seconds(ids, 5, 5, 4) == max(
        nbytes / bounds.HBM_BYTES_PER_S, flops / bounds.F32_FLOPS_PER_S)
    # a row past fm_w's end clips there: fm_w's distinct rows fall to one
    clipped = torch.tensor([[3, 4]], dtype=torch.int32)
    assert bounds.b1_seconds(clipped, 2, 5, 4) == (
        (1 * 2 * 8 + 2 * 16 + 1 * 4 + 1 * 2 * 16 + 8) / bounds.HBM_BYTES_PER_S)
