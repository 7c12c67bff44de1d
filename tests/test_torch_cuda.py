"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: emb 1e-6 (the same float32 product), y_w 1e-5 and y_v 1e-4
(sums taken in another order).
"""

import pytest
import torch

from deepfm_tpu_torch.ops import fused_ctr

TOL = {"emb": 1e-6, "y_w": 1e-5, "y_v": 1e-4}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deepfm_tpu_torch.core.platform import resolve_device

    return resolve_device("cuda")


def _problem(device, v, pad, k, b, f, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    fm_v = torch.randn((v + pad, k), generator=g, device=device)
    fm_v[v:] = 0
    fm_w = torch.randn((v,), generator=g, device=device)
    ids = torch.randint(-50, v + pad + 100, (b, f), generator=g, device=device).to(dtype)
    vals = torch.rand((b, f), generator=g, device=device)
    return fm_w, fm_v, ids, vals


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("b,f,k", [(64, 39, 32), (1, 7, 8), (33, 70, 100), (5, 1, 1)])
def test_fused_ctr_kernel_matches_plain(device, dtype, b, f, k):
    fm_w, fm_v, ids, vals = _problem(device, 1000, 8, k, b, f, dtype)
    before = fused_ctr.launches
    got = fused_ctr.fused_ctr_interaction(fm_w, fm_v, ids, vals)
    want = fused_ctr.fused_ctr_plain(fm_w, fm_v, ids, vals)
    torch.cuda.synchronize()
    assert fused_ctr.launches == before + 1
    for a, w, name in zip(got, want, ("emb", "y_w", "y_v")):
        torch.testing.assert_close(a, w, rtol=TOL[name], atol=TOL[name])


@pytest.mark.cuda
def test_fused_ctr_kernel_rejects_what_it_does_not_take(device):
    fm_w, fm_v, ids, vals = _problem(device, 100, 0, 8, 4, 3, torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ctr.fused_ctr_interaction(fm_w, fm_v, ids.t().contiguous().t(), vals.t().contiguous().t())
    with pytest.raises(ValueError, match="float32"):
        fused_ctr.fused_ctr_interaction(fm_w, fm_v.double(), ids, vals)
    with pytest.raises(ValueError, match="embedding size"):
        fused_ctr.fused_ctr_interaction(fm_w, torch.zeros((100, 129), device=device), ids, vals)
    with pytest.raises(ValueError, match="is on cpu"):
        fused_ctr.fused_ctr_interaction(fm_w, fm_v, ids.cpu(), vals)
