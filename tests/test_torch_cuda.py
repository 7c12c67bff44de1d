"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: emb 1e-6 (the same float32 product), y_w 1e-5 and y_v 1e-4
(sums taken in another order).  Backward: 1e-5 relative to each output's
largest magnitude, because the kernel adds duplicate rows with float32
atomics in an order that changes from run to run (the plain version sums
them in index order), so its gradients are not bit-reproducible.
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


BWD_REL = 1e-5


def _assert_rel(got, want, name):
    scale = float(want.abs().max()) + 1e-30
    err = float((got - want).abs().max())
    assert err <= BWD_REL * scale, f"{name}: max abs err {err}, scale {scale}"


def _cotangents(device, b, f, k, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((b, f, k), generator=g, device=device),
            torch.randn((b,), generator=g, device=device),
            torch.randn((b,), generator=g, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("b,f,k", [(64, 39, 32), (1, 7, 8), (33, 70, 100), (5, 1, 1)])
@pytest.mark.parametrize("want_vals", [True, False])
def test_fused_ctr_backward_kernel_matches_plain(device, dtype, b, f, k, want_vals):
    fm_w, fm_v, ids, vals = _problem(device, 1000, 8, k, b, f, dtype)
    # hot rows: every batch row hits rows 1..min(f, 13), as Criteo records do
    hot = min(f, 13)
    ids[:, :hot] = torch.arange(1, hot + 1, device=device, dtype=dtype)
    g_emb, g_yw, g_yv = _cotangents(device, b, f, k)
    before = fused_ctr.backward_launches
    got = fused_ctr.fused_ctr_backward(g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals,
                                       want_vals)
    want = fused_ctr.fused_ctr_backward_plain(g_emb, g_yw, g_yv, fm_w, fm_v, ids,
                                              vals, want_vals)
    torch.cuda.synchronize()
    assert fused_ctr.backward_launches == before + 1
    for a, w, name in zip(got, want, ("d_fm_w", "d_fm_v", "d_vals")):
        if w is None:
            assert a is None
        else:
            _assert_rel(a, w, name)


@pytest.mark.cuda
def test_fused_ctr_autograd_runs_both_kernels(device):
    fm_w, fm_v, ids, vals = _problem(device, 500, 4, 32, 16, 39, torch.int32)
    fm_w.requires_grad_(True)
    fm_v.requires_grad_(True)
    vals.requires_grad_(True)
    fwd, bwd = fused_ctr.launches, fused_ctr.backward_launches
    emb, y_w, y_v = fused_ctr.fused_ctr_interaction(fm_w, fm_v, ids, vals)
    (emb.square().sum() + y_w.sum() + 3 * y_v.sum()).backward()
    torch.cuda.synchronize()
    assert (fused_ctr.launches, fused_ctr.backward_launches) == (fwd + 1, bwd + 1)
    ref = [t.detach().clone().requires_grad_(True) for t in (fm_w, fm_v, vals)]
    emb, y_w, y_v = fused_ctr.fused_ctr_plain(ref[0], ref[1], ids, ref[2])
    (emb.square().sum() + y_w.sum() + 3 * y_v.sum()).backward()
    for a, w, name in zip((fm_w, fm_v, vals), ref, ("d_fm_w", "d_fm_v", "d_vals")):
        _assert_rel(a.grad, w.grad, name)


@pytest.mark.cuda
def test_fused_ctr_backward_rejects_what_it_does_not_take(device):
    fm_w, fm_v, ids, vals = _problem(device, 100, 0, 8, 4, 3, torch.int32)
    g_emb, g_yw, g_yv = _cotangents(device, 4, 3, 8)
    bwd = fused_ctr.fused_ctr_backward
    with pytest.raises(ValueError, match="g_emb must be float32"):
        bwd(g_emb[:, :2], g_yw, g_yv, fm_w, fm_v, ids, vals)
    with pytest.raises(ValueError, match="g_yw must be float32"):
        bwd(g_emb, g_yw.double(), g_yv, fm_w, fm_v, ids, vals)
    with pytest.raises(ValueError, match="g_yv is on cpu"):
        bwd(g_emb, g_yw, g_yv.cpu(), fm_w, fm_v, ids, vals)
    with pytest.raises(ValueError, match="g_emb must be contiguous"):
        bwd(g_emb.transpose(0, 1).contiguous().transpose(0, 1), g_yw, g_yv,
            fm_w, fm_v, ids, vals)
    with pytest.raises(ValueError, match="fm_v is on cpu"):
        bwd(g_emb.cpu(), g_yw.cpu(), g_yv.cpu(), fm_w.cpu(), fm_v.cpu(), ids.cpu(),
            vals.cpu())
    with pytest.raises(ValueError, match="embedding size"):
        bwd(torch.zeros((4, 3, 129), device=device), g_yw, g_yv, fm_w,
            torch.zeros((100, 129), device=device), ids, vals)


@pytest.mark.cuda
@pytest.mark.parametrize("batch_norm", [False, True])
def test_train_step_through_kernels_matches_plain(device, batch_norm):
    """One loss.backward() of a small float32 DeepFM through the kernels
    against the same through the plain forward and autograd, from the same
    weights: loss within 1e-6 relative, every gradient within 1e-5 of its
    largest magnitude."""
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.models import DeepFM
    from deepfm_tpu_torch.train.step import loss_terms

    cfg = ModelConfig(feature_size=2000, field_size=39, embedding_size=32,
                      deep_layers=(64, 32), dropout_keep=(1.0, 1.0),
                      compute_dtype="float32", batch_norm=batch_norm,
                      fused_kernel="auto")
    model = DeepFM(cfg, device=device, generator=torch.Generator().manual_seed(0))
    model.train()
    g = torch.Generator(device=device).manual_seed(3)
    ids = torch.randint(0, 2000, (256, 39), generator=g, device=device)
    ids[:, :13] = torch.arange(1, 14, device=device)
    vals = torch.rand((256, 39), generator=g, device=device)
    labels = (torch.rand((256,), generator=g, device=device) < 0.25).float()
    params = dict(model.named_parameters())
    results = []
    for fused in (fused_ctr.fused_ctr_interaction, fused_ctr.fused_ctr_plain):
        i, v = model.prepare(ids, vals)
        loss, _ = loss_terms(model, model.head(*fused(model.fm_w, model.fm_v, i, v)),
                             labels)
        results.append((loss, torch.autograd.grad(loss, list(params.values()))))
    (loss_k, grads_k), (loss_p, grads_p) = results
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-6, atol=0)
    for name, a, w in zip(params, grads_k, grads_p):
        _assert_rel(a, w, name)
