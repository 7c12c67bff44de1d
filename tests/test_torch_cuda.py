"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances (kernel B1 and B1'; B2's stand above its tests): emb 1e-6 (the same float32 product), y_w 1e-5 and y_v 1e-4
(sums taken in another order).  Backward: 1e-5 relative to each output's
largest magnitude, because the kernel adds duplicate rows with float32
atomics in an order that changes from run to run (the plain version sums
them in index order), so its gradients are not bit-reproducible.
"""

import pytest
import torch

from deepfm_tpu_torch.ops import fused_ctr, retrieval

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
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("want_vals", [True, False])
@pytest.mark.parametrize("b,f,k", [(256, 39, 32), (70, 13, 100)])
def test_fused_ctr_backward_kernel_one_row(device, dtype, want_vals, b, f, k):
    """Every lookup on one row: every window is one group, and every block
    sums its windows in one slot of its table.  Held to the plain version
    in float64, because the B·F
    float32 terms of that one row round near the tolerance in any float32
    order."""
    fm_w, fm_v, ids, vals = _problem(device, 1000, 8, k, b, f, dtype)
    ids[:] = 7
    g_emb, g_yw, g_yv = _cotangents(device, b, f, k)
    got = fused_ctr.fused_ctr_backward(g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals,
                                       want_vals)
    want = fused_ctr.fused_ctr_backward_plain(
        *(t.double() for t in (g_emb, g_yw, g_yv, fm_w, fm_v)), ids, vals.double(),
        want_vals)
    torch.cuda.synchronize()
    for a, w, name in zip(got, want, ("d_fm_w", "d_fm_v", "d_vals")):
        if w is None:
            assert a is None
        else:
            _assert_rel(a.double(), w, name)


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


# ---------------------------------------------------------------------------
# kernel B2 (ops/retrieval.py, csrc/retrieval_topk.cu)
#
# Tolerance: scores within rtol 1e-4 / atol 1e-5 of the plain version's,
# position by position: one float32 dot per row, summed in another order
# than cuBLAS's, over unit-normal queries whose dots reach ~10, so rounding
# reaches ~1e-6 absolute.  Rows equal except near-ties inside that
# tolerance, which retrieval.topk_agreement checks row by row.

B2_RTOL, B2_ATOL = 1e-4, 1e-5


def _b2_problem(device, r, d, b, seed=0, dup=True, pads=True):
    from deepfm_tpu_torch.funnel.quant import quantize_rows

    g = torch.Generator().manual_seed(seed)
    emb = torch.randn((r, d), generator=g)
    emb /= emb.norm(dim=1, keepdim=True)
    if dup and r > 40:
        emb[r - 12] = emb[5]                    # an exact tie far apart
        emb[20:30] = emb[7]                     # ten equal rows
    ids = torch.arange(r, dtype=torch.int32)
    if pads:
        ids[-5:] = -1
        ids[3] = -7
    codes, scales = (torch.from_numpy(a) for a in quantize_rows(emb.numpy()))
    u = torch.randn((b, d), generator=g)
    u[0] = codes[7].float() * scales[7]         # query 0 sits on the ten ties
    return [t.to(device) for t in (u, codes, scales, ids)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,d,b,kos", [
    (4096, 32, 8, 128), (1000, 16, 1, 1), (3000, 32, 130, 1000), (500, 48, 3, 1000),
    (117_581, 32, 64, 128), (2048, 128, 9, 37)])
def test_retrieval_kernel_matches_plain(device, r, d, b, kos):
    u, codes, scales, ids = _b2_problem(device, r, d, b)
    before = retrieval.launches
    got = retrieval.retrieval_topk(u, codes, scales, ids, kos)
    want = retrieval.retrieval_topk_plain(u, codes, scales, ids, kos)
    torch.cuda.synchronize()
    assert retrieval.launches == before + 1
    assert got[0].shape == got[1].shape == (b, kos)
    agree = retrieval.topk_agreement(u, codes, scales, ids, got, want, B2_RTOL, B2_ATOL)
    assert agree["ok"], agree
    # the ten equal rows come back in row order on query 0
    if kos >= 10:
        top = got[1][0, :10].tolist()
        assert top == sorted(top)


@pytest.mark.cuda
def test_retrieval_kernel_rejects_what_it_does_not_take(device):
    u, codes, scales, ids = _b2_problem(device, 256, 32, 2)
    topk = retrieval.retrieval_topk
    with pytest.raises(ValueError, match="codes must be"):
        topk(u, codes.float(), scales, ids, 8)
    with pytest.raises(ValueError, match="ids must be"):
        topk(u, codes, scales, ids.long(), 8)
    with pytest.raises(ValueError, match="u must be"):
        topk(u.double(), codes, scales, ids, 8)
    with pytest.raises(ValueError, match="scales must be"):
        topk(u, codes, scales[:-1], ids, 8)
    with pytest.raises(ValueError, match="contiguous"):
        topk(u.t().contiguous().t(), codes, scales, ids, 8)
    with pytest.raises(ValueError, match="is on cpu"):
        topk(u, codes.cpu(), scales, ids, 8)
    with pytest.raises(ValueError, match="kos must be"):
        topk(u, codes, scales, ids, retrieval.MAX_KOS + 1)
    with pytest.raises(ValueError, match="kos must be"):
        topk(u, codes, scales, ids, 0)
    for d in (8, 20, retrieval.MAX_DIM + 16):
        odd = torch.zeros((256, d), dtype=torch.int8, device=device)
        with pytest.raises(ValueError, match="dimension"):
            topk(torch.zeros((2, d), device=device), odd, scales, ids, 8)
    # codes that start one byte into their allocation
    flat = torch.zeros((257 * 32 + 1,), dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="aligned"):
        topk(u, flat[1:1 + 256 * 32].view(256, 32), scales, ids, 8)


@pytest.mark.cuda
def test_int8_retrieve_on_the_card_matches_the_cpu(device):
    """build_retrieve_with in int8 mode, the same payload on the card
    (kernel B2) and on the CPU (plain): ids equal, scores within 1e-5."""
    import numpy as np

    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.funnel import (build_index, build_retrieve_with,
                                         make_funnel_context, stage_funnel_payload)
    from deepfm_tpu_torch.models import DeepFM, TwoTower

    rank_cfg = ModelConfig(feature_size=5000, field_size=6, embedding_size=8,
                           deep_layers=(16,), dropout_keep=(1.0,),
                           compute_dtype="float32")
    query_cfg = ModelConfig(model_name="two_tower", user_vocab_size=300,
                            item_vocab_size=5000, user_field_size=3, item_field_size=3,
                            tower_layers=(32,), tower_dim=32, embedding_size=8,
                            compute_dtype="float32")
    rng = np.random.default_rng(0)
    items = rng.permutation(5000)[:4000]
    feats = rng.integers(0, 5000, (4000, 3))
    user_ids = torch.from_numpy(rng.integers(0, 300, (16, 3)))
    out = {}
    for dev in ("cpu", device):
        query = TwoTower(query_cfg, device=dev, generator=torch.Generator().manual_seed(1))
        rank = DeepFM(rank_cfg, device=dev, generator=torch.Generator().manual_seed(2))
        index = build_index(query, items, feats, np.ones((4000, 3), np.float32))
        ctx = make_funnel_context(rank_cfg, query_cfg, capacity=4096, top_k=32,
                                  retrieval="int8", oversample=4)
        payload = stage_funnel_payload(ctx, rank, query, index)
        uids, uvals = user_ids.to(dev), torch.ones((16, 3), device=dev)
        before = retrieval.launches
        with torch.inference_mode():
            s, cid = build_retrieve_with(ctx)(payload, uids, uvals)
        out[str(dev)] = (s.cpu(), cid.cpu(), retrieval.launches - before)
    (s_c, id_c, n_c), (s_g, id_g, n_g) = out["cpu"], out[str(device)]
    assert (n_c, n_g) == (0, 1)
    torch.testing.assert_close(s_g, s_c, rtol=0, atol=1e-5)
    assert torch.equal(id_g, id_c)


def _b2_adversarial(device, r, d, seed, all_equal=False, live=None):
    from deepfm_tpu_torch.funnel.quant import quantize_rows

    g = torch.Generator().manual_seed(seed)
    emb = torch.randn((r, d), generator=g)
    emb /= emb.norm(dim=1, keepdim=True)
    if all_equal:
        emb[:] = emb[0]
    ids = torch.arange(r, dtype=torch.int32)
    if live is not None:
        keep = torch.zeros(r, dtype=torch.bool)
        keep[torch.linspace(0, r - 1, live).long()] = True
        ids = torch.where(keep, ids, torch.full_like(ids, -1))
    codes, scales = (torch.from_numpy(a) for a in quantize_rows(emb.numpy()))
    u = torch.randn((8, d), generator=g)
    return [t.to(device) for t in (u, codes, scales, ids)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,d,kos", [
    ("all_equal", 32, 128), ("live_100", 32, 128), ("spread", 32, 1),
    ("spread", 32, 1024), ("spread", 16, 128), ("spread", 128, 128),
    ("all_equal", 32, 1024)])
def test_retrieval_kernel_adversarial(device, case, d, kos):
    """Inputs that fill the select's threshold bin (every score equal: the
    first kos rows, in row order) or starve it (100 live rows of 20,000),
    kos 1 and 1,024, D 16 and 128; B 8."""
    r = 20_000
    u, codes, scales, ids = _b2_adversarial(
        device, r, d, seed=kos + d, all_equal=case == "all_equal",
        live=100 if case == "live_100" else None)
    got = retrieval.retrieval_topk(u, codes, scales, ids, kos)
    want = retrieval.retrieval_topk_plain(u, codes, scales, ids, kos)
    torch.cuda.synchronize()
    agree = retrieval.topk_agreement(u, codes, scales, ids, got, want, B2_RTOL, B2_ATOL)
    assert agree["ok"], agree
    if case == "all_equal":
        assert got[1].tolist() == [list(range(kos))] * 8
    if case == "live_100":
        assert torch.isfinite(got[0]).sum(dim=1).tolist() == [100] * 8
