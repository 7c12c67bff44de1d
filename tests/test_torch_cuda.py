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


def _forward_matches_plain(fm_w, fm_v, ids, vals):
    before = fused_ctr.launches
    got = fused_ctr.fused_ctr_interaction(fm_w, fm_v, ids, vals)
    want = fused_ctr.fused_ctr_plain(fm_w, fm_v, ids, vals)
    torch.cuda.synchronize()
    assert fused_ctr.launches == before + 1
    for a, w, name in zip(got, want, ("emb", "y_w", "y_v")):
        torch.testing.assert_close(a, w, rtol=TOL[name], atol=TOL[name])


# Every layout of the forward: K a multiple of 4 whose float4 row fills 1-32
# lanes (4, 8, 16, 32, 64, 128) or part of them (48, 100), and the scalar
# layout (1, 7) with 1 or 8 lanes a field; F within one round, at a round's
# edge (40 fields at K = 32), past it (70) and past the largest round (512
# fields at K = 1).  B: on a 132-SM card the float4 layout takes 4 warps a
# row (a row a block) up to 1,056 rows and 1 (4 rows a block) above; 1,101
# and 33 are not multiples of 4 rows.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("k", [1, 4, 7, 8, 16, 32, 48, 64, 100, 128])
@pytest.mark.parametrize("f", [1, 39, 40, 70, 600])
@pytest.mark.parametrize("b", [1, 33, 1101])
def test_fused_ctr_kernel_matches_plain(device, dtype, b, f, k):
    _forward_matches_plain(*_problem(device, 1000, 8, k, b, f, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,k", [(4096, 70, 100), (1101, 600, 128), (4096, 600, 1),
                                   (33, 600, 32), (4096, 39, 32)])
def test_fused_ctr_kernel_sums_hold_to_float64(device, b, f, k):
    """y_w and y_v against the plain version run in float64, at widths
    where a float32 sum's order shows (long rows of fields or wide rows),
    within the same tolerances: the kernel's sums must stay as close to
    the exact ones as its stated tolerance, whatever order it takes."""
    fm_w, fm_v, ids, vals = _problem(device, 1000, 8, k, b, f, torch.int64)
    got = fused_ctr.fused_ctr_interaction(fm_w, fm_v, ids, vals)
    want = fused_ctr.fused_ctr_plain(fm_w.double(), fm_v.double(), ids, vals.double())
    torch.cuda.synchronize()
    for a, w, name in zip(got, want, ("emb", "y_w", "y_v")):
        torch.testing.assert_close(a.double(), w, rtol=TOL[name], atol=TOL[name])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("k", [4, 32, 128])
def test_fused_ctr_kernel_misaligned_views(device, dtype, k):
    """fm_v and vals as contiguous views that start 4 bytes past a 16-byte
    boundary: the launch takes the scalar layout (a float4 load there
    would fault) and gives the plain version's answer."""
    fm_w, fm_v, ids, vals = _problem(device, 1000, 8, k, 33, 39, dtype)
    assert fused_ctr.forward_layout(fm_v, 33).startswith("vector")
    fm_v_off = torch.empty(fm_v.numel() + 1, device=device)[1:].view(fm_v.shape)
    vals_off = torch.empty(vals.numel() + 1, device=device)[1:].view(vals.shape)
    fm_v_off.copy_(fm_v)
    vals_off.copy_(vals)
    assert fm_v_off.is_contiguous() and fm_v_off.data_ptr() % 16 == 4
    assert fused_ctr.forward_layout(fm_v_off, 33).startswith("scalar")
    _forward_matches_plain(fm_w, fm_v_off, ids, vals_off)


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
# the lazy step's compact tables and the data-parallel step


@pytest.mark.cuda
@pytest.mark.parametrize("b", [256, 1024])
def test_fused_ctr_kernels_on_compact_tables(device, b):
    """B1 and B1' on the lazy step's compact tables: fm_v[row_id] [N, K] and
    fm_w[row_id] [N] with each lookup's segment as its id.  Forward and
    backward against the plain versions; the compact gradients are the
    full-table gradients of the distinct rows, and zero on the padding
    segments."""
    from deepfm_tpu_torch.ops.embedding import sort_segments

    v, f, k = 117_581, 39, 32
    fm_w, fm_v, _, vals = _problem(device, v, 3, k, b, f, torch.int64)
    g = torch.Generator(device=device).manual_seed(5)
    ids = torch.where(torch.rand((b, f), generator=g, device=device) < 0.5,
                      torch.randint(0, 50, (b, f), generator=g, device=device),
                      torch.randint(0, v, (b, f), generator=g, device=device))
    ids[:, :13] = torch.arange(1, 14, device=device)
    order, seg, row_id, valid = sort_segments(ids.reshape(-1))
    slot = torch.empty_like(seg).scatter_(0, order, seg).to(torch.int32).view(b, f)
    fm_w_c, fm_v_c = fm_w[row_id], fm_v[row_id]
    _forward_matches_plain(fm_w_c, fm_v_c, slot, vals)
    g_emb, g_yw, g_yv = _cotangents(device, b, f, k)
    got = fused_ctr.fused_ctr_backward(g_emb, g_yw, g_yv, fm_w_c, fm_v_c, slot, vals, False)
    want = fused_ctr.fused_ctr_backward_plain(g_emb, g_yw, g_yv, fm_w_c, fm_v_c, slot,
                                              vals, False)
    full = fused_ctr.fused_ctr_backward_plain(g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals,
                                              False)
    torch.cuda.synchronize()
    for a, w, name in zip(got[:2], want[:2], ("d_fm_w", "d_fm_v")):
        _assert_rel(a, w, name)
    live = valid.nonzero()[:, 0]
    _assert_rel(got[0][live], full[0][row_id[live]], "d_fm_w vs the full table")
    _assert_rel(got[1][live], full[1][row_id[live]], "d_fm_v vs the full table")
    pad = (~valid).nonzero()[:, 0]
    assert pad.numel() > 0
    assert not got[0][pad].any() and not got[1][pad].any()


def _copy_train_state(dst, src):
    dst.model.load_state_dict(src.model.state_dict())
    dst.step, dst.optimizer.count = src.step, src.optimizer.count
    for name, slots in src.optimizer.slots.items():
        for slot, t in slots.items():
            dst.optimizer.slots[name][slot].copy_(t)
    for mine, theirs in ((dst.lazy.m, src.lazy.m), (dst.lazy.v, src.lazy.v)):
        for key, t in theirs.items():
            mine[key].copy_(t)


@pytest.mark.cuda
def test_lazy_step_through_kernels_matches_plain(device, monkeypatch):
    """One full-width lazy step (117,581 x 39 x 32, B = 1,024, float32 MLP,
    dropout off) after a warm-up step, through the kernels and through the
    plain versions from the same state: the loss within 1e-6 relative;
    fm_w, fm_v and their m and v within 1e-5 of each tensor's largest
    magnitude (Adam turns a rounding difference in a near-zero gradient
    into a step of up to lr, so a row is not held alone); every untouched
    row, and its m and v, bit for bit as before the step."""
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.train import step as step_mod

    cfg = Config.from_dict({"model": {"fused_kernel": "auto", "compute_dtype": "float32",
                                      "dropout_keep": (1.0, 1.0, 1.0)},
                            "optimizer": {"lazy_embedding_updates": True}})
    g = torch.Generator(device=device).manual_seed(7)

    def batch():
        ids = torch.randint(0, 117_581, (1024, 39), generator=g, device=device)
        ids[:, :13] = torch.arange(1, 14, device=device)
        return {"feat_ids": ids, "feat_vals": torch.rand((1024, 39), generator=g,
                                                         device=device),
                "label": (torch.rand((1024,), generator=g, device=device) < 0.25).float()}

    kernel = step_mod.create_train_state(cfg, device)
    step_mod.train_step(kernel, batch())
    plain = step_mod.create_train_state(cfg, device)
    _copy_train_state(plain, kernel)
    b = batch()
    before = {k: t.detach().clone() for k, t in (
        ("fm_w", kernel.model.fm_w), ("fm_v", kernel.model.fm_v),
        ("m.fm_w", kernel.lazy.m["fm_w"]), ("m.fm_v", kernel.lazy.m["fm_v"]),
        ("v.fm_w", kernel.lazy.v["fm_w"]), ("v.fm_v", kernel.lazy.v["fm_v"]))}
    launches = fused_ctr.launches, fused_ctr.backward_launches
    m_k = step_mod.train_step(kernel, b)
    assert (fused_ctr.launches, fused_ctr.backward_launches) == (
        launches[0] + 1, launches[1] + 1)
    monkeypatch.setattr(step_mod, "fused_ctr_interaction", fused_ctr.fused_ctr_plain)
    m_p = step_mod.train_step(plain, b)
    torch.cuda.synchronize()
    assert fused_ctr.launches == launches[0] + 1
    torch.testing.assert_close(m_k["loss"], m_p["loss"], rtol=1e-6, atol=0)
    touched = torch.zeros(117_584, dtype=torch.bool, device=device)
    touched[b["feat_ids"].reshape(-1)] = True
    for state in (kernel, plain):
        after = {"fm_w": state.model.fm_w, "fm_v": state.model.fm_v,
                 "m.fm_w": state.lazy.m["fm_w"], "m.fm_v": state.lazy.m["fm_v"],
                 "v.fm_w": state.lazy.v["fm_w"], "v.fm_v": state.lazy.v["fm_v"]}
        for name, t in after.items():
            rows = ~touched[:t.shape[0]]
            assert torch.equal(t.detach()[rows].view(torch.int32),
                               before[name][rows].view(torch.int32)), name
    for name, a, w in (("fm_w", kernel.model.fm_w, plain.model.fm_w),
                       ("fm_v", kernel.model.fm_v, plain.model.fm_v)):
        _assert_rel(a.detach(), w.detach(), name)
    for slot in ("m", "v"):
        for key in ("fm_w", "fm_v"):
            _assert_rel(getattr(kernel.lazy, slot)[key], getattr(plain.lazy, slot)[key],
                        f"{slot}.{key}")


@pytest.mark.cuda
def test_world1_nccl_step_matches_single_card_step(device, tmp_path):
    """Three data-parallel steps at world size 1 over NCCL (one fused
    all-reduce each) against three single-card steps from the same
    weights, at the flagship width on batches of distinct ids (no float
    atomics race in B1'): parameters within 1e-5 of their largest
    magnitude."""
    import torch.distributed as dist

    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.parallel import spmd
    from deepfm_tpu_torch.parallel.mesh import initialize_distributed
    from deepfm_tpu_torch.train.step import create_train_state, train_step

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1, device_id=device)
    try:
        cfg = Config.from_dict({"model": {"fused_kernel": "auto"}})
        ctx = initialize_distributed(cfg.mesh, device)
        assert ctx.world_size == 1 and ctx.group is not None
        dp = spmd.create_dp_train_state(cfg, ctx)
        one = create_train_state(cfg, device)
        g = torch.Generator(device=device).manual_seed(11)
        for _ in range(3):
            ids = torch.randperm(117_581, generator=g, device=device)[:1024 * 39]
            b = {"feat_ids": ids.view(1024, 39),
                 "feat_vals": torch.rand((1024, 39), generator=g, device=device),
                 "label": (torch.rand((1024,), generator=g, device=device) < 0.25).float()}
            m_dp = spmd.train_step(dp, b, ctx)
            m_one = train_step(one, b)
            torch.testing.assert_close(m_dp["loss"], m_one["loss"], rtol=1e-6, atol=0)
        torch.cuda.synchronize()
        for (name, a), w in zip(dp.model.state_dict().items(),
                                one.model.state_dict().values()):
            _assert_rel(a, w, name)
    finally:
        dist.destroy_process_group()


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


# ---------------------------------------------------------------------------
# serving: the bucket graphs of serve/graphs.py and the hot swap over them

SERVE_BUCKETS = (8, 32, 128, 512)


def _serve_cfg():
    from deepfm_tpu_torch.core.config import ModelConfig

    return ModelConfig(feature_size=5000, field_size=39, embedding_size=32,
                       deep_layers=(64, 32), dropout_keep=(1.0, 1.0),
                       batch_norm=True, fused_kernel="auto")


def _serve_state(seed):
    from deepfm_tpu_torch.models import DeepFM

    model = DeepFM(_serve_cfg(), device="cpu", generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # BN statistics away from their init
        g = torch.Generator().manual_seed(seed + 1)
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    return model.state_dict()


def _serve_rows(b, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(-10, 5100, (b, 39)).astype(np.int64)
    return ids, rng.random((b, 39)).astype(np.float32)


def _eager(state, ids, vals, device, plain=False):
    """The eager forward of ``state`` through the kernel (or its plain
    version) on the card."""
    from deepfm_tpu_torch.serve.export import model_from_state

    model = model_from_state(_serve_cfg(), state, device)
    with torch.inference_mode():
        i, v = model.prepare(torch.from_numpy(ids).to(device), torch.from_numpy(vals).to(device))
        fused = fused_ctr.fused_ctr_plain if plain else fused_ctr.fused_ctr_interaction
        return torch.sigmoid(model.head(*fused(model.fm_w, model.fm_v, i, v))).cpu().numpy()


@pytest.mark.cuda
def test_graphed_predict_matches_the_eager_forward_at_every_bucket(device):
    """Each slot's graph of each bucket against the eager kernel forward
    (1e-6) and the plain forward (1e-4) of the same weights, on rows that
    fill the bucket and rows that leave part of it padded."""
    import numpy as np

    from deepfm_tpu_torch.serve.graphs import WARMUP_CALLS, GraphedPredictor

    state = _serve_state(0)
    pred = GraphedPredictor(_serve_cfg(), state, device=device, buckets=SERVE_BUCKETS)
    with pytest.raises(RuntimeError, match="precompile"):
        pred.predict_with(0, *_serve_rows(8, 0))
    launches, captured = fused_ctr.launches, fused_ctr.captured
    pred.precompile()
    assert pred.graph_count == 2 * len(SERVE_BUCKETS) and pred.kernel_launches_per_replay == 1
    # the side-stream warm-ups run B1; the captures only record it
    assert fused_ctr.launches == launches + WARMUP_CALLS * pred.graph_count
    assert fused_ctr.captured == captured + pred.graph_count
    for b in SERVE_BUCKETS:
        for n in (b, b - 3):
            ids, vals = _serve_rows(n, seed=b + n)
            launches = fused_ctr.launches
            for slot in (0, 1):
                got = pred.predict_with(slot, ids, vals)
                assert got.shape == (n,) and np.isfinite(got).all()
                np.testing.assert_allclose(got, _eager(state, ids, vals, device),
                                           rtol=0, atol=1e-6)
                np.testing.assert_allclose(got, _eager(state, ids, vals, device, plain=True),
                                           rtol=0, atol=1e-4)
            assert fused_ctr.launches == launches + 2  # the eager references only
    ids, vals = _serve_rows(1100, seed=7)  # chunked 512 + 512 + 76 -> 128
    np.testing.assert_allclose(pred.predict_with(0, ids, vals), _eager(state, ids, vals, device),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_swaps_keep_the_graphs_and_the_canary_uses_the_idle_slot(device, tmp_path):
    """Two published versions swap in under traffic: the graph count stays
    8, every traffic answer is the old or the new version's, the canary
    replays only the idle slot, and after each swap the answers are the new
    version's."""
    import threading

    import numpy as np

    from deepfm_tpu_torch.online.publisher import ModelPublisher
    from deepfm_tpu_torch.serve.export import build_graphed_batcher, export_servable
    from deepfm_tpu_torch.serve.reload import HotSwapper

    states = [_serve_state(s) for s in (0, 1, 2)]
    servable = export_servable(_serve_cfg(), states[0], tmp_path / "v0")
    batcher, predictor, holder, cfg, _ = build_graphed_batcher(
        servable, device=device, buckets=SERVE_BUCKETS, max_wait_ms=0.5)
    canary_slots = []
    real = predictor.predict_with

    def run(job):
        def traced():
            predictor.predict_with = lambda slot, i, v: (canary_slots.append(
                (slot, holder.get())), real(slot, i, v))[1]
            try:
                return job()
            finally:
                predictor.predict_with = real
        return batcher.run_on_worker(traced)

    ids, vals = _serve_rows(5, seed=11)
    want = [_eager(s, ids, vals, device) for s in states]
    stop = threading.Event()
    bad, answers = [], []

    def client():
        while not stop.is_set():
            got = batcher.score(ids, vals)
            match = [v for v, w in enumerate(want) if np.allclose(got, w, rtol=0, atol=1e-6)]
            answers.append(match)
            if not match:
                bad.append(got)

    try:
        assert predictor.graph_count == 8
        swapper = HotSwapper(holder, predictor, str(tmp_path / "publish"), cfg, run=run,
                             staging_dir=str(tmp_path / "staging"))
        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        pub = ModelPublisher(str(tmp_path / "publish"))
        for v in (1, 2):
            pub.publish(cfg, states[v])
            assert swapper.poll_once() is True, swapper.status()
            assert predictor.graph_count == 8 and holder.version == v
            np.testing.assert_allclose(batcher.score(ids, vals), want[v], rtol=0, atol=1e-6)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not bad and answers
        # the canary replayed the slot that was idle at the time, twice
        assert {(s, live) for s, live in canary_slots} == {(1, 0), (0, 1)}
    finally:
        stop.set()
        batcher.close()


# ---------------------------------------------------------------------------
# the online trainer


@pytest.mark.cuda
def test_online_trainer_on_the_card_launches_the_kernels_and_matches_the_cpu(device,
                                                                               tmp_path):
    """The online trainer on the card at a small width (V = 1,000, F = 10,
    K = 8, MLP (16,), batch 64, float32, dropout off, Adam lr 5e-4) over 4
    segments of 64 records: B1 and B1′ launch once on every step, and the
    committed state equals the same run on the CPU through the plain
    versions within the train tests' 1e-5 (absolute, float32), cursor and
    step equal."""
    import numpy as np

    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.online import OnlineTrainer, StreamCursor, append_segment
    from deepfm_tpu_torch.online.stream import segment_name

    rng = np.random.default_rng(5)
    for seq in range(4):
        ids = rng.permutation(1000)[:640].reshape(64, 10)
        append_segment(str(tmp_path / "stream"), (rng.random(64) < 0.3).astype(np.float32),
                       ids, rng.random((64, 10), dtype=np.float32), seq=seq)

    def run(dev):
        cfg = Config.from_dict({
            "model": {"feature_size": 1000, "field_size": 10, "embedding_size": 8,
                      "deep_layers": (16,), "dropout_keep": (1.0,),
                      "compute_dtype": "float32", "fused_kernel": "auto"},
            "data": {"training_data_dir": str(tmp_path / "stream"), "batch_size": 64},
            "run": {"model_dir": str(tmp_path / dev / "ckpt"), "log_steps": 1000,
                    "servable_model_dir": str(tmp_path / dev / "publish"),
                    "checkpoint_every_steps": 1, "online_publish_every_steps": 2}})
        counts = []
        state = OnlineTrainer(cfg, device=dev).run(
            follow=False,
            on_commit=lambda s, c: counts.append((fused_ctr.launches,
                                                  fused_ctr.backward_launches, c)))
        return state, counts

    start = fused_ctr.launches, fused_ctr.backward_launches
    card, counts = run("cuda")
    assert [c[:2] for c in counts] == [(start[0] + i, start[1] + i) for i in range(1, 5)]
    assert counts[-1][2] == StreamCursor(segment_name(3), 64)
    cpu, _ = run("cpu")
    assert card.step == cpu.step == 4 and card.optimizer.count == cpu.optimizer.count
    for name, a, w in [*zip(card.model.state_dict(), card.model.state_dict().values(),
                            cpu.model.state_dict().values()),
                       *((f"{n}.{s}", card.optimizer.slots[n][s], t)
                         for n, slots in cpu.optimizer.slots.items()
                         for s, t in slots.items())]:
        torch.testing.assert_close(a.cpu(), w, rtol=0, atol=1e-5, msg=name)


# -- the graphed train step and the paged step (train/step.py StepGraph,
# tiered/step.py), on batches of distinct ids: B1''s atomics then add one
# term a row, so a step is bit-reproducible and graphed = eager holds bit
# for bit

def _graph_setup(lazy, steps, seed=0):
    from deepfm_tpu_torch.analysis.trace_audit import audit_cfg, distinct_batches

    cfg = audit_cfg(lazy)
    return cfg, [{k: v.pin_memory() for k, v in b.items()}
                 for b in distinct_batches(cfg, steps, seed)]


@pytest.mark.cuda
@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
def test_the_graphed_step_equals_the_eager_step_bit_for_bit(device, lazy):
    from deepfm_tpu_torch.analysis.trace_audit import state_tensors
    from deepfm_tpu_torch.train.step import (WARMUP_STEPS, create_train_state,
                                             graph_kernel_runs, graphed_train_step,
                                             train_step)

    cfg, batches = _graph_setup(lazy, WARMUP_STEPS + 4)
    graphed, eager = create_train_state(cfg, device), create_train_state(cfg, device)
    eager.generator.set_state(graphed.generator.get_state())
    runs = dict(graph_kernel_runs)
    for batch in batches:
        mg = graphed_train_step(graphed, batch)
        me = train_step(eager, {k: v.to(device) for k, v in batch.items()})
        assert all(torch.equal(mg[k], me[k]) for k in mg)
    got, want = state_tensors(graphed), state_tensors(eager)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    g = graphed.graph
    assert g.replays == 4 and g.per_replay == (1, 1)
    assert graph_kernel_runs["forward"] - runs["forward"] == 4
    assert graph_kernel_runs["backward"] - runs["backward"] == 4
    assert graphed.generator.get_state().equal(eager.generator.get_state())


@pytest.mark.cuda
def test_a_resumed_graphed_run_equals_an_uninterrupted_one(device, tmp_path):
    """The dropout generator registered with the graph round-trips through
    Checkpointer: 4 graphed steps, a save, a fresh state restored in place,
    4 more graphed steps equal 8 uninterrupted graphed steps bit for bit."""
    from deepfm_tpu_torch.analysis.trace_audit import state_tensors
    from deepfm_tpu_torch.checkpoint import Checkpointer
    from deepfm_tpu_torch.train.step import create_train_state, graphed_train_step

    cfg, batches = _graph_setup(False, 8, seed=3)
    whole = create_train_state(cfg, device)
    for batch in batches:
        graphed_train_step(whole, batch)
    first = create_train_state(cfg, device)
    for batch in batches[:4]:
        graphed_train_step(first, batch)
    ckpt = Checkpointer(tmp_path / "ckpt")
    ckpt.save(first)
    ckpt.wait_until_finished()
    resumed = ckpt.restore(create_train_state(cfg, device))
    for batch in batches[4:]:
        graphed_train_step(resumed, batch)
    got, want = state_tensors(resumed), state_tensors(whole)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert resumed.step == whole.step == 8


@pytest.mark.cuda
def test_a_capture_that_syncs_raises(device):
    """A body that reads the card from the host is refused at its capture
    (set_sync_debug_mode("error")); nothing falls back to the eager step."""
    from deepfm_tpu_torch.train.step import (WARMUP_STEPS, StepGraph, create_train_state,
                                             resident_body)

    cfg, batches = _graph_setup(False, WARMUP_STEPS + 1)
    state = create_train_state(cfg, device)

    def syncing(st, inputs, scalars):
        metrics = resident_body(st, inputs, scalars)
        float(metrics["loss"])  # a host read inside the step
        return metrics

    graph = StepGraph(syncing, state, batches[0])
    for batch in batches[:WARMUP_STEPS]:
        graph(state, batch)  # eager on a side stream: a sync is allowed there
    with pytest.raises(RuntimeError):
        graph(state, batches[-1])
    assert graph.graph is None


@pytest.mark.cuda
def test_the_trace_audit_finds_nothing_on_the_card(device):
    from deepfm_tpu_torch.analysis import run_trace_audit

    findings = run_trace_audit(device)
    assert findings == [], [f.render() for f in findings]


@pytest.mark.cuda
def test_the_paged_step_replays_and_equals_the_resident_lazy_step(device, tmp_path):
    from deepfm_tpu_torch.analysis.trace_audit import audit_cfg, distinct_batches
    from deepfm_tpu_torch.tiered import TieredTrainer
    from deepfm_tpu_torch.train.step import WARMUP_STEPS, create_train_state, train_step

    cfg = audit_cfg(lazy=True, fused_kernel="off", tiered_embeddings=True,
                    tiered_page_rows=64)
    bf = cfg.data.batch_size * cfg.model.field_size
    resident = create_train_state(cfg, device)
    batches = distinct_batches(cfg, WARMUP_STEPS + 3, seed=5)
    with TieredTrainer.from_resident_state(cfg, create_train_state(cfg, device),
                                           str(tmp_path / "cold"), capacity=bf,
                                           stage_rows=bf, host_rows=4 * bf) as tr:
        for batch in batches:
            got = tr.train_batch(batch)
            want = train_step(resident, {k: v.to(device) for k, v in batch.items()})
            assert torch.equal(got["loss"], want["loss"])
        assert tr.state.graph.replays == 3 and tr.pager.stats()["evictions"] > 0
        rows, m, v = tr.export_tables()
    for k in ("fm_w", "fm_v"):
        assert torch.equal(torch.from_numpy(rows[k]), getattr(resident.model, k).detach().cpu())
        assert torch.equal(torch.from_numpy(v[k]), resident.lazy.v[k].cpu())


# ---------------------------------------------------------------------------
# the funnel's graphs, hot swap and sharded index


FUNNEL_BUCKETS = (8, 32)


def _funnel_parts(seed, items=3000, capacity=4096):
    """A small funnel on the CPU: ranker and query tower ``state_dict``s,
    an index of ``items`` spread ids (B2 needs D a multiple of 16)."""
    import numpy as np

    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.funnel import FunnelIndex
    from deepfm_tpu_torch.models import DeepFM, TwoTower

    rank_cfg = ModelConfig(feature_size=5000, field_size=6, embedding_size=8,
                           deep_layers=(16,), dropout_keep=(1.0,), compute_dtype="float32",
                           fused_kernel="auto")
    query_cfg = ModelConfig(model_name="two_tower", user_vocab_size=300,
                            item_vocab_size=5000, user_field_size=3, item_field_size=3,
                            tower_layers=(32,), tower_dim=32, embedding_size=8,
                            compute_dtype="float32")
    g = torch.Generator().manual_seed(seed)
    rank = DeepFM(rank_cfg, device="cpu", generator=g).state_dict()
    query = TwoTower(query_cfg, device="cpu", generator=g).state_dict()
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(items, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    index = FunnelIndex(item_ids=rng.permutation(5000)[:items].astype(np.int32), item_emb=emb)
    return rank_cfg, query_cfg, rank, query, index, capacity


def _funnel_rows(b, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, 300, (b, 3)), rng.integers(0, 5000, (b, 6))], 1)
    return ids.astype(np.int64), rng.random((b, 9)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_graphed_funnel_equals_the_eager_funnel(device, mode):
    """Each slot's retrieve and rank graphs of each bucket against the same
    stages run eagerly: ids equal, probabilities and retrieval scores
    within 1e-6; the overflow flag as eager; B2 and B1 counted as
    captured, each replay running what its capture recorded."""
    import numpy as np

    from deepfm_tpu_torch.funnel import graphs as fgraphs
    from deepfm_tpu_torch.funnel import make_funnel_context

    rank_cfg, query_cfg, rank, query, index, cap = _funnel_parts(0)
    ctx = make_funnel_context(rank_cfg, query_cfg, capacity=cap, top_k=16, return_n=8,
                              retrieval=mode, oversample=4)
    graphs = fgraphs.FunnelGraphs(ctx, rank, query, index, device=device,
                                  buckets=FUNNEL_BUCKETS)
    with pytest.raises(RuntimeError, match="precompile"):
        graphs.dispatch(0, *_funnel_rows(8, 0))
    b2, b1 = retrieval.captured, fused_ctr.captured
    graphs.precompile()
    assert graphs.graph_count == 2 * 2 * len(FUNNEL_BUCKETS)
    want_b2 = 1 if mode == "int8" else 0
    assert graphs.launches_per_replay == {"retrieval": want_b2, "forward": 1}
    assert retrieval.captured - b2 == want_b2 * 2 * len(FUNNEL_BUCKETS)
    assert fused_ctr.captured - b1 == 2 * len(FUNNEL_BUCKETS)
    for b in FUNNEL_BUCKETS:
        for n in (b, b - 3):
            ids, vals = _funnel_rows(n, seed=b + n)
            for slot in (0, 1):
                runs = dict(fgraphs.graph_kernel_runs)
                pack, overflow, (t_r, t_k) = graphs.dispatch(slot, ids, vals)
                assert fgraphs.graph_kernel_runs["forward"] == runs["forward"] + 1
                assert fgraphs.graph_kernel_runs["retrieval"] == runs["retrieval"] + want_b2
                want, want_overflow = graphs.eager(slot, ids, vals)
                assert pack.shape == (n, 3, 8) and t_r > 0 and t_k > 0
                np.testing.assert_array_equal(pack[:, 0], want[:, 0])
                np.testing.assert_allclose(pack[:, 1:], want[:, 1:], rtol=0, atol=1e-6)
                assert overflow == want_overflow is False


@pytest.mark.cuda
def test_a_funnel_swap_captures_nothing_and_serves_the_new_version(device, tmp_path):
    """FunnelScorer on the card and a FunnelSwapper: a published version
    swaps in without a capture (graph count and B1/B2 captures unchanged),
    answers change to the new version's eager answers, a NaN version rolls
    back, and the overflow flag counts a corpus smaller than top_k."""
    import numpy as np

    from deepfm_tpu_torch.funnel import FunnelIndex, FunnelPublisher, export_funnel_servable
    from deepfm_tpu_torch.funnel.serve import FunnelScorer, FunnelSwapper

    rank_cfg, query_cfg, rank, query, index, cap = _funnel_parts(0)
    servable = export_funnel_servable(str(tmp_path / "s"), rank_cfg, rank, query_cfg, query,
                                      index, top_k=16, return_n=8, capacity=cap,
                                      retrieval="int8", oversample=4, min_recall=0.5)
    scorer = FunnelScorer(servable, device=device, buckets=FUNNEL_BUCKETS, max_wait_ms=0.0)
    try:
        swapper = FunnelSwapper(scorer, str(tmp_path / "pub"), staging_dir=str(tmp_path / "st"))
        pub = FunnelPublisher(str(tmp_path / "pub"))
        _, _, rank2, query2, index2, _ = _funnel_parts(1)
        pub.publish_funnel(rank_cfg, rank2, query_cfg, query2, index2, top_k=16, return_n=8,
                           capacity=cap, retrieval="int8", oversample=4, min_recall=0.5)
        ids, vals = _funnel_rows(5, 3)
        before = scorer.engine.score(ids, vals)
        counts = (scorer.graphs.graph_count, retrieval.captured, fused_ctr.captured)
        assert swapper.poll_once(), swapper.status()
        assert (scorer.graphs.graph_count, retrieval.captured, fused_ctr.captured) == counts
        assert scorer.versions() == (1, 1) and scorer.holder.get() == 1
        after = scorer.engine.score(ids, vals)
        want, _ = scorer.graphs.eager(1, ids, vals)
        assert not np.array_equal(after[:, 0], before[:, 0])
        np.testing.assert_array_equal(after[:, 0], want[:, 0])
        np.testing.assert_allclose(after[:, 1:], want[:, 1:], rtol=0, atol=1e-6)
        nan = dict(rank2, fm_b=torch.full_like(rank2["fm_b"], float("nan")))
        pub.publish_funnel(rank_cfg, nan, query_cfg, query2, index2, top_k=16, return_n=8,
                           capacity=cap, retrieval="int8", oversample=4, min_recall=0.5)
        assert not swapper.poll_once() and swapper.status()["rollbacks_total"] == 1
        np.testing.assert_array_equal(scorer.engine.score(ids, vals), after)
        small = FunnelIndex(item_ids=index2.item_ids[:40], item_emb=index2.item_emb[:40])
        pub.publish_funnel(rank_cfg, rank2, query_cfg, query2, small, top_k=16, return_n=8,
                           capacity=cap, retrieval="int8", oversample=1, min_recall=0.5)
        assert swapper.poll_once(), swapper.status()
        assert scorer.engine.score(ids, vals).shape == (5, 3, 8)
        assert scorer.merge_overflow_total == 0        # 40 items fill the top 16
        assert scorer.graphs.graph_count == counts[0]
    finally:
        scorer.close()


@pytest.mark.cuda
def test_the_funnel_audit_finds_nothing_on_the_card(device):
    from deepfm_tpu_torch.analysis.trace_audit import audit_funnel

    findings = audit_funnel(device)
    assert findings == [], [f.render() for f in findings]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_the_sharded_retrieve_on_one_card_equals_one_shard(device, mode):
    """Two index shards on the one card give one shard's ids (scores
    within 1e-6 of the row's largest magnitude)."""
    from deepfm_tpu_torch.funnel import (build_retrieve_with, make_funnel_context,
                                         stage_funnel_payload)
    from deepfm_tpu_torch.serve.export import model_from_state

    rank_cfg, query_cfg, rank, query, index, cap = _funnel_parts(2)
    rank_m = model_from_state(rank_cfg, rank, device)
    query_m = model_from_state(query_cfg, query, device)
    ids, _ = _funnel_rows(32, 5)
    uids = torch.from_numpy(ids[:, :3]).to(device)
    uvals = torch.ones((32, 3), device=device)
    out = {}
    for mp in (1, 2):
        ctx = make_funnel_context(rank_cfg, query_cfg, capacity=cap, top_k=16,
                                  retrieval=mode, oversample=4, model_parallel=mp)
        payload = stage_funnel_payload(ctx, rank_m, query_m, index)
        assert {s["item_ids"].device for s in payload["shards"]} == {device}
        with torch.no_grad():
            out[mp] = build_retrieve_with(ctx)(payload, uids, uvals)
    (s1, c1), (s2, c2) = out[1], out[2]
    assert torch.equal(c1, c2)
    tol = 1e-6 * s1.abs().amax(dim=1, keepdim=True)
    assert bool(((s1 - s2).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_the_sharded_retrieve_graph_equals_the_eager_retrieve(device, mode):
    """FunnelGraphs over four index shards on the one card: the retrieve
    graph's ids equal the eager sharded retrieve's and, in exact mode, one
    shard's (scores within 1e-6 of the row's largest magnitude); the pack
    equals the eager stages'."""
    import numpy as np

    from deepfm_tpu_torch.funnel import (build_retrieve_with, make_funnel_context,
                                         stage_funnel_payload)
    from deepfm_tpu_torch.funnel.graphs import FunnelGraphs
    from deepfm_tpu_torch.serve.export import model_from_state

    rank_cfg, query_cfg, rank, query, index, cap = _funnel_parts(2)
    ids, vals = _funnel_rows(32, 6)
    uids = torch.from_numpy(ids[:, :3]).to(device)
    uvals = torch.from_numpy(vals[:, :3]).to(device)
    eager = {}
    for mp in (1, 4):
        ctx = make_funnel_context(rank_cfg, query_cfg, capacity=cap, top_k=16, return_n=8,
                                  retrieval=mode, oversample=4, model_parallel=mp)
        payload = stage_funnel_payload(ctx, model_from_state(rank_cfg, rank, device),
                                       model_from_state(query_cfg, query, device), index)
        with torch.no_grad():
            eager[mp] = [t.cpu().numpy() for t in build_retrieve_with(ctx)(payload, uids, uvals)]
    graphs = FunnelGraphs(ctx, rank, query, index, device=device, buckets=FUNNEL_BUCKETS)
    graphs.precompile()
    pack, _, _, scores, cand = graphs.dispatch(0, ids, vals, full=True)
    np.testing.assert_array_equal(cand, eager[4][1])
    np.testing.assert_allclose(scores, eager[4][0], rtol=0, atol=1e-6)
    if mode == "exact":
        np.testing.assert_array_equal(cand, eager[1][1])
        tol = 1e-6 * np.abs(eager[1][0]).max(axis=1, keepdims=True)
        assert (np.abs(scores - eager[1][0]) <= tol).all()
    want, _ = graphs.eager(0, ids, vals)
    np.testing.assert_array_equal(pack[:, 0], want[:, 0])
    np.testing.assert_allclose(pack[:, 1:], want[:, 1:], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dp,mp,exchange", [(1, 2, "psum"), (1, 2, "alltoall"),
                                            (2, 2, "alltoall"), (2, 4, "psum")])
def test_a_members_graphs_equal_the_single_process_graphs(device, tmp_path, dp, mp, exchange):
    """A pool member's row-sharded predict (serve/pool/sharded.py), one
    graph a slot and bucket with B1 a data slice, equals the
    single-process graphed predict bit for bit at every bucket, on a batch
    that overflows the all-to-all (the psum fallback, a device select)
    too; a slot load captures nothing."""
    import numpy as np

    from deepfm_tpu_torch.serve.export import export_servable
    from deepfm_tpu_torch.serve.graphs import GraphedPredictor
    from deepfm_tpu_torch.serve.pool.sharded import (MEMBER_SLOTS, load_sharded_servable,
                                                     stage_sharded_payload)

    state = _serve_state(0)
    servable = export_servable(_serve_cfg(), state, tmp_path / "s")
    single = GraphedPredictor(_serve_cfg(), state, device=device, buckets=SERVE_BUCKETS)
    single.precompile()
    _, pred, _, ctx = load_sharded_servable(servable, dp, mp, device=device,
                                            exchange=exchange, buckets=SERVE_BUCKETS)
    pred.precompile()
    assert pred.graph_count == MEMBER_SLOTS * len(SERVE_BUCKETS)
    assert pred.kernel_launches_per_replay == dp
    for b in SERVE_BUCKETS:
        ids, vals = _serve_rows(b, seed=b)
        np.testing.assert_array_equal(pred.predict_with(0, ids, vals),
                                      single.predict_with(0, ids, vals))
    b = SERVE_BUCKETS[-1]
    skewed = (np.arange(b * 39) % ctx.rows_local).reshape(b, 39)
    vals = np.ones((b, 39), np.float32)
    np.testing.assert_array_equal(pred.predict_with(0, skewed, vals),
                                  single.predict_with(0, skewed, vals))
    captured = fused_ctr.captured
    pred.load_slot(2, stage_sharded_payload(ctx, _serve_state(1)))
    assert fused_ctr.captured == captured
    assert not np.array_equal(pred.predict_with(2, ids, vals), pred.predict_with(0, ids, vals))


@pytest.mark.cuda
def test_the_degraded_retrieve_graph_equals_its_eager_stages(device):
    """The funnel's third graph, the retrieve at the degraded oversample,
    captured at boot beside the full one: a degraded dispatch replays it
    (B2 at K·os_d), captures nothing and equals the degraded stages run
    eagerly."""
    import numpy as np

    from deepfm_tpu_torch.funnel import make_funnel_context
    from deepfm_tpu_torch.funnel.graphs import FunnelGraphs

    rank_cfg, query_cfg, rank, query, index, cap = _funnel_parts(2)
    ids, vals = _funnel_rows(32, 6)
    ctx = make_funnel_context(rank_cfg, query_cfg, capacity=cap, top_k=16, return_n=8,
                              retrieval="int8", oversample=4)
    graphs = FunnelGraphs(ctx, rank, query, index, device=device, buckets=FUNNEL_BUCKETS,
                          slots=3, degraded_oversample=2)
    graphs.precompile()
    assert graphs.graph_count == 3 * 3 * len(FUNNEL_BUCKETS)
    before = (retrieval.captured, fused_ctr.captured)
    for slot in range(3):
        pack, _, _ = graphs.dispatch(slot, ids, vals, degraded=True)
        want, _ = graphs.eager(slot, ids, vals, degraded=True)
        np.testing.assert_array_equal(pack[:, 0], want[:, 0])
        np.testing.assert_allclose(pack[:, 1:], want[:, 1:], rtol=0, atol=1e-6)
    assert (retrieval.captured, fused_ctr.captured) == before
