"""Fused embedding gather + FM interaction and its backward: counterpart of
``deepfm_tpu/ops/pallas_ctr.py`` (``fused_ctr_interaction`` and its custom
VJP).

``fused_ctr_interaction(fm_w, fm_v, ids, vals) -> (emb, y_w, y_v)`` is a
``torch.autograd.Function`` (``FusedCTR``):

* on CUDA tensors its forward launches the hand-written Hopper kernel
  ``fused_ctr_forward`` and its backward the kernel ``fused_ctr_backward``
  (both in ``csrc/fused_ctr.cu``, built at first use, ops/_build.py), or
  raises;
* on CPU tensors its forward runs :func:`fused_ctr_plain`, built from
  ``scaled_embedding``, ``fm_first_order`` and ``fm_second_order``, and its
  backward :func:`fused_ctr_backward_plain`, the backward formula written
  with ``index_add_``.

There is no fallback from the card to the plain versions.  ``launches`` and
``backward_launches`` count each kernel's launches, so a caller can show
that a path ran through the kernels.  A forward or backward recorded into
a CUDA graph does not run until the graph replays, so it counts in
``captured`` or ``backward_captured``, not in the launches: a caller that
replays graphs counts their runs itself (serve/graphs.py,
train/step.py ``StepGraph``).

Id clipping: ids clip to ``[0, fm_v rows - 1]`` for ``emb`` (a padded fm_v's
zero rows are reachable by int32 ids past ``feature_size``), and that row
clips again to ``[0, fm_w rows - 1]`` for the fm_w term, since fm_w is never
padded.  int64 ids clip before they narrow.  The backward clips the same
way; the plain JAX chain (``dense_lookup`` per table) does too.
"""

from __future__ import annotations

import ctypes

import torch

from .embedding import dense_lookup, scaled_embedding
from .fm import fm_first_order, fm_second_order

# kernel launches since import (or since a caller reset them), and the
# forwards and backwards recorded into CUDA graphs instead
launches = 0
backward_launches = 0
captured = 0
backward_captured = 0

_MAX_K = 128  # csrc/fused_ctr.cu: 4 floats a lane
_INT_MAX = 2**31 - 1


def _rows(fm_w, fm_v, ids):
    """(fm_v rows, fm_w rows) of each lookup, clipped, as int64 [B, F]."""
    r = ids.clamp(0, fm_v.shape[0] - 1).long()
    return r, r.clamp(max=fm_w.shape[0] - 1)


def fused_ctr_plain(fm_w, fm_v, ids, vals):
    """Plain PyTorch version: fm_w [Vw], fm_v [Vv, K], ids/vals [B, F] ->
    (emb [B, F, K], y_w [B], y_v [B]), all float32."""
    ids = ids.reshape(-1, ids.shape[-1])
    vals = vals.reshape(ids.shape).to(torch.float32)
    rows = ids.clamp(0, fm_v.shape[0] - 1)
    emb = scaled_embedding(fm_v, rows, vals)
    y_w = fm_first_order(dense_lookup(fm_w, rows), vals)
    return emb, y_w, fm_second_order(emb)


def fused_ctr_backward_plain(g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals,
                             want_vals: bool = True):
    """Plain PyTorch version of the backward: the cotangents g_emb [B, F, K],
    g_yw [B], g_yv [B] -> (d_fm_w [Vw], d_fm_v [Vv, K], d_vals [B, F] or
    None).  Duplicate rows sum."""
    r, rw = _rows(fm_w, fm_v, ids)
    vals = vals.to(torch.float32)
    v_rows = fm_v[r]                                            # [B, F, K]
    e = v_rows * vals[..., None]
    g_e = g_emb + g_yv[:, None, None] * (e.sum(dim=1, keepdim=True) - e)
    k = fm_v.shape[1]
    d_fm_v = torch.zeros_like(fm_v).index_add_(
        0, r.reshape(-1), (g_e * vals[..., None]).reshape(-1, k))
    d_fm_w = torch.zeros_like(fm_w).index_add_(
        0, rw.reshape(-1), (g_yw[:, None] * vals).reshape(-1))
    d_vals = None
    if want_vals:
        d_vals = (g_e * v_rows).sum(dim=-1) + g_yw[:, None] * fm_w[rw]
    return d_fm_w, d_fm_v, d_vals


class FusedCTR(torch.autograd.Function):
    """Autograd around the forward and backward kernels (plain versions on
    CPU tensors).  ``ids`` takes no gradient."""

    @staticmethod
    def forward(ctx, fm_w, fm_v, ids, vals):
        if fm_v.device.type == "cpu":
            out = fused_ctr_plain(fm_w, fm_v, ids, vals)
        else:
            out = _forward_cuda(fm_w, fm_v, ids, vals)
        ctx.save_for_backward(fm_w, fm_v, ids, vals)
        return out

    @staticmethod
    def backward(ctx, g_emb, g_yw, g_yv):
        fm_w, fm_v, ids, vals = ctx.saved_tensors
        # autograd materializes the cotangent of an unused output as zeros
        g_emb, g_yw, g_yv = g_emb.contiguous(), g_yw.contiguous(), g_yv.contiguous()
        want_vals = ctx.needs_input_grad[3]
        if fm_v.device.type == "cpu":
            d_fm_w, d_fm_v, d_vals = fused_ctr_backward_plain(
                g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals, want_vals)
        else:
            d_fm_w, d_fm_v, d_vals = fused_ctr_backward(
                g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals, want_vals)
        return d_fm_w, d_fm_v, None, d_vals


def fused_ctr_interaction(fm_w, fm_v, ids, vals):
    """(fm_w [Vw], fm_v [Vv, K], ids [B, F] int32|int64, vals [B, F] f32)
    -> (emb [B, F, K], y_w [B], y_v [B]).  emb is already scaled by vals.
    Differentiable in fm_w, fm_v and vals."""
    if fm_v.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"fused_ctr_interaction runs on cuda or cpu tensors, got "
            f"{fm_v.device}"
        )
    ids = ids.reshape(-1, ids.shape[-1])
    return FusedCTR.apply(fm_w, fm_v, ids, vals.reshape(ids.shape))


def _check(cond: bool, msg: str, fn: str) -> None:
    if not cond:
        raise ValueError(f"{fn}: {msg}")


def _check_inputs(fm_w, fm_v, ids, vals, fn: str) -> None:
    """What both kernels take: device, dtype, shape and contiguity."""
    dev = fm_v.device
    _check(dev.type == "cuda", f"fm_v is on {dev}, the kernel runs on cuda", fn)
    for name, t in (("fm_w", fm_w), ("ids", ids), ("vals", vals)):
        _check(t.device == dev, f"{name} is on {t.device}, fm_v on {dev}", fn)
    _check(fm_v.dim() == 2 and fm_v.dtype == torch.float32,
           f"fm_v must be 2-D float32, got {tuple(fm_v.shape)} {fm_v.dtype}", fn)
    _check(fm_w.dim() == 1 and fm_w.dtype == torch.float32,
           f"fm_w must be 1-D float32, got {tuple(fm_w.shape)} {fm_w.dtype}", fn)
    _check(ids.dim() == 2 and ids.dtype in (torch.int32, torch.int64),
           f"ids must be [B, F] int32 or int64, got {tuple(ids.shape)} "
           f"{ids.dtype}", fn)
    _check(vals.shape == ids.shape and vals.dtype == torch.float32,
           f"vals must be float32 of ids' shape {tuple(ids.shape)}, got "
           f"{tuple(vals.shape)} {vals.dtype}", fn)
    for name, t in (("fm_w", fm_w), ("fm_v", fm_v), ("ids", ids), ("vals", vals)):
        _check(t.is_contiguous(), f"{name} must be contiguous", fn)
    v_rows, k = fm_v.shape
    b, f = ids.shape
    _check(v_rows > 0 and fm_w.shape[0] > 0, "tables must have rows", fn)
    _check(1 <= k <= _MAX_K, f"embedding size must be in [1, {_MAX_K}], got {k}", fn)
    _check(b * f * k <= _INT_MAX, f"batch {b}x{f}x{k} too large", fn)


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {rc} "
            f"({lib.fused_ctr_error_string(rc).decode()})"
        )


def _forward_cuda(fm_w, fm_v, ids, vals):
    global launches, captured
    _check_inputs(fm_w, fm_v, ids, vals, "fused_ctr_interaction")
    dev = fm_v.device
    v_rows, k = fm_v.shape
    b, f = ids.shape
    emb = torch.empty((b, f, k), device=dev, dtype=torch.float32)
    y_w = torch.empty((b,), device=dev, dtype=torch.float32)
    y_v = torch.empty((b,), device=dev, dtype=torch.float32)
    if b == 0:
        return emb, y_w, y_v
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.fused_ctr_forward(
            fm_w.data_ptr(), fm_w.shape[0], fm_v.data_ptr(), v_rows, k,
            ids.data_ptr(), int(ids.dtype == torch.int64), vals.data_ptr(),
            b, f, emb.data_ptr(), y_w.data_ptr(), y_v.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        capturing = torch.cuda.is_current_stream_capturing()
    _raise_on(rc, lib, "fused_ctr_forward")
    if capturing:
        captured += 1
    else:
        launches += 1
    return emb, y_w, y_v


def forward_layout(fm_v, batch: int) -> str:
    """The launch the forward kernel takes for this CUDA fm_v [V, K] and
    batch (emb, which the wrapper allocates, lies on 16 bytes): ``"vector"``
    (float4 pieces: K a multiple of 4 and fm_v on 16 bytes) or
    ``"scalar"``, with the lanes a field, the pieces a lane and the warps a
    batch row."""
    k = fm_v.shape[1]
    code = _library().fused_ctr_forward_layout(fm_v.data_ptr(), k, 0, batch)
    w, lanes = code & 0xFF, (code >> 8) & 0xFF
    per_lane, split = (code >> 16) & 0xFF, code >> 24
    kind = "vector" if w == 4 else "scalar"
    return (f"{kind} K={k}: {lanes} lanes a field, {per_lane} x {w} floats a "
            f"lane, {split} warps a row")


def fused_ctr_backward(g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals,
                       want_vals: bool = True):
    """The backward kernel on CUDA tensors: (d_fm_w [Vw], d_fm_v [Vv, K],
    d_vals [B, F] or None).  Raises on anything the kernel does not take.
    d_fm_v and d_fm_w are zero-filled here; the kernel adds into them."""
    global backward_launches, backward_captured
    fn = "fused_ctr_backward"
    _check_inputs(fm_w, fm_v, ids, vals, fn)
    dev = fm_v.device
    v_rows, k = fm_v.shape
    b, f = ids.shape
    for name, t, shape in (("g_emb", g_emb, (b, f, k)), ("g_yw", g_yw, (b,)),
                           ("g_yv", g_yv, (b,))):
        _check(t.device == dev, f"{name} is on {t.device}, fm_v on {dev}", fn)
        _check(tuple(t.shape) == shape and t.dtype == torch.float32,
               f"{name} must be float32 {shape}, got {tuple(t.shape)} {t.dtype}", fn)
        _check(t.is_contiguous(), f"{name} must be contiguous", fn)
    d_fm_w = torch.zeros_like(fm_w)
    d_fm_v = torch.zeros_like(fm_v)
    d_vals = torch.empty((b, f), device=dev, dtype=torch.float32) if want_vals else None
    if b == 0:
        return d_fm_w, d_fm_v, d_vals
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.fused_ctr_backward(
            g_emb.data_ptr(), g_yw.data_ptr(), g_yv.data_ptr(),
            fm_w.data_ptr(), fm_w.shape[0], fm_v.data_ptr(), v_rows, k,
            ids.data_ptr(), int(ids.dtype == torch.int64), vals.data_ptr(),
            b, f, d_fm_w.data_ptr(), d_fm_v.data_ptr(),
            d_vals.data_ptr() if want_vals else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        capturing = torch.cuda.is_current_stream_capturing()
    _raise_on(rc, lib, fn)
    if capturing:
        backward_captured += 1
    else:
        backward_launches += 1
    return d_fm_w, d_fm_v, d_vals


def _library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("fused_ctr")
    if lib.fused_ctr_forward.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.fused_ctr_forward.argtypes = [
            p, i64, p, i64, i32, p, i32, p, i32, i32, p, p, p, p]
        lib.fused_ctr_forward.restype = ctypes.c_int
        lib.fused_ctr_forward_layout.argtypes = [p, i32, p, i32]
        lib.fused_ctr_forward_layout.restype = ctypes.c_int
        lib.fused_ctr_backward.argtypes = [
            p, p, p, p, i64, p, i64, i32, p, i32, p, i32, i32, p, p, p, p]
        lib.fused_ctr_backward.restype = ctypes.c_int
        lib.fused_ctr_error_string.argtypes = [ctypes.c_int]
        lib.fused_ctr_error_string.restype = ctypes.c_char_p
    return lib
