"""Fused embedding gather + FM interaction: counterpart of
``deepfm_tpu/ops/pallas_ctr.py``.

``fused_ctr_interaction(fm_w, fm_v, ids, vals) -> (emb, y_w, y_v)``:

* on CUDA tensors it launches the hand-written Hopper kernel
  ``csrc/fused_ctr.cu`` (built at first use, ops/_build.py), or raises;
* on CPU tensors it runs :func:`fused_ctr_plain`, the plain PyTorch version
  built from ``scaled_embedding``, ``fm_first_order`` and
  ``fm_second_order``.

There is no fallback from the card to the plain version.  ``launches``
counts the kernel's launches, so a caller can show that a path ran through
the kernel.

Id clipping: ids clip to ``[0, fm_v rows - 1]`` for ``emb`` (a padded fm_v's
zero rows are reachable by int32 ids past ``feature_size``), and that row
clips again to ``[0, fm_w rows - 1]`` for the fm_w term, since fm_w is never
padded.  int64 ids clip before they narrow.
"""

from __future__ import annotations

import ctypes

import torch

from .embedding import dense_lookup, scaled_embedding
from .fm import fm_first_order, fm_second_order

# kernel launches since import (or since a caller reset it)
launches = 0

_MAX_K = 128  # csrc/fused_ctr.cu: 4 floats a lane
_INT_MAX = 2**31 - 1


def fused_ctr_plain(fm_w, fm_v, ids, vals):
    """Plain PyTorch version: fm_w [Vw], fm_v [Vv, K], ids/vals [B, F] ->
    (emb [B, F, K], y_w [B], y_v [B]), all float32."""
    ids = ids.reshape(-1, ids.shape[-1])
    vals = vals.reshape(ids.shape).to(torch.float32)
    rows = ids.clamp(0, fm_v.shape[0] - 1)
    emb = scaled_embedding(fm_v, rows, vals)
    y_w = fm_first_order(dense_lookup(fm_w, rows), vals)
    return emb, y_w, fm_second_order(emb)


def fused_ctr_interaction(fm_w, fm_v, ids, vals):
    """(fm_w [Vw], fm_v [Vv, K], ids [B, F] int32|int64, vals [B, F] f32)
    -> (emb [B, F, K], y_w [B], y_v [B]).  emb is already scaled by vals."""
    if fm_v.device.type == "cpu":
        return fused_ctr_plain(fm_w, fm_v, ids, vals)
    if fm_v.device.type != "cuda":
        raise ValueError(
            f"fused_ctr_interaction runs on cuda or cpu tensors, got "
            f"{fm_v.device}"
        )
    return _forward_cuda(fm_w, fm_v, ids, vals)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_ctr_interaction: {msg}")


def _forward_cuda(fm_w, fm_v, ids, vals):
    global launches
    dev = fm_v.device
    for name, t in (("fm_w", fm_w), ("ids", ids), ("vals", vals)):
        _check(t.device == dev, f"{name} is on {t.device}, fm_v on {dev}")
    _check(fm_v.dim() == 2 and fm_v.dtype == torch.float32,
           f"fm_v must be 2-D float32, got {tuple(fm_v.shape)} {fm_v.dtype}")
    _check(fm_w.dim() == 1 and fm_w.dtype == torch.float32,
           f"fm_w must be 1-D float32, got {tuple(fm_w.shape)} {fm_w.dtype}")
    _check(ids.dim() == 2 and ids.dtype in (torch.int32, torch.int64),
           f"ids must be [B, F] int32 or int64, got {tuple(ids.shape)} "
           f"{ids.dtype}")
    _check(vals.shape == ids.shape and vals.dtype == torch.float32,
           f"vals must be float32 of ids' shape {tuple(ids.shape)}, got "
           f"{tuple(vals.shape)} {vals.dtype}")
    for name, t in (("fm_w", fm_w), ("fm_v", fm_v), ("ids", ids), ("vals", vals)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
    v_rows, k = fm_v.shape
    b, f = ids.shape
    _check(v_rows > 0 and fm_w.shape[0] > 0, "tables must have rows")
    _check(1 <= k <= _MAX_K, f"embedding size must be in [1, {_MAX_K}], got {k}")
    _check(b * f * k <= _INT_MAX, f"batch {b}x{f}x{k} too large")

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
    if rc != 0:
        raise RuntimeError(
            f"fused_ctr_forward launch failed: CUDA error {rc} "
            f"({lib.fused_ctr_error_string(rc).decode()})"
        )
    launches += 1
    return emb, y_w, y_v


def _library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("fused_ctr")
    if lib.fused_ctr_forward.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.fused_ctr_forward.argtypes = [
            p, i64, p, i64, i32, p, i32, p, i32, i32, p, p, p, p]
        lib.fused_ctr_forward.restype = ctypes.c_int
        lib.fused_ctr_error_string.argtypes = [ctypes.c_int]
        lib.fused_ctr_error_string.restype = ctypes.c_char_p
    return lib
