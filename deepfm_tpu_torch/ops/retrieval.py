"""Int8 retrieval score + top-k: counterpart of
``deepfm_tpu/ops/pallas_retrieval.py`` (``retrieval_topk_kernel`` and its
portable twin ``score_topk_tiles``).

``retrieval_topk(u, codes, scales, ids, kos) -> (scores, rows)``: per query
of ``u [B, D] f32``, the top ``kos`` rows of ``u·(codes·scales)ᵀ`` over an
int8 corpus (``codes [R, D] i8``, ``scales [R] f32``, ``ids [R] i32``; rows
with ``ids < 0`` score -inf), sorted by descending score with ties toward
the smaller row.  ``scores [B, kos] f32``, ``rows [B, kos] i32`` (local row
indices).  Slots past the corpus (``R < kos``) are ``(-inf, 0)``; a caller
masks on the score before trusting a row.

* on CUDA tensors it launches the hand-written Hopper kernel
  (``csrc/retrieval_topk.cu``, built at first use, ops/_build.py), or
  raises;
* on CPU tensors it runs :func:`retrieval_topk_plain`.

There is no fallback from the card to the plain version, and the JAX
package's ``funnel_pallas`` knob and compile probe are not carried over.
``launches`` counts the kernel's launches.  Retrieval takes no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# kernel launches since import (or since a caller reset them)
launches = 0

MAX_KOS = 1024   # csrc/retrieval_topk.cu: the candidate buffer holds kos + a row block
MAX_DIM = 128    # queries staged in shared memory
DIM_STEP = 16    # a row's codes are read as 16-byte chunks
_MAX_ROWS = 2**31 - 1  # rows are the low 32 bits of a key, read as int32
_MAX_BATCH = 65_535    # the rank kernel's grid has one row per query
# the scans' row blocks: whole 256-row tiles, two blocks per SM over all
# chunks of 8 queries, at most 4,096 rows (a row block bounds the buffer)
_TILE = 256
_QUERIES_PER_BLOCK = 8
_MAX_ROWS_PER_BLOCK = 4096
# the candidate buffer keeps room for this many keys past kos, so that on
# spread scores the first digit's bin fits and no second digit is counted
_MIN_SLACK = 2048


def retrieval_topk_plain(u, codes, scales, ids, kos: int):
    """Plain PyTorch version: ``(codes.float()·scales) @ uᵀ`` (dequantize,
    then the dot), ids < 0 masked to -inf, and a stable descending sort
    so ties go to the smaller row."""
    b = u.shape[0]
    rows = codes.shape[0]
    deq = codes.to(torch.float32) * scales[:, None]
    s = (deq @ u.T).T                                    # [B, R]
    s = torch.where(ids[None, :] >= 0, s, torch.full_like(s, float("-inf")))
    # -0.0 and +0.0 are one score (the kernel's key canonicalizes them)
    s = s + 0.0
    take = min(int(kos), rows)
    top_s, top_r = torch.sort(s, dim=1, descending=True, stable=True)
    scores = torch.full((b, kos), float("-inf"), dtype=torch.float32, device=u.device)
    out_rows = torch.zeros((b, kos), dtype=torch.int32, device=u.device)
    scores[:, :take] = top_s[:, :take]
    out_rows[:, :take] = top_r[:, :take].to(torch.int32)
    return scores, out_rows


def topk_agreement(u, codes, scales, ids, got, want, rtol: float, atol: float) -> dict:
    """How far a selection ``got = (scores, rows)`` (the kernel's) agrees
    with ``want`` (the plain version's) on the same inputs.  Two float32
    dots of one row may round differently, so near-ties may swap places or
    trade the last slot; anything else is a disagreement.  ``ok`` holds
    when, per query:

    * the scores agree position by position within ``atol + rtol·|want|``
      (-inf where and only where ``want`` has -inf);
    * every returned finite slot is a real row (id >= 0), returned once,
      whose own score (dequantize, then dot) is the reported one within
      the same tolerance.

    Then a row that differs from ``want``'s at a position is a near-tie,
    counted in ``swapped``, and a row that ``want`` did not select at all
    scores within the tolerance of the kos-th score, counted in
    ``boundary``.  ``traded[q]`` is query q's count of both.

    The serving path never calls this: it sits beside the plain version
    because the card tests and ``chip_smoke.py`` both hold the kernel to
    that version with it."""
    gs, gr = got
    ws, wr = want
    finite = torch.isfinite(ws)
    tol = atol + rtol * ws.abs().where(finite, torch.zeros_like(ws))
    diff = (gs - ws).abs().where(finite, torch.zeros_like(ws))
    ok = bool(torch.equal(torch.isfinite(gs), finite)) and bool((diff <= tol).all())
    rows = gr.long().clamp(0, codes.shape[0] - 1)
    own = ((codes[rows].to(torch.float32) * scales[rows][..., None])
           * u[:, None, :]).sum(-1)
    own_err = (own - gs).abs().where(finite, torch.zeros_like(gs))
    ok = ok and bool((own_err <= tol).all()) and bool((ids[rows][finite] >= 0).all())
    traded = ((gr != wr) & finite).sum(dim=1).tolist()
    boundary = 0
    for q in range(gs.shape[0]):
        mine = gr[q][finite[q]].tolist()
        theirs = set(wr[q][finite[q]].tolist())
        ok = ok and len(set(mine)) == len(mine)
        boundary += sum(r not in theirs for r in mine)
    return {"ok": ok, "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
            "max_own_err": float(own_err.max()) if own_err.numel() else 0.0,
            "swapped": sum(traded) - boundary, "boundary": boundary,
            "traded": traded}


def retrieval_topk(u, codes, scales, ids, kos: int):
    """(u [B, D] f32, codes [R, D] i8, scales [R] f32, ids [R] i32) ->
    (scores [B, kos] f32, rows [B, kos] i32), sorted by (-score, row)."""
    if u.device.type == "cpu":
        return retrieval_topk_plain(u, codes, scales, ids, kos)
    if u.device.type != "cuda":
        raise ValueError(f"retrieval_topk runs on cuda or cpu tensors, got {u.device}")
    return _retrieval_topk_cuda(u, codes, scales, ids, int(kos))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"retrieval_topk: {msg}")


def _check_inputs(u, codes, scales, ids, kos: int) -> None:
    dev = u.device
    for name, t in (("codes", codes), ("scales", scales), ("ids", ids)):
        _check(t.device == dev, f"{name} is on {t.device}, u on {dev}")
    _check(u.dim() == 2 and u.dtype == torch.float32,
           f"u must be [B, D] float32, got {tuple(u.shape)} {u.dtype}")
    b, d = u.shape
    _check(codes.dim() == 2 and codes.dtype == torch.int8 and codes.shape[1] == d,
           f"codes must be [R, {d}] int8, got {tuple(codes.shape)} {codes.dtype}")
    r = codes.shape[0]
    _check(scales.shape == (r,) and scales.dtype == torch.float32,
           f"scales must be [{r}] float32, got {tuple(scales.shape)} {scales.dtype}")
    _check(ids.shape == (r,) and ids.dtype == torch.int32,
           f"ids must be [{r}] int32, got {tuple(ids.shape)} {ids.dtype}")
    for name, t in (("u", u), ("codes", codes), ("scales", scales), ("ids", ids)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(1 <= kos <= MAX_KOS, f"kos must be in [1, {MAX_KOS}], got {kos}")
    _check(d % DIM_STEP == 0 and DIM_STEP <= d <= MAX_DIM,
           f"dimension must be a multiple of {DIM_STEP} in [{DIM_STEP}, {MAX_DIM}], got {d}")
    _check(codes.data_ptr() % 16 == 0, "codes must start 16-byte aligned")
    _check(r <= _MAX_ROWS, f"{r} rows: the kernel indexes at most {_MAX_ROWS}")
    _check(b <= _MAX_BATCH, f"{b} queries: the kernel takes at most {_MAX_BATCH}")


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def scan_plan(rows: int, batch: int, kos: int, sms: int) -> tuple[int, int]:
    """``(rows_per_block, cap)`` of the kernel's scans: row blocks of whole
    256-row tiles, enough of them for two blocks per SM over all chunks of
    8 queries but at most 4,096 rows each; and the per-query candidate
    buffer, ``kos`` plus the larger of a row block and 2,048 keys (the
    kernel needs at least ``kos`` plus a row block)."""
    chunks = -(-batch // _QUERIES_PER_BLOCK)
    want = max(1, -(-2 * sms // chunks))
    tiles = max(1, -(-rows // (want * _TILE)))
    per_block = min(_MAX_ROWS_PER_BLOCK, tiles * _TILE)
    return per_block, kos + max(per_block, _MIN_SLACK)


def _retrieval_topk_cuda(u, codes, scales, ids, kos: int):
    global launches
    _check_inputs(u, codes, scales, ids, kos)
    dev = u.device
    b, d = u.shape
    r = codes.shape[0]
    scores = torch.empty((b, kos), device=dev, dtype=torch.float32)
    rows = torch.empty((b, kos), device=dev, dtype=torch.int32)
    if b == 0:
        return scores, rows
    lib = _library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    per_block, cap = scan_plan(r, b, kos, _sm_count(index))
    nbytes = lib.retrieval_topk_workspace(b, r, per_block, cap)
    workspace = torch.empty((nbytes,), device=dev, dtype=torch.uint8)
    with torch.cuda.device(dev):
        rc = lib.retrieval_topk(
            u.data_ptr(), codes.data_ptr(), scales.data_ptr(), ids.data_ptr(),
            b, d, r, kos, per_block, cap, workspace.data_ptr(), scores.data_ptr(),
            rows.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"retrieval_topk launch failed: CUDA error {rc} "
            f"({lib.retrieval_topk_error_string(rc).decode()})")
    launches += 1
    return scores, rows


def _library() -> ctypes.CDLL:
    from . import _build

    lib = _build.load("retrieval_topk")
    if lib.retrieval_topk.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.retrieval_topk.argtypes = [p, p, p, p, i32, i32, i64, i32, i32, i32, p, p, p, p]
        lib.retrieval_topk.restype = ctypes.c_int
        lib.retrieval_topk_workspace.argtypes = [i32, i64, i32, i32]
        lib.retrieval_topk_workspace.restype = ctypes.c_longlong
        lib.retrieval_topk_error_string.argtypes = [ctypes.c_int]
        lib.retrieval_topk_error_string.restype = ctypes.c_char_p
    return lib
