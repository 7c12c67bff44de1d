"""Per-row symmetric int8 quantization of the item-tower embedding matrix:
a copy of ``deepfm_tpu/funnel/quant.py`` (numpy only).

The quantized retrieval tier (funnel/index.py ``retrieval_mode="int8"``)
stores the corpus twice: the f32 ``item_emb`` rows it already had (the
exact-rescore source — only ever read through a shortlist-sized gather)
and an int8 code matrix + per-row f32 scale derived here.  Scoring then
streams 1 byte/element instead of 4 — the retrieval matmul is bandwidth-
bound at corpus scale, so the code stream is where the latency goes —
while the oversampled shortlist is re-scored against the exact f32 rows
before anything crosses a collective (ScaNN's asymmetric score-then-
rescore shape, arxiv 1908.10396).

Per-row symmetric means ``codes[i] = round(emb[i] / scales[i])`` with
``scales[i] = max|emb[i]| / 127``: zero is exactly representable (pad
rows stay exactly zero), and the worst-case per-element reconstruction
error is ``scales[i] / 2`` — recorded per publish as the quantization
error bound so the manifest carries the quality budget alongside the
measured recall (funnel/recall.py).
"""

from __future__ import annotations

import numpy as np

# the knob's legal values (resolve_retrieval_mode validates them for
# funnel/index.py): "auto" picks int8 once the index capacity crosses
# AUTO_INT8_MIN_ROWS — below that the exact matmul is already cheap and
# bit-parity beats an (oversample, min_recall) budget nobody needed
RETRIEVAL_MODES = ("exact", "int8", "auto")
AUTO_INT8_MIN_ROWS = 1 << 20

_QMAX = 127.0


def resolve_retrieval_mode(mode: str, capacity: int) -> str:
    """Resolve the ``funnel_retrieval`` knob to a concrete mode.

    Resolution keys on the index CAPACITY (static serving geometry), not
    the live item count: the mode picks which executables compile at
    boot, and a corpus that grows across republishes must not flip the
    payload tree mid-traffic."""
    if mode not in RETRIEVAL_MODES:
        raise ValueError(
            f"funnel_retrieval={mode!r} is not one of {RETRIEVAL_MODES}"
        )
    if mode == "auto":
        return "int8" if int(capacity) >= AUTO_INT8_MIN_ROWS else "exact"
    return mode


def quantize_rows(emb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``[N, D] f32 -> (codes [N, D] int8, scales [N] f32)``.

    All-zero rows (index pad rows) quantize to scale 0 + zero codes, so a
    dequantized pad row is exactly zero — the pad-masking invariant
    (id < 0 ⇒ -inf) never depends on quantization noise."""
    emb = np.asarray(emb, np.float32)
    if emb.ndim != 2:
        raise ValueError(f"expected [N, D] embeddings, got shape {emb.shape}")
    amax = np.abs(emb).max(axis=1)
    scales = (amax / _QMAX).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    codes = np.clip(np.rint(emb / safe[:, None]), -_QMAX, _QMAX)
    return codes.astype(np.int8), scales


def dequantize_rows(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """The scorer's reconstruction: ``codes * scales[:, None]`` in f32."""
    return (np.asarray(codes, np.float32)
            * np.asarray(scales, np.float32)[:, None])


def quantization_stats(emb: np.ndarray, codes: np.ndarray,
                       scales: np.ndarray) -> dict:
    """The error budget a publish records next to the measured recall:
    worst observed per-element reconstruction error, the analytic bound
    (``max(scales) / 2``), and the worst per-row score perturbation for a
    unit query (``||err_row||_2`` — Cauchy-Schwarz on ``u·err``)."""
    emb = np.asarray(emb, np.float32)
    err = emb - dequantize_rows(codes, scales)
    row_l2 = np.sqrt((err * err).sum(axis=1)) if emb.size else np.zeros(0)
    return {
        "max_abs_err": float(np.abs(err).max()) if emb.size else 0.0,
        "err_bound": float(scales.max() / 2.0) if np.size(scales) else 0.0,
        "max_row_score_err": float(row_l2.max()) if emb.size else 0.0,
    }
