"""The yardstick's peaks and the kernels' least times.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W limit): HBM 3.35 TB/s, bf16 989 TFLOP/s, float32 outside the
tensor cores 67 TFLOP/s.

The two bounds are frozen copies of the port's ``chip_smoke.py``
``fused_ctr_bound_ms`` and ``fused_ctr_backward_bound_ms``, in seconds:
each input read once (of a table only the rows the batch touches, each
once), each output written once, over the HBM rate; or the float32
operations over the float32 peak, whichever is longer.  The backward's
zero fill of its gradient buffers is a separate kernel and not counted.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12


def _distinct(ids: torch.Tensor, fm_w_rows: int, fm_v_rows: int) -> tuple[int, int]:
    rows = ids.long().clamp(0, fm_v_rows - 1)
    return (int(torch.unique(rows).numel()),
            int(torch.unique(rows.clamp(max=fm_w_rows - 1)).numel()))


def b1_seconds(ids: torch.Tensor, fm_w_rows: int, fm_v_rows: int, k: int) -> float:
    """B1 (``fused_ctr_forward``) on int32 ``ids`` ``[B, F]``."""
    b, f = ids.shape
    uniq_v, uniq_w = _distinct(ids, fm_w_rows, fm_v_rows)
    nbytes = (b * f * 4 * 2                  # ids (int32) + vals
              + uniq_v * k * 4 + uniq_w * 4  # distinct table rows
              + b * f * k * 4 + 2 * b * 4)   # emb, y_w, y_v
    flops = 4 * b * f * k + 2 * b * f
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def b1_backward_seconds(ids: torch.Tensor, fm_w_rows: int, fm_v_rows: int, k: int,
                        want_vals: bool = False) -> float:
    """B1′ (``fused_ctr_backward``) on ``ids`` ``[B, F]``; the training
    step takes no ``d_vals``."""
    b, f = ids.shape
    uniq_v, uniq_w = _distinct(ids, fm_w_rows, fm_v_rows)
    nbytes = (b * f * k * 4                          # g_emb
              + b * f * (ids.element_size() + 4)     # ids, vals
              + 2 * b * 4                            # g_yw, g_yv
              + 2 * (uniq_v * k * 4 + uniq_w * 4)    # rows read, grads written
              + (b * f * 4 if want_vals else 0))     # d_vals
    flops = b * f * k * (7 + (2 if want_vals else 0)) + 2 * b * f
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
