"""Shared fixtures of the benchmark's own tests (README.md: run them with
``python -m pytest ctrbench/tests`` from the checkout's root)."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small_cell(workload: str, **traffic):
    """The cell at a size the CPU holds: a short ring, and the given
    traffic keys replaced; the configuration as committed."""
    from ctrbench.cell import load_cell

    cell = load_cell(ROOT, workload)
    tr = dict(cell.traffic, ring_batches=4, trace_steps=3)
    tr.update(traffic)
    return load_cell(ROOT, workload, config=cell.config, traffic=tr)


def tiny_cell(workload: str, **model):
    """The cell at toy widths (a 1,000-row vocabulary, batch 64), with the
    given model keys replaced."""
    from ctrbench.cell import load_cell

    cell = load_cell(ROOT, workload)
    m = dict(cell.model, feature_size=1000)
    if m["model_name"] == "xdeepfm":
        m["cin_layers"] = [16, 16]
    m.update(model)
    tr = dict(cell.traffic, batch_size=64, ring_batches=8, trace_steps=3)
    return load_cell(ROOT, workload, config=dict(cell.config, model=m), traffic=tr)


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)
