"""On the card (the ``cuda`` marker; skipped without one): each one-card
cell runs whole and comes out correct with its traced metrics, and the
control at the cell's own size comes out not correct."""

import time

import pytest

from conftest import ROOT
from ctrbench import compare, harness
from ctrbench.calibrate import compared_steps
from ctrbench.cell import load_cell
from ctrbench.reference.common import Lowered

pytestmark = pytest.mark.cuda
ONE_CARD = ["deepfm_train_b1024", "xdeepfm_train_b4096", "deepfm_train_b8192"]


@pytest.mark.parametrize("workload", ONE_CARD)
def test_cell_runs_correct_with_its_trace(card, workload):
    cell = load_cell(ROOT, workload)
    line, checks = harness.run(cell, 2**31 + 123, 1.0, True, t_start=time.perf_counter())
    assert line["correct"], checks
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert {m["name"] for m in cell.metrics(True)} == set(line["metrics"])


@pytest.mark.parametrize("workload", ONE_CARD)
def test_control_is_not_correct(card, workload):
    cell = load_cell(ROOT, workload)
    steps = compared_steps(cell)
    ref = harness.reference_readings(cell, 77, steps, card)
    low = harness.reference_readings(cell, 77, steps, card, prec=Lowered())
    ok, checks = compare.judge(compare.readings(low, ref),
                               compare.load_limits(ROOT, workload))
    assert not ok, checks
