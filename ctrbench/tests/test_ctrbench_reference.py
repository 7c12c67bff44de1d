"""The reference against the port at a tiny size on the CPU.  The test
imports the port; the reference does not (test_ctrbench_imports.py)."""

import math

import pytest
import torch

from conftest import tiny_cell
from ctrbench import feed, harness
from ctrbench.program import Program
from ctrbench.reference import common, family
from ctrbench.weights import make_weights


@pytest.mark.parametrize("workload", ["deepfm_train_b1024", "xdeepfm_train_b4096"])
def test_logits_agree_in_float32(workload):
    cell = tiny_cell(workload, compute_dtype="float32")
    prog = Program(cell.model, cell.optimizer, 64, "cpu")
    w = make_weights(cell.model, 9, torch.device("cpu"), 0.25)
    assert abs(float(w["fm_b"][0]) - math.log(1 / 3)) < 1e-6
    prog.load(w, 1)
    rec = feed.make_records(cell.traffic, cell.model, 9, torch.device("cpu"))
    ids, vals = rec["feat_ids"][:64], rec["feat_vals"][:64]
    model = prog.state.model.eval()
    with torch.no_grad():
        got = model(ids, vals)
        want = family(cell.model["model_name"]).logits(
            w, ids, vals, cell.model, [None] * len(cell.model["deep_layers"]),
            common.Float32())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("workload", ["deepfm_train_b1024", "xdeepfm_train_b4096"])
def test_training_steps_agree_in_float32(workload):
    """The harness's whole comparison on the CPU with the program in
    float32: the losses, first gradients and changes agree to rounding
    (dropout masks, L2 term and Adam included)."""
    import time

    cell = tiny_cell(workload, compute_dtype="float32")
    line, _ = harness.run(cell, 31, 0.2, False, t_start=time.perf_counter(),
                          device_type="cpu")
    c = line["checks"]
    assert c["loss_gap"]["value"] < 1e-5
    assert c["grad_gap"]["value"] < 1e-5
    assert c["change_gap"]["value"] < 1e-4


def test_bfloat16_program_departs_from_float32_reference():
    """The configuration's bf16 MLP reads a gap a float32 program does not."""
    import time

    cell = tiny_cell("deepfm_train_b1024")
    line, _ = harness.run(cell, 31, 0.0, False, t_start=time.perf_counter(),
                          device_type="cpu")
    assert line["checks"]["grad_gap"]["value"] > 1e-4


def test_dropout_masks_follow_the_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = common.dropout_masks(g1, 16, [8, 4], [0.5, 1.0])
    b = common.dropout_masks(g2, 16, [8, 4], [0.5, 1.0])
    assert a[1] is None and torch.equal(a[0], b[0])
    assert 0.2 < float(a[0].float().mean()) < 0.8


def test_adam_first_step_moves_each_element_by_lr():
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    opt = common.Adam(p, 0.1, 0.9, 0.999, 1e-8)
    opt.step(p, {"w": torch.tensor([0.5, -0.25, 0.0])})
    torch.testing.assert_close(p["w"], torch.tensor([0.9, -1.9, 3.0]))
