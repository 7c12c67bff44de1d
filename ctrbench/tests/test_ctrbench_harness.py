"""The harness without a card: what it refuses, and that a broken timed
path, and the control in the program's place, come out not correct at
the cell's own size (README.md: the card tests run the same on the
card)."""

import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

import plants
from conftest import ROOT, small_cell, tiny_cell
from ctrbench import compare, harness
from ctrbench.calibrate import compared_steps
from ctrbench.reference.common import Lowered

CPU = torch.device("cpu")


def _run(cell, seed=41, **kw):
    return harness.run(cell, seed, 0.0, False, t_start=time.perf_counter(),
                       device_type="cpu", **kw)[0]


def _cli(cwd, env=None):
    return subprocess.run([sys.executable, "ctrbench/run.py", "--workload",
                           "deepfm_train_b1024", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this is the cardless refusal")
    out = _cli(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "never falls back to the CPU" in out.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "ctrbench"), tmp_path / "ctrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _cli(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""


def test_refuses_a_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.Refused, match="jax"):
        _run(tiny_cell("deepfm_train_b1024"))


def test_cell_is_correct_at_its_size():
    line = _run(small_cell("deepfm_train_b1024"))
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["deepfm_train_b1024", "deepfm_train_b8192",
                                      "xdeepfm_train_b4096"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_step_is_not_correct(workload, fault):
    line = _run(_cell(workload), plant=getattr(plants, fault))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["deepfm_train_b1024", "deepfm_train_b8192",
                                      "xdeepfm_train_b4096"])
def test_control_is_not_correct(workload):
    """The reference in the program's place, one precision down."""
    cell = _cell(workload)
    steps = compared_steps(cell)
    ref = harness.reference_readings(cell, 43, steps, CPU)
    low = harness.reference_readings(cell, 43, steps, CPU, prec=Lowered())
    ok, checks = compare.judge(compare.readings(low, ref),
                               compare.load_limits(ROOT, workload))
    assert not ok, checks


def _cell(workload):
    """The cell at its size, but xDeepFM's batch at 1,024 (its CIN's
    products at 4,096 rows outgrow a test run on the CPU)."""
    if workload == "xdeepfm_train_b4096":
        return small_cell(workload, batch_size=1024)
    return small_cell(workload)

