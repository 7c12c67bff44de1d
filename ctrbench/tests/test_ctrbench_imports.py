"""What a run loads: no module whose top-level name (before the first
dot, compared whole) is ``jax``, ``jaxlib``, ``flax`` or ``deepfm_tpu``
(``deepfm_tpu_torch`` is another name), and nothing of the port under
``ctrbench/reference/``."""

import ast
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "deepfm_tpu"}
BENCH = os.path.join(ROOT, "ctrbench")


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(folder: str) -> list[str]:
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(folder)
                  for f in fs if f.endswith(".py"))


@pytest.mark.parametrize("path", _sources(os.path.join(BENCH, "reference")),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert not names & (FORBIDDEN | {"deepfm_tpu_torch", "bench", "benchmarks"}), names


def test_harness_sources_import_no_jax_package():
    for path in _sources(BENCH):
        names = _imports(path)
        assert not names & (FORBIDDEN | {"bench", "benchmarks"}), (path, names)


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import sys, json\n"
        "import ctrbench.reference, ctrbench.reference.deepfm, ctrbench.reference.xdeepfm\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    assert "deepfm_tpu_torch" not in loaded
    assert not loaded & FORBIDDEN


def test_cpu_rehearsal_loads_no_jax_package():
    """A whole run on the CPU (set-up, window, traced segment, reference)
    leaves no forbidden top-level name in ``sys.modules``."""
    loaded = _loaded_after(
        "import sys, json, time\n"
        "sys.path.insert(0, 'ctrbench/tests')\n"
        "from conftest import tiny_cell\n"
        "from ctrbench import harness\n"
        "line, _ = harness.run(tiny_cell('deepfm_train_b1024'), 5, 0.2, True,\n"
        "                      t_start=time.perf_counter(), device_type='cpu')\n"
        "assert line['attempted'] > 0\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    assert "deepfm_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
