"""The port stands alone: no module of ``deepfm_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the package imports
with JAX made unimportable."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "deepfm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "orbax", "deepfm_tpu")


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "deepfm_tpu_torch").rglob("*.py"))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'orbax', 'deepfm_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Alone in a directory (and here without a card) the script exits
    non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


NATIVE_SOURCES = sorted([*(ROOT / "deepfm_tpu_torch" / "native" / "src").glob("*.cc"),
                         *(ROOT / "deepfm_tpu_torch" / "csrc").glob("*.cu")])


@pytest.mark.parametrize("path", NATIVE_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_native_sources_include_nothing_of_the_jax_package(path):
    """The port's C++ and CUDA sources are its own copies: no include
    reaches into ``deepfm_tpu/``, and the native library builds only from
    files under ``deepfm_tpu_torch/``."""
    includes = [line for line in path.read_text().splitlines()
                if line.lstrip().startswith("#include")]
    assert not [i for i in includes if "deepfm_tpu/" in i or ".." in i], includes


def test_the_native_library_builds_from_the_port_s_own_sources():
    from deepfm_tpu_torch import native

    for src in (native.SOURCE, native.ENCODER_SOURCE):
        assert Path(src).resolve().is_relative_to(ROOT / "deepfm_tpu_torch"), src
        assert Path(src).is_file()
