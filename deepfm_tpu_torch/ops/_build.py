"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``deepfm_tpu_torch/csrc/<name>.cu`` is compiled on its own by ``nvcc``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), under ``csrc/_build/`` (git-ignored).  The library's
file name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  Builds of several sources run in
parallel.  A failed build raises with the compiler's output.

Nothing here runs at import: the wrappers call :func:`load` when they first
launch a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, CUDA_HOME and CUDA_PATH): the "
        "port's kernels are built from deepfm_tpu_torch/csrc at first use"
    )


def sources() -> list[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile every named source (default: all) that has no current
    library, one ``nvcc`` each, all started together.

    Returns ``{name: {"seconds": wall seconds, "log": compiler stderr}}``
    for the sources it compiled (``-Xptxas -v`` puts each kernel's
    registers, shared memory and spills in the log)."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (time.perf_counter(), out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built, failed = {}, []
    for name, (t0, out, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
        built[name] = {"seconds": time.perf_counter() - t0,
                       "log": stdout + stderr}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _loaded[name] = lib
        return lib
