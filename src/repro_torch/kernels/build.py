"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ source under ``repro_torch/csrc/`` with a plain C
entry point.  The first call compiles it with ``nvcc`` for ``sm_90a`` into a
shared library, named by a hash of the source and flags so an edited source
rebuilds, and loads it with ``ctypes``.  Nothing is compiled at import.

The library goes under ``build/repro_torch/`` of the checkout (``build/`` is
in ``.gitignore``) when the package runs from a source tree
(``<root>/src/repro_torch``), and under ``repro_torch_build/`` in the
temporary directory when it is installed elsewhere, so an installed package
never writes beside site-packages.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = (_ROOT / "build" / "repro_torch"
             if (_ROOT / "src" / "repro_torch").is_dir()
             else pathlib.Path(tempfile.gettempdir()) / "repro_torch_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path.  The compiler's resource report (registers,
    spills) goes to ``<name>.log`` beside it."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)     # atomic: concurrent builders race safely
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name``."""
    return ctypes.CDLL(str(build(name)))
