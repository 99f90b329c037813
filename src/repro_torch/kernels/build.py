"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Every kernel library of the port is one ``.cu`` file with a plain C
interface.  ``build_library(source)`` compiles it at first use into
``_build/<hash of the source and the flags>/lib<name>.so`` beside this file
(gitignored) and keeps the compiler's register and spill report
(``-Xptxas -v``) there as ``ptxas.log``; ``load_library(source)`` opens the
library once per process.  Two sources build in parallel without clashing:
each has its own directory, and a build is renamed into place only when
nvcc succeeded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_library", "load_library"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else [])
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def build_library(source: Path) -> Path:
    """Compile ``source`` into a shared library, once per source and flags.

    Returns the library's path; ``ptxas.log`` beside it holds nvcc's
    register and spill report.
    """
    source = Path(source)
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / tag.hexdigest()[:16] / f"lib{source.stem}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    (out.parent / "ptxas.log").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library(source: Path) -> ctypes.CDLL:
    """The library built from ``source``, opened once per process."""
    return ctypes.CDLL(str(build_library(source)))
