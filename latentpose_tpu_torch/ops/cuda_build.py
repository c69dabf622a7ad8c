"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` from ``latentpose_tpu_torch/csrc/`` for
``sm_90a`` into ``latentpose_tpu_torch/_build/`` and bound with ``ctypes``
(plain C entry points; no PyTorch headers, so a build takes seconds).  The
file name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing is built at import:
the first wrapper call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                   "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA "
                       "kernels are built from latentpose_tpu_torch/csrc/ at "
                       "first use and need the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def load_library(name: str, sources: tuple) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>-<hash>.so`` from ``sources``
    (file names under ``csrc/``).  The compiler's report (registers, shared
    memory, spills from ``-Xptxas -v``) is kept in ``<lib>.log`` beside it."""
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.read_bytes())
    lib_path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               *map(str, paths)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
        lib_path.with_suffix(".log").write_text(log)
        os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    return ctypes.CDLL(str(lib_path))


def build_log(lib: ctypes.CDLL) -> str:
    """The compiler's report kept beside a library that :func:`load_library`
    built ("" when it was built by an earlier process of another tree)."""
    log = Path(lib._name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
