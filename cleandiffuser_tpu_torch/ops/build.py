"""Build and load the port's CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C interface. At first use
it is compiled with nvcc for Hopper (sm_90a) into a shared library under
`cleandiffuser_tpu_torch/_build/` and loaded with ctypes. The library's
file name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing is compiled when a
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "load_library", "build_log"]

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
                       "the port's CUDA kernels")


def _library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_log(name: str) -> str:
    """The compiler's output (ptxas registers, shared memory, spills) from
    the build of `csrc/<name>.cu`, or "" if it has not been built here."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if its library is missing, then load it.
    Reads and hashes the source: callers load once and keep the handle."""
    lib_path = _library_path(name)
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a private name, then rename: a concurrent build of the
        # same source never exposes a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {name}.cu:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))
