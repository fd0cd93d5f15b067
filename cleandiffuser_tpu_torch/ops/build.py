"""Build and load the port's CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C interface (it may
include the shared `csrc/*.cuh`). At first use it is compiled with nvcc for
Hopper (sm_90a) into a shared library under `cleandiffuser_tpu_torch/_build/`
and loaded with ctypes. The library's file name carries a hash of the
source, the headers and the flags, so an edited source or header is rebuilt
and a stale library is never loaded. Nothing is compiled when a
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "Builds", "build_libraries",
           "load_library", "build_log", "sass"]

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
    # the source and every header beside it, which a source may include
    src = b"".join(path.read_bytes() for path in
                   [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_log(name: str) -> str:
    """The compiler's output (ptxas registers, shared memory, spills) from
    the build of `csrc/<name>.cu`, or "" if it has not been built here."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass(name: str) -> str:
    """The SASS of the built `csrc/<name>.cu` library, from the toolkit's
    `cuobjdump -sass` (the card's machine code: which instructions run)."""
    cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(_library_path(name))], check=True,
                          capture_output=True, text=True).stdout


class Builds:
    """Starts one nvcc process for every `csrc/<name>.cu` whose library is
    missing, all together, each read by a thread of its own, which notes
    when it ended; returns at once, so the caller may do other work, then
    `wait()` (or `kill()`)."""

    def __init__(self, names):
        self.t0 = time.perf_counter()
        self.seconds = {name: 0.0 for name in names}
        self.jobs = []
        for name in dict.fromkeys(names):
            lib_path = _library_path(name)
            if lib_path.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build to a private name, then rename: a concurrent build of the
            # same source never exposes a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
            done = {}
            reader = threading.Thread(target=self._read, args=(proc, done), daemon=True)
            reader.start()
            self.jobs.append((name, lib_path, tmp, cmd, proc, reader, done))

    def _read(self, proc, done):
        done["out"], done["err"] = proc.communicate()
        done["seconds"] = time.perf_counter() - self.t0

    def wait(self) -> dict:
        """Wait for every build. Returns the seconds from the start until
        each build ended (0.0 for a library already built). Raises if a
        build fails."""
        failed = []
        for name, lib_path, tmp, cmd, proc, reader, done in self.jobs:
            reader.join()
            out, err = done["out"], done["err"]
            self.seconds[name] = done["seconds"]
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed building {name}.cu:\n{' '.join(cmd)}\n{out}\n{err}")
                continue
            lib_path.with_suffix(".log").write_text(out + err)
            os.replace(tmp, lib_path)
        self.jobs = []
        if failed:
            raise RuntimeError("\n".join(failed))
        return self.seconds

    def kill(self):
        """Stop every build still running and remove its partial output."""
        for _, _, tmp, _, proc, reader, _ in self.jobs:
            proc.kill()
            reader.join()
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.jobs = []


def build_libraries(names) -> dict:
    """Build every `csrc/<name>.cu` whose library is missing, one nvcc
    process each, all started together; wait for all of them. Returns the
    seconds from the start until each build ended (0.0 for a library
    already built). Raises if a build fails."""
    return Builds(names).wait()


def load_library(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if its library is missing, then load it.
    Reads and hashes the source: callers load once and keep the handle."""
    build_libraries([name])
    return ctypes.CDLL(str(_library_path(name)))
