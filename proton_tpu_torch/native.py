"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain ``extern "C"`` interface. At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``build/kernels/`` at the root of the checkout, and loaded
with ``ctypes``. The library's file name carries a hash of the source and
the flags, so a stale build is never loaded. ``ptxas -v`` output (the
registers and spills of every kernel) is kept beside the library.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Build(NamedTuple):
    path: Path        # the shared library
    log: str          # nvcc/ptxas output of the build that made it
    seconds: float    # wall time of this call's build (0.0 if cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(*names: str) -> Dict[str, Build]:
    """Compile the named sources that have no current build, one nvcc
    process per source, all started together. Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    t0 = time.perf_counter()
    for name in names:
        so = library_path(name)
        if so.exists():
            log = so.with_suffix(".log")
            out[name] = Build(so, log.read_text() if log.exists() else "",
                              0.0)
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), so, tmp)
    for name, (proc, so, tmp) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
        out[name] = Build(so, log, time.perf_counter() - t0)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name)[name].path))
