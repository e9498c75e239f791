"""Build and load the port's CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C interface (it may
include the shared `csrc/*.cuh` headers).  It is compiled with nvcc for
Hopper (`sm_90a`) into a shared library under `build/kernels/` at the
repository root (listed in .gitignore), at its first use, and loaded with
ctypes.  Importing the package builds nothing.  The library's file name
carries a hash of the source, the headers and the flags, so an edited source
is rebuilt and a stale library is never loaded.  `build_libraries` starts one
nvcc per source at once.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: Seconds nvcc took per kernel name, for the builds of this process.
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def build_library(name: str) -> Tuple[Path, str]:
    """Compile `csrc/<name>.cu` unless a library of the same source and
    flags exists.  Returns its path and nvcc's output (empty when nothing
    was compiled)."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    start = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        BUILD_SECONDS[name] = time.perf_counter() - start
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def build_libraries(names) -> Dict[str, Tuple[Path, str]]:
    """`build_library` for several kernels, one nvcc process each, all
    started together.  Returns {name: (path, nvcc output)}."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build_library, names)))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`'s shared library."""
    path, _ = build_library(name)
    return ctypes.CDLL(str(path))


__all__ = ["build_library", "build_libraries", "load_library", "BUILD_DIR", "BUILD_SECONDS"]
