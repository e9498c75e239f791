"""Build and load the port's CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C interface (it may
include the shared `csrc/*.cuh` headers).  A name `<name>@<variant>` builds
the same source with the variant's flags (VARIANTS) into a library of its
own: `@depths` builds the chain kernels for 1 to 8 layers, their plain
build for 2 to 4 (csrc/chain_common.cuh).  It is compiled with nvcc for
Hopper (`sm_90a`) into a shared library under `build/kernels/` at the
repository root (listed in .gitignore), at its first use, and loaded with
ctypes.  Importing the package builds nothing.  The library's file name
carries a hash of the source, the headers and the flags, so an edited source
is rebuilt and a stale library is never loaded.  `start_builds` runs one
nvcc per library, at most MAX_NVCC at once, the largest sources first, and
`build_libraries` waits for them.
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
#: nvcc processes `start_builds` runs at once: one a core of the card's
#: 8-core machine.  With 25 sources at once, three a core, the K2 chain
#: form's source built for every depth passed the 600-second limit below (it
#: took 386 s with 18 at once; its 2-4-layer build 323 s with 25).
MAX_NVCC = 8
#: The flags of each variant of a source (a kernel name `<source>@<variant>`).
VARIANTS = {"depths": ("-DCNF_ALL_DEPTHS",)}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def source_of(name: str) -> Tuple[Path, Tuple[str, ...]]:
    """The source of kernel `name` and the flags its variant adds."""
    base, _, variant = name.partition("@")
    return CSRC / f"{base}.cu", VARIANTS[variant] if variant else ()


def build_library(name: str) -> Tuple[Path, str]:
    """Compile kernel `name`'s source unless a library of the same source
    and flags exists.  Returns its path and nvcc's output (empty when
    nothing was compiled)."""
    src, extra = source_of(name)
    flags = NVCC_FLAGS + extra
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
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
            [_nvcc(), *flags, "-o", tmp, str(src)],
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


def start_builds(names) -> Dict[str, concurrent.futures.Future]:
    """Start `build_library` for several kernels, one nvcc process each, at
    most MAX_NVCC (and the cores this process may run on) at once, the
    largest sources first.  Returns {name: future of (path, nvcc output)}."""
    workers = max(1, min(len(names), MAX_NVCC, len(os.sched_getaffinity(0))))
    order = sorted(names, key=lambda n: -source_of(n)[0].stat().st_size)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
    futures = {name: pool.submit(build_library, name) for name in order}
    pool.shutdown(wait=False)
    return {name: futures[name] for name in names}


def build_libraries(names) -> Dict[str, Tuple[Path, str]]:
    """`start_builds` for several kernels, waited for.  Returns {name:
    (path, nvcc output)}."""
    return {name: f.result() for name, f in start_builds(names).items()}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load kernel `name`'s shared library."""
    path, _ = build_library(name)
    return ctypes.CDLL(str(path))


__all__ = ["build_library", "build_libraries", "start_builds", "source_of", "load_library", "BUILD_DIR",
           "BUILD_SECONDS", "VARIANTS"]
