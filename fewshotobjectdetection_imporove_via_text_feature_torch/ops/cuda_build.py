"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source in ``csrc/`` compiles to its own shared library with a plain C
interface, for ``sm_90a`` (Hopper), into ``build/torch_kernels/`` at the
root of the checkout (listed in ``.gitignore``). A library is named after
the hash of its source and flags, so an edited source is rebuilt and a
built one is reused. Nothing here runs at import time: the first CUDA call
of a wrapper builds what it needs; ``build_all`` builds every kernel at
once, one ``nvcc`` process per source, all started together.

No fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("nms", "roi_align")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of this package are built from source at first use"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfsod_{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (path, job or None if built)."""
    out = library_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, (proc, tmp, cmd)


def _finish(out: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Build every kernel library, one nvcc per source, in parallel.
    Returns the compiler's output per source ("" when already built)."""
    jobs = {name: _start(name) for name in SOURCES}
    return {name: _finish(*jobs[name]) for name in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            out, job = _start(name)
            _finish(out, job)
            lib = ctypes.CDLL(str(out))
            _LOADED[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
