"""ctypes binding for the repository's native data-IO core
(``csrc/fsodtf_dataio.cpp``, framework-free C++: libjpeg decode,
shortest-edge resize, flip and a padded float32 canvas, OpenMP).

Counterpart of the JAX package's ``data/native_io.py``, with its contract:
``load_image`` returns None when the core cannot be built or loaded, or a
file cannot be decoded, and the mapper then decodes with PIL. That is the
data path's own fallback, not a kernel's: the native core and PIL decode
the same file. Which path was taken is logged once per process.

The core is built with ``g++`` at first use into ``build/torch_kernels/``
at the root of the checkout (listed in ``.gitignore``), under a name that
hashes the source and flags, through a temporary file and a rename, so that
concurrent processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "csrc" / "fsodtf_dataio.cpp"
BUILD_DIR = ROOT / "build" / "torch_kernels"
FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp")
LIBS = ("-ljpeg",)

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(FLAGS + LIBS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libfsodtf_dataio-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise OSError(f"{' '.join(cmd)} failed: {proc.stderr.strip()}")
    os.replace(tmp, out)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except OSError as e:  # no g++, no libjpeg, no source: PIL decodes
            logger.warning("native data-IO core unavailable (%s); images "
                           "are decoded with PIL", e)
            return None
        lib.fsodtf_load_image.restype = ctypes.c_int
        lib.fsodtf_load_image.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        logger.info("images are decoded by the native data-IO core (%s)",
                    out)
    return _lib


def available() -> bool:
    return _load() is not None


def load_image(path: str, short_edge: int, max_size: int, out_hw,
               flip: bool = False, bgr: bool = True):
    """Decode, resize, flip and pad one JPEG natively.

    Returns (canvas float32 (H, W, 3), new_hw (2,), orig_hw (2,)), or None
    when the core is unavailable or the file could not be decoded."""
    lib = _load()
    if lib is None:
        return None
    oh, ow = out_hw
    canvas = np.zeros((oh, ow, 3), np.float32)
    new_hw = np.zeros(2, np.int32)
    orig_hw = np.zeros(2, np.int32)
    rc = lib.fsodtf_load_image(
        path.encode(), int(short_edge), int(max_size), int(oh), int(ow),
        int(bool(flip)), int(bool(bgr)),
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        new_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        orig_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if rc != 0:
        return None
    return canvas, new_hw, orig_hw
