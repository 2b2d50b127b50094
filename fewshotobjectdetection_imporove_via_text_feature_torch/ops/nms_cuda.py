"""Greedy NMS as one call of the hand-written CUDA kernels in
``csrc/nms.cu``: two launches per 1024-box chunk, all on the current stream.

Replaces the JAX package's Pallas kernel ``_nms_kernel``
(``ops/nms_pallas.py``); its plain version is ``ops.nms.nms_sorted_plain``,
whose keep mask it reproduces bit for bit. The wrapper takes CUDA tensors
only: it launches the kernels or raises. ``nms_sorted_cuda.launches``
counts calls, one per call; ``kernel_launches_per_call`` gives the kernel
launches each makes.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build


def _lib():
    lib = cuda_build.load("nms")
    if lib.fsod_nms_sorted.argtypes is None:
        lib.fsod_nms_sorted.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.fsod_nms_sorted.restype = ctypes.c_int
        lib.fsod_nms_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.fsod_nms_scratch_bytes.restype = ctypes.c_longlong
        lib.fsod_nms_launches.argtypes = [ctypes.c_int]
        lib.fsod_nms_launches.restype = ctypes.c_int
    return lib


def kernel_launches_per_call(n: int) -> int:
    """Kernel launches one ``nms_sorted_cuda`` call over N boxes makes."""
    return _lib().fsod_nms_launches(n)


def nms_sorted_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float, max_keep: int | None = None):
    """Keep mask (B, N) bool for score-sorted boxes (B, N, 4) float32 and
    valid (B, N) bool on one CUDA device; see ``nms_sorted_plain``."""
    if not (boxes.is_cuda and valid.is_cuda):
        raise ValueError("nms_sorted_cuda takes CUDA tensors")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(
            f"nms_sorted_cuda: boxes float32 and valid bool, got "
            f"{boxes.dtype} and {valid.dtype}"
        )
    b, n = valid.shape
    if boxes.shape != (b, n, 4):
        raise ValueError(f"boxes {tuple(boxes.shape)} vs valid {(b, n)}")
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return keep
    boxes = boxes.contiguous()
    valid = valid.contiguous()
    lib = _lib()
    scratch = torch.empty((lib.fsod_nms_scratch_bytes(b, n),),
                          dtype=torch.uint8, device=boxes.device)
    with torch.cuda.device(boxes.device):
        err = lib.fsod_nms_sorted(
            boxes.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
            keep.data_ptr(), b, n, float(iou_threshold),
            -1 if max_keep is None else int(max_keep),
            torch.cuda.current_stream(boxes.device).cuda_stream,
        )
    cuda_build.check(err, "fsod_nms_sorted")
    nms_sorted_cuda.launches += 1
    return keep


nms_sorted_cuda.launches = 0
