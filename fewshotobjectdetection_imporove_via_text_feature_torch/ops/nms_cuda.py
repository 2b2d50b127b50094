"""Greedy NMS as one hand-written CUDA kernel call (``csrc/nms.cu``).

Replaces the JAX package's Pallas kernel ``_nms_kernel``
(``ops/nms_pallas.py``); its plain version is ``ops.nms.nms_sorted_plain``,
whose keep mask it reproduces bit for bit. The wrapper takes CUDA tensors
only: it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_BLOCK = 64


def _lib():
    lib = cuda_build.load("nms")
    fn = lib.fsod_nms_sorted
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


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
    col_blocks = -(-n // _BLOCK)
    mask = torch.empty((b, n, col_blocks), dtype=torch.int64,
                       device=boxes.device)
    fn = _lib()
    with torch.cuda.device(boxes.device):
        err = fn(
            boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(),
            keep.data_ptr(), b, n, float(iou_threshold),
            -1 if max_keep is None else int(max_keep),
            torch.cuda.current_stream(boxes.device).cuda_stream,
        )
    cuda_build.check(err, "fsod_nms_sorted")
    nms_sorted_cuda.launches += 1
    return keep


nms_sorted_cuda.launches = 0
