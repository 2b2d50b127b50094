"""ROIAlignV2 forward as one hand-written CUDA kernel call
(``csrc/roi_align.cu``).

Replaces the JAX package's ``roi_align_mxu`` (``ops/roi_align_mxu.py``);
its plain version is ``ops.roi_align.roi_align_plain``. The wrapper takes
CUDA tensors only: it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = cuda_build.load("roi_align")
    fn = lib.fsod_roi_align_fwd
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def roi_align_cuda(features: torch.Tensor, boxes: torch.Tensor,
                   output_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                   sampling_ratio: int = 0,
                   bin_stride: int = 1) -> torch.Tensor:
    """features (B, C, H, W) float32 or bfloat16, boxes (B, S, 4) float32,
    both on one CUDA device -> (B, S, C, P', P') in the features' dtype
    (a channels-last view of the kernel's (B, S, P', P', C) output)."""
    if not (features.is_cuda and boxes.is_cuda):
        raise ValueError("roi_align_cuda takes CUDA tensors")
    if features.dtype not in _DTYPES:
        raise TypeError(f"roi_align_cuda: features dtype {features.dtype}")
    if features.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or boxes.shape[0] != features.shape[0]:
        raise ValueError(
            f"roi_align_cuda: features {tuple(features.shape)}, boxes "
            f"{tuple(boxes.shape)}"
        )
    b, c, h, w = features.shape
    s = boxes.shape[1]
    p_out = len(range(0, output_size, bin_stride))
    # NHWC: a free view when the features are already channels-last
    nhwc = features.permute(0, 2, 3, 1).contiguous()
    boxes = boxes.to(torch.float32).contiguous()
    out = torch.empty((b, s, p_out, p_out, c), dtype=features.dtype,
                      device=features.device)
    if out.numel():
        fn = _lib()
        with torch.cuda.device(features.device):
            err = fn(
                nhwc.data_ptr(), _DTYPES[features.dtype], boxes.data_ptr(),
                out.data_ptr(), b, h, w, c, s, output_size, bin_stride,
                float(spatial_scale), sampling_ratio,
                torch.cuda.current_stream(features.device).cuda_stream,
            )
        cuda_build.check(err, "fsod_roi_align_fwd")
        roi_align_cuda.launches += 1
    return out.permute(0, 1, 4, 2, 3)


roi_align_cuda.launches = 0
