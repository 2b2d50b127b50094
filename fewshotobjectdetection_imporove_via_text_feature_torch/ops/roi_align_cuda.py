"""ROIAlignV2 forward and backward as hand-written CUDA kernel calls
(``csrc/roi_align.cu``); ``ops/custom_ops.py`` makes them the CUDA
implementations of ``fsod::roi_align`` and its gradient.

Replaces the JAX package's ``roi_align_mxu`` (``ops/roi_align_mxu.py``) and
its autodiff gradient; the plain versions are
``ops.roi_align.roi_align_plain`` and its autograd. The wrappers take CUDA
tensors only: they launch their kernel or raise. The forward kernel takes
any C: it reads 8 channels a thread with 16-byte loads where C is a
multiple of 8 and the bases are 16-byte aligned, and channel by channel
elsewhere. The backward kernel gathers over tiles of pixels: it writes
every element of the gradient once, in grad_out's dtype (bf16 rounded once
from a float32 sum), summing in a fixed order, so two launches on the same
inputs give bitwise-equal gradients.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward kernel's tile of pixels, rows x columns: kTileH and kTileW in
# csrc/roi_align.cu, which a test reads to hold these to them
BWD_TILE_ROWS, BWD_TILE_COLS = 16, 8


def _lib(name="fsod_roi_align_fwd"):
    fn = getattr(cuda_build.load("roi_align"), name)
    if fn.argtypes is None:
        # (data, dtype, boxes, out, b, h, w, c, s, p, bin_stride, scale,
        #  sampling, stream)
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


def roi_align_bwd_cuda(grad_out: torch.Tensor, boxes: torch.Tensor,
                       feature_shape, output_size: int = 7,
                       spatial_scale: float = 1.0 / 16.0,
                       sampling_ratio: int = 0,
                       bin_stride: int = 1) -> torch.Tensor:
    """The gradient of ``roi_align_cuda`` with respect to the features:
    grad_out (B, S, C, P', P') float32 or bfloat16 and boxes (B, S, 4) on
    one CUDA device, feature_shape (B, C, H, W) -> (B, C, H, W) in
    grad_out's dtype, a channels-last view of the kernel's NHWC output."""
    if not (grad_out.is_cuda and boxes.is_cuda):
        raise ValueError("roi_align_bwd_cuda takes CUDA tensors")
    if grad_out.dtype not in _DTYPES:
        raise TypeError(f"roi_align_bwd_cuda: grad dtype {grad_out.dtype}")
    b, c, h, w = feature_shape
    s = boxes.shape[1]
    p_out = len(range(0, output_size, bin_stride))
    if tuple(grad_out.shape) != (b, s, c, p_out, p_out) \
            or tuple(boxes.shape) != (b, s, 4):
        raise ValueError(
            f"roi_align_bwd_cuda: grad {tuple(grad_out.shape)}, boxes "
            f"{tuple(boxes.shape)}, features {tuple(feature_shape)}"
        )
    dev = grad_out.device
    if s == 0 or b * h * w * c == 0:  # no ROI: no launch
        return torch.zeros((b, h, w, c), dtype=grad_out.dtype,
                           device=dev).permute(0, 3, 1, 2)
    # the kernel's (B, S, P', P', C) order: free when grad_out is the
    # permuted view the forward returned
    g = grad_out.permute(0, 1, 3, 4, 2).contiguous()
    boxes = boxes.to(torch.float32).contiguous()
    # the kernel writes every element, zeros included
    grad = torch.empty((b, h, w, c), dtype=grad_out.dtype, device=dev)
    fn = _lib("fsod_roi_align_bwd")
    with torch.cuda.device(dev):
        err = fn(
            g.data_ptr(), _DTYPES[grad_out.dtype], boxes.data_ptr(),
            grad.data_ptr(), b, h, w, c, s, output_size, bin_stride,
            float(spatial_scale), sampling_ratio,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(err, "fsod_roi_align_bwd")
    roi_align_bwd_cuda.launches += 1
    return grad.permute(0, 3, 1, 2)


roi_align_bwd_cuda.launches = 0

