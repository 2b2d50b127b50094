"""The hand-written kernels as PyTorch operators: ``fsod::nms_sorted``,
``fsod::roi_align`` and ``fsod::roi_align_backward``.

Each operator's CUDA implementation is the kernel's launcher
(``ops/nms_cuda.py``, ``ops/roi_align_cuda.py``: it launches or raises, and
counts its launches); its CPU implementation is the kernel's plain version
(``ops/nms.py``, ``ops/roi_align.py``). A ``register_fake`` gives each
output's shape, dtype and strides, so ``torch.export`` traces a model
through the operators without running them: an exported program run on
the card launches the kernels, the same program on the CPU runs the plain
versions. ``fsod::roi_align`` takes its gradient from
``fsod::roi_align_backward`` (to the features only; the boxes are detached
proposals and ground truth).

Scalars are schema ``int`` and ``float`` arguments; NMS's ``max_keep`` is
-1 for none. The plain versions' host syncs (the NMS sweep's early exit)
stay inside the CPU implementations, where tracing never enters.
"""

from __future__ import annotations

from typing import List

import torch

from .nms import nms_sorted_plain
from .roi_align import roi_align_backward_plain, roi_align_plain


def _p_out(output_size: int, bin_stride: int) -> int:
    return len(range(0, output_size, bin_stride))


# ---------------------------------------------------------------- NMS --
@torch.library.custom_op("fsod::nms_sorted", mutates_args=(),
                         device_types="cpu")
def nms_sorted(boxes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float, max_keep: int) -> torch.Tensor:
    """Keep mask (B, N) bool of score-sorted boxes (B, N, 4) float32 with
    valid (B, N) bool; ``max_keep`` < 0 means no limit."""
    return nms_sorted_plain(boxes, valid, iou_threshold,
                            None if max_keep < 0 else max_keep).contiguous()


@nms_sorted.register_kernel("cuda")
def _nms_sorted_cuda(boxes, valid, iou_threshold, max_keep):
    from .nms_cuda import nms_sorted_cuda

    return nms_sorted_cuda(boxes, valid, iou_threshold,
                           None if max_keep < 0 else max_keep)


@nms_sorted.register_fake
def _nms_sorted_fake(boxes, valid, iou_threshold, max_keep):
    return torch.empty(valid.shape, dtype=torch.bool, device=valid.device)


# ------------------------------------------------------------ ROIAlign --
@torch.library.custom_op("fsod::roi_align", mutates_args=(),
                         device_types="cpu")
def roi_align_op(features: torch.Tensor, boxes: torch.Tensor,
                 output_size: int, spatial_scale: float, sampling_ratio: int,
                 bin_stride: int) -> torch.Tensor:
    """ROIAlignV2 of features (B, C, H, W) at boxes (B, S, 4) ->
    (B, S, C, P', P') in the features' dtype."""
    return roi_align_plain(features, boxes, output_size, spatial_scale,
                           sampling_ratio, bin_stride).contiguous()


@roi_align_op.register_kernel("cuda")
def _roi_align_cuda(features, boxes, output_size, spatial_scale,
                    sampling_ratio, bin_stride):
    from .roi_align_cuda import roi_align_cuda

    return roi_align_cuda(features, boxes, output_size, spatial_scale,
                          sampling_ratio, bin_stride)


@roi_align_op.register_fake
def _roi_align_fake(features, boxes, output_size, spatial_scale,
                    sampling_ratio, bin_stride):
    b, c = features.shape[:2]
    s = boxes.shape[1]
    p = _p_out(output_size, bin_stride)
    if features.device.type == "cuda":
        # the kernel writes (B, S, P', P', C) and returns a permuted view
        return features.new_empty((b, s, p, p, c)).permute(0, 1, 4, 2, 3)
    return features.new_empty((b, s, c, p, p))


@torch.library.custom_op("fsod::roi_align_backward", mutates_args=(),
                         device_types="cpu")
def roi_align_backward(grad: torch.Tensor, boxes: torch.Tensor,
                       feature_shape: List[int], output_size: int,
                       spatial_scale: float, sampling_ratio: int,
                       bin_stride: int) -> torch.Tensor:
    """The gradient of ``fsod::roi_align`` to features of ``feature_shape``
    (B, C, H, W), in grad's dtype."""
    return roi_align_backward_plain(grad, boxes, feature_shape, output_size,
                                    spatial_scale, sampling_ratio,
                                    bin_stride).contiguous()


@roi_align_backward.register_kernel("cuda")
def _roi_align_backward_cuda(grad, boxes, feature_shape, output_size,
                             spatial_scale, sampling_ratio, bin_stride):
    from .roi_align_cuda import roi_align_bwd_cuda

    return roi_align_bwd_cuda(grad, boxes, tuple(feature_shape), output_size,
                              spatial_scale, sampling_ratio, bin_stride)


@roi_align_backward.register_fake
def _roi_align_backward_fake(grad, boxes, feature_shape, output_size,
                             spatial_scale, sampling_ratio, bin_stride):
    b, c, h, w = feature_shape
    if grad.device.type == "cuda":
        # the kernel writes an NHWC gradient
        return grad.new_empty((b, h, w, c)).permute(0, 3, 1, 2)
    return grad.new_empty((b, c, h, w))


def _roi_align_setup_context(ctx, inputs, output):
    features, boxes, output_size, spatial_scale, sampling_ratio, \
        bin_stride = inputs
    ctx.save_for_backward(boxes)
    ctx.args = (list(features.shape), output_size, spatial_scale,
                sampling_ratio, bin_stride)


def _roi_align_grad(ctx, grad):
    (boxes,) = ctx.saved_tensors
    grad_features = None
    if ctx.needs_input_grad[0]:
        grad_features = roi_align_backward(grad, boxes, *ctx.args)
    return grad_features, None, None, None, None, None


roi_align_op.register_autograd(_roi_align_grad,
                               setup_context=_roi_align_setup_context)
