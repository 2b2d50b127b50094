"""ROIAlignV2 (aligned=True): the sample plan, the plain PyTorch version and
the device switch.

Counterpart of the JAX package's ``ops/roi_align.py`` (``roi_sample_geometry``)
and ``ops/roi_align_mxu.py`` (the interpolation-matrix form, the JAX
default). ``roi_align_plain`` is the plain version of the CUDA kernels in
``ops/roi_align_cuda.py``, its gradient ``roi_align_backward_plain`` that
of the backward kernel; ``roi_align`` picks the kernels or the plain
versions by device, through the ``fsod::roi_align`` operator.

Semantics (the JAX package's, detectron2's ROIAlignV2 with its documented
deviations):
  * continuous coordinates: x_feat = x_img * spatial_scale - 0.5;
  * bin size max(roi_size, 1e-6) / P;
  * ``sampling_ratio`` S > 0: S x S samples per bin at (j + 0.5) / S;
    ``sampling_ratio`` 0 (adaptive): g = ceil(roi_size / P) samples per
    axis, capped at the static ceil(feat_size / P) (PARITY #1), g = 0
    (a degenerate axis) gives 0;
  * samples outside [-1, size] contribute 0; the others are clamped to
    [0, size - 1] and read bilinearly;
  * ``bin_stride``: only the bins range(0, P, bin_stride) are emitted.

Layouts: features (B, C, H, W); boxes (B, S, 4) XYXY in image coordinates;
output (B, S, C, P', P') in the features' dtype. The plain version computes
in float32 (float64 for float64 features) and rounds once to the features'
dtype, as the kernel does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .dispatch import use_operator


class ROISampleGeometry(NamedTuple):
    """Per-axis sample plan; leading dim R, or 1 when shared by all ROIs."""

    y1: torch.Tensor      # (R,) continuous ROI starts, feature coords
    x1: torch.Tensor
    bin_h: torch.Tensor   # (R,) bin sizes (1e-6 degenerate clamp)
    bin_w: torch.Tensor
    grid_y: torch.Tensor  # (R|1, P'*Sy) in-ROI sample offsets (bin units)
    grid_x: torch.Tensor  # (R|1, P'*Sx)
    wy: torch.Tensor      # (R|1, Sy) per-sample averaging weights
    wx: torch.Tensor      # (R|1, Sx)
    p_out: int            # emitted bins per axis
    sy: int               # sample slots per bin along y
    sx: int


def roi_sample_geometry(boxes: torch.Tensor, spatial_scale: float,
                        output_size: int, sampling_ratio: int,
                        bin_stride: int, feat_hw=None) -> ROISampleGeometry:
    """The aligned=True sample plan of ROIs ``boxes`` (R, 4), in float32:
    the same operations, in the same order, as the JAX function of the same
    name. ``feat_hw`` (static H, W) is needed for adaptive sampling."""
    p = output_size
    s = sampling_ratio
    dev = boxes.device
    f32 = torch.float32
    # divisors as device tensors: CUDA divides by a host scalar as a
    # multiplication by its reciprocal, one rounding off the true quotient
    p_t = torch.tensor(float(p), dtype=f32, device=dev)
    boxes = boxes.to(f32)
    x1 = boxes[:, 0] * spatial_scale - 0.5
    y1 = boxes[:, 1] * spatial_scale - 0.5
    x2 = boxes[:, 2] * spatial_scale - 0.5
    y2 = boxes[:, 3] * spatial_scale - 0.5
    bin_w = torch.clamp(x2 - x1, min=1e-6) / p_t
    bin_h = torch.clamp(y2 - y1, min=1e-6) / p_t
    bins = torch.arange(0, p, bin_stride, dtype=f32, device=dev)
    p_out = len(range(0, p, bin_stride))

    if s > 0:
        s_t = torch.tensor(float(s), dtype=f32, device=dev)
        sub = (torch.arange(s, dtype=f32, device=dev)[None, :] + 0.5) / s_t
        grid = (bins[:, None] + sub).reshape(1, -1)  # (1, P'*S)
        w = torch.full((1, s), 1.0 / s, dtype=f32, device=dev)
        return ROISampleGeometry(
            y1, x1, bin_h, bin_w, grid, grid, w, w, p_out, s, s
        )

    if feat_hw is None:
        raise ValueError("sampling_ratio=0 (adaptive) needs feat_hw")
    h, w_ = feat_hw
    sy = max(1, -(-int(h) // p))
    sx = max(1, -(-int(w_) // p))

    def axis(raw_size, cap):
        g = torch.clamp(torch.ceil(raw_size / p_t), 0.0, float(cap))
        gs = torch.clamp(g, min=1.0)[:, None]  # (R, 1)
        j = torch.arange(cap, dtype=f32, device=dev)
        wgt = torch.where(j[None, :] < g[:, None], 1.0, 0.0) / gs
        grid = (
            bins[None, :, None] + (j[None, None, :] + 0.5) / gs[:, :, None]
        ).reshape(raw_size.shape[0], p_out * cap)  # (R, P'*cap); R may be 0
        return grid, wgt

    grid_y, wy = axis(y2 - y1, sy)
    grid_x, wx = axis(x2 - x1, sx)
    return ROISampleGeometry(
        y1, x1, bin_h, bin_w, grid_y, grid_x, wy, wx, p_out, sy, sx
    )


def _interp_matrix(start, bin_size, grid, wsamp, size: int, p_out: int,
                   s: int) -> torch.Tensor:
    """(R, P', size) averaged bilinear weights of each emitted bin against
    the ``size`` feature positions along one axis."""
    t = start[:, None] + grid * bin_size[:, None]  # (R, P'*S)
    oob = (t < -1.0) | (t > size)
    tc = torch.clamp(t, 0.0, size - 1.0)
    pos = torch.arange(size, dtype=t.dtype, device=t.device)
    w = torch.clamp(1.0 - torch.abs(tc[:, :, None] - pos), min=0.0)
    w = torch.where(oob[:, :, None], 0.0, w)
    r = start.shape[0]
    w = w.reshape(r, p_out, s, size) * wsamp[:, None, :, None]
    return w.sum(dim=2)


def _interp_weights(boxes: torch.Tensor, feature_shape, output_size: int,
                    spatial_scale: float, sampling_ratio: int,
                    bin_stride: int):
    """The averaged bilinear weights of boxes (B, S, 4) on a map of
    ``feature_shape`` (B, C, H, W): Wy (B, S, P', H) and Wx (B, S, P', W),
    float32."""
    b, _, h, w = feature_shape
    s = boxes.shape[1]
    geo = roi_sample_geometry(
        boxes.reshape(-1, 4), spatial_scale, output_size, sampling_ratio,
        bin_stride, feat_hw=(h, w),
    )
    p_out = geo.p_out
    wy = _interp_matrix(geo.y1, geo.bin_h, geo.grid_y, geo.wy, h, p_out,
                        geo.sy).reshape(b, s, p_out, h)
    wx = _interp_matrix(geo.x1, geo.bin_w, geo.grid_x, geo.wx, w, p_out,
                        geo.sx).reshape(b, s, p_out, w)
    return wy, wx


def _roi_align_plain_forward(features, boxes, output_size, spatial_scale,
                             sampling_ratio, bin_stride):
    h, w = features.shape[2:]
    wy, wx = _interp_weights(boxes, features.shape, output_size,
                             spatial_scale, sampling_ratio, bin_stride)
    acc = torch.promote_types(features.dtype, torch.float32)
    feat = features.to(acc)
    wy, wx = wy.to(acc), wx.to(acc)
    # contracting the longer axis first keeps the intermediate smaller
    if w >= h:
        g = torch.einsum("brqw,bchw->brqch", wx, feat)
        out = torch.einsum("brph,brqch->brcpq", wy, g)
    else:
        g = torch.einsum("brph,bchw->brpcw", wy, feat)
        out = torch.einsum("brqw,brpcw->brcpq", wx, g)
    return out.to(features.dtype)


def roi_align_backward_plain(grad: torch.Tensor, boxes: torch.Tensor,
                             feature_shape, output_size: int = 7,
                             spatial_scale: float = 1.0 / 16.0,
                             sampling_ratio: int = 0,
                             bin_stride: int = 1) -> torch.Tensor:
    """The gradient of ROIAlign to features of ``feature_shape`` (B, C,
    H, W): ``Wy[r]^T @ G[r] @ Wx[r]`` summed over the ROIs in float32
    (float64 for a float64 grad), rounded once to grad's dtype; the plain
    version of the backward kernel. The contractions run in the reverse
    order of the forward's."""
    h, w = feature_shape[2:]
    wy, wx = _interp_weights(boxes, feature_shape, output_size,
                             spatial_scale, sampling_ratio, bin_stride)
    acc = torch.promote_types(grad.dtype, torch.float32)
    g = grad.to(acc)
    wy, wx = wy.to(acc), wx.to(acc)
    if w >= h:
        t = torch.einsum("brph,brcpq->brqch", wy, g)
        out = torch.einsum("brqw,brqch->bchw", wx, t)
    else:
        t = torch.einsum("brqw,brcpq->brpcw", wx, g)
        out = torch.einsum("brph,brpcw->bchw", wy, t)
    return out.to(grad.dtype)


class _PlainROIAlign(torch.autograd.Function):
    """``_roi_align_plain_forward`` with ``roi_align_backward_plain`` as its
    backward: the plain pair states what the kernel pair computes. The
    gradient goes to the features (the boxes are detached proposals)."""

    @staticmethod
    def forward(ctx, features, boxes, output_size, spatial_scale,
                sampling_ratio, bin_stride):
        ctx.save_for_backward(boxes)
        ctx.args = (tuple(features.shape), output_size, spatial_scale,
                    sampling_ratio, bin_stride)
        return _roi_align_plain_forward(features, boxes, output_size,
                                        spatial_scale, sampling_ratio,
                                        bin_stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (boxes,) = ctx.saved_tensors
        grad_features = None
        if ctx.needs_input_grad[0]:
            grad_features = roi_align_backward_plain(grad, boxes, *ctx.args)
        return grad_features, None, None, None, None, None


def roi_align_plain(features: torch.Tensor, boxes: torch.Tensor,
                    output_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                    sampling_ratio: int = 0,
                    bin_stride: int = 1) -> torch.Tensor:
    """Interpolation-matrix ROIAlign, the plain version of the kernel:
    ``out[r] = Wy[r] @ F @ Wx[r]^T`` in float32, contracting the longer
    spatial axis first; its gradient is ``roi_align_backward_plain`` (S = 0
    ROIs give an empty output and a zero gradient)."""
    return _PlainROIAlign.apply(features, boxes, output_size, spatial_scale,
                                sampling_ratio, bin_stride)


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              output_size: int = 7, spatial_scale: float = 1.0 / 16.0,
              sampling_ratio: int = 0, bin_stride: int = 1) -> torch.Tensor:
    """ROIAlignV2 on the tensors' device (``ops.dispatch``) through the
    ``fsod::roi_align`` operator (``ops/custom_ops.py``): for CUDA tensors
    the CUDA kernels, forward and backward (the gradient goes to the
    features, not the boxes); for CPU tensors the plain version and its
    autograd. Inside ``plain_ops()`` CUDA tensors take the plain version."""
    if not use_operator(features):
        return roi_align_plain(features, boxes, output_size, spatial_scale,
                               sampling_ratio, bin_stride)
    return torch.ops.fsod.roi_align(features, boxes, int(output_size),
                                    float(spatial_scale), int(sampling_ratio),
                                    int(bin_stride))
