"""ROIAlignV2 (aligned=True): the sample plan, the plain PyTorch version and
the device switch.

Counterpart of the JAX package's ``ops/roi_align.py`` (``roi_sample_geometry``)
and ``ops/roi_align_mxu.py`` (the interpolation-matrix form, the JAX
default). ``roi_align_plain`` is the plain version of the CUDA kernel in
``ops/roi_align_cuda.py``; ``roi_align`` picks one of them by device.

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

from .dispatch import use_kernel


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


def roi_align_plain(features: torch.Tensor, boxes: torch.Tensor,
                    output_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                    sampling_ratio: int = 0,
                    bin_stride: int = 1) -> torch.Tensor:
    """Interpolation-matrix ROIAlign, the plain version of the kernel:
    ``out[r] = Wy[r] @ F @ Wx[r]^T`` in float32, contracting the longer
    spatial axis first."""
    b, _, h, w = features.shape
    s = boxes.shape[1]
    geo = roi_sample_geometry(
        boxes.reshape(-1, 4), spatial_scale, output_size, sampling_ratio,
        bin_stride, feat_hw=(h, w),
    )
    p_out = geo.p_out
    # S = 0 takes the same path: an empty output that autograd still links
    # to the features (their gradient is then 0)
    wy = _interp_matrix(geo.y1, geo.bin_h, geo.grid_y, geo.wy, h, p_out,
                        geo.sy).reshape(b, s, p_out, h)
    wx = _interp_matrix(geo.x1, geo.bin_w, geo.grid_x, geo.wx, w, p_out,
                        geo.sx).reshape(b, s, p_out, w)
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


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              output_size: int = 7, spatial_scale: float = 1.0 / 16.0,
              sampling_ratio: int = 0, bin_stride: int = 1) -> torch.Tensor:
    """ROIAlignV2 on the tensors' device (``ops.dispatch``): for CUDA
    tensors the CUDA kernels, forward and backward, through an autograd
    Function (the gradient goes to the features, not the boxes); for CPU
    tensors the plain version and its autograd."""
    if use_kernel(features):
        from .roi_align_cuda import ROIAlignFunction

        return ROIAlignFunction.apply(features, boxes, output_size,
                                      spatial_scale, sampling_ratio,
                                      bin_stride)
    return roi_align_plain(features, boxes, output_size, spatial_scale,
                           sampling_ratio, bin_stride)
