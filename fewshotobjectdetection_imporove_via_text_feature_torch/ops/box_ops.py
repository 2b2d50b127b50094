"""Box geometry ops on XYXY float tensors of shape (..., 4).

Same formulas and the same operation order as the JAX package's
``ops/box_ops.py`` (detectron2 ``pairwise_iou`` / ``Box2BoxTransform`` /
``Boxes.clip``), so float32 results agree bit for bit where the order of
operations decides a comparison (NMS).
"""

from __future__ import annotations

import math

import torch

# detectron2 clamps predicted dw/dh so exp() cannot overflow:
# _DEFAULT_SCALE_CLAMP = log(1000.0 / 16).
SCALE_CLAMP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of XYXY boxes; shape (..., 4) -> (...)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix (..., M, N) between boxes1 (..., M, 4) and boxes2
    (..., N, 4); a non-positive union gives 0."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    pos = union > 0
    return torch.where(
        pos, inter / torch.where(pos, union, torch.ones_like(union)),
        torch.zeros_like(union),
    )


def decode_deltas(
    deltas: torch.Tensor,
    boxes: torch.Tensor,
    weights=(1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas: deltas (..., K*4) against boxes
    (..., 4) -> (..., K*4) XYXY; dw/dh clamped at ``SCALE_CLAMP``."""
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    shape = deltas.shape
    dx = deltas[..., 0::4] / wx
    dy = deltas[..., 1::4] / wy
    dw = torch.clamp(deltas[..., 2::4] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(deltas[..., 3::4] / wh, max=SCALE_CLAMP)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]
    out = torch.stack(
        [
            pred_cx - 0.5 * pred_w,
            pred_cy - 0.5 * pred_h,
            pred_cx + 0.5 * pred_w,
            pred_cy + 0.5 * pred_h,
        ],
        dim=-1,
    )
    return out.reshape(shape)


def clip_boxes(boxes: torch.Tensor, image_hw) -> torch.Tensor:
    """Clip XYXY boxes to [0, w] x [0, h]; ``image_hw = (h, w)``, floats or
    tensors broadcastable against ``boxes[..., 0]``."""
    h, w = image_hw
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    h = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty_mask(boxes: torch.Tensor, threshold: float = 0.0):
    """Boxes.nonempty: width > threshold AND height > threshold."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)
