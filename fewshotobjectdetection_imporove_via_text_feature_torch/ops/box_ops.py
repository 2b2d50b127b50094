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


def encode_deltas(
    src_boxes: torch.Tensor,
    target_boxes: torch.Tensor,
    weights=(1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Box2BoxTransform.get_deltas: (dx, dy, dw, dh) from ``src_boxes`` to
    ``target_boxes`` (..., 4). Non-positive widths and heights are replaced
    by 1 so that padded boxes give finite deltas, which the caller masks."""
    wx, wy, ww, wh = weights
    src_w = src_boxes[..., 2] - src_boxes[..., 0]
    src_h = src_boxes[..., 3] - src_boxes[..., 1]
    src_cx = src_boxes[..., 0] + 0.5 * src_w
    src_cy = src_boxes[..., 1] + 0.5 * src_h

    tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
    tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
    tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
    tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

    one = torch.ones((), dtype=src_w.dtype, device=src_w.device)
    safe_w = torch.where(src_w > 0, src_w, one)
    safe_h = torch.where(src_h > 0, src_h, one)
    safe_tw = torch.where(tgt_w > 0, tgt_w, one)
    safe_th = torch.where(tgt_h > 0, tgt_h, one)

    dx = wx * (tgt_cx - src_cx) / safe_w
    dy = wy * (tgt_cy - src_cy) / safe_h
    dw = ww * torch.log(safe_tw / safe_w)
    dh = wh * torch.log(safe_th / safe_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def smooth_l1(diff: torch.Tensor, beta: float) -> torch.Tensor:
    """Elementwise smooth L1 of box-delta differences (fvcore's
    ``smooth_l1_loss`` without reduction); plain L1 at beta 0."""
    ad = torch.abs(diff)
    if beta > 0:
        return torch.where(ad < beta, 0.5 * diff * diff / beta,
                           ad - 0.5 * beta)
    return ad


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
