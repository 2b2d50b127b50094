"""Region Proposal Network: anchors, head, fixed-shape proposal selection,
anchor labelling and losses.

Counterpart of the JAX package's ``models/rpn.py``: StandardRPNHead (shared
3x3 conv -> 1x1 objectness + 1x1 deltas), ``select_top_proposals``
(top-k by objectness -> decode -> clip -> drop empty -> NMS with
``max_keep`` -> fixed post-NMS slots with a validity mask),
``label_and_sample_anchors`` and ``rpn_losses``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..ops.box_ops import SCALE_CLAMP, encode_deltas, pairwise_iou, smooth_l1
from ..ops.matcher import match_proposals
from ..ops.nms import nms_auto, top_k
from ..ops.sampler import subsample_labels
from ..structures import GTInstances, Proposals
from .layers import with_bias


def cell_anchors(sizes=(32, 64, 128, 256, 512),
                 aspect_ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """(A, 4) zero-centered anchors; sizes outer x ratios inner."""
    cell = []
    for size in sizes:
        area = float(size) ** 2
        for ratio in aspect_ratios:
            w = np.sqrt(area / ratio)
            h = w * ratio
            cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(cell, np.float32)


def generate_anchors(feat_hw: Tuple[int, int], stride: int = 16,
                     sizes=(32, 64, 128, 256, 512),
                     aspect_ratios=(0.5, 1.0, 2.0),
                     offset: float = 0.0) -> np.ndarray:
    """Dense anchors (H*W*A, 4) float32 in detectron2's
    DefaultAnchorGenerator layout: index (y * W + x) * A + a."""
    cell = cell_anchors(sizes, aspect_ratios)
    h, w = feat_hw
    shift_x = (np.arange(w, dtype=np.float32) + offset) * stride
    shift_y = (np.arange(h, dtype=np.float32) + offset) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + cell[None]).reshape(-1, 4)


class RPNHead(nn.Module):
    """StandardRPNHead. Returns logits (B, H*W*A) and deltas (B, H*W*A, 4),
    both float32, in the (y, x, anchor) order of ``generate_anchors``."""

    def __init__(self, in_channels: int, num_anchors: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(in_channels, num_anchors * 4, 1)

    @staticmethod
    def _conv(conv, x):
        return with_bias(torch.nn.functional.conv2d, x, conv.weight,
                         conv.bias, conv.stride, conv.padding)

    def forward(self, x):
        t = torch.relu(self._conv(self.conv, x))
        logits = self._conv(self.objectness_logits, t)
        deltas = self._conv(self.anchor_deltas, t)
        b = x.shape[0]
        logits = logits.permute(0, 2, 3, 1).reshape(b, -1)
        deltas = deltas.permute(0, 2, 3, 1).reshape(b, -1, 4)
        return logits.float(), deltas.float()


def compact_kept(keep_sorted: torch.Tensor, d: int):
    """Positions (B, d) of the first ``d`` kept entries of each row, in
    order, and their validity: the fixed-slot gather of the JAX package's
    rank/scatter. Rows with fewer kept entries pad with invalid slots."""
    b, n = keep_sorted.shape
    if n < d:
        keep_sorted = torch.nn.functional.pad(keep_sorted, (0, d - n))
    # kept entries first, each group in its original order
    _, pos = torch.sort((~keep_sorted).to(torch.uint8), dim=1, stable=True)
    pos = pos[:, :d]
    valid = torch.gather(keep_sorted, 1, pos)
    return pos.clamp(max=n - 1), valid


def select_top_proposals(pred_logits, pred_deltas, cell, feat_hw, stride,
                         image_hw, pre_nms_topk, post_nms_topk,
                         nms_thresh=0.7, min_size=0.0,
                         bbox_reg_weights=(1.0,) * 4) -> Proposals:
    """find_top_rpn_proposals, fixed shape: logits (B, N), deltas (B, N, 4),
    cell anchors (A, 4), image_hw (B, 2). Anchor geometry is rebuilt from
    the grid arithmetically, in the JAX package's operation order."""
    b, n = pred_logits.shape
    k = min(pre_nms_topk, n)
    fh, fw = feat_hw
    num_a = cell.shape[0]
    dev, dt = pred_logits.device, pred_logits.dtype
    cell = torch.as_tensor(cell, dtype=dt, device=dev)
    cw = cell[:, 2] - cell[:, 0]
    ch = cell[:, 3] - cell[:, 1]
    acx = (torch.arange(fw, dtype=dt, device=dev) * stride)[None, :, None]
    acy = (torch.arange(fh, dtype=dt, device=dev) * stride)[:, None, None]

    d = pred_deltas.reshape(b, fh, fw, num_a, 4)
    wx, wy, ww, wh = bbox_reg_weights
    pcx = d[..., 0] / wx * cw + acx
    pcy = d[..., 1] / wy * ch + acy
    pw = torch.exp(torch.clamp(d[..., 2] / ww, max=SCALE_CLAMP)) * cw
    ph = torch.exp(torch.clamp(d[..., 3] / wh, max=SCALE_CLAMP)) * ch
    img_h = image_hw[:, 0].to(dt)[:, None, None, None]
    img_w = image_hw[:, 1].to(dt)[:, None, None, None]
    zero = torch.zeros((), dtype=dt, device=dev)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)

    boxes_all = torch.stack([
        clip(pcx - 0.5 * pw, img_w), clip(pcy - 0.5 * ph, img_h),
        clip(pcx + 0.5 * pw, img_w), clip(pcy + 0.5 * ph, img_h),
    ], dim=-1).reshape(b, n, 4)

    scores, idx = top_k(pred_logits, k)
    boxes = torch.gather(boxes_all, 1, idx[..., None].expand(b, k, 4))
    valid = ((boxes[..., 2] - boxes[..., 0] > min_size)
             & (boxes[..., 3] - boxes[..., 1] > min_size))
    # scores come out of top_k descending: NMS skips its sort; only the
    # first post_nms_topk kept boxes are used, so it may stop there
    keep, _ = nms_auto(boxes, scores, valid, nms_thresh, assume_sorted=True,
                       max_keep=post_nms_topk)
    pos, out_valid = compact_kept(keep, post_nms_topk)
    out_boxes = torch.gather(boxes, 1, pos[..., None].expand(b, -1, 4))
    out_boxes = torch.where(out_valid[..., None], out_boxes, zero)
    out_scores = torch.where(out_valid, torch.gather(scores, 1, pos),
                             torch.full_like(out_valid, float("-inf"),
                                             dtype=dt))
    return Proposals(boxes=out_boxes, objectness=out_scores, valid=out_valid)


def label_and_sample_anchors(anchors: torch.Tensor, gt: GTInstances,
                             batch_size_per_image: int = 256,
                             positive_fraction: float = 0.5,
                             iou_thresholds=(0.3, 0.7), generator=None,
                             priorities=None):
    """Anchor labels (B, N) int32 in {-1, 0, 1}, subsampled, and the matched
    GT box of every anchor (B, N, 4) float32, for anchors (N, 4) and padded
    GT (B, G). ``generator`` / ``priorities`` as in
    ``ops.sampler.subsample_labels``."""
    iou = pairwise_iou(gt.boxes.float(), anchors)  # (B, G, N)
    matched_idx, labels = match_proposals(
        iou, gt.valid, list(iou_thresholds), [0, -1, 1],
        allow_low_quality_matches=True,
    )
    labels = subsample_labels(labels, batch_size_per_image,
                              positive_fraction, 0, generator, priorities)
    matched = torch.gather(gt.boxes.float(), 1,
                           matched_idx[..., None].expand(-1, -1, 4))
    return labels, matched


def rpn_losses(pred_logits, pred_deltas, anchors, gt_labels, matched_boxes,
               batch_size_per_image: int = 256, smooth_l1_beta: float = 0.0,
               bbox_reg_weights=(1.0, 1.0, 1.0, 1.0),
               loss_weight: float = 1.0, bbox_reg_loss_weight: float = 1.0):
    """Objectness BCE-with-logits over the sampled anchors and (smooth) L1
    on the positives, both over B * batch_size_per_image. logits (B, N),
    deltas (B, N, 4), anchors (N, 4), labels (B, N), matched (B, N, 4)."""
    normalizer = float(pred_logits.shape[0] * batch_size_per_image)
    pos = gt_labels == 1
    gt_deltas = encode_deltas(anchors[None], matched_boxes, bbox_reg_weights)
    loc = smooth_l1(pred_deltas - gt_deltas, smooth_l1_beta)
    zero = torch.zeros((), dtype=loc.dtype, device=loc.device)
    loss_loc = torch.where(pos[..., None], loc, zero).sum() / normalizer
    # the stable form: max(z, 0) - z * y + log(1 + exp(-|z|))
    z = pred_logits
    bce = (torch.clamp(z, min=0.0) - z * pos.to(z.dtype)
           + torch.log1p(torch.exp(-torch.abs(z))))
    loss_cls = torch.where(gt_labels >= 0, bce, zero).sum() / normalizer
    return {
        "loss_rpn_cls": loss_cls * loss_weight,
        "loss_rpn_loc": loss_loc * loss_weight * bbox_reg_loss_weight,
    }
