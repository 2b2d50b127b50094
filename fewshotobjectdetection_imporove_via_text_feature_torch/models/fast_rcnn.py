"""Fast R-CNN output layers, losses and fixed-shape inference.

Counterpart of the JAX package's ``models/fast_rcnn.py``. Inference:
softmax -> drop the background column -> score threshold -> a static
candidate budget by top-k -> class-offset NMS with ``max_keep`` -> the first
``topk_per_image`` kept detections in fixed slots. Training: softmax cross
entropy and (smooth) L1 over a fixed grid of sampled slots, and the cls
dropout of the gfsod fine-tunes.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.box_ops import clip_boxes, decode_deltas, encode_deltas, smooth_l1
from ..parallel.collectives import global_normalizer, local_rand
from ..ops.nms import batched_nms_fixed, top_k
from .rpn import compact_kept


def cls_dropout(x: torch.Tensor, rate: float, generator=None):
    """flax ``nn.Dropout``: each value kept with probability 1 - rate (a
    uniform draw from ``generator`` below it) and scaled by 1 / (1 - rate),
    the others 0. Rows are ROIs of the batch: under a process group the
    draw covers the global batch and this rank keeps its rows."""
    keep = 1.0 - rate
    mask = local_rand(x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class FastRCNNOutputLayers(nn.Module):
    """Linear cls (K+1) and box (4K, or 4 class-agnostic) heads, float32.
    ``att_x``, when given, is the cls input in place of ``x`` (ref
    fast_rcnn.py:403-417): ``cls_in_features`` is its width (the text and
    semantic heads' attended features, or the K+1 attention scores of the
    cross-output head). With ``attention_scores_as_logits``
    (FastRCNNAttentionOutputLayers) the cls input is the scores and there
    is no ``cls_score``. With ``cls_dropout``, the cls input (not the box
    input) goes through dropout at ``dropout_ratio`` in training."""

    def __init__(self, in_features: int, num_classes: int,
                 cls_agnostic_bbox_reg: bool = False, box_dim: int = 4,
                 cls_dropout: bool = False, dropout_ratio: float = 0.8,
                 cls_in_features: int = None,
                 attention_scores_as_logits: bool = False):
        super().__init__()
        num_reg = 1 if cls_agnostic_bbox_reg else num_classes
        self.cls_score = None
        if not attention_scores_as_logits:
            self.cls_score = nn.Linear(cls_in_features or in_features,
                                       num_classes + 1)
        self.bbox_pred = nn.Linear(in_features, num_reg * box_dim)
        self.cls_dropout = cls_dropout
        self.dropout_ratio = dropout_ratio

    def forward(self, x, att_x=None, train: bool = False, generator=None):
        if x.dim() > 2:
            x = x.flatten(1)
        cls_in = x if att_x is None else att_x
        if self.cls_dropout and train:
            cls_in = cls_dropout(cls_in, self.dropout_ratio, generator)
        scores = cls_in if self.cls_score is None else self.cls_score(cls_in)
        return scores, self.bbox_pred(x)


def fast_rcnn_losses(pred_logits, pred_deltas, proposal_boxes, gt_boxes,
                     gt_classes, valid, num_classes: int,
                     box_reg_weights=(10.0, 10.0, 5.0, 5.0),
                     smooth_l1_beta: float = 0.0):
    """Softmax cross entropy (mean over valid slots) and (smooth) L1 on the
    foreground slots' class-specific deltas (sum over the valid count).
    pred_logits (R, K+1), pred_deltas (R, 4K) or (R, 4), proposal_boxes and
    gt_boxes (R, 4), gt_classes (R,) in [0, K] (K background), valid (R,).
    The valid count is the global batch's (``global_normalizer``)."""
    r = pred_logits.shape[0]
    nvalid = global_normalizer(valid.sum())
    zero = torch.zeros((), dtype=pred_logits.dtype,
                       device=pred_logits.device)
    logp = torch.log_softmax(pred_logits, dim=-1)
    safe_cls = torch.clamp(gt_classes, 0, num_classes).long()
    ce = -logp.gather(1, safe_cls[:, None])[:, 0]
    loss_cls = torch.where(valid, ce, zero).sum() / nvalid

    fg = valid & (gt_classes >= 0) & (gt_classes < num_classes)
    gt_deltas = encode_deltas(proposal_boxes, gt_boxes, box_reg_weights)
    if pred_deltas.shape[-1] == 4:
        pd = pred_deltas
    else:
        cls_idx = torch.clamp(gt_classes, 0, num_classes - 1).long()
        pd = pred_deltas.reshape(r, num_classes, 4).gather(
            1, cls_idx[:, None, None].expand(r, 1, 4))[:, 0]
    l1 = smooth_l1(pd - gt_deltas, smooth_l1_beta)
    loss_box = torch.where(fg[:, None], l1, zero).sum() / nvalid
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box}


def fast_rcnn_inference(pred_logits, pred_deltas, proposal_boxes,
                        proposal_valid, image_hw, num_classes: int,
                        score_thresh: float = 0.05, nms_thresh: float = 0.5,
                        topk_per_image: int = 100, candidate_topk: int = 1024,
                        box_reg_weights=(10.0, 10.0, 5.0, 5.0)):
    """Batched fixed-shape Fast R-CNN inference.

    pred_logits (B, P, K+1), pred_deltas (B, P, 4K or 4), proposal_boxes
    (B, P, 4), proposal_valid (B, P), image_hw (B, 2) in the network frame.
    Returns boxes (B, D, 4), scores (B, D), classes (B, D) int32 and valid
    (B, D), D = topk_per_image, in the network frame.
    """
    b, p = pred_logits.shape[:2]
    scores = torch.softmax(pred_logits, dim=-1)[..., :-1]  # (B, P, K)
    boxes = decode_deltas(pred_deltas, proposal_boxes, box_reg_weights)
    if pred_deltas.shape[-1] == 4:
        boxes = boxes[:, :, None, :].expand(b, p, num_classes, 4)
    else:
        boxes = boxes.reshape(b, p, num_classes, 4)
    hw = image_hw.to(boxes.dtype)
    boxes = clip_boxes(boxes, (hw[:, 0, None, None], hw[:, 1, None, None]))

    cand = (scores > score_thresh) & proposal_valid[..., None]
    flat_scores = torch.where(cand, scores, -1.0).reshape(b, -1)
    k = min(candidate_topk, flat_scores.shape[1])
    top_scores, top_idx = top_k(flat_scores, k)
    top_valid = top_scores > 0.0
    top_boxes = torch.gather(boxes.reshape(b, -1, 4), 1,
                             top_idx[..., None].expand(b, k, 4))
    top_classes = (top_idx % num_classes).to(torch.int32)

    # top_scores are descending (invalid -1 fill sorts last): NMS skips its
    # sort; only the first topk_per_image kept entries are used, so it may
    # stop there
    keep, _ = batched_nms_fixed(top_boxes, top_scores, top_classes,
                                top_valid, nms_thresh, assume_sorted=True,
                                max_keep=topk_per_image)
    d = topk_per_image
    pos, valid = compact_kept(keep, d)
    out_boxes = torch.gather(top_boxes, 1, pos[..., None].expand(b, d, 4))
    out_boxes = torch.where(valid[..., None], out_boxes, 0.0)
    out_scores = torch.where(valid, torch.gather(top_scores, 1, pos), 0.0)
    out_classes = torch.where(valid, torch.gather(top_classes, 1, pos), 0)
    return out_boxes, out_scores, out_classes.to(torch.int32), valid


def rescale_detections(boxes, image_hw, orig_hw):
    """detector_postprocess: boxes (B, D, 4) from the resized network frame
    (image_hw (B, 2)) back to original coordinates (orig_hw (B, 2)), clipped."""
    dt = boxes.dtype
    sy = orig_hw[:, 0].to(dt) / image_hw[:, 0].to(dt)
    sx = orig_hw[:, 1].to(dt) / image_hw[:, 1].to(dt)
    scaled = boxes * torch.stack([sx, sy, sx, sy], dim=-1)[:, None, :]
    oh = orig_hw.to(dt)
    return clip_boxes(scaled, (oh[:, 0, None], oh[:, 1, None]))
