"""C4 ROI head: ROIAlign (7x7 over res4 at 1/16) -> res5 -> spatial mean
-> Fast R-CNN predictor, and the training-time proposal sampling.

Counterpart of the JAX package's ``models/roi_heads.py``
(``label_and_sample_proposals``, ``Res5ROIHeads``). With the stride of
res5's block0 on its 1x1 convs (``stride_in_1x1``) the odd bins of the
pooled 7x7 map are never read, so when ``elide_strided_bins`` also holds
the pooler emits only the even bins (4x4) and block0 runs at stride 1: the
same outputs, less work.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.box_ops import pairwise_iou
from ..ops.matcher import match_proposals
from ..ops.roi_align import roi_align
from ..ops.sampler import sample_proposals_fixed
from ..structures import GTInstances, Proposals
from .backbone import Res5Stage
from .fast_rcnn import FastRCNNOutputLayers


def label_and_sample_proposals(proposals: Proposals, gt: GTInstances,
                               batch_size_per_image: int = 512,
                               positive_fraction: float = 0.25,
                               num_classes: int = 20,
                               iou_threshold: float = 0.5,
                               append_gt: bool = True, generator=None,
                               priorities=None):
    """Match proposals (B, P) and, with ``append_gt``, the GT boxes
    appended to them against the padded GT (B, G), and sample a fixed
    S-slot training set per image. Padded columns never match or get
    sampled. Returns boxes (B, S, 4), gt_classes (B, S) (the class, K for
    background and unfilled slots), gt_boxes (B, S, 4) and valid (B, S).
    ``generator`` / ``priorities`` as in
    ``ops.sampler.sample_proposals_fixed``."""
    boxes, valid = proposals.boxes, proposals.valid
    if append_gt:
        boxes = torch.cat([boxes, gt.boxes.to(boxes.dtype)], dim=1)
        valid = torch.cat([valid, gt.valid], dim=1)
    iou = pairwise_iou(gt.boxes.to(boxes.dtype), boxes)  # (B, G, P+G)
    iou = torch.where(valid[:, None, :], iou, torch.zeros_like(iou))
    matched_idx, matched_labels = match_proposals(
        iou, gt.valid, [iou_threshold], [0, 1], False)
    classes = torch.gather(gt.classes.long(), 1, matched_idx)
    bg = torch.full_like(classes, num_classes)
    classes = torch.where(gt.valid.any(dim=1, keepdim=True), classes, bg)
    classes = torch.where(matched_labels == 0, bg, classes)
    ignore = torch.full_like(classes, -1)
    classes = torch.where(matched_labels == -1, ignore, classes)
    classes = torch.where(valid, classes, ignore)  # padded slots

    idx, sampled_valid = sample_proposals_fixed(
        classes, batch_size_per_image, positive_fraction, num_classes,
        generator, priorities)
    gt_idx = torch.gather(matched_idx, 1, idx)
    return {
        "boxes": torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        "gt_classes": torch.where(sampled_valid,
                                  torch.gather(classes, 1, idx),
                                  torch.full_like(idx, num_classes)),
        "gt_boxes": torch.gather(gt.boxes.to(boxes.dtype), 1,
                                 gt_idx[..., None].expand(-1, -1, 4)),
        "valid": sampled_valid,
    }


class Res5ROIHeads(nn.Module):
    def __init__(self, num_classes: int, pooler_resolution: int = 7,
                 pooler_scale: float = 1.0 / 16.0, sampling_ratio: int = 0,
                 res2_out_channels: int = 256, width_per_group: int = 64,
                 res5_blocks: int = 3, cls_agnostic_bbox_reg: bool = False,
                 roi_chunk: int = 256, stride_in_1x1: bool = True,
                 elide_strided_bins: bool = True, cls_dropout: bool = False,
                 dropout_ratio: float = 0.8,
                 attention_output_layer: bool = False, cls_in_features=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.pooler_resolution = pooler_resolution
        self.pooler_scale = pooler_scale
        self.sampling_ratio = sampling_ratio
        self.roi_chunk = roi_chunk
        self.dtype = dtype
        # elision needs block0's stride on the 1x1 convs: with it on the
        # 3x3 conv2, every pooled position is read
        self.elide = elide_strided_bins and stride_in_1x1
        self.res5 = Res5Stage(
            res2_out_channels=res2_out_channels,
            width_per_group=width_per_group, num_blocks=res5_blocks,
            stride_in_1x1=stride_in_1x1,
            first_stride=1 if self.elide else 2,
        )
        self.box_predictor = FastRCNNOutputLayers(
            res2_out_channels * 8, num_classes,
            cls_agnostic_bbox_reg=cls_agnostic_bbox_reg,
            cls_dropout=cls_dropout, dropout_ratio=dropout_ratio,
            cls_in_features=cls_in_features,
            attention_scores_as_logits=attention_output_layer,
        )

    def pooled_features(self, features: torch.Tensor,
                        boxes: torch.Tensor) -> torch.Tensor:
        """features (B, C, H, W); boxes (B, S, 4) -> (B*S, 2048) float32.
        ROIs go through ROIAlign -> res5 -> mean in chunks of ``roi_chunk``
        per image, which bounds the live intermediates."""
        b, s = boxes.shape[:2]
        chunk = min(self.roi_chunk if self.roi_chunk > 0 else s, s)
        bin_stride = 2 if self.elide else 1
        # the kernel reads NHWC: one layout change for all chunks
        features = features.contiguous(memory_format=torch.channels_last)
        outs = []
        for start in range(0, s, chunk):
            bx = boxes[:, start : start + chunk]
            pooled = roi_align(
                features, bx, self.pooler_resolution, self.pooler_scale,
                self.sampling_ratio, bin_stride,
            )  # (B, c, C, P', P')
            pooled = pooled.reshape(-1, *pooled.shape[2:]).to(self.dtype)
            x = self.res5(pooled)
            # spatial mean accumulated in float32
            outs.append(x.mean(dim=(2, 3), dtype=torch.float32)
                        .reshape(b, bx.shape[1], -1))
        return torch.cat(outs, dim=1).reshape(b * s, -1)

    def forward(self, features, boxes, train: bool = False, generator=None,
                gt_classes=None, valid=None):
        """Returns (scores (B*S, K+1), deltas (B*S, 4K), aux), float32;
        ``train`` turns on the predictor's cls dropout, drawn from
        ``generator``. ``aux`` holds a head's extra losses and outputs (none
        here); the text heads read ``gt_classes`` and ``valid`` (B*S,)."""
        scores, deltas = self.box_predictor(
            self.pooled_features(features, boxes), train=train,
            generator=generator)
        return scores, deltas, {}
