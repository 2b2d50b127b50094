"""C4 ROI head: ROIAlign (7x7 over res4 at 1/16) -> res5 -> spatial mean
-> Fast R-CNN predictor.

Counterpart of the JAX package's ``models/roi_heads.py`` ``Res5ROIHeads``
(inference side). With the stride of res5's block0 on its 1x1 convs
(``stride_in_1x1``) the odd bins of the pooled 7x7 map are never read, so
when ``elide_strided_bins`` also holds the pooler emits only the even bins
(4x4) and block0 runs at stride 1: the same outputs, less work.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.roi_align import roi_align
from .backbone import Res5Stage
from .fast_rcnn import FastRCNNOutputLayers


class Res5ROIHeads(nn.Module):
    def __init__(self, num_classes: int, pooler_resolution: int = 7,
                 pooler_scale: float = 1.0 / 16.0, sampling_ratio: int = 0,
                 res2_out_channels: int = 256, width_per_group: int = 64,
                 res5_blocks: int = 3, cls_agnostic_bbox_reg: bool = False,
                 roi_chunk: int = 256, stride_in_1x1: bool = True,
                 elide_strided_bins: bool = True, dtype=torch.float32):
        super().__init__()
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

    def forward(self, features, boxes):
        """Returns (scores (B*S, K+1), deltas (B*S, 4K)), float32."""
        return self.box_predictor(self.pooled_features(features, boxes))
