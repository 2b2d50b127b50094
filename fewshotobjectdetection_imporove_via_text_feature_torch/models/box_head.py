"""The ConvFC box head and ``StandardROIHeads``.

Counterpart of the JAX package's ``models/box_head.py`` (ref
defrcn/modeling/roi_heads/box_head.py:17-99 and roi_heads.py:389-526):
ROIAlign at P x P (bin_stride 1) over the res4 map, then two separate
towers of n x [conv3x3 + relu] and n x [fc + relu], each with its own
``FastRCNNOutputLayers``: the cls tower gives the logits (with cls dropout
in training), the box tower the deltas. The towers compute in the compute
dtype with explicit casts, and hand the predictors float32.

The first fc flattens (C, P, P), as detectron2 does; the flax module
flattens (P, P, C), and ``checkpoint.state_dict_from_jax_params`` permutes
that weight's input order.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.roi_align import roi_align
from .fast_rcnn import FastRCNNOutputLayers
from .layers import with_bias


class FastRCNNConvFCHead(nn.Module):
    """(R, C, P, P) -> (R, fc_dim), or (R, conv_dim * P * P) without fcs,
    float32."""

    def __init__(self, in_channels: int, resolution: int, num_conv: int = 0,
                 conv_dim: int = 256, num_fc: int = 2, fc_dim: int = 1024,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        # detectron2's names: conv1.., fc1..
        self.num_conv, self.num_fc = num_conv, num_fc
        c = in_channels
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}",
                            nn.Conv2d(c, conv_dim, 3, padding=1))
            c = conv_dim
        d = c * resolution * resolution
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(d, fc_dim))
            d = fc_dim
        self.out_features = d

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(self.num_conv):
            conv = getattr(self, f"conv{i + 1}")
            x = F.relu(with_bias(F.conv2d, x, conv.weight, conv.bias,
                                 padding=1))
        x = x.flatten(1)
        for i in range(self.num_fc):
            fc = getattr(self, f"fc{i + 1}")
            x = F.relu(with_bias(F.linear, x, fc.weight, fc.bias))
        return x.float()


class StandardROIHeads(nn.Module):
    """Separate cls and box ConvFC towers over the same pooled features."""

    def __init__(self, num_classes: int, in_channels: int,
                 pooler_resolution: int = 7, pooler_scale: float = 1.0 / 16.0,
                 sampling_ratio: int = 0, num_conv: int = 0,
                 conv_dim: int = 256, num_fc: int = 2, fc_dim: int = 1024,
                 cls_agnostic_bbox_reg: bool = False,
                 cls_dropout: bool = False, dropout_ratio: float = 0.8,
                 dtype=torch.float32):
        super().__init__()
        if num_conv + num_fc == 0:
            # detectron2's FastRCNNConvFCHead asserts a non-empty tower:
            # the flattened pooled map would otherwise feed the predictors
            raise ValueError(
                "StandardROIHeads needs ROI_BOX_HEAD.NUM_CONV + NUM_FC > 0 "
                "(detectron2 FastRCNNConvFCHead assert)")
        self.num_classes = num_classes
        self.pooler_resolution = pooler_resolution
        self.pooler_scale = pooler_scale
        self.sampling_ratio = sampling_ratio
        self.dtype = dtype
        tower = dict(in_channels=in_channels, resolution=pooler_resolution,
                     num_conv=num_conv, conv_dim=conv_dim, num_fc=num_fc,
                     fc_dim=fc_dim, dtype=dtype)
        self.box_head = FastRCNNConvFCHead(**tower)
        self.cls_head = FastRCNNConvFCHead(**tower)
        d = self.box_head.out_features
        self.box_predictor = FastRCNNOutputLayers(
            d, num_classes, cls_agnostic_bbox_reg=cls_agnostic_bbox_reg)
        self.cls_predictor = FastRCNNOutputLayers(
            d, num_classes, cls_agnostic_bbox_reg=cls_agnostic_bbox_reg,
            cls_dropout=cls_dropout, dropout_ratio=dropout_ratio)

    def forward(self, features, boxes, train: bool = False, generator=None,
                gt_classes=None, valid=None):
        """features (B, C, H, W), boxes (B, S, 4) -> (scores (B*S, K+1),
        deltas (B*S, 4K), {}), float32; ``train`` turns on the cls
        predictor's dropout, drawn from ``generator``."""
        features = features.contiguous(memory_format=torch.channels_last)
        pooled = roi_align(features, boxes, self.pooler_resolution,
                           self.pooler_scale, self.sampling_ratio, 1)
        pooled = pooled.reshape(-1, *pooled.shape[2:])  # (B*S, C, P, P)
        scores, _ = self.cls_predictor(self.cls_head(pooled), train=train,
                                       generator=generator)
        _, deltas = self.box_predictor(self.box_head(pooled), train=train)
        return scores, deltas, {}
