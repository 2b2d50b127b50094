"""The text-feature branch: semantic and teacher/student ROI heads, and the
meta-architectures that paint GT into the features. Counterpart of the JAX
package's ``models/text_heads.py``:

  * ``paint_semantic_map``: (B, H, W, sem) maps, each cell inside a GT box
    given that class's embedding (the last valid GT wins; ``adding`` sums
    overlapping boxes; ``inclusive_end`` paints through the cell of the
    box's far edge), the others the background vector;
  * ``SematicRes5ROIHeads`` (+ ``cross_output``): ROI features attend over
    the class bank; CE of the attention weights against the GT class
    (``loss_attentive``); the attended features, or their scores against
    the bank, are the cls input;
  * ``TextRes5ROIHeads``: a text-guided teacher (``LVAttention`` or its
    text-space variant, each with ``vkv``) and a text-free student (an MLP
    adapter and its own predictor) distilled from it by an L2 or cosine
    feature loss and a KL logit loss, on one pooled feature. The targets
    are detached (PARITY #8). Inference runs the student, or the teacher
    when GT labels the proposals;
  * ``GeneralizedSemanticRCNN``: the painted map through ``sem2vis_proj``
    replaces res4; ``GeneralizedDistillatedRCNN`` (+ Adding): res2-res4
    regress the painted maps (``loss_rpn_res{2,3,4}``) and the detector
    runs on raw res4; ``GeneralizedTextRCNN``: cat(res4, text map) through
    ``to_rpn_input_proj``; ``GeneralizedTextAttRCNN``: res4 cells attend
    over the text map's cells (H*W tokens an image).

Features are NCHW here and NHWC in the JAX package: the maps are painted
NHWC, the projections run on NHWC tensors, and the tokens are the H*W cells
row-major. The text layers compute in float32 and the fused feature is cast
back to the compute dtype, as the flax layers (no dtype) do; no autocast.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import global_normalizer
from ..structures import GTInstances
from .attention import (
    LVAttention,
    LVAttentionTextDomination,
    SematicProposalAttention,
    SingleHeadSiameseAttention,
    loss_fn_kd_only,
)
from .fast_rcnn import FastRCNNOutputLayers
from .meta_arch import GeneralizedRCNN
from .roi_heads import Res5ROIHeads


# --------------------------------------------------------------------------
# semantic map painting
# --------------------------------------------------------------------------
def paint_semantic_map(gt: GTInstances, embeddings: torch.Tensor,
                       bg_vector: torch.Tensor, feat_hw: Tuple[int, int],
                       stride: int = 16, adding: bool = False,
                       inclusive_end: bool = False) -> torch.Tensor:
    """(B, H, W, sem) map of ``embeddings`` (C, sem) painted in the GT
    boxes, ``bg_vector`` (sem,) or (1, sem) elsewhere. A box covers cells
    [floor(x1 / stride), floor(x2 / stride)) (the Semantic and Distillated
    meta-archs, ref rcnn.py:177-185), or through floor(x2 / stride) with
    ``inclusive_end`` (the Text meta-archs, rcnn.py:398-405)."""
    h, w = feat_hw
    boxes = gt.boxes.float()
    dev = boxes.device
    # a device tensor, not a host scalar: CUDA divides by a host scalar as
    # a multiply by its reciprocal
    s = torch.tensor(float(stride), device=dev)
    end = 1.0 if inclusive_end else 0.0
    x1 = torch.floor(boxes[..., 0] / s)
    y1 = torch.floor(boxes[..., 1] / s)
    x2 = torch.floor(boxes[..., 2] / s) + end
    y2 = torch.floor(boxes[..., 3] / s) + end
    xs = torch.arange(w, dtype=boxes.dtype, device=dev)
    ys = torch.arange(h, dtype=boxes.dtype, device=dev)
    in_x = (xs >= x1[..., None]) & (xs < x2[..., None])  # (B, G, W)
    in_y = (ys >= y1[..., None]) & (ys < y2[..., None])  # (B, G, H)
    inside = (in_y[..., :, None] & in_x[..., None, :]
              & gt.valid[..., None, None])  # (B, G, H, W)
    b, g = gt.classes.shape
    cls = torch.clamp(gt.classes.long(), 0, embeddings.shape[0] - 1)
    covered = inside.any(dim=1)  # (B, H, W)
    if adding:
        fg = torch.einsum("bghw,bgs->bhws", inside.to(embeddings.dtype),
                          embeddings[cls])
    else:
        rank = torch.arange(1, g + 1, dtype=torch.int32, device=dev)
        winner = torch.where(inside, rank[:, None, None],
                             torch.zeros((), dtype=torch.int32,
                                         device=dev)).amax(dim=1)
        idx = torch.clamp(winner.long() - 1, 0, g - 1).reshape(b, h * w)
        cls_map = torch.where(winner > 0, torch.gather(cls, 1, idx)
                              .reshape(b, h, w), torch.zeros_like(idx)
                              .reshape(b, h, w))
        fg = embeddings[cls_map]
    return torch.where(covered[..., None], fg, bg_vector.reshape(-1))


def _nhwc(feat: torch.Tensor) -> torch.Tensor:
    return feat.permute(0, 2, 3, 1)


def _nchw(feat: torch.Tensor) -> torch.Tensor:
    return feat.permute(0, 3, 1, 2)


# --------------------------------------------------------------------------
# ROI heads
# --------------------------------------------------------------------------
class SematicRes5ROIHeads(Res5ROIHeads):
    """Res5 head + ``SematicProposalAttention``, CE of the attention weights
    against the GT class (``loss_attentive``). ``cross_output``: the
    attended features, projected to the bank's width, are scored against
    the bank and those K+1 scores are the cls input.

    MODEL.ADDITION.FREEZEATTENTION freezes ``roi_heads.attention.`` in the
    optimizer only: the gradient still flows through the attention into
    res5 and the backbone (ref roi_heads.py:948-951)."""

    def __init__(self, class_embed, bg_embed, cross_output: bool = False,
                 **kw):
        width = kw.get("res2_out_channels", 256) * 8
        super().__init__(
            cls_in_features=kw["num_classes"] + 1 if cross_output else width,
            **kw)
        self.cross_output = cross_output
        self.attention = SematicProposalAttention(width, class_embed,
                                                  bg_embed)
        if cross_output:
            self.output_projection = nn.Linear(
                width, np.asarray(class_embed).shape[1])

    def forward(self, features, boxes, train: bool = False, generator=None,
                gt_classes=None, valid=None):
        feat = self.pooled_features(features, boxes)
        attn, out = self.attention(feat)
        if self.cross_output:
            att_feat = F.relu(self.output_projection(out["sim2stext"]))
            att_x = att_feat @ out["text_feat"].T  # (N, K+1)
        else:
            att_x = out["sim2stext"]
        scores, deltas = self.box_predictor(feat, att_x, train=train,
                                            generator=generator)
        aux = {}
        if train and gt_classes is not None and not self.cross_output:
            # CE over the attention weights' C + 2 columns (the dummy key
            # included), as the reference (ref :1073-1081)
            logits = attn[0]
            logp = torch.log_softmax(logits, dim=-1)
            safe = torch.clamp(gt_classes.long(), 0, logits.shape[-1] - 1)
            ce = -logp.gather(1, safe[:, None])[:, 0]
            if valid is not None:
                ce = torch.where(valid, ce, torch.zeros_like(ce))
                aux["loss_attentive"] = ce.sum() / global_normalizer(
                    valid.sum())
            else:
                aux["loss_attentive"] = ce.mean()
        return scores, deltas, aux


class TextRes5ROIHeads(Res5ROIHeads):
    """A text-guided teacher and a text-free student on one pooled feature.
    ``attention_kind``: lv | lv_vkv | text_dom | text_dom_vkv. The
    teacher's ``box_predictor`` classifies the attended feature; the
    student's ``stu_box_predictor`` classifies ``mlp_adapter(feature)``,
    distilled from the teacher by ``loss_student_feat`` (mean squared
    error, or 1 - cosine with ``l2_cosine``; ``distill_l2``) and
    ``loss_kl`` (at ``kl_temp``; ``distill_kl``), against detached
    targets. In training cls dropout draws twice from the step's
    generator, teacher first."""

    def __init__(self, class_embed, attention_kind: str = "lv",
                 distill_l2: bool = True, distill_kl: bool = True,
                 l2_cosine: bool = False, kl_temp: float = 1.0, **kw):
        super().__init__(**kw)
        c = kw.get("res2_out_channels", 256) * 8
        self.distill_l2 = distill_l2
        self.distill_kl = distill_kl
        self.l2_cosine = l2_cosine
        self.kl_temp = kl_temp
        if attention_kind in ("lv", "lv_vkv"):
            self.attention = LVAttention(c, class_embed,
                                         vkv=attention_kind == "lv_vkv")
        elif attention_kind in ("text_dom", "text_dom_vkv"):
            self.attention = LVAttentionTextDomination(
                c, class_embed, vkv=attention_kind == "text_dom_vkv")
        else:
            raise ValueError(f"attention_kind {attention_kind!r}")
        self.stu_box_predictor = FastRCNNOutputLayers(
            c, kw["num_classes"],
            cls_agnostic_bbox_reg=kw.get("cls_agnostic_bbox_reg", False),
            cls_dropout=kw.get("cls_dropout", False),
            dropout_ratio=kw.get("dropout_ratio", 0.8))
        self.mlp_adapter = nn.Sequential(
            nn.Linear(c, c // 2), nn.ReLU(), nn.Linear(c // 2, c), nn.ReLU())

    def forward_teacher(self, feat, gt_classes, valid, train: bool,
                        generator=None):
        # valid keeps pad slots out of the cross-ROI attention's keys; in
        # training the keys are every rank's ROIs, as one global batch
        _, out = self.attention(feat, gt_classes, valid, across_ranks=train)
        scores, deltas = self.box_predictor(
            feat, out["sim2stext"], train=train, generator=generator)
        return scores, deltas, out

    def forward_student(self, feat, teacher_out, valid, train: bool,
                        generator=None):
        s = self.mlp_adapter(feat)
        losses = {}
        if train and teacher_out is not None and self.distill_l2:
            t = teacher_out["sim2stext"].detach()
            if self.l2_cosine:
                ns = s / torch.linalg.vector_norm(
                    s, dim=-1, keepdim=True).clamp_min(1e-8)
                nt = t / torch.linalg.vector_norm(
                    t, dim=-1, keepdim=True).clamp_min(1e-8)
                per = 1.0 - torch.sum(ns * nt, dim=-1)
            else:
                per = torch.mean((s - t) ** 2, dim=-1)
            if valid is not None:
                per = torch.where(valid, per, torch.zeros_like(per))
                losses["loss_student_feat"] = per.sum() / global_normalizer(
                    valid.sum())
            else:
                losses["loss_student_feat"] = per.mean()
        scores, deltas = self.stu_box_predictor(feat, s, train=train,
                                                generator=generator)
        return scores, deltas, losses

    def forward(self, features, boxes, train: bool = False, generator=None,
                gt_classes=None, valid=None):
        feat = self.pooled_features(features, boxes)
        if not train:
            if gt_classes is not None:  # the teacher on GT-labelled ROIs
                scores, deltas, _ = self.forward_teacher(
                    feat, gt_classes, valid, False)
            else:
                scores, deltas, _ = self.forward_student(feat, None, None,
                                                         False)
            return scores, deltas, {}
        t_scores, t_deltas, t_out = self.forward_teacher(
            feat, gt_classes, valid, True, generator)
        s_scores, s_deltas, losses = self.forward_student(
            feat, t_out, valid, True, generator)
        if self.distill_kl:
            losses["loss_kl"] = loss_fn_kd_only(
                s_scores, gt_classes, self.num_classes, t_scores.detach(),
                temperature=self.kl_temp, valid=valid)
        return s_scores, s_deltas, {"teacher_scores": t_scores,
                                    "teacher_deltas": t_deltas, **losses}


# --------------------------------------------------------------------------
# meta-architectures
# --------------------------------------------------------------------------
class _PaintingRCNN(GeneralizedRCNN):
    """Holds the class bank (a buffer, not in the state dict) and the
    learned background vector of the painted maps."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.register_buffer(
            "semantic_bank", torch.from_numpy(
                np.asarray(kw["class_embed"], np.float32)), persistent=False)
        self.semantic_dim = self.semantic_bank.shape[1]
        self.bg_feature = nn.Parameter(torch.zeros(1, self.semantic_dim))

    def paint(self, gt, hw, stride, **kw):
        return paint_semantic_map(gt, self.semantic_bank, self.bg_feature,
                                  hw, stride=stride, **kw)

    def all_background(self, feat):
        """The map without GT (serving): every cell background."""
        b, _, h, w = feat.shape
        return self.bg_feature.reshape(1, 1, 1, -1).expand(
            b, h, w, self.semantic_dim)

    def forward_train(self, images, gt, sampling_generator=None,
                      dropout_generator=None):
        feat, _ = self.compute_features(images, gt)
        return self._train_tail(feat, images, gt, sampling_generator,
                                dropout_generator)


class GeneralizedSemanticRCNN(_PaintingRCNN):
    """The painted map through ``sem2vis_proj`` replaces res4 (ref
    rcnn.py:121-206). Evaluation paints test-time GT, as the reference does
    (GT-leaky, PARITY #12); without GT (serving) it projects an
    all-background map, so TEST.NO_GT_EVAL is refused for this family."""

    eval_gt_role = "paint"
    paint_replaces_features = True

    def __init__(self, **kw):
        super().__init__(**kw)
        self.sem2vis_proj = nn.Linear(self.semantic_dim,
                                      self.res2_out_channels * 4, bias=False)

    def compute_features(self, images, gt=None):
        feat, feats = GeneralizedRCNN.compute_features(self, images)
        if gt is None:
            sem = self.all_background(feat)
        else:
            sem = self.paint(gt, feat.shape[2:], self.anchor_stride)
        return _nchw(self.sem2vis_proj(sem).to(feat.dtype)), feats


class GeneralizedDistillatedRCNN(_PaintingRCNN):
    """res2, res3 and res4 projected to the bank's width regress the
    painted maps at strides 4, 8 and 16 (``loss_rpn_res{2,3,4}``, mean
    squared error; ``adding_variant``: overlapping boxes sum); the detector
    runs on raw res4 in training and evaluation (ref rcnn.py:209-357)."""

    eval_gt_role = "none"

    def __init__(self, adding_variant: bool = False, **kw):
        super().__init__(**kw)
        self.adding_variant = adding_variant
        c2 = self.res2_out_channels
        for i, scale in enumerate(("res2", "res3", "res4")):
            setattr(self, f"vis2sem_{scale}",
                    nn.Linear(c2 * 2**i, self.semantic_dim))

    def compute_features(self, images, gt=None):
        return GeneralizedRCNN.compute_features(self, images)

    def forward_train(self, images, gt, sampling_generator=None,
                      dropout_generator=None):
        feat, feats = GeneralizedRCNN.compute_features(self, images)
        kd = {}
        for scale, stride in (("res2", 4), ("res3", 8), ("res4", 16)):
            f = feats[scale]
            sem = self.paint(gt, f.shape[2:], stride,
                             adding=self.adding_variant)
            proj = getattr(self, f"vis2sem_{scale}")(_nhwc(f).float())
            kd[f"loss_rpn_{scale}"] = torch.mean((proj - sem) ** 2)
        return self._train_tail(feat, images, gt, sampling_generator,
                                dropout_generator, extra_losses=kd)


class GeneralizedTextRCNN(_PaintingRCNN):
    """cat(res4, painted text map) through ``to_rpn_input_proj`` (ref
    rcnn.py:359-452). Evaluation paints test-time GT (GT-leaky, as the
    reference); without GT every cell is background and the same
    projection runs, which keeps the features in the training
    distribution."""

    eval_gt_role = "paint"

    def __init__(self, **kw):
        super().__init__(**kw)
        self.init_fusion(self.res2_out_channels * 4)

    def init_fusion(self, c4):
        """The layers that fuse the text map into res4's c4 channels."""
        self.to_rpn_input_proj = nn.Linear(c4 + self.semantic_dim, c4)

    def text_map(self, feat, gt):
        if gt is None:
            return self.all_background(feat)
        return self.paint(gt, feat.shape[2:], self.anchor_stride,
                          inclusive_end=True)

    def fuse_text(self, feat, gt):
        fused = torch.cat([_nhwc(feat).float(), self.text_map(feat, gt)],
                          dim=-1)
        return _nchw(self.to_rpn_input_proj(fused).to(feat.dtype))

    def compute_features(self, images, gt=None):
        feat, feats = GeneralizedRCNN.compute_features(self, images)
        return self.fuse_text(feat, gt), feats


class GeneralizedTextAttRCNN(GeneralizedTextRCNN):
    """Each res4 cell attends over the text map's cells of its image (ref
    rcnn.py:454-520): queries the visual cells, keys
    ``LtoVproj(text map)``, values ``attproj(cat(visual, keys))``, through
    a ``SingleHeadSiameseAttention`` as constructed (no re-init)."""

    def init_fusion(self, c4):
        self.LtoVproj = nn.Linear(self.semantic_dim, c4)
        self.attproj = nn.Linear(2 * c4, c4)
        self.pixel_attention = SingleHeadSiameseAttention(c4,
                                                          reinit_scale=None)

    def fuse_text(self, feat, gt):
        b, c, h, w = feat.shape
        text = self.LtoVproj(self.text_map(feat, gt))  # (B, H, W, C)
        vis = _nhwc(feat).float()
        value = self.attproj(torch.cat([vis, text], dim=-1))
        out, _ = self.pixel_attention(vis.reshape(b, h * w, c),
                                      text.reshape(b, h * w, c),
                                      value.reshape(b, h * w, c))
        return _nchw(out.reshape(b, h, w, c).to(feat.dtype))


META_ARCHS = {
    "GeneralizedSemanticRCNN": (GeneralizedSemanticRCNN, {}),
    "GeneralizedDistillatedRCNN": (GeneralizedDistillatedRCNN, {}),
    "GeneralizedDistillatedAddingRCNN": (GeneralizedDistillatedRCNN,
                                         {"adding_variant": True}),
    "GeneralizedTextRCNN": (GeneralizedTextRCNN, {}),
    "GeneralizedTextAttRCNN": (GeneralizedTextAttRCNN, {}),
}
