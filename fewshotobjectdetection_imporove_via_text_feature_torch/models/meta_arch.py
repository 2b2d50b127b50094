"""GeneralizedRCNN: the DeFRCN C4 detector with gradient-decoupled branches.

Counterpart of the JAX package's ``models/meta_arch.py``: normalize ->
backbone (res4) -> GDL + affine per branch -> RPN proposals -> Res5 ROI
head -> fixed-shape Fast R-CNN inference -> original-frame boxes
(``forward_inference``), or -> anchor labelling and RPN losses, proposal
sampling and Fast R-CNN losses (``forward_train``). Module names follow
detectron2's state dict (``backbone``, ``proposal_generator.rpn_head``,
``roi_heads``, ``affine_rpn``, ``affine_rcnn``).

The ROI head is chosen by ``roi_heads_name`` (MODEL.ROI_HEADS.NAME):
``Res5ROIHeads``, ``StandardROIHeads`` (``box_head.py``), or a text-family head of ``text_heads.py`` with the class
bank. The text meta-archs there reuse this skeleton: ``compute_features``
takes the GT they paint, ``_train_tail`` their extra losses, and
``eval_gt_role`` says what GT handed to ``forward_inference`` means.

Under ``torch.profiler`` the stages are spans (``utils/tracing.py``):
``normalize``, ``backbone`` (stem to res4), ``branch`` (GDL's affine
layers), ``rpn`` (head to the NMS kernel), ``roi_heads`` and, in
inference, ``detections`` (the final NMS, top-k and the rescale).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.box_ops import pairwise_iou
from ..ops.gdl import decouple_layer
from ..ops.matcher import match_proposals
from ..parallel.collectives import global_normalizer
from ..parallel.spatial import banded_backbone
from ..structures import Detections, GTInstances, ImageBatch
from ..utils.tracing import span
from .backbone import RESNET_STAGES, ResNetC4
from .fast_rcnn import (
    fast_rcnn_inference,
    fast_rcnn_losses,
    rescale_detections,
)
from .roi_heads import Res5ROIHeads, label_and_sample_proposals
from .rpn import (
    RPNHead,
    cell_anchors,
    generate_anchors,
    label_and_sample_anchors,
    rpn_losses,
    select_top_proposals,
)


class AffineLayer(nn.Module):
    """Per-channel scale and bias on an NCHW map; parameters (1, C, 1, 1)
    as in detectron2's DeFRCN."""

    def __init__(self, channels: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.bias = (nn.Parameter(torch.zeros(1, channels, 1, 1))
                     if use_bias else None)

    def forward(self, x):
        out = x * self.weight.to(x.dtype)
        if self.bias is not None:
            out = out + self.bias.to(x.dtype)
        return out


class _ProposalGenerator(nn.Module):
    """Holds the RPN head under detectron2's ``proposal_generator`` name."""

    def __init__(self, in_channels: int, num_anchors: int):
        super().__init__()
        self.rpn_head = RPNHead(in_channels, num_anchors)


class GeneralizedRCNN(nn.Module):
    """DeFRCN-style Faster R-CNN C4; ``forward_inference`` is the serving
    path, ``forward_train`` the training losses. Hyper-parameters keep the
    JAX module's field names."""

    def __init__(
        self,
        num_classes: int = 20,
        rpn_enable_decouple: bool = True,
        rpn_backward_scale: float = 0.0,
        roi_enable_decouple: bool = True,
        roi_backward_scale: float = 0.75,
        depth: int = 101,
        stem_out_channels: int = 64,
        res2_out_channels: int = 256,
        width_per_group: int = 64,
        stride_in_1x1: bool = True,
        elide_strided_bins: bool = True,
        freeze_at: int = 3,
        remat_backbone: bool = False,
        freeze_backbone: bool = False,
        freeze_rpn: bool = False,
        anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512),
        anchor_aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0),
        anchor_stride: int = 16,
        rpn_pre_nms_topk: Tuple[int, int] = (12000, 6000),
        rpn_post_nms_topk: Tuple[int, int] = (2000, 1000),
        rpn_nms_thresh: float = 0.7,
        rpn_batch_per_image: int = 256,
        rpn_positive_fraction: float = 0.5,
        rpn_iou_thresholds: Tuple[float, float] = (0.3, 0.7),
        rpn_smooth_l1_beta: float = 0.0,
        rpn_bbox_reg_weights: Tuple[float, ...] = (1.0,) * 4,
        rpn_loss_weight: float = 1.0,
        rpn_bbox_reg_loss_weight: float = 1.0,
        rpn_min_size: float = 0.0,
        roi_batch_per_image: int = 512,
        roi_positive_fraction: float = 0.25,
        roi_iou_threshold: float = 0.5,
        proposal_append_gt: bool = True,
        roi_chunk: int = 256,
        pooler_resolution: int = 7,
        sampling_ratio: int = 0,
        box_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0),
        smooth_l1_beta: float = 0.0,
        cls_agnostic_bbox_reg: bool = False,
        cls_dropout: bool = False,
        dropout_ratio: float = 0.8,
        test_score_thresh: float = 0.05,
        test_nms_thresh: float = 0.5,
        test_topk_per_image: int = 100,
        test_candidate_topk: int = 1024,
        pixel_mean: Tuple[float, ...] = (103.530, 116.280, 123.675),
        pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0),
        roi_heads_name: str = "Res5ROIHeads",
        box_convfc: Tuple[int, int, int, int] = (0, 256, 2, 1024),
        output_layer: str = "FastRCNNOutputLayers",
        class_embed=None,
        bg_embed=None,
        l2_cosine: bool = False,
        kl_temp: float = 1.0,
        distill_l2: bool = True,
        distill_kl: bool = True,
        dtype=torch.float32,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.rpn_enable_decouple = rpn_enable_decouple
        self.rpn_backward_scale = rpn_backward_scale
        self.roi_enable_decouple = roi_enable_decouple
        self.roi_backward_scale = roi_backward_scale
        self.freeze_backbone = freeze_backbone
        self.freeze_rpn = freeze_rpn
        self.anchor_sizes = tuple(anchor_sizes)
        self.anchor_aspect_ratios = tuple(anchor_aspect_ratios)
        self.anchor_stride = anchor_stride
        self.rpn_pre_nms_topk = tuple(rpn_pre_nms_topk)
        self.rpn_post_nms_topk = tuple(rpn_post_nms_topk)
        self.rpn_nms_thresh = rpn_nms_thresh
        self.rpn_batch_per_image = rpn_batch_per_image
        self.rpn_positive_fraction = rpn_positive_fraction
        self.rpn_iou_thresholds = tuple(rpn_iou_thresholds)
        self.rpn_smooth_l1_beta = rpn_smooth_l1_beta
        self.rpn_bbox_reg_weights = tuple(rpn_bbox_reg_weights)
        self.rpn_loss_weight = rpn_loss_weight
        self.rpn_bbox_reg_loss_weight = rpn_bbox_reg_loss_weight
        self.rpn_min_size = rpn_min_size
        self.roi_batch_per_image = roi_batch_per_image
        self.roi_positive_fraction = roi_positive_fraction
        self.roi_iou_threshold = roi_iou_threshold
        self.proposal_append_gt = proposal_append_gt
        self.box_reg_weights = tuple(box_reg_weights)
        self.smooth_l1_beta = smooth_l1_beta
        self.test_score_thresh = test_score_thresh
        self.test_nms_thresh = test_nms_thresh
        self.test_topk_per_image = test_topk_per_image
        self.test_candidate_topk = test_candidate_topk
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.res2_out_channels = res2_out_channels
        self.dtype = dtype
        # TPU.SPATIAL_PARTITION (serving): the devices of the backbone's row
        # bands, set by DefaultPredictor; None runs the backbone whole
        self.spatial_devices = None

        self.backbone = ResNetC4(
            depth=depth, stem_out_channels=stem_out_channels,
            res2_out_channels=res2_out_channels,
            width_per_group=width_per_group, stride_in_1x1=stride_in_1x1,
            freeze_at=freeze_at, remat=remat_backbone, dtype=dtype,
        )
        c4 = res2_out_channels * 4
        num_anchors = len(self.anchor_sizes) * len(self.anchor_aspect_ratios)
        self.proposal_generator = _ProposalGenerator(c4, num_anchors)
        # as in the JAX parameter tree, a branch's affine layer exists only
        # when that branch is decoupled
        self.affine_rpn = AffineLayer(c4) if rpn_enable_decouple else None
        self.affine_rcnn = AffineLayer(c4) if roi_enable_decouple else None
        self.roi_heads = self.build_roi_heads(
            roi_heads_name,
            dict(num_classes=num_classes, sampling_ratio=sampling_ratio,
                 pooler_resolution=pooler_resolution,
                 res2_out_channels=res2_out_channels,
                 width_per_group=width_per_group,
                 res5_blocks=RESNET_STAGES[depth][3],
                 cls_agnostic_bbox_reg=cls_agnostic_bbox_reg,
                 roi_chunk=roi_chunk, stride_in_1x1=stride_in_1x1,
                 elide_strided_bins=elide_strided_bins,
                 cls_dropout=cls_dropout, dropout_ratio=dropout_ratio,
                 attention_output_layer=(
                     output_layer == "FastRCNNAttentionOutputLayers"),
                 dtype=dtype),
            dict(class_embed=class_embed, bg_embed=bg_embed,
                 l2_cosine=l2_cosine, kl_temp=kl_temp,
                 distill_l2=distill_l2, distill_kl=distill_kl),
            box_convfc)

    @staticmethod
    def build_roi_heads(name: str, common: dict, text: dict,
                        box_convfc=(0, 256, 2, 1024)):
        """MODEL.ROI_HEADS.NAME -> the ROI head (ref ROI_HEADS_REGISTRY);
        ``box_convfc`` is StandardROIHeads' (NUM_CONV, CONV_DIM, NUM_FC,
        FC_DIM) of MODEL.ROI_BOX_HEAD."""
        if name == "Res5ROIHeads":
            return Res5ROIHeads(**common)
        if name == "StandardROIHeads":
            from .box_head import StandardROIHeads

            num_conv, conv_dim, num_fc, fc_dim = box_convfc
            return StandardROIHeads(
                num_classes=common["num_classes"],
                in_channels=common["res2_out_channels"] * 4,
                pooler_resolution=common["pooler_resolution"],
                sampling_ratio=common["sampling_ratio"], num_conv=num_conv,
                conv_dim=conv_dim, num_fc=num_fc, fc_dim=fc_dim,
                cls_agnostic_bbox_reg=common["cls_agnostic_bbox_reg"],
                cls_dropout=common["cls_dropout"],
                dropout_ratio=common["dropout_ratio"], dtype=common["dtype"])
        from .text_heads import SematicRes5ROIHeads, TextRes5ROIHeads

        if name in ("SematicRes5ROIHeads", "SematicRes5ROIHeadsCrossOutput"):
            return SematicRes5ROIHeads(
                class_embed=text["class_embed"], bg_embed=text["bg_embed"],
                cross_output=name.endswith("CrossOutput"), **common)
        kinds = {"TextRes5ROIHeads": "lv", "TextRes5ROIHeads_VKV": "lv_vkv",
                 "TextRes5ROIHeads_textDomination": "text_dom",
                 "TextRes5ROIHeads_textDomination_VKV": "text_dom_vkv"}
        if name in kinds:
            return TextRes5ROIHeads(
                class_embed=text["class_embed"], attention_kind=kinds[name],
                l2_cosine=text["l2_cosine"], kl_temp=text["kl_temp"],
                distill_l2=text["distill_l2"], distill_kl=text["distill_kl"],
                **common)
        raise KeyError(f"Unknown ROI_HEADS.NAME {name!r}")

    # ------------------------------------------------------------------
    def normalize(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) raw pixels -> (B, 3, H, W) in the compute dtype.
        Padded zero pixels are normalized like the others (PARITY #13)."""
        dt = self.dtype
        image = image.to(dt)
        mean = torch.tensor(self.pixel_mean, dtype=dt, device=image.device)
        std = torch.tensor(self.pixel_std, dtype=dt, device=image.device)
        return ((image - mean) / std).permute(0, 3, 1, 2).contiguous()

    # What GT handed to ``forward_inference`` means for this meta-arch (the
    # reference's evaluation passes test-time GT to the model):
    #   "teacher": label the proposals with it and run a text head's
    #     teacher (the plain arch ignores it otherwise);
    #   "paint": paint it into the features (the Semantic and Text
    #     families, GT-leaky by design, PARITY #12);
    #   "none": ignore it (Distillated).
    eval_gt_role = "teacher"
    # the detection features are solely the painted map (the Semantic
    # family): evaluating without GT would score a constant map
    paint_replaces_features = False

    def compute_features(self, images: ImageBatch, gt=None):
        """(res4 (B, C, H, W), {"res2", "res3", "res4"}); ``gt`` is for the
        painting meta-archs, this one ignores it. With ``spatial_devices``
        the backbone runs in row bands and only res4 comes back, gathered
        on the first of them (``parallel/spatial.py``)."""
        with span("normalize"):
            x = self.normalize(images.image)
        with span("backbone"):
            if self.spatial_devices is not None:
                feats = {"res4": banded_backbone(self.backbone, x,
                                                 self.spatial_devices)}
            else:
                feats = self.backbone(x)
        feat = feats["res4"]
        if self.freeze_backbone:
            feat = feat.detach()
        return feat, feats

    def branch_features(self, feat):
        """GDL + affine per branch (ref rcnn.py:88-98)."""
        with span("branch"):
            feat_rpn = feat
            if self.rpn_enable_decouple:
                feat_rpn = self.affine_rpn(
                    decouple_layer(feat, self.rpn_backward_scale))
            feat_rcnn = feat
            if self.roi_enable_decouple:
                feat_rcnn = self.affine_rcnn(
                    decouple_layer(feat, self.roi_backward_scale))
        return feat_rpn, feat_rcnn

    def run_rpn(self, feat_rpn, images: ImageBatch, train: bool):
        with span("rpn"):
            logits, deltas = self.proposal_generator.rpn_head(feat_rpn)
            if self.freeze_rpn:
                logits, deltas = logits.detach(), deltas.detach()
            h, w = feat_rpn.shape[2], feat_rpn.shape[3]
            idx = 0 if train else 1
            proposals = select_top_proposals(
                logits.detach(), deltas.detach(),
                cell_anchors(self.anchor_sizes, self.anchor_aspect_ratios),
                (h, w), self.anchor_stride, images.hw,
                pre_nms_topk=self.rpn_pre_nms_topk[idx],
                post_nms_topk=self.rpn_post_nms_topk[idx],
                nms_thresh=self.rpn_nms_thresh, min_size=self.rpn_min_size,
                bbox_reg_weights=self.rpn_bbox_reg_weights,
            )
        return logits, deltas, proposals

    def forward(self, images: ImageBatch) -> Detections:
        return self.forward_inference(images)

    def forward_train(self, images: ImageBatch, gt: GTInstances,
                      sampling_generator=None, dropout_generator=None):
        """The loss dict of one training batch: ``loss_*`` entries carry
        gradient, ``metric/*`` entries are diagnostics without it. Anchor
        and ROI sampling draw from ``sampling_generator``, cls dropout from
        ``dropout_generator`` (each on the model's device, or None for the
        global generator)."""
        feat, _ = self.compute_features(images)
        return self._train_tail(feat, images, gt, sampling_generator,
                                dropout_generator)

    def _train_tail(self, feat, images: ImageBatch, gt: GTInstances,
                    sampling_generator=None, dropout_generator=None,
                    extra_losses=None):
        """RPN losses, proposal sampling and ROI losses on res4 features
        (or the features a text meta-arch fused), and ``extra_losses``."""
        feat_rpn, feat_rcnn = self.branch_features(feat)
        logits, deltas, proposals = self.run_rpn(feat_rpn, images,
                                                 train=True)
        h, w = feat_rpn.shape[2], feat_rpn.shape[3]
        anchors = torch.from_numpy(generate_anchors(
            (h, w), self.anchor_stride, self.anchor_sizes,
            self.anchor_aspect_ratios)).to(feat.device)
        gt_labels, matched_boxes = label_and_sample_anchors(
            anchors, gt, self.rpn_batch_per_image,
            self.rpn_positive_fraction, self.rpn_iou_thresholds,
            generator=sampling_generator,
        )
        losses = rpn_losses(
            logits, deltas, anchors, gt_labels, matched_boxes,
            batch_size_per_image=self.rpn_batch_per_image,
            smooth_l1_beta=self.rpn_smooth_l1_beta,
            bbox_reg_weights=self.rpn_bbox_reg_weights,
            loss_weight=self.rpn_loss_weight,
            bbox_reg_loss_weight=self.rpn_bbox_reg_loss_weight,
        )
        b = images.image.shape[0]
        losses["metric/rpn_num_pos_anchors"] = (gt_labels == 1).sum() / b
        losses["metric/rpn_num_neg_anchors"] = (gt_labels == 0).sum() / b
        sampled = label_and_sample_proposals(
            proposals, gt, self.roi_batch_per_image,
            self.roi_positive_fraction, self.num_classes,
            self.roi_iou_threshold, self.proposal_append_gt,
            generator=sampling_generator,
        )
        losses.update(self.roi_losses(feat_rcnn, sampled,
                                      dropout_generator))
        if extra_losses:
            losses.update(extra_losses)
        return losses

    def roi_losses(self, feat_rcnn, sampled, dropout_generator=None):
        """Fast R-CNN losses of the sampled ROIs, and the accuracy and
        sample-count diagnostics, computed without gradient; a text head's
        teacher losses with the ``_t`` suffix and its extra losses."""
        gt_classes = sampled["gt_classes"].reshape(-1)
        valid = sampled["valid"].reshape(-1)
        with span("roi_heads"):
            scores, deltas, aux = self.roi_heads(
                feat_rcnn, sampled["boxes"], train=True,
                generator=dropout_generator, gt_classes=gt_classes,
                valid=valid)

        def det_losses(s, d):
            return fast_rcnn_losses(
                s, d, sampled["boxes"].reshape(-1, 4),
                sampled["gt_boxes"].reshape(-1, 4), gt_classes, valid,
                num_classes=self.num_classes,
                box_reg_weights=self.box_reg_weights,
                smooth_l1_beta=self.smooth_l1_beta,
            )

        losses = det_losses(scores, deltas)
        with torch.no_grad():
            b = sampled["valid"].shape[0]
            bg = self.num_classes
            pred = scores.argmax(dim=1)
            fg = valid & (gt_classes >= 0) & (gt_classes < bg)
            # ratios over the global batch's counts, as logged by the JAX
            # package; the per-image means are exact under averaging
            n_valid = global_normalizer(valid.sum())
            n_fg = fg.sum()
            fg_norm = global_normalizer(n_fg)
            losses.update({
                "metric/cls_accuracy":
                    (valid & (pred == gt_classes)).sum() / n_valid,
                "metric/fg_cls_accuracy":
                    (fg & (pred == gt_classes)).sum() / fg_norm,
                "metric/false_negative":
                    (fg & (pred == bg)).sum() / fg_norm,
                "metric/roi_num_fg_samples": n_fg / b,
                "metric/roi_num_bg_samples":
                    (valid & (gt_classes == bg)).sum() / b,
            })
        # the teacher's own detection losses (ref roi_heads.py:818-826);
        # the rest of aux are scalar losses (loss_kl, loss_student_feat,
        # loss_attentive)
        if "teacher_scores" in aux:
            t = det_losses(aux.pop("teacher_scores"),
                           aux.pop("teacher_deltas"))
            losses.update({k + "_t": v for k, v in t.items()})
        losses.update(aux)
        return losses

    def label_proposals(self, proposals, gt: GTInstances):
        """(B, P) class of each proposal: its matched GT's at IoU >= the ROI
        threshold, else background (ref label_proposals,
        roi_heads.py:677-713); no sampling."""
        iou = pairwise_iou(gt.boxes.to(proposals.boxes.dtype),
                           proposals.boxes)  # (B, G, P)
        iou = torch.where(proposals.valid[:, None, :], iou,
                          torch.zeros_like(iou))
        midx, mlab = match_proposals(iou, gt.valid, [self.roi_iou_threshold],
                                     [0, 1], False)
        cls = torch.gather(gt.classes.long(), 1, midx)
        bg = torch.full_like(cls, self.num_classes)
        cls = torch.where(gt.valid.any(dim=1, keepdim=True), cls, bg)
        return torch.where(mlab == 0, bg, cls)

    def forward_inference(self, images: ImageBatch,
                          gt: GTInstances = None) -> Detections:
        """Detections of a batch. ``gt`` (test-time GT, as the reference's
        evaluation hands it over) is used as ``eval_gt_role`` says: painted
        into the features, or labelling the proposals for a text head's
        teacher; without it a text head runs its student."""
        paint_gt = gt if self.eval_gt_role == "paint" else None
        feat, _ = self.compute_features(images, gt=paint_gt)
        feat_rpn, feat_rcnn = self.branch_features(feat)
        _, _, proposals = self.run_rpn(feat_rpn, images, train=False)
        head_kwargs = {}
        if gt is not None and self.eval_gt_role == "teacher":
            head_kwargs = dict(
                gt_classes=self.label_proposals(proposals, gt).reshape(-1),
                valid=proposals.valid.reshape(-1))
        with span("roi_heads"):
            scores, deltas, _ = self.roi_heads(feat_rcnn, proposals.boxes,
                                               **head_kwargs)
        b, p = proposals.boxes.shape[:2]
        with span("detections"):
            boxes, scores, classes, valid = fast_rcnn_inference(
                scores.reshape(b, p, -1), deltas.reshape(b, p, -1),
                proposals.boxes, proposals.valid, images.hw,
                num_classes=self.num_classes,
                score_thresh=self.test_score_thresh,
                nms_thresh=self.test_nms_thresh,
                topk_per_image=self.test_topk_per_image,
                candidate_topk=self.test_candidate_topk,
                box_reg_weights=self.box_reg_weights,
            )
            boxes = rescale_detections(boxes, images.hw, images.orig_hw)
        return Detections(boxes=boxes, scores=scores, classes=classes,
                          valid=valid)
