"""Model builder: cfg -> ``GeneralizedRCNN`` (torch ``nn.Module``).

Counterpart of the JAX package's ``models/build.py``. This package has the
flagship DeFRCN detector so far: ``GeneralizedRCNN`` with ``Res5ROIHeads``
and ``FastRCNNOutputLayers``, for inference and training. Any other
meta-architecture, ROI head or output layer, and any training key this
package does not honour, raises ``NotImplementedError`` naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import torch

# Architecture facets fixed at the detectron2 / reference default; a
# changed value would otherwise be silently ignored.
_FIXED_AT_DEFAULT = (
    ("MODEL.MASK_ON", False),
    ("MODEL.KEYPOINT_ON", False),
    ("MODEL.LOAD_PROPOSALS", False),
    ("MODEL.BACKBONE.NAME", "build_resnet_backbone"),
    ("MODEL.RESNETS.OUT_FEATURES", ("res4",)),
    ("MODEL.RESNETS.NUM_GROUPS", 1),
    ("MODEL.RESNETS.NORM", "FrozenBN"),
    ("MODEL.RESNETS.RES5_DILATION", 1),
    ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", (False,) * 4),
    ("MODEL.ANCHOR_GENERATOR.OFFSET", 0.0),
    ("MODEL.PROPOSAL_GENERATOR.NAME", "RPN"),
    ("MODEL.RPN.IN_FEATURES", ("res4",)),
    ("MODEL.RPN.IOU_LABELS", (0, -1, 1)),
    ("MODEL.RPN.HEAD_NAME", "StandardRPNHead"),
    ("MODEL.RPN.BOUNDARY_THRESH", -1),
    ("MODEL.ROI_HEADS.IN_FEATURES", ("res4",)),
    ("MODEL.ROI_HEADS.IOU_LABELS", (0, 1)),
    ("MODEL.ROI_BOX_HEAD.NAME", "FastRCNNConvFCHead"),
    ("MODEL.ROI_BOX_HEAD.POOLER_TYPE", "ROIAlignV2"),
    ("TEST.AUG.ENABLED", False),
)

# where ROADMAP.md puts the names the JAX package builds and this package
# does not have yet: StandardROIHeads has its own item, every other one
# (the semantic, distillation and text meta-archs, heads and output
# layers) is in the text-families item
_LATER = {
    "StandardROIHeads": "Queue 1 item 13 (StandardROIHeads)",
    "TPU.REMAT_BACKBONE": "Queue 1 item 8 (training: activation recompute)",
}
_LATER_DEFAULT = "Queue 1 item 10 (text, semantic and distill families)"


def _get(cfg, dotted):
    node = cfg
    for part in dotted.split("."):
        node = node[part]
    return tuple(node) if isinstance(node, (list, tuple)) else node


def _not_ported(what: str, name: str):
    return NotImplementedError(
        f"{what} {name!r} is not ported to the PyTorch package yet: "
        f"ROADMAP.md {_LATER.get(name, _LATER_DEFAULT)}"
    )


def build_model(cfg):
    """cfg -> ``GeneralizedRCNN`` with float32 parameters on the CPU (the
    caller moves it to its device); reads what inference and training need,
    as the JAX package's ``_common_kwargs`` does (ROI_HEADS.FREEZE_FEAT is
    the optimizer's, as there)."""
    from .meta_arch import GeneralizedRCNN

    for dotted, want in _FIXED_AT_DEFAULT:
        got = _get(cfg, dotted)
        if got != want:
            raise NotImplementedError(
                f"{dotted} = {got!r}: only the reference architecture "
                f"({dotted} = {want!r}) is implemented"
            )
    if cfg.MODEL.META_ARCHITECTURE != "GeneralizedRCNN":
        raise _not_ported("META_ARCHITECTURE", cfg.MODEL.META_ARCHITECTURE)
    if cfg.MODEL.ROI_HEADS.NAME != "Res5ROIHeads":
        raise _not_ported("ROI_HEADS.NAME", cfg.MODEL.ROI_HEADS.NAME)
    if cfg.MODEL.ROI_HEADS.OUTPUT_LAYER != "FastRCNNOutputLayers":
        raise _not_ported("ROI_HEADS.OUTPUT_LAYER",
                          cfg.MODEL.ROI_HEADS.OUTPUT_LAYER)
    if cfg.TPU.REMAT_BACKBONE:
        raise _not_ported("training option", "TPU.REMAT_BACKBONE")
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg.TPU.COMPUTE_DTYPE]
    freeze_at = 4 if cfg.MODEL.BACKBONE.FREEZE else cfg.MODEL.BACKBONE.FREEZE_AT
    rpn, roi = cfg.MODEL.RPN, cfg.MODEL.ROI_HEADS
    return GeneralizedRCNN(
        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
        rpn_enable_decouple=cfg.MODEL.RPN.ENABLE_DECOUPLE,
        rpn_backward_scale=cfg.MODEL.RPN.BACKWARD_SCALE,
        roi_enable_decouple=cfg.MODEL.ROI_HEADS.ENABLE_DECOUPLE,
        roi_backward_scale=cfg.MODEL.ROI_HEADS.BACKWARD_SCALE,
        depth=cfg.MODEL.RESNETS.DEPTH,
        stem_out_channels=cfg.MODEL.RESNETS.STEM_OUT_CHANNELS,
        res2_out_channels=cfg.MODEL.RESNETS.RES2_OUT_CHANNELS,
        width_per_group=cfg.MODEL.RESNETS.WIDTH_PER_GROUP,
        stride_in_1x1=cfg.MODEL.RESNETS.STRIDE_IN_1X1,
        elide_strided_bins=cfg.TPU.ELIDE_STRIDED_BINS,
        freeze_at=freeze_at,
        freeze_backbone=cfg.MODEL.BACKBONE.FREEZE,
        freeze_rpn=rpn.FREEZE,
        anchor_sizes=tuple(cfg.MODEL.ANCHOR_GENERATOR.SIZES[0]),
        anchor_aspect_ratios=tuple(
            cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
        rpn_pre_nms_topk=(cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN,
                          cfg.MODEL.RPN.PRE_NMS_TOPK_TEST),
        rpn_post_nms_topk=(cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN,
                           cfg.MODEL.RPN.POST_NMS_TOPK_TEST),
        rpn_nms_thresh=rpn.NMS_THRESH,
        rpn_batch_per_image=rpn.BATCH_SIZE_PER_IMAGE,
        rpn_positive_fraction=rpn.POSITIVE_FRACTION,
        rpn_iou_thresholds=tuple(rpn.IOU_THRESHOLDS),
        rpn_smooth_l1_beta=rpn.SMOOTH_L1_BETA,
        rpn_bbox_reg_weights=tuple(rpn.BBOX_REG_WEIGHTS),
        rpn_loss_weight=rpn.LOSS_WEIGHT,
        rpn_bbox_reg_loss_weight=rpn.BBOX_REG_LOSS_WEIGHT,
        rpn_min_size=cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE,
        roi_batch_per_image=roi.BATCH_SIZE_PER_IMAGE,
        roi_positive_fraction=roi.POSITIVE_FRACTION,
        roi_iou_threshold=roi.IOU_THRESHOLDS[0],
        proposal_append_gt=roi.PROPOSAL_APPEND_GT,
        roi_chunk=cfg.TPU.ROI_CHUNK,
        pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
        sampling_ratio=cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
        box_reg_weights=tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS),
        smooth_l1_beta=cfg.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA,
        cls_agnostic_bbox_reg=cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG,
        cls_dropout=roi.CLS_DROPOUT,
        dropout_ratio=roi.DROPOUT_RATIO,
        test_score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
        test_nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
        test_topk_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        test_candidate_topk=cfg.TPU.MAX_DETECTIONS_PRE_NMS,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        dtype=dtype,
    )

