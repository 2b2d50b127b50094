"""cfg -> a meta-architecture (torch ``nn.Module``): ``build_model``.

Counterpart of the JAX package's ``models/build.py``: MODEL.META_ARCHITECTURE
picks ``GeneralizedRCNN`` or a text-family meta-arch of ``text_heads.py``,
MODEL.ROI_HEADS.NAME its ROI head (``Res5ROIHeads``, ``StandardROIHeads``,
the Sematic and Text heads) and OUTPUT_LAYER its predictor. Every model but
the plain ``GeneralizedRCNN`` with ``Res5ROIHeads`` or ``StandardROIHeads``
gets the class-embedding bank of
DATASETS.TRAIN's classes (MODEL.ADDITION.NAME, GloVe by default, read under
MODEL.ADDITION.EMBEDDING_PATH; synthetic vectors where no file is there)
and a background vector orthogonal to its mean. StandardROIHeads takes
its towers from MODEL.ROI_BOX_HEAD; TPU.REMAT_BACKBONE recomputes the
trainable backbone stages in the backward pass.
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

_OUTPUT_LAYERS = ("FastRCNNOutputLayers", "FastRCNNAttentionOutputLayers")


def _get(cfg, dotted):
    node = cfg
    for part in dotted.split("."):
        node = node[part]
    return tuple(node) if isinstance(node, (list, tuple)) else node


def _text_head_kwargs(cfg):
    """The class-embedding bank (C, dim) and the background vector (1, dim)
    orthogonal to its mean, for every model but the plain GeneralizedRCNN
    with Res5ROIHeads or StandardROIHeads."""
    if (cfg.MODEL.ROI_HEADS.NAME in ("Res5ROIHeads", "StandardROIHeads")
            and cfg.MODEL.META_ARCHITECTURE == "GeneralizedRCNN"):
        return {}
    from ..utils.class_embedding import (
        create_normalized_orthogonal_tensor,
        get_class_embed,
    )
    from ..utils.class_name import get_class_name

    model = cfg.MODEL.ADDITION.NAME
    if model in (None, "none", ""):
        model = "glove"
    try:
        names = get_class_name(cfg)
    except (ValueError, IndexError) as e:
        raise ValueError(
            f"{cfg.MODEL.META_ARCHITECTURE}/{cfg.MODEL.ROI_HEADS.NAME} needs "
            "a class-embedding bank but the class names could not be "
            f"resolved from DATASETS.TRAIN={tuple(cfg.DATASETS.TRAIN)!r}: {e}"
        ) from e
    bank = get_class_embed(names, model,
                           root=cfg.MODEL.ADDITION.EMBEDDING_PATH)
    bg = create_normalized_orthogonal_tensor(bank.mean(axis=0))
    return {"class_embed": bank, "bg_embed": bg}


def build_model(cfg):
    """cfg -> the model with float32 parameters on the CPU (the caller moves
    it to its device); reads what inference and training need, as the JAX
    package's ``_common_kwargs`` does (ROI_HEADS.FREEZE_FEAT and
    ADDITION.FREEZEATTENTION are the optimizer's, as there)."""
    from .meta_arch import GeneralizedRCNN
    from .text_heads import META_ARCHS

    for dotted, want in _FIXED_AT_DEFAULT:
        got = _get(cfg, dotted)
        if got != want:
            raise NotImplementedError(
                f"{dotted} = {got!r}: only the reference architecture "
                f"({dotted} = {want!r}) is implemented"
            )
    meta = cfg.MODEL.META_ARCHITECTURE
    if meta != "GeneralizedRCNN" and meta not in META_ARCHS:
        raise KeyError(f"Unknown META_ARCHITECTURE {meta!r}; have "
                       f"{sorted(['GeneralizedRCNN', *META_ARCHS])}")
    if cfg.MODEL.ROI_HEADS.OUTPUT_LAYER not in _OUTPUT_LAYERS:
        raise KeyError(f"Unknown ROI_HEADS.OUTPUT_LAYER "
                       f"{cfg.MODEL.ROI_HEADS.OUTPUT_LAYER!r}")
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg.TPU.COMPUTE_DTYPE]
    freeze_at = 4 if cfg.MODEL.BACKBONE.FREEZE else cfg.MODEL.BACKBONE.FREEZE_AT
    rpn, roi = cfg.MODEL.RPN, cfg.MODEL.ROI_HEADS
    text = _text_head_kwargs(cfg)
    cls, extra = META_ARCHS.get(meta, (GeneralizedRCNN, {}))
    return cls(
        **extra,
        **text,
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
        roi_heads_name=roi.NAME,
        box_convfc=(cfg.MODEL.ROI_BOX_HEAD.NUM_CONV,
                    cfg.MODEL.ROI_BOX_HEAD.CONV_DIM,
                    cfg.MODEL.ROI_BOX_HEAD.NUM_FC,
                    cfg.MODEL.ROI_BOX_HEAD.FC_DIM),
        remat_backbone=cfg.TPU.REMAT_BACKBONE,
        output_layer=roi.OUTPUT_LAYER,
        l2_cosine=roi.L2_COSINE,
        kl_temp=float(roi.KL_TEMP),
        # the distillation gates (the reference's commented guards,
        # roi_heads.py:608 and :746): the L2 feature loss needs DISTILLATE
        # and L2, the KL logit loss DISTILLATE and KL (KL defaults True)
        distill_l2=roi.DISTILLATE and roi.L2,
        distill_kl=roi.DISTILLATE and roi.KL,
        dtype=dtype,
    )

