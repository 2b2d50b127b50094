from .box_ops import (
    box_area,
    clip_boxes,
    decode_deltas,
    encode_deltas,
    nonempty_mask,
    pairwise_iou,
)
from .dispatch import plain_ops
from .gdl import decouple_layer
from .matcher import match_proposals
from .nms import batched_nms_fixed, nms_auto, nms_fixed, top_k
from .roi_align import roi_align, roi_align_plain, roi_sample_geometry
from . import custom_ops  # noqa: F401  (registers the fsod:: operators)
from .sampler import sample_proposals_fixed, subsample_labels

__all__ = [
    "box_area",
    "clip_boxes",
    "decode_deltas",
    "encode_deltas",
    "nonempty_mask",
    "pairwise_iou",
    "plain_ops",
    "decouple_layer",
    "match_proposals",
    "batched_nms_fixed",
    "nms_auto",
    "nms_fixed",
    "top_k",
    "roi_align",
    "roi_align_plain",
    "roi_sample_geometry",
    "sample_proposals_fixed",
    "subsample_labels",
]
