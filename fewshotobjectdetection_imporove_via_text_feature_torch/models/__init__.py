from .backbone import (
    RESNET_STAGES,
    BottleneckBlock,
    FrozenBN,
    Res5Stage,
    ResNetC4,
    ResStage,
)
from .build import build_model
from .fast_rcnn import (
    FastRCNNOutputLayers,
    fast_rcnn_inference,
    rescale_detections,
)
from .meta_arch import AffineLayer, GeneralizedRCNN
from .roi_heads import Res5ROIHeads
from .rpn import RPNHead, cell_anchors, generate_anchors, select_top_proposals

__all__ = [
    "RESNET_STAGES",
    "BottleneckBlock",
    "FrozenBN",
    "Res5Stage",
    "ResNetC4",
    "ResStage",
    "build_model",
    "FastRCNNOutputLayers",
    "fast_rcnn_inference",
    "rescale_detections",
    "AffineLayer",
    "GeneralizedRCNN",
    "Res5ROIHeads",
    "RPNHead",
    "cell_anchors",
    "generate_anchors",
    "select_top_proposals",
]
