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
    cls_dropout,
    fast_rcnn_inference,
    fast_rcnn_losses,
    rescale_detections,
)
from .attention import (
    FFN,
    LVAttention,
    LVAttentionTextDomination,
    SematicProposalAttention,
    SingleHeadSiameseAttention,
    loss_fn_kd_only,
    scaled_dot_product_attention,
)
from .meta_arch import AffineLayer, GeneralizedRCNN
from .roi_heads import Res5ROIHeads, label_and_sample_proposals
from .text_heads import (
    GeneralizedDistillatedRCNN,
    GeneralizedSemanticRCNN,
    GeneralizedTextAttRCNN,
    GeneralizedTextRCNN,
    SematicRes5ROIHeads,
    TextRes5ROIHeads,
    paint_semantic_map,
)
from .rpn import (
    RPNHead,
    cell_anchors,
    generate_anchors,
    label_and_sample_anchors,
    rpn_losses,
    select_top_proposals,
)

__all__ = [
    "RESNET_STAGES",
    "BottleneckBlock",
    "FrozenBN",
    "Res5Stage",
    "ResNetC4",
    "ResStage",
    "build_model",
    "FastRCNNOutputLayers",
    "cls_dropout",
    "fast_rcnn_inference",
    "fast_rcnn_losses",
    "rescale_detections",
    "FFN",
    "LVAttention",
    "LVAttentionTextDomination",
    "SematicProposalAttention",
    "SingleHeadSiameseAttention",
    "loss_fn_kd_only",
    "scaled_dot_product_attention",
    "GeneralizedDistillatedRCNN",
    "GeneralizedSemanticRCNN",
    "GeneralizedTextAttRCNN",
    "GeneralizedTextRCNN",
    "SematicRes5ROIHeads",
    "TextRes5ROIHeads",
    "paint_semantic_map",
    "AffineLayer",
    "GeneralizedRCNN",
    "Res5ROIHeads",
    "label_and_sample_proposals",
    "RPNHead",
    "cell_anchors",
    "generate_anchors",
    "label_and_sample_anchors",
    "rpn_losses",
    "select_top_proposals",
]
