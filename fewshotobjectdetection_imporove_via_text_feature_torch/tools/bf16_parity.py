"""The cases on which the default compute dtype, bfloat16, is held to a
reference, and the rule that holds it. No JAX: the CPU tests
(``tests/test_torch_bf16_*.py``, the port against the JAX package) and
``chip_smoke.py`` phase 19 (the card against the CPU) build their inputs,
configs and weights here, so that both run the same cases.

X is the arm under test in bfloat16, J the reference arm in bfloat16 and
R the reference in float32, all on the same inputs and weights. For a
tensor, e(X) = max|X - R| / max|R|, and u = 2**-8 is bf16's unit roundoff.

1. a tensor (features, pooled features, head outputs, losses, gradients,
   updates): e(X) <= 2 e(J) + u;
2. proposals and detections computed from the same bf16-rounded head
   outputs: the same sets as the reference's, exactly;
3. of the valid detections, the number X matches in J (IoU > 0.9, same
   class) is at least the number J matches in R.

A failure is a fault to repair, never a tolerance to widen.
"""

from __future__ import annotations

import numpy as np
import torch

U = 2.0 ** -8
MATCH_IOU = 0.9

# the tiny detector: depth 14, a 128x160 canvas, two images
NUM_CLASSES = 5
H, W = 128, 160
PRE_NMS, POST_NMS = 1200, 300
MAX_GT = 8
TEXT_POST_NMS = 64
SEM = 16  # the text families' embedding width


# ------------------------------------------------------------- the rule
def err(x, ref) -> float:
    """e(X) = max|X - R| / max|R|, in float64."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def rule1(x, j, r):
    """Rule 1 on one tensor of each arm (arrays): (e(X), e(J), limit)."""
    ex, ej = err(x, r), err(j, r)
    return ex, ej, 2 * ej + U


def iou(a, b) -> np.ndarray:
    """Pairwise IoU of (N, 4) and (M, 4) XYXY boxes, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)

    def area(t):
        return (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])

    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def matched(a, b) -> int:
    """How many of ``a``'s detections have one in ``b`` (same image) with
    IoU > MATCH_IOU and the same class; ``a`` and ``b`` are lists of
    (boxes, classes), one per image."""
    n = 0
    for (ab, ac), (bb, bc) in zip(a, b):
        if len(ab) and len(bb):
            same = np.asarray(ac)[:, None] == np.asarray(bc)[None, :]
            n += int(((iou(ab, bb) > MATCH_IOU) & same).any(axis=1).sum())
    return n


def rule3(x, j, r):
    """Rule 3 on [(boxes, classes)] per image of each arm: (X in J, J in
    R, {arm: valid count})."""
    counts = {name: sum(len(b) for b, _ in d)
              for name, d in (("X", x), ("J", j), ("R", r))}
    return matched(x, j), matched(j, r), counts


# ------------------------------------------------------------- weights
def perturb(state, seed=0):
    """A state dict with every tensor made to matter, as
    tests/test_full_network_oracle.py perturbs the JAX package's params:
    FrozenBN statistics and scales drawn, the GDL affine layers off the
    identity, the zero-initialised conv3s (the residual branches) and
    zero biases drawn. Returns a new dict of float32 tensors."""
    rng = np.random.RandomState(seed)
    out = dict(state)
    for name in sorted(out):
        t = out[name]
        shape = tuple(t.shape)
        if name.endswith("running_mean"):
            v = rng.normal(0, 0.1, shape)
        elif name.endswith(("running_var", "norm.weight")):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.startswith("affine_") and name.endswith("weight"):
            v = rng.uniform(0.8, 1.2, shape)
        elif name.startswith("affine_") and name.endswith("bias"):
            v = rng.normal(0, 0.05, shape)
        elif name.endswith("conv3.weight"):
            v = rng.normal(0, 0.05, shape)
        elif name.endswith("bias") and t.dim() == 1 and not t.any():
            v = rng.normal(0, 0.02, shape)
        else:
            continue
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


def seed_weights(model, seed=0):
    """``init_weights`` from ``seed``, then ``perturb``, loaded into
    ``model``; returns the float32 state."""
    from ..checkpoint import init_weights

    init_weights(model, torch.Generator().manual_seed(seed))
    state = perturb(model.state_dict())
    model.load_state_dict(state)
    return state


# ------------------------------------------------------------- models
def tiny_kwargs(stride_in_1x1=True, **extra):
    """The tiny GeneralizedRCNN's arguments (any depth-14 meta-arch)."""
    return dict(num_classes=NUM_CLASSES, depth=14, stem_out_channels=8,
                res2_out_channels=16, width_per_group=4, freeze_at=0,
                stride_in_1x1=stride_in_1x1,
                rpn_pre_nms_topk=(PRE_NMS, PRE_NMS),
                rpn_post_nms_topk=(POST_NMS, POST_NMS),
                test_candidate_topk=POST_NMS * NUM_CLASSES, **extra)


def train_kwargs(post_nms=POST_NMS):
    """Exhaustive sampling budgets (every labelled anchor, every candidate
    ROI under the 25% cap, so that any draw chooses the same sets) and no
    dropout."""
    return dict(rpn_batch_per_image=100000,
                roi_batch_per_image=4 * (post_nms + MAX_GT),
                cls_dropout=False)


def class_bank():
    """A synthetic unit-norm (5, 16) class-embedding bank and its
    background row."""
    rng = np.random.RandomState(0)
    b = rng.randn(NUM_CLASSES, SEM).astype(np.float32)
    bank = b / np.linalg.norm(b, axis=1, keepdims=True)
    return bank, np.ones((1, SEM), np.float32) / np.sqrt(SEM)


def text_kwargs(meta):
    """The text families' tiny arguments: post-NMS 64 with exhaustive
    budgets, the student recipe's distillation flags; Distillated with the
    cross-output Sematic head and the attention output layers."""
    bank, bg = class_bank()
    kw = dict(tiny_kwargs(), **train_kwargs(TEXT_POST_NMS),
              roi_heads_name="Res5ROIHeads", class_embed=bank, bg_embed=bg,
              distill_l2=True, distill_kl=True, kl_temp=5.0)
    kw["rpn_post_nms_topk"] = (TEXT_POST_NMS, TEXT_POST_NMS)
    if meta.startswith("GeneralizedDistillated"):
        kw.update(roi_heads_name="SematicRes5ROIHeadsCrossOutput",
                  output_layer="FastRCNNAttentionOutputLayers")
    return kw


TEXT_ARCHS = ("GeneralizedTextRCNN", "GeneralizedTextAttRCNN",
              "GeneralizedSemanticRCNN", "GeneralizedDistillatedRCNN")


# ------------------------------------------------------------- inputs
def tiny_inputs(padded, seed=7):
    """Two 128x160 images as (canvas, hw, orig) arrays; ``padded`` puts
    the second at 96x128 inside the canvas, zero pixels outside."""
    rng = np.random.RandomState(seed)
    canvas = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    hw = np.array([[H, W], [H, W]], np.int32)
    if padded:
        hw[1] = (96, 128)
        canvas[1, 96:, :, :] = 0.0
        canvas[1, :, 128:, :] = 0.0
    return canvas, hw, hw * 2 + 3


def tiny_gt(hw, seed=3):
    """Four GT boxes an image inside its valid region, padded to MAX_GT:
    (boxes, classes, valid) arrays."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((2, MAX_GT, 4), np.float32)
    classes = np.zeros((2, MAX_GT), np.int32)
    valid = np.zeros((2, MAX_GT), bool)
    for i in range(2):
        ih, iw = hw[i]
        x1 = rng.uniform(0, iw - 40, 4)
        y1 = rng.uniform(0, ih - 40, 4)
        bw, bh = rng.uniform(16, 60, 4), rng.uniform(16, 60, 4)
        boxes[i, :4] = np.stack([x1, y1, np.minimum(x1 + bw, iw),
                                 np.minimum(y1 + bh, ih)], axis=1)
        classes[i, :4] = rng.randint(0, NUM_CLASSES, 4)
        valid[i, :4] = True
    return boxes, classes, valid


def image_batch(canvas, hw, orig):
    from ..structures import ImageBatch

    return ImageBatch(torch.from_numpy(canvas), torch.from_numpy(hw),
                      torch.from_numpy(orig))


def gt_instances(boxes, classes, valid):
    from ..structures import GTInstances

    return GTInstances(torch.from_numpy(boxes), torch.from_numpy(classes),
                       torch.from_numpy(valid))


def pooled_boxes():
    """(2, 24, 4) boxes inside the canvas, for the pooled features."""
    rng = np.random.RandomState(1)
    xy = rng.uniform(0, [W - 40, H - 40], (2, 24, 2))
    return np.concatenate([xy, xy + rng.uniform(4, 60, (2, 24, 2))],
                          -1).astype(np.float32)


def head_outputs():
    """Box-head outputs rounded to bf16 (ties in the scores, as a bf16
    head gives them) with their proposals, for Fast R-CNN inference on the
    same inputs: (logits, deltas, boxes, valid, hw) arrays and its
    keyword arguments."""
    rng = np.random.RandomState(3)
    b, p, k = 2, 300, NUM_CLASSES

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    logits = bf16(rng.randn(b, p, k + 1) * 2)
    deltas = bf16(rng.randn(b, p, 4 * k) * 0.3)
    xy = rng.uniform(0, [W - 40, H - 40], (b, p, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (b, p, 2))],
                           -1).astype(np.float32)
    valid = rng.rand(b, p) > 0.1
    hw = np.array([[H, W], [96, 128]], np.int32)
    return (logits, deltas, boxes, valid, hw), dict(
        num_classes=k, topk_per_image=50, candidate_topk=400)


def raw_batch():
    """Two raw images in a (112, 144) source bucket that the device
    preprocessing resizes into the 128x160 canvas, the second flipped:
    (raw, hw, orig, short, flip)."""
    from ..data.mapper import resize_shortest_edge_size

    rng = np.random.RandomState(5)
    raw = np.zeros((2, 112, 144, 3), np.uint8)
    orig = np.array([[100, 130], [90, 120]], np.int32)
    short = np.array([128, 128], np.float32)
    flip = np.array([False, True])
    hw = np.array([resize_shortest_edge_size(h, w, s, W)
                   for (h, w), s in zip(orig, short)], np.int32)
    for i, (h, w) in enumerate(orig):
        raw[i, :h, :w] = rng.randint(0, 256, (h, w, 3))
        # three GT boxes and classes drawn from the same stream, as the
        # device-preprocessing suite draws them (unused here)
        rng.uniform(0, w - 40, 3), rng.uniform(0, h - 40, 3)
        rng.uniform(12, 40, 3), rng.uniform(12, 40, 3)
        rng.randint(0, 5, 3)
    return raw, hw, orig, short, flip


def predictor_images():
    """Three BGR images of three bucket shapes, the first repeated."""
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, (230, 310, 3), dtype=np.uint8),
              rng.randint(0, 255, (192, 256, 3), dtype=np.uint8),
              rng.randint(0, 255, (300, 200, 3), dtype=np.uint8)]
    return images + images[:1]


def export_images():
    """Two BGR images, one of each orientation of the export bucket."""
    return [np.random.RandomState(sum(hw)).randint(0, 256, (*hw, 3),
                                                   dtype=np.uint8)
            for hw in ((100, 150), (150, 100))]


# ------------------------------------------------------------- configs
def predictor_cfg(dtype, cfg=None):
    """The tiny ``DefaultPredictor`` config (one 192x256 bucket), on
    ``cfg`` (the port's defaults when None)."""
    if cfg is None:
        from ..config import get_cfg

        cfg = get_cfg()
    cfg.MODEL.WEIGHTS = ""
    cfg.MODEL.RESNETS.DEPTH = 14
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 4
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = NUM_CLASSES
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 256
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 64
    cfg.TPU.IMAGE_BUCKETS = ((192, 256),)
    cfg.TPU.MAX_DETECTIONS_PRE_NMS = 256
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.INPUT.MIN_SIZE_TEST = 192
    cfg.INPUT.MAX_SIZE_TEST = 256
    return cfg


EXPORT_OPTS = [
    "MODEL.RESNETS.DEPTH", "14",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "4",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "128",
    "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
    "MODEL.ROI_HEADS.NUM_CLASSES", "5",
    "INPUT.MIN_SIZE_TEST", "96",
    "INPUT.MAX_SIZE_TEST", "192",
    "TPU.IMAGE_BUCKETS", "[(128, 192)]",
    "MODEL.WEIGHTS", "",
]


def export_cfg(dtype):
    """The tiny serving-export config (one 128x192 bucket)."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_list(EXPORT_OPTS + ["TPU.COMPUTE_DTYPE", dtype])
    return cfg


def step_cfg(config_file):
    """``config_file``'s solver at a three-step contract: FREEZE_AT 2,
    momentum 0.9, weight decay 1e-3 (5e-4 on biases, at twice the rate),
    warm-up 2, a step at 2, norm clipping at 0.05."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(config_file)
    cfg.SOLVER.update(BASE_LR=0.02, MOMENTUM=0.9, WEIGHT_DECAY=1e-3,
                      WEIGHT_DECAY_BIAS=5e-4, BIAS_LR_FACTOR=2.0,
                      WARMUP_ITERS=2, WARMUP_FACTOR=0.1, STEPS=(2,),
                      GAMMA=0.5)
    cfg.MODEL.BACKBONE.FREEZE_AT = 2
    cfg.MODEL.ROI_HEADS.FREEZE_FEAT = False
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 0.05
    return cfg
