"""The work the inputs need, counted from the configuration and the shapes:
the detector's floating-point operations (convolutions and linear
layers, the MACs of each counted twice, as ``FlopCounterMode`` counts), and
the hand-written kernels' operations and bytes, so a share of a peak or
of a roofline counts the same work whatever computes it.

Peaks: NVIDIA's data sheet of the H100 SXM, dense, at its 700 W limit.
"""

from __future__ import annotations

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
IOU_TEST_OPS = 12               # float32 operations of one IoU test
STAGE_BLOCKS = {14: (1, 1, 1, 1), 26: (2, 2, 2, 2), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3)}


def _out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def _conv(cin, cout, k, hw):
    return 2 * cin * cout * k * k * hw[0] * hw[1]


def backbone_flops(h: int, w: int, depth=101, stem=64, res2=256,
                   width=64, stride_in_1x1=True) -> dict:
    """Per-stage FLOPs of the C4 trunk on one (h, w) canvas:
    {"stem", "res2", "res3", "res4"} and the res4 size."""
    out = {}
    sh, sw = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    out["stem"] = _conv(3, stem, 7, (sh, sw))
    hh, ww = _out(sh, 3, 2, 1), _out(sw, 3, 2, 1)
    cin = stem
    for idx, name in enumerate(("res2", "res3", "res4")):
        cout, mid = res2 * 2 ** idx, width * 2 ** idx
        total = 0
        for j in range(STAGE_BLOCKS[depth][idx]):
            s = 2 if (j == 0 and idx > 0) else 1
            oh, ow = _out(hh, 1, s, 0), _out(ww, 1, s, 0)
            in_hw = (oh, ow) if stride_in_1x1 else (hh, ww)
            total += _conv(cin, mid, 1, in_hw)
            total += _conv(mid, mid, 3, (oh, ow))
            total += _conv(mid, cout, 1, (oh, ow))
            if j == 0:
                total += _conv(cin, cout, 1, (oh, ow))
            cin, hh, ww = cout, oh, ow
        out[name] = total
    out["res4_hw"] = (hh, ww)
    return out


def rpn_flops(feat_hw, channels=1024, anchors=15) -> int:
    return (_conv(channels, channels, 3, feat_hw)
            + _conv(channels, anchors, 1, feat_hw)
            + _conv(channels, anchors * 4, 1, feat_hw))


def res5_flops_per_roi(res2=256, width=64, blocks=3, pooled=7) -> int:
    """res5 on one ROI: block 0's stride-2 1x1 convs read every other bin
    of the pooled map, so the stage runs at ceil(pooled / 2)."""
    side = (pooled + 1) // 2
    hw = (side, side)
    cin, mid, cout = res2 * 4, width * 8, res2 * 8
    total = 0
    for j in range(blocks):
        total += _conv(cin, mid, 1, hw) + _conv(mid, mid, 3, hw) + \
            _conv(mid, cout, 1, hw)
        if j == 0:
            total += _conv(cin, cout, 1, hw)
        cin = cout
    return total


def predictor_flops_per_roi(num_classes, in_features=2048) -> int:
    return 2 * in_features * ((num_classes + 1) + 4 * num_classes)


def inference_flops(cfg, canvas) -> dict:
    """FLOPs of one image's forward on a padded canvas (h, w), by the
    precision they run in: {"low": the trunk, the RPN head and res5 over
    every proposal slot, in the configuration's compute dtype; "f32": the
    box predictor, which runs in float32}."""
    m = cfg.MODEL
    bb = backbone_flops(*canvas, depth=m.RESNETS.DEPTH,
                        stem=m.RESNETS.STEM_OUT_CHANNELS,
                        res2=m.RESNETS.RES2_OUT_CHANNELS,
                        width=m.RESNETS.WIDTH_PER_GROUP,
                        stride_in_1x1=m.RESNETS.STRIDE_IN_1X1)
    c4 = m.RESNETS.RES2_OUT_CHANNELS * 4
    a = len(m.ANCHOR_GENERATOR.SIZES[0]) * len(
        m.ANCHOR_GENERATOR.ASPECT_RATIOS[0])
    rois = m.RPN.POST_NMS_TOPK_TEST
    res5 = res5_flops_per_roi(
        m.RESNETS.RES2_OUT_CHANNELS, m.RESNETS.WIDTH_PER_GROUP,
        STAGE_BLOCKS[m.RESNETS.DEPTH][3], m.ROI_BOX_HEAD.POOLER_RESOLUTION)
    pred = predictor_flops_per_roi(m.ROI_HEADS.NUM_CLASSES,
                                   m.RESNETS.RES2_OUT_CHANNELS * 8)
    low = (bb["stem"] + bb["res2"] + bb["res3"] + bb["res4"]
           + rpn_flops(bb["res4_hw"], c4, a) + rois * res5)
    return {"low": low, "f32": rois * pred}


def ideal_seconds(flops: dict, compute_dtype: str) -> float:
    """The least time of ``flops`` at the card's peaks: the compute
    dtype's part at its peak, the float32 part at float32's."""
    peak = PEAK_BF16_FLOPS if compute_dtype == "bfloat16" else PEAK_F32_FLOPS
    return flops["low"] / peak + flops["f32"] / PEAK_F32_FLOPS


# ------------------------------------------------------------ kernels --
def axis_bin_taps(start, size_raw, p, n, bin_stride):
    """(R, P', n) bool: the map positions along one axis that each emitted
    bin of each ROI reads with a nonzero bilinear weight (ROIAlignV2,
    adaptive sampling capped at ceil(n / p))."""
    cap = max(1, -(-n // p))
    f = torch.float32
    bin_size = size_raw.clamp(min=1e-6) / p
    g = torch.ceil(size_raw / p).clamp(0, cap)
    gs = g.clamp(min=1)
    j = torch.arange(cap, dtype=f, device=start.device)
    used = j[None, :] < g[:, None]                      # (R, cap)
    bins = torch.arange(0, p, bin_stride, dtype=f, device=start.device)
    t = start[:, None, None] + (bins[None, :, None] + (j[None, None, :] + 0.5)
                                / gs[:, None, None]) * bin_size[:, None, None]
    ok = ~((t < -1.0) | (t > n)) & used[:, None, :]
    t = t.clamp(0.0, n - 1.0)
    pos = torch.arange(n, dtype=f, device=start.device)
    w = (1.0 - (t[..., None] - pos).abs()).clamp(min=0.0)
    return ((w > 0) & ok[..., None]).any(dim=2)


def _axis_taps(start, size_raw, p, n, bin_stride):
    """(R, n) bool: the positions that some emitted bin of each ROI reads."""
    return axis_bin_taps(start, size_raw, p, n, bin_stride).any(dim=1)


def bin_taps(boxes, h, w, p, bin_stride, scale):
    """Per axis, the map rows and columns each emitted bin reads: ((R, P',
    h), (R, P', w)) bool; boxes (B, S, 4) in image coordinates."""
    x = boxes.reshape(-1, 4).float() * scale - 0.5
    return (axis_bin_taps(x[:, 1], x[:, 3] - x[:, 1], p, h, bin_stride),
            axis_bin_taps(x[:, 0], x[:, 2] - x[:, 0], p, w, bin_stride))


def read_bins(boxes, h, w, p, bin_stride, scale) -> int:
    """The emitted bins that read some map pixel: a bin none of whose
    samples lands on the map (an empty box, a box off the map) has an
    output of 0 and an output gradient that nothing needs."""
    if boxes.shape[1] == 0:
        return 0
    ty, tx = bin_taps(boxes, h, w, p, bin_stride, scale)
    return int((ty.any(-1).sum(-1) * tx.any(-1).sum(-1)).sum())


def tapped_pixels(boxes, h, w, p, bin_stride, scale) -> int:
    """(image, pixel) pairs that some ROI of the image reads with a
    nonzero weight; boxes (B, S, 4) in image coordinates."""
    b, s = boxes.shape[:2]
    if s == 0:
        return 0
    x = boxes.reshape(-1, 4).float() * scale - 0.5
    rows = _axis_taps(x[:, 1], x[:, 3] - x[:, 1], p, h, bin_stride)
    cols = _axis_taps(x[:, 0], x[:, 2] - x[:, 0], p, w, bin_stride)
    hit = torch.einsum("brh,brw->bhw", rows.reshape(b, s, h).float(),
                       cols.reshape(b, s, w).float())
    return int((hit > 0).sum())


def roi_align_fwd_bytes(features, boxes, p, bin_stride, scale) -> int:
    """Least bytes of one ROIAlign forward: the tapped pixels' channels
    read once, the boxes read, the output written once."""
    b, c, h, w = features.shape
    e = features.element_size()
    p_out = len(range(0, p, bin_stride))
    taps = tapped_pixels(boxes, h, w, p, bin_stride, scale)
    return taps * c * e + boxes.numel() * 4 + \
        boxes.shape[0] * boxes.shape[1] * c * p_out * p_out * e


def roi_align_bwd_bytes(grad, boxes, feature_shape, p, bin_stride,
                        scale) -> int:
    """Least bytes of one ROIAlign backward: the output gradient of every
    bin that reads the map read once (a bin that reads no pixel adds
    nothing), the boxes read, the feature gradient (the whole map, its
    zeros included) written once."""
    b, c, h, w = feature_shape
    e = grad.element_size()
    return read_bins(boxes, h, w, p, bin_stride, scale) * c * e + \
        boxes.numel() * 4 + b * c * h * w * e


def nms_iou_tests(keep, valid, max_keep) -> int:
    """IoU tests greedy NMS needs on these boxes (score order): each valid
    box it reaches is tested against the boxes kept before it; it stops
    once ``max_keep`` boxes are kept (max_keep < 0: never)."""
    kept = keep.long()
    before = torch.cumsum(kept, dim=1) - kept
    reached = valid.bool()
    if max_keep is not None and max_keep >= 0:
        reached = reached & (before < max_keep)
    return int((before * reached).sum())


def nms_bytes(boxes, valid) -> int:
    """Least bytes of one NMS call: boxes and validity read, keep written."""
    return boxes.numel() * 4 + 2 * valid.numel()


def least_seconds(ops: float, ops_peak: float, nbytes: float) -> float:
    return max(ops / ops_peak, nbytes / PEAK_HBM_BYTES)


def train_flops(cfg, canvas, batch: int) -> dict:
    """FLOPs of one training step of ``batch`` images on a canvas, forward
    and backward, by precision. Stages that run without autograd (the
    frozen trunk) have no backward; a trainable convolution's backward is
    its weight gradient and its input gradient (twice its forward), less
    the input gradient where its input needs none (res4's first block
    reads the frozen res3); res5 keeps autograd (its weights are only left
    out of the optimizer), so it has both. The text head (the cross-ROI
    attention over every sampled ROI of the batch, the adapter, the
    predictors) runs in float32."""
    m = cfg.MODEL
    r = m.RESNETS
    bb = backbone_flops(*canvas, depth=r.DEPTH, stem=r.STEM_OUT_CHANNELS,
                        res2=r.RES2_OUT_CHANNELS, width=r.WIDTH_PER_GROUP,
                        stride_in_1x1=r.STRIDE_IN_1X1)
    freeze_at = 4 if m.BACKBONE.FREEZE else m.BACKBONE.FREEZE_AT
    stages = ("stem", "res2", "res3", "res4")
    low = 0
    first_trained = True
    for i, name in enumerate(stages):
        low += bb[name]
        if i + 1 > freeze_at:            # a trained stage
            back = 2 * bb[name]
            if first_trained and i > 0:
                # no input gradient into the frozen stage before it
                back -= _first_block_input_flops(r, i, bb, canvas)
            first_trained = False
            low += back
    c4 = r.RES2_OUT_CHANNELS * 4
    a = len(m.ANCHOR_GENERATOR.SIZES[0]) * len(
        m.ANCHOR_GENERATOR.ASPECT_RATIOS[0])
    low += 3 * rpn_flops(bb["res4_hw"], c4, a)
    rois = m.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    res5 = res5_flops_per_roi(r.RES2_OUT_CHANNELS, r.WIDTH_PER_GROUP,
                              STAGE_BLOCKS[r.DEPTH][3],
                              m.ROI_BOX_HEAD.POOLER_RESOLUTION)
    low += 3 * rois * res5
    d = r.RES2_OUT_CHANNELS * 8
    k = m.ROI_HEADS.NUM_CLASSES
    per_roi = (2 * predictor_flops_per_roi(k, d)     # teacher and student
               + 2 * 2 * d * (d // 2))               # the adapter
    f32 = 3 * rois * per_roi
    low *= batch
    f32 *= batch
    f32 += 3 * attention_flops(batch * rois, d, m.ADDITION.SEMANTIC_DIM, k)
    return {"low": low, "f32": f32}


def _first_block_input_flops(r, stage_index, bb, canvas):
    """The forward FLOPs of the first block's convolutions that read the
    stage's input (conv1 and the shortcut) of stage ``stage_index``."""
    cin = r.STEM_OUT_CHANNELS if stage_index == 1 else \
        r.RES2_OUT_CHANNELS * 2 ** (stage_index - 2)
    idx = stage_index - 1
    mid = r.WIDTH_PER_GROUP * 2 ** idx
    cout = r.RES2_OUT_CHANNELS * 2 ** idx
    h, w = canvas
    sh, sw = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    hh, ww = _out(sh, 3, 2, 1), _out(sw, 3, 2, 1)
    for _ in range(idx):
        hh, ww = _out(hh, 1, 2, 0), _out(ww, 1, 2, 0)
    return _conv(cin, mid, 1, (hh, ww)) + _conv(cin, cout, 1, (hh, ww))


def attention_flops(n: int, d: int, sem: int, classes: int) -> int:
    """The teacher's forward over n ROIs of width d: the text projection
    of the class bank, the value projection, Q/K/V, the n x (n + 1)
    scores and their average of the values, the three merge linears and
    the FFN (d -> 1024 -> d)."""
    return (2 * (classes + 1) * sem * d + 2 * n * (2 * d) * d
            + 3 * 2 * n * d * d + 2 * 2 * n * (n + 1) * d
            + 2 * 2 * n * d * (d // 2) + 2 * n * (2 * (d // 2) + d) * d
            + 2 * 2 * n * d * 1024)
