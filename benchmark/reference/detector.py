"""The plain reference of DeFRCN's C4 detector (ResNet-101, FrozenBN, GDL
affine layers, RPN, ROIAlignV2, res5, Fast R-CNN inference), in float32
PyTorch with TF32 off.

It imports nothing of the measured program and of the JAX package: every
function reads the weights from a dict under detectron2's names, the dict
that the benchmark draws from the seed and hands to both sides. The
semantics are those the program documents (detectron2 with its stated
departures): images are padded with zero pixels before normalization;
ROIAlignV2 clamps a bin to 1e-6 and caps the adaptive sample count at
ceil(map side / P); class-aware NMS shifts each class by (1 + the largest
valid coordinate of the image); top-k breaks ties to the lower index.

``quant`` is the control's hook: a function applied to both operands of
every convolution and linear layer (``fp8_e4m3``), so the same code computes
the reference in a lower precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SCALE_CLAMP = math.log(1000.0 / 16.0)
STAGE_BLOCKS = {14: (1, 1, 1, 1), 26: (2, 2, 2, 2), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3)}


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at the format's largest value, 448), back in
    float32: an fp8 operand of a float32-accumulated product. The
    gradient passes the rounding unchanged (a straight-through estimate),
    so a backward pass multiplies by the rounded operands."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    s = amax / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


def _ident(x):
    return x


class Detector:
    """Weights ``sd`` (name -> tensor, on the device the reference runs
    on) and the architecture's settings from the configuration."""

    def __init__(self, sd, depth=101, num_classes=15, stride_in_1x1=True,
                 anchor_sizes=(32, 64, 128, 256, 512),
                 aspect_ratios=(0.5, 1.0, 2.0), anchor_stride=16,
                 pixel_mean=(103.530, 116.280, 123.675),
                 pixel_std=(1.0, 1.0, 1.0), quant=None):
        self.sd = {k: v.float() for k, v in sd.items()}
        self.blocks = STAGE_BLOCKS[depth]
        self.num_classes = num_classes
        self.stride_in_1x1 = stride_in_1x1
        self.anchor_sizes = tuple(anchor_sizes)
        self.aspect_ratios = tuple(aspect_ratios)
        self.anchor_stride = anchor_stride
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.q = quant or _ident

    # -- layers ---------------------------------------------------------
    def conv(self, x, name, stride=1, padding=0, bias=False):
        b = self.sd[name + ".bias"] if bias else None
        return F.conv2d(self.q(x), self.q(self.sd[name + ".weight"]), b,
                        stride, padding)

    def linear(self, x, name):
        return F.linear(self.q(x), self.q(self.sd[name + ".weight"]),
                        self.sd[name + ".bias"])

    def frozen_bn(self, x, name):
        w, b = self.sd[name + ".weight"], self.sd[name + ".bias"]
        mean, var = self.sd[name + ".running_mean"], self.sd[
            name + ".running_var"]
        scale = w / torch.sqrt(var + 1e-5)
        shift = b - mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]

    def conv_bn(self, x, name, stride=1, padding=0):
        return self.frozen_bn(self.conv(x, name, stride, padding),
                              name + ".norm")

    def block(self, x, name, stride):
        s1, s3 = (stride, 1) if self.stride_in_1x1 else (1, stride)
        out = F.relu(self.conv_bn(x, name + ".conv1", s1))
        out = F.relu(self.conv_bn(out, name + ".conv2", s3, 1))
        out = self.conv_bn(out, name + ".conv3")
        if name + ".shortcut.weight" in self.sd:
            x = self.conv_bn(x, name + ".shortcut", stride)
        return F.relu(out + x)

    # -- backbone -------------------------------------------------------
    def normalize(self, image):
        """(B, H, W, 3) raw BGR pixels -> (B, 3, H, W) float32."""
        x = image.float()
        mean = torch.tensor(self.pixel_mean, device=x.device)
        std = torch.tensor(self.pixel_std, device=x.device)
        return ((x - mean) / std).permute(0, 3, 1, 2)

    def res4(self, image):
        """Raw pixels (B, H, W, 3) -> the res4 map (B, 1024, H/16, W/16)."""
        x = F.relu(self.conv_bn(self.normalize(image), "backbone.stem.conv1",
                                2, 3))
        x = F.max_pool2d(x, 3, 2, 1)
        for idx, name in enumerate(("res2", "res3", "res4")):
            for j in range(self.blocks[idx]):
                stride = 2 if (j == 0 and idx > 0) else 1
                x = self.block(x, f"backbone.{name}.{j}", stride)
        return x

    def affine(self, feat, name):
        return feat * self.sd[name + ".weight"] + self.sd[name + ".bias"]

    # -- RPN ------------------------------------------------------------
    def rpn_head(self, feat_rpn):
        """-> logits (B, H*W*A), deltas (B, H*W*A, 4), (y, x, anchor)."""
        p = "proposal_generator.rpn_head"
        t = F.relu(self.conv(feat_rpn, p + ".conv", 1, 1, bias=True))
        logits = self.conv(t, p + ".objectness_logits", bias=True)
        deltas = self.conv(t, p + ".anchor_deltas", bias=True)
        b = feat_rpn.shape[0]
        return (logits.permute(0, 2, 3, 1).reshape(b, -1),
                deltas.permute(0, 2, 3, 1).reshape(b, -1, 4))

    def anchors(self, feat_hw, device):
        """(H*W*A, 4) anchors, detectron2's DefaultAnchorGenerator."""
        cell = []
        for size in self.anchor_sizes:
            for ratio in self.aspect_ratios:
                w = math.sqrt(size * size / ratio)
                h = w * ratio
                cell.append([-w / 2, -h / 2, w / 2, h / 2])
        cell = torch.tensor(cell, dtype=torch.float32, device=device)
        h, w = feat_hw
        sx = torch.arange(w, dtype=torch.float32, device=device) * \
            self.anchor_stride
        sy = torch.arange(h, dtype=torch.float32, device=device) * \
            self.anchor_stride
        yy, xx = torch.meshgrid(sy, sx, indexing="ij")
        shifts = torch.stack([xx, yy, xx, yy], -1).reshape(-1, 1, 4)
        return (shifts + cell[None]).reshape(-1, 4)

    def proposals(self, logits, deltas, feat_hw, image_hw, pre_nms_topk,
                  post_nms_topk, nms_thresh):
        """find_top_rpn_proposals for one level: per image a list of
        (boxes (k, 4), logits (k,)) in kept order."""
        anchors = self.anchors(feat_hw, logits.device)
        out = []
        for i in range(logits.shape[0]):
            boxes = apply_deltas(deltas[i], anchors, (1.0,) * 4)
            boxes = clip(boxes, image_hw[i])
            k = min(pre_nms_topk, logits.shape[1])
            scores, idx = torch.sort(logits[i], descending=True,
                                     stable=True)
            scores, boxes = scores[:k], boxes[idx[:k]]
            ok = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            keep = greedy_nms(boxes, ok, nms_thresh, post_nms_topk)
            out.append((boxes[keep], scores[keep]))
        return out

    # -- ROI heads ------------------------------------------------------
    def res5_head(self, pooled):
        """(R, 1024, 7, 7) -> (R, 2048) after res5 and the spatial mean."""
        x = pooled
        for j in range(self.blocks[3]):
            x = self.block(x, f"roi_heads.res5.{j}", 2 if j == 0 else 1)
        return x.mean(dim=(2, 3))

    def box_head(self, feat_rcnn, boxes, chunk=256):
        """feat_rcnn (C, H, W) of one image, proposal boxes (R, 4) ->
        (class logits (R, K+1), deltas (R, 4K))."""
        scores, deltas = [], []
        for s in range(0, boxes.shape[0], chunk):
            pooled = roi_align(feat_rcnn, boxes[s:s + chunk], 7, 1 / 16.0)
            x = self.res5_head(pooled)
            scores.append(self.linear(x, "roi_heads.box_predictor.cls_score"))
            deltas.append(self.linear(x, "roi_heads.box_predictor.bbox_pred"))
        return torch.cat(scores), torch.cat(deltas)


# ---------------------------------------------------------------- boxes --
def apply_deltas(deltas, boxes, weights):
    """Box2BoxTransform.apply_deltas: deltas (R, 4K) on boxes (R, 4)."""
    wx, wy, ww, wh = weights
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    dx, dy = deltas[:, 0::4] / wx, deltas[:, 1::4] / wy
    dw = torch.clamp(deltas[:, 2::4] / ww, max=SCALE_CLAMP)
    dh = torch.clamp(deltas[:, 3::4] / wh, max=SCALE_CLAMP)
    pcx = dx * w[:, None] + cx[:, None]
    pcy = dy * h[:, None] + cy[:, None]
    pw = torch.exp(dw) * w[:, None]
    ph = torch.exp(dh) * h[:, None]
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw,
                       pcy + 0.5 * ph], dim=-1)
    return out.reshape(deltas.shape[0], -1)


def clip(boxes, hw):
    """Clip XYXY boxes (..., 4k) to [0, w] x [0, h]."""
    h, w = float(hw[0]), float(hw[1])
    shape = boxes.shape
    b = boxes.reshape(-1, 4)
    b = torch.stack([b[:, 0].clamp(0, w), b[:, 1].clamp(0, h),
                     b[:, 2].clamp(0, w), b[:, 3].clamp(0, h)], -1)
    return b.reshape(shape)


def iou_matrix(a, b):
    """(M, N) IoU; a non-positive union gives 0."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-30),
                       torch.zeros_like(union))


def greedy_nms(boxes, valid, thresh, max_keep=None):
    """Indices kept by greedy NMS over boxes already in descending score
    order (stable ties): a box is kept when it is valid and no kept box
    before it overlaps it by IoU > thresh. The overlap matrix is made on
    the boxes' device and packed to bits; the greedy pass runs on the
    host, one box at a time."""
    n = boxes.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.long)
    over = torch.zeros((n, -(-n // 8) * 8), dtype=torch.uint8,
                       device=boxes.device)
    for s in range(0, n, 1024):
        over[s:s + 1024, :n] = iou_matrix(boxes[s:s + 1024], boxes) > thresh
    bits = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                        device=boxes.device)
    packed = (over.view(n, -1, 8) * bits).sum(-1, dtype=torch.uint8)
    packed = packed.cpu().numpy()
    ok = valid.detach().cpu().numpy()
    gone = np.zeros(packed.shape[1], np.uint8)
    keep = []
    for i in range(n):
        if not ok[i] or (gone[i >> 3] >> (7 - (i & 7))) & 1:
            continue
        keep.append(i)
        if max_keep is not None and len(keep) >= max_keep:
            break
        gone |= packed[i]
    return torch.tensor(keep, dtype=torch.long)


# ------------------------------------------------------------ ROIAlign --
def _axis_weights(start, size_raw, p, n, cap):
    """(R, p, n) averaged bilinear weights of each bin against the n map
    positions along one axis (ROIAlignV2, aligned, adaptive sampling)."""
    f = torch.float32
    bin_size = size_raw.clamp(min=1e-6) / p
    g = torch.ceil(size_raw / p).clamp(0, cap)  # samples per bin
    gs = g.clamp(min=1)
    j = torch.arange(cap, dtype=f, device=start.device)
    wj = (j[None, :] < g[:, None]).float() / gs[:, None]  # (R, cap)
    bins = torch.arange(p, dtype=f, device=start.device)
    t = start[:, None, None] + (bins[None, :, None] + (j[None, None, :] + 0.5)
                                / gs[:, None, None]) * bin_size[:, None, None]
    oob = (t < -1.0) | (t > n)
    t = t.clamp(0.0, n - 1.0)
    pos = torch.arange(n, dtype=f, device=start.device)
    hat = (1.0 - (t[..., None] - pos).abs()).clamp(min=0.0)  # (R, p, cap, n)
    hat = torch.where(oob[..., None], torch.zeros_like(hat), hat)
    return (hat * wj[:, None, :, None]).sum(dim=2)


def roi_align(feat, boxes, p, scale):
    """ROIAlignV2 of one image's map feat (C, H, W) at boxes (R, 4) in
    image coordinates -> (R, C, p, p), float32."""
    c, h, w = feat.shape
    x = boxes.float() * scale - 0.5
    wy = _axis_weights(x[:, 1], x[:, 3] - x[:, 1], p, h, max(1, -(-h // p)))
    wx = _axis_weights(x[:, 0], x[:, 2] - x[:, 0], p, w, max(1, -(-w // p)))
    t = torch.einsum("rph,chw->rpcw", wy, feat.float())
    return torch.einsum("rpcw,rqw->rcpq", t, wx)


# ------------------------------------------------- Fast R-CNN inference --
def detections(scores_logits, deltas, proposals, image_hw, orig_hw,
               num_classes, score_thresh=0.05, nms_thresh=0.5, topk=100,
               candidate_topk=2048, weights=(10.0, 10.0, 5.0, 5.0)):
    """One image's detections from its class logits (P, K+1), deltas
    (P, 4K) and proposals (P, 4) (the valid ones only): softmax, drop the
    background, decode, clip, the score threshold, the candidate budget,
    class-aware greedy NMS, the first ``topk``, rescaled to the original
    size. Returns boxes (D, 4), scores (D,), classes (D,)."""
    probs = torch.softmax(scores_logits.float(), dim=-1)[:, :-1]
    boxes = clip(apply_deltas(deltas.float(), proposals.float(), weights),
                 image_hw).reshape(-1, num_classes, 4)
    flat = torch.where(probs > score_thresh, probs,
                       torch.full_like(probs, -1.0)).reshape(-1)
    k = min(candidate_topk, flat.shape[0])
    top, idx = torch.sort(flat, descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    ok = top > 0
    cls = idx % num_classes
    cand = boxes.reshape(-1, 4)[idx]
    masked = torch.where(ok[:, None], cand, torch.zeros_like(cand))
    unit = masked.amax() + 1.0
    keep = greedy_nms(cand + (cls.float() * unit)[:, None], ok, nms_thresh,
                      topk)
    keep = keep.to(cand.device)
    sy = float(orig_hw[0]) / float(image_hw[0])
    sx = float(orig_hw[1]) / float(image_hw[1])
    out = cand[keep] * torch.tensor([sx, sy, sx, sy], device=cand.device)
    return clip(out, orig_hw), top[keep], cls[keep]
