"""What decides ``correct`` in an evaluation cell: the detector's stages,
as the timed path produced them on a sample of its batches, held to the
float32 reference (``reference/detector.py``), and the limits they are held
to.

The timed path's stages are captured at module boundaries (the backbone's
res4 map, the RPN head's logits and deltas, the ROI heads' input proposals
and output logits and deltas, and the detections the evaluator received).
The reference computes the backbone from the batch's raw pixels; every
later stage it computes again from the program's own input to that stage
(its res4, its head outputs, its proposals), so one stage's rounding does
not move the next stage's discrete choices (top-k, NMS):

  backbone_rel       |res4 - ref| / |ref| (Frobenius, the whole batch)
  rpn_head_rel       the same for the RPN head's logits and deltas (the
                     larger), the reference run on the program's res4
  proposals_missed   share of proposals without a counterpart at IoU >=
                     0.99 (both ways, the worst image), the reference's
                     top-k, decode and NMS run on the program's head outputs
  roi_head_rel       the ROI heads' class logits and deltas (the larger
                     relative error), the reference's ROIAlign, res5 and
                     predictor run on the program's map and proposals
  detections_missed  share of detections without a counterpart of the same
                     class at IoU >= 0.99 whose score is within 1e-3 (both
                     ways, the worst image), the reference's Fast R-CNN
                     inference run on the program's logits and deltas
"""

from __future__ import annotations

import contextlib
import time

import torch

from reference.detector import Detector, detections, iou_matrix

NAMES = ("backbone_rel", "rpn_head_rel", "proposals_missed", "roi_head_rel",
         "detections_missed")


@contextlib.contextmanager
def exact_float32():
    """TF32 off in cuBLAS and cuDNN while the reference runs."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _missed(a_boxes, b_boxes, same=None, iou=0.99):
    """Share of boxes of a and of b with no counterpart in the other at
    IoU >= ``iou`` (and ``same[i, j]`` true)."""
    n_a, n_b = a_boxes.shape[0], b_boxes.shape[0]
    if n_a + n_b == 0:
        return 0.0
    if n_a == 0 or n_b == 0:
        return 1.0
    hit = iou_matrix(a_boxes.float(), b_boxes.float()) >= iou
    if same is not None:
        hit &= same
    miss = (~hit.any(dim=1)).sum() + (~hit.any(dim=0)).sum()
    return float(miss) / (n_a + n_b)


def detector_for(config: dict, cfg, state: dict, quant=None) -> Detector:
    m = cfg.MODEL
    return Detector(
        state, depth=m.RESNETS.DEPTH, num_classes=m.ROI_HEADS.NUM_CLASSES,
        stride_in_1x1=m.RESNETS.STRIDE_IN_1X1,
        anchor_sizes=tuple(m.ANCHOR_GENERATOR.SIZES[0]),
        aspect_ratios=tuple(m.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
        pixel_mean=tuple(m.PIXEL_MEAN), pixel_std=tuple(m.PIXEL_STD),
        quant=quant)


def settings(cfg) -> dict:
    return dict(pre_nms=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
                post_nms=cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
                rpn_nms=cfg.MODEL.RPN.NMS_THRESH,
                score=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
                nms=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
                topk=cfg.TEST.DETECTIONS_PER_IMAGE,
                cand=cfg.TPU.MAX_DETECTIONS_PRE_NMS,
                weights=tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS))


@torch.no_grad()
def compare(cap: dict, ref: Detector, s: dict, block: int = 4,
            seconds: dict = None) -> dict:
    """The five numbers of one captured batch (see the module's text);
    ``seconds`` (a dict) gets each stage's time added to it."""
    seconds = {} if seconds is None else seconds
    clock = [time.perf_counter()]

    def lap(name):
        if image.is_cuda:
            torch.cuda.synchronize(image.device)
        now = time.perf_counter()
        seconds[name] = seconds.get(name, 0.0) + now - clock[0]
        clock[0] = now

    image, hw, orig = cap["image"], cap["hw"], cap["orig_hw"]
    b = image.shape[0]
    k = ref.num_classes
    with exact_float32():
        num = den = 0.0
        for i in range(0, b, block):
            r = ref.res4(image[i:i + block])
            num += float((cap["res4"][i:i + block].float() - r).pow(2).sum())
            den += float(r.pow(2).sum())
        backbone = (num / max(den, 1e-30)) ** 0.5
        lap("backbone")

        res4 = cap["res4"].float()
        lg, dl = ref.rpn_head(ref.affine(res4, "affine_rpn"))
        rpn = max(_rel(cap["rpn_logits"], lg), _rel(cap["rpn_deltas"], dl))
        lap("rpn_head")

        props = ref.proposals(cap["rpn_logits"].float(),
                              cap["rpn_deltas"].float(), res4.shape[2:],
                              hw, s["pre_nms"], s["post_nms"], s["rpn_nms"])
        boxes = cap["proposals"].float()
        valid = (boxes[..., 2] > boxes[..., 0]) & \
            (boxes[..., 3] > boxes[..., 1])
        prop_missed = max(_missed(boxes[i][valid[i]], props[i][0])
                          for i in range(b))
        lap("proposals")

        feat = ref.affine(res4, "affine_rcnn")
        p = boxes.shape[1]
        sc = cap["roi_scores"].float().reshape(b, p, -1)
        de = cap["roi_deltas"].float().reshape(b, p, -1)
        num_s = den_s = num_d = den_d = 0.0
        det_missed = 0.0
        for i in range(b):
            v = valid[i]
            rs, rd = ref.box_head(feat[i], boxes[i][v])
            num_s += float((sc[i][v] - rs).pow(2).sum())
            den_s += float(rs.pow(2).sum())
            num_d += float((de[i][v] - rd).pow(2).sum())
            den_d += float(rd.pow(2).sum())
            rb, rsc, rc = detections(
                sc[i][v], de[i][v], boxes[i][v], hw[i], orig[i], k,
                s["score"], s["nms"], s["topk"], s["cand"], s["weights"])
            pb, psc, pc = (torch.as_tensor(t, device=rb.device)
                           for t in cap["det"][i])
            same = (pc.long()[:, None] == rc.long()[None, :]) & \
                ((psc.float()[:, None] - rsc[None, :]).abs() <= 1e-3)
            det_missed = max(det_missed, _missed(pb, rb, same))
        lap("roi_heads_and_detections")
        roi = max((num_s / max(den_s, 1e-30)) ** 0.5,
                  (num_d / max(den_d, 1e-30)) ** 0.5)
    return {"backbone_rel": backbone, "rpn_head_rel": rpn,
            "proposals_missed": prop_missed, "roi_head_rel": roi,
            "detections_missed": det_missed}


@torch.no_grad()
def reference_captures(ref: Detector, image, hw, orig, s: dict,
                       block: int = 4) -> dict:
    """The captures that ``ref`` would give in the program's place (the
    control: ``ref`` built with a lower-precision ``quant``)."""
    b = image.shape[0]
    with exact_float32():
        res4 = torch.cat([ref.res4(image[i:i + block])
                          for i in range(0, b, block)])
        lg, dl = ref.rpn_head(ref.affine(res4, "affine_rpn"))
        props = ref.proposals(lg, dl, res4.shape[2:], hw, s["pre_nms"],
                              s["post_nms"], s["rpn_nms"])
        p = s["post_nms"]
        boxes = torch.zeros(b, p, 4, device=image.device)
        for i, (bx, _) in enumerate(props):
            boxes[i, :bx.shape[0]] = bx
        feat = ref.affine(res4, "affine_rcnn")
        scores, deltas, dets = [], [], []
        for i in range(b):
            n = props[i][0].shape[0]
            rs, rd = ref.box_head(feat[i], boxes[i][:n])
            fs = torch.zeros(p, rs.shape[1], device=image.device)
            fd = torch.zeros(p, rd.shape[1], device=image.device)
            fs[:n], fd[:n] = rs, rd
            scores.append(fs)
            deltas.append(fd)
            dets.append(tuple(t.cpu().numpy() for t in detections(
                rs, rd, boxes[i][:n], hw[i], orig[i], ref.num_classes,
                s["score"], s["nms"], s["topk"], s["cand"], s["weights"])))
    return {"image": image, "hw": hw, "orig_hw": orig, "res4": res4,
            "rpn_logits": lg, "rpn_deltas": dl, "proposals": boxes,
            "roi_scores": torch.cat(scores), "roi_deltas": torch.cat(deltas),
            "det": dets}

