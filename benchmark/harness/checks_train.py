"""What decides ``correct`` in a training cell: the first steps, as the
timed path's own step object made them in set-up, followed by the float32
reference (``reference/student.py``) from the same weights, on the same
batches, with the same sampling and dropout draws, and on the program's
own sampled ROIs of each step:

  loss_gap     the largest |total loss - reference| / |reference| over the
               checked steps
  grad_gap     the first gradient as the optimizer got it (its momentum
               buffer after step 1, less the weight decay), by the worst
               leaf: | |g| - |g_ref| | / max(|g_ref|, the median leaf's)
  change_gap   the parameters' change over the checked steps, measured as
               grad_gap, by the worst leaf (``change_gap_median``, the
               median leaf's, is printed beside it)
  grad_rel     the first gradient's error, |g - g_ref| / max(|g_ref|, the
               median leaf's), by the median leaf: the gap of norms is
               blind to rounding that changes a gradient's direction, and
               fp8 is told from bfloat16 by this number

The sampled ROIs that both sides train on are the program's, so the
training path's proposals and its ROI labels are held apart, on the same
checked steps, from the program's own RPN head outputs and the batch's
ground truth:

  rois_unexplained   share of the valid sampled ROIs with no counterpart
                     at IoU >= 0.99 among the ground-truth boxes and the
                     reference's proposals (its top-k, decode and NMS at
                     the training settings, run on the program's head
                     outputs)
  roi_labels_wrong   the valid sampled ROIs whose class differs from the
                     reference matcher's (the class of the ground-truth
                     box of highest IoU where that is at least the
                     threshold, else background), over those that either
                     side labels foreground

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out (a rule on the
reference's gradient, not on names).
"""

from __future__ import annotations

import torch

from reference.detector import Detector, iou_matrix
from reference.student import StudentStep, lr_at, sgd_step, step_generators

NAMES = ("loss_gap", "grad_gap", "change_gap", "grad_rel",
         "rois_unexplained", "roi_labels_wrong")
NEGLIGIBLE = 1e-3


def frozen_prefixes(cfg) -> tuple:
    """Names the configuration leaves out of the optimizer."""
    m = cfg.MODEL
    freeze_at = 4 if m.BACKBONE.FREEZE else m.BACKBONE.FREEZE_AT
    out = list(("backbone.stem.", "backbone.res2.", "backbone.res3.",
                "backbone.res4.")[:freeze_at])
    if m.RPN.FREEZE:
        out.append("proposal_generator.")
    if m.ROI_HEADS.FREEZE_FEAT:
        out.append("roi_heads.res5.")
    if m.ADDITION.FREEZEATTENTION:
        out.append("roi_heads.attention.")
    return tuple(out)


def trainable_names(cfg, model) -> list:
    frozen = frozen_prefixes(cfg)
    return sorted(n for n, _ in model.named_parameters()
                  if not n.startswith(frozen))


def groups(cfg, names) -> dict:
    """name -> (lr factor, weight decay) as detectron2 groups them: the
    norm layers' parameters, the other biases, the rest."""
    s = cfg.SOLVER
    out = {}
    for n in names:
        if ".norm3." in n:
            out[n] = (1.0, s.WEIGHT_DECAY_NORM)
        elif n.endswith(".bias"):
            out[n] = (s.BIAS_LR_FACTOR, s.WEIGHT_DECAY_BIAS)
        else:
            out[n] = (1.0, s.WEIGHT_DECAY)
    return out


def settings(cfg) -> dict:
    m = cfg.MODEL
    return dict(
        depth=m.RESNETS.DEPTH, classes=m.ROI_HEADS.NUM_CLASSES,
        stride_in_1x1=m.RESNETS.STRIDE_IN_1X1,
        anchor_sizes=tuple(m.ANCHOR_GENERATOR.SIZES[0]),
        aspect_ratios=tuple(m.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
        pixel_mean=tuple(m.PIXEL_MEAN), pixel_std=tuple(m.PIXEL_STD),
        frozen=frozen_prefixes(cfg), rpn_scale=m.RPN.BACKWARD_SCALE,
        roi_scale=m.ROI_HEADS.BACKWARD_SCALE,
        rpn_iou=tuple(m.RPN.IOU_THRESHOLDS),
        rpn_batch=m.RPN.BATCH_SIZE_PER_IMAGE,
        rpn_fraction=m.RPN.POSITIVE_FRACTION,
        box_weights=tuple(m.ROI_BOX_HEAD.BBOX_REG_WEIGHTS),
        dropout=m.ROI_HEADS.DROPOUT_RATIO, kl_temp=float(m.ROI_HEADS.KL_TEMP))


def _norms(d):
    return {n: float(v.float().norm()) for n, v in d.items()}


def _gaps(prog: dict, ref: dict, keep) -> dict:
    """Each kept leaf's | |prog| - |ref| | / max(|ref|, the median leaf's)."""
    med = sorted(ref[n] for n in keep)[len(keep) // 2]
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep}


def _gap(prog: dict, ref: dict, keep) -> float:
    return max(_gaps(prog, ref, keep).values())


def describe(cfg, state, names, ref_out, prog_totals, prog_grad0,
             prog_params) -> str:
    """One line for standard error: each step's loss gap, and for the
    gradients and the changes the three worst leaves and the median
    leaf's gap."""
    totals, g0, params = ref_out
    p0 = {n: state[n].float() for n in names}
    g_ref = _norms(g0)
    med = sorted(g_ref.values())[len(g_ref) // 2]
    keep = [n for n in names if g_ref[n] >= NEGLIGIBLE * med]
    parts = ["step loss gaps " + ", ".join(
        f"{abs(p - r) / abs(r):.4g}" for p, r in zip(prog_totals, totals))]
    for what, prog, ref in (
            ("grad", _norms(prog_grad0), g_ref),
            ("change", _norms({n: prog_params[n].float() - p0[n]
                               for n in names}),
             _norms({n: params[n] - p0[n] for n in names}))):
        gaps = _gaps(prog, ref, keep)
        order = sorted(gaps, key=gaps.get)
        worst = ", ".join(f"{n} {gaps[n]:.4g} ({prog[n]:.4g} vs "
                          f"{ref[n]:.4g})" for n in order[-3:])
        parts.append(f"{what}: median leaf {gaps[order[len(order) // 2]]:.4g}"
                     f", worst {worst}")
    return "; ".join(parts) + f"; {len(keep)} of {len(names)} leaves kept"


def follow(cfg, state, bank, batches, rois, names, prog_seed, device,
           quant=None):
    """The reference's checked steps from ``state``: (total loss of each
    step, the first step's gradients, the parameters after the last).
    ``batches``: the steps' host batches; ``rois``: the program's sampled
    ROIs of each step; ``quant``: the control's lower precision."""
    s = settings(cfg)
    so = cfg.SOLVER
    grp = groups(cfg, names)
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32 = c.allow_tf32 = False
    try:
        ref = StudentStep(dict(state), bank.to(device), s, quant=quant)
        if sorted(ref.trainable) != sorted(names):
            raise ValueError("the reference and the program train other "
                             f"leaves: {set(ref.trainable) ^ set(names)}")
        params = {n: state[n].float().clone() for n in names}
        bufs, totals, g0 = {}, [], None
        for k, ((ib, gt, _), roi) in enumerate(zip(batches, rois)):
            ref.sd.update(params)
            losses, grads = ref.grads(
                ib.image.to(device), ib.hw,
                (gt.boxes.to(device), gt.classes.to(device),
                 gt.valid.to(device)), roi,
                step_generators(prog_seed, k, device))
            totals.append(sum(losses.values()))
            grads = {n: g.detach() for n, g in grads.items()}
            if k == 0:
                g0 = {n: g.clone() for n, g in grads.items()}
            lr = lr_at(k, so.BASE_LR, tuple(so.STEPS), so.GAMMA,
                       so.WARMUP_ITERS, so.WARMUP_FACTOR, so.WARMUP_METHOD)
            with torch.no_grad():
                sgd_step(params, grads, bufs, grp, lr, so.MOMENTUM)
    finally:
        m.allow_tf32, c.allow_tf32 = saved
    return totals, g0, params


def compare(cfg, state, names, ref_out, prog_totals, prog_grad0,
            prog_params) -> dict:
    """The three numbers (see the module's text) of the program's (or the
    control's) checked steps against the reference's ``ref_out``
    (``follow``'s result): total losses, first gradients (as the optimizer
    got them, the weight decay taken off), parameters after."""
    totals, g0, params = ref_out
    p0 = {n: state[n].float() for n in names}
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_totals, totals))
    g_ref = _norms(g0)
    med = sorted(g_ref.values())[len(g_ref) // 2]
    keep = [n for n in names if g_ref[n] >= NEGLIGIBLE * med]
    g_prog = _norms(prog_grad0)
    d_ref = _norms({n: params[n] - p0[n] for n in names})
    d_prog = _norms({n: prog_params[n].float() - p0[n] for n in names})
    med = sorted(g_ref[n] for n in keep)[len(keep) // 2]
    rel = sorted(float((prog_grad0[n].float() - g0[n]).norm())
                 / max(g_ref[n], med) for n in keep)
    change = sorted(_gaps(d_prog, d_ref, keep).values())
    return {"loss_gap": loss_gap, "grad_gap": _gap(g_prog, g_ref, keep),
            "change_gap": change[-1], "grad_rel": rel[len(rel) // 2],
            "change_gap_median": change[len(change) // 2]}


def optimizer_gradient(cfg, names, state, buf0) -> dict:
    """The first gradient as the optimizer got it: its momentum buffer
    after one step (dampening 0: the gradient plus the weight decay) less
    the decay."""
    grp = groups(cfg, names)
    return {n: buf0[n].float() - grp[n][1] * state[n].float()
            for n in names}



@torch.no_grad()
def sampling(cfg, batches, rois, rpn) -> dict:
    """``rois_unexplained`` and ``roi_labels_wrong`` (see the module's
    text) of the checked steps: ``batches`` their host batches, ``rois``
    the program's sampled ROIs, ``rpn`` its RPN head outputs (logits,
    deltas, the map's size) of each step."""
    m = cfg.MODEL
    ref = Detector({}, anchor_sizes=tuple(m.ANCHOR_GENERATOR.SIZES[0]),
                   aspect_ratios=tuple(m.ANCHOR_GENERATOR.ASPECT_RATIOS[0]))
    k = m.ROI_HEADS.NUM_CLASSES
    thresh = float(m.ROI_HEADS.IOU_THRESHOLDS[0])
    wrong = fg = unexplained = total = 0
    for (ib, gt, _), (boxes, classes, valid), (logits, deltas, feat_hw) in \
            zip(batches, rois, rpn):
        b = boxes.shape[0]
        dev = boxes.device
        classes, valid = classes.reshape(b, -1), valid.reshape(b, -1)
        props = ref.proposals(logits, deltas, feat_hw, ib.hw,
                              m.RPN.PRE_NMS_TOPK_TRAIN,
                              m.RPN.POST_NMS_TOPK_TRAIN, m.RPN.NMS_THRESH)
        for i in range(b):
            v = valid[i].bool()
            bx = boxes[i][v].float()
            gv = gt.valid[i].to(dev).bool()
            gb = gt.boxes[i].to(dev).float()[gv]
            gc = gt.classes[i].to(dev).long()[gv]
            mine = torch.full((bx.shape[0],), k, dtype=torch.long,
                              device=dev)
            if gb.shape[0] and bx.shape[0]:
                iou = iou_matrix(gb, bx)
                best, arg = iou.max(dim=0)
                mine = torch.where(best >= thresh, gc[arg], mine)
            theirs = classes[i][v].long()
            wrong += int((theirs != mine).sum())
            fg += int(((theirs < k) | (mine < k)).sum())
            cand = torch.cat([props[i][0].to(dev), gb])
            if bx.shape[0]:
                hit = (iou_matrix(bx, cand) >= 0.99).any(dim=1) \
                    if cand.shape[0] else torch.zeros(
                    bx.shape[0], dtype=torch.bool, device=dev)
                unexplained += int((~hit).sum())
                total += bx.shape[0]
    return {"rois_unexplained": unexplained / max(total, 1),
            "roi_labels_wrong": wrong / max(fg, 1)}
