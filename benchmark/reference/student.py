"""The plain reference of one training step of the text-distilled student
(DeFRCN gfsod fine-tune with ``TextRes5ROIHeads``, run_text_train_student.sh):
float32 PyTorch with TF32 off, on the weights under detectron2's names.

One step: res4 from the raw pixels (stem to res3 frozen, without autograd;
res4 trained), the gradient-decoupled affine branches (the RPN's passes 0
of its gradient to res4, the ROI heads' 0.001), the RPN head and its
losses over the anchors sampled as the program samples them (the same
draws from the step's generator), the ROI heads on the step's sampled ROIs
(ROIAlignV2, res5 frozen, the spatial mean), the teacher (the cross-ROI
attention over every sampled ROI of the batch, each keyed by its GT
class's projected embedding) and the student (an MLP adapter), class
dropout from the step's second generator, the student's and the teacher's
Fast R-CNN losses, the feature L2 and the KL distillation against
detached targets; then SGD with momentum over the trainable leaves.

The sampled ROIs are an input: the program's own, as the step produced
them (the reference follows the program step by step from there). res4's
activations are recomputed four images at a time for the backward pass, so
a batch of 16 at 800x1344 fits beside the program's state.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .detector import Detector, iou_matrix, roi_align


class _Decouple(torch.autograd.Function):
    """Identity forward, the gradient scaled by ``scale`` (GDL)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def step_generators(seed: int, step: int, device):
    """The step's (sampling, dropout) generators: two words of
    SeedSequence([seed, step])."""
    a, b = np.random.SeedSequence([seed, step]).generate_state(2)
    return (torch.Generator(device=device).manual_seed(int(a)),
            torch.Generator(device=device).manual_seed(int(b)))


def _take(eligible, k, gen):
    """k eligible slots of each row uniformly without replacement: the
    largest of uniform priorities (ties to the lower index); (idx, ok)."""
    k = min(k, eligible.shape[-1])
    pri = torch.rand(eligible.shape, generator=gen, device=gen.device)
    pri = torch.where(eligible, pri.to(eligible.device),
                      torch.full_like(pri, -1.0))
    vals, idx = torch.sort(pri, dim=-1, descending=True, stable=True)
    return idx[..., :k], vals[..., :k] >= 0


def sample_anchor_labels(labels, batch, fraction, gen):
    """detectron2's subsample_labels (1 positive, 0 negative, -1 ignored):
    at most batch * fraction positives, the rest negatives."""
    pos, neg = labels == 1, labels == 0
    max_pos = int(batch * fraction)
    n_pos = pos.sum(-1, keepdim=True).clamp(max=max_pos)
    n_neg = torch.minimum(neg.sum(-1, keepdim=True), batch - n_pos)
    p_idx, p_ok = _take(pos, max_pos, gen)
    n_idx, n_ok = _take(neg, batch, gen)
    rp = torch.arange(p_idx.shape[-1], device=labels.device)
    rn = torch.arange(n_idx.shape[-1], device=labels.device)
    out = torch.full_like(labels, -1)
    out.scatter_(-1, p_idx, torch.where(p_ok & (rp < n_pos), 1,
                                        out.gather(-1, p_idx)))
    out.scatter_(-1, n_idx, torch.where(n_ok & (rn < n_neg), 0,
                                        out.gather(-1, n_idx)))
    return out


def encode(src, tgt, weights):
    """Box2BoxTransform.get_deltas; non-positive sizes read as 1."""
    wx, wy, ww, wh = weights
    sw, sh = src[..., 2] - src[..., 0], src[..., 3] - src[..., 1]
    tw, th = tgt[..., 2] - tgt[..., 0], tgt[..., 3] - tgt[..., 1]
    one = torch.ones_like(sw)
    sw, sh = torch.where(sw > 0, sw, one), torch.where(sh > 0, sh, one)
    tw, th = torch.where(tw > 0, tw, one), torch.where(th > 0, th, one)
    scx, scy = src[..., 0] + 0.5 * (src[..., 2] - src[..., 0]), \
        src[..., 1] + 0.5 * (src[..., 3] - src[..., 1])
    tcx, tcy = tgt[..., 0] + 0.5 * (tgt[..., 2] - tgt[..., 0]), \
        tgt[..., 1] + 0.5 * (tgt[..., 3] - tgt[..., 1])
    return torch.stack([wx * (tcx - scx) / sw, wy * (tcy - scy) / sh,
                        ww * torch.log(tw / sw), wh * torch.log(th / sh)],
                       -1)


class StudentStep:
    """``sd``: name -> float32 tensor (trainable ones become leaves);
    ``bank``: (C, sem) class vectors; ``s``: the configuration's settings
    (``settings`` in ``harness/checks_train.py``)."""

    def __init__(self, sd, bank, s, quant=None):
        self.s = s
        self.det = Detector(sd, depth=s["depth"], num_classes=s["classes"],
                            stride_in_1x1=s["stride_in_1x1"],
                            anchor_sizes=s["anchor_sizes"],
                            aspect_ratios=s["aspect_ratios"],
                            pixel_mean=s["pixel_mean"],
                            pixel_std=s["pixel_std"], quant=quant)
        self.sd = self.det.sd
        self.bank = bank.float()
        self.q = self.det.q
        self.trainable = [n for n in sorted(self.sd)
                          if not n.startswith(s["frozen"])
                          and not n.endswith(("running_mean",
                                              "running_var"))
                          and ".norm." not in n]

    # -- pieces ---------------------------------------------------------
    def lin(self, x, name, bias=True):
        b = self.sd[name + ".bias"] if bias else None
        return F.linear(self.q(x), self.q(self.sd[name + ".weight"]), b)

    def to_res3(self, image):
        d = self.det
        x = F.relu(d.conv_bn(d.normalize(image), "backbone.stem.conv1", 2, 3))
        x = F.max_pool2d(x, 3, 2, 1)
        for idx, name in enumerate(("res2", "res3")):
            for j in range(d.blocks[idx]):
                x = d.block(x, f"backbone.{name}.{j}",
                            2 if (j == 0 and idx > 0) else 1)
        return x

    def res4_stage(self, x):
        for j in range(self.det.blocks[2]):
            x = self.det.block(x, f"backbone.res4.{j}", 2 if j == 0 else 1)
        return x

    def attention(self, feat, gt_classes, valid):
        p = "roi_heads.attention."
        c = self.bank.shape[0]
        embed = self.lin(torch.cat([self.bank, self.sd[p + "w_bg"]]),
                         p + "proj2")
        text = F.relu(embed[gt_classes.long().clamp(0, c)])
        value = F.relu(self.lin(torch.cat([feat, embed[
            gt_classes.long().clamp(0, c)]], -1), p + "proj_k"))
        a = p + "attention."
        d = feat.shape[-1]
        qp = self.lin(feat, a + "w_q", False)
        kp = torch.cat([self.lin(text, a + "w_k", False),
                        self.sd[a + "dummy"]])
        vp = torch.cat([self.lin(value, a + "w_v", False),
                        value.new_zeros(1, d)])
        mask = torch.cat([valid, valid.new_ones(1)])
        logits = (self.q(qp) @ self.q(kp).t()) / float(np.sqrt(d))
        logits = logits.masked_fill(~mask[None, :], float("-inf"))
        w = torch.softmax(logits, -1)
        out = self.q(w) @ self.q(vp)
        o1 = F.relu(self.lin(out * feat, a + "linear1"))
        o2 = F.relu(self.lin(feat - out, a + "linear2"))
        x = self.lin(torch.cat([o1, o2, feat], -1), a + "linear3")
        y = x + self.lin(F.relu(self.lin(x, a + "ffn.linear1")),
                         a + "ffn.linear2")
        y = F.layer_norm(y, (d,), self.sd[a + "ffn.norm3.weight"],
                         self.sd[a + "ffn.norm3.bias"], 1e-5)
        return F.relu(y)

    def det_losses(self, scores, deltas, boxes, gt_boxes, gt_classes, valid):
        k = self.s["classes"]
        n = valid.sum().clamp(min=1)
        ce = -torch.log_softmax(scores, -1).gather(
            1, gt_classes.long().clamp(0, k)[:, None])[:, 0]
        loss_cls = torch.where(valid, ce, torch.zeros_like(ce)).sum() / n
        fg = valid & (gt_classes >= 0) & (gt_classes < k)
        tgt = encode(boxes, gt_boxes, self.s["box_weights"])
        pick = deltas.reshape(-1, k, 4).gather(1, gt_classes.long().clamp(
            0, k - 1)[:, None, None].expand(-1, 1, 4))[:, 0]
        l1 = (pick - tgt).abs()
        loss_box = torch.where(fg[:, None], l1, torch.zeros_like(l1)).sum() / n
        return loss_cls, loss_box

    # -- one step -------------------------------------------------------
    def losses(self, res4, image_hw, gt, rois, gens):
        """The step's loss dict on res4 (a tensor the gradient reaches):
        gt = (boxes (B, G, 4), classes (B, G), valid (B, G)); rois =
        (boxes (B, S, 4), gt_classes (B*S,), valid (B*S,))."""
        s, d = self.s, self.det
        sampling, dropout = gens
        b = res4.shape[0]
        feat_rpn = d.affine(_Decouple.apply(res4, s["rpn_scale"]),
                            "affine_rpn")
        feat_rcnn = d.affine(_Decouple.apply(res4, s["roi_scale"]),
                             "affine_rcnn")
        logits, deltas = d.rpn_head(feat_rpn)
        anchors = d.anchors(res4.shape[2:], res4.device)
        gb, gc, gv = gt
        iou = torch.stack([iou_matrix(gb[i].float(), anchors)
                           for i in range(b)])            # (B, G, N)
        masked = torch.where(gv[..., None], iou, torch.full_like(iou, -1.0))
        best, idx = masked.max(dim=1)
        anyv = gv.any(dim=1, keepdim=True)
        best = torch.where(anyv, best, torch.zeros_like(best))
        idx = torch.where(anyv, idx, torch.zeros_like(idx))
        lo, hi = s["rpn_iou"]
        labels = torch.where(best >= hi, 1, torch.where(best >= lo, -1, 0))
        top = masked.amax(dim=-1, keepdim=True)
        low_q = ((iou >= top) & (top > 0) & gv[..., None]).any(dim=1)
        labels = torch.where(low_q, 1, labels)
        labels = sample_anchor_labels(labels, s["rpn_batch"],
                                      s["rpn_fraction"], sampling)
        matched = torch.gather(gb.float(), 1, idx[..., None].expand(-1, -1, 4))
        norm = float(b * s["rpn_batch"])
        pos = labels == 1
        gt_d = encode(anchors[None].expand_as(matched), matched, (1.0,) * 4)
        loc = (deltas - gt_d).abs()
        loss_rpn_loc = torch.where(pos[..., None], loc,
                                   torch.zeros_like(loc)).sum() / norm
        z = logits
        bce = z.clamp(min=0) - z * pos.float() + torch.log1p(torch.exp(
            -z.abs()))
        loss_rpn_cls = torch.where(labels >= 0, bce,
                                   torch.zeros_like(bce)).sum() / norm

        rb, rc, rv = rois
        sper = rb.shape[1]
        pooled = torch.cat([roi_align(feat_rcnn[i], rb[i], 7, 1 / 16.0)
                            for i in range(b)])
        feat = torch.cat([d.res5_head(pooled[j:j + 256])
                          for j in range(0, pooled.shape[0], 256)])
        # the matched GT box of each sampled ROI: the first best IoU
        gtb = []
        for i in range(b):
            m = torch.where(gv[i][:, None],
                            iou_matrix(gb[i].float(), rb[i].float()),
                            torch.full((gb.shape[1], sper), -1.0,
                                       device=rb.device))
            gtb.append(gb[i].float()[m.argmax(dim=0)])
        gtb = torch.cat(gtb)
        boxes = rb.reshape(-1, 4).float()
        keep = 1.0 - s["dropout"]

        def drop(x):
            mask = torch.rand(x.shape, generator=dropout,
                              device=dropout.device).to(x.device) < keep
            return torch.where(mask, x / keep, torch.zeros_like(x))

        t = self.attention(feat, rc, rv)
        t_scores = self.lin(drop(t), "roi_heads.box_predictor.cls_score")
        t_deltas = self.lin(feat, "roi_heads.box_predictor.bbox_pred")
        a = F.relu(self.lin(F.relu(self.lin(feat, "roi_heads.mlp_adapter.0")),
                            "roi_heads.mlp_adapter.2"))
        n = rv.sum().clamp(min=1)
        per = ((a - t.detach()) ** 2).mean(-1)
        loss_feat = torch.where(rv, per, torch.zeros_like(per)).sum() / n
        s_scores = self.lin(drop(a), "roi_heads.stu_box_predictor.cls_score")
        s_deltas = self.lin(feat, "roi_heads.stu_box_predictor.bbox_pred")
        temp = s["kl_temp"]
        logp_s = torch.log_softmax(s_scores / temp, 1)
        p_t = torch.softmax(t_scores.detach() / temp, 1)
        logp_t = torch.log_softmax(t_scores.detach() / temp, 1)
        kl = (p_t * (logp_t - logp_s)).sum(1)
        kl = torch.where(rc == s["classes"], kl * 1.5, kl)
        loss_kl = torch.where(rv, kl, torch.zeros_like(kl)).sum() / n * \
            temp * temp
        lc, lb = self.det_losses(s_scores, s_deltas, boxes, gtb, rc, rv)
        lct, lbt = self.det_losses(t_scores, t_deltas, boxes, gtb, rc, rv)
        return {"loss_rpn_cls": loss_rpn_cls, "loss_rpn_loc": loss_rpn_loc,
                "loss_cls": lc, "loss_box_reg": lb, "loss_cls_t": lct,
                "loss_box_reg_t": lbt, "loss_student_feat": loss_feat,
                "loss_kl": loss_kl}

    def grads(self, image, image_hw, gt, rois, gens, block=4):
        """(losses, {trainable name: gradient}) of one step. res4 is made
        without autograd, the heads' graph is run back to it, then res4 is
        recomputed ``block`` images at a time and run back to its
        weights."""
        leaves = {n: self.sd[n].detach().requires_grad_(True)
                  for n in self.trainable}
        self.sd.update(leaves)
        with torch.no_grad():
            x3 = torch.cat([self.to_res3(image[i:i + block])
                            for i in range(0, image.shape[0], block)])
            r4 = torch.cat([self.res4_stage(x3[i:i + block])
                            for i in range(0, x3.shape[0], block)])
        r4 = r4.requires_grad_(True)
        losses = self.losses(r4, image_hw, gt, rois, gens)
        total = sum(losses.values())
        head = [n for n in self.trainable if not n.startswith(
            "backbone.")]
        g = torch.autograd.grad(total, [r4] + [leaves[n] for n in head],
                                allow_unused=True)
        out = {n: gi for n, gi in zip(head, g[1:])}
        body = [n for n in self.trainable if n.startswith("backbone.")]
        acc = {n: torch.zeros_like(leaves[n]) for n in body}
        for i in range(0, x3.shape[0], block):
            y = self.res4_stage(x3[i:i + block])
            gi = torch.autograd.grad(y, [leaves[n] for n in body],
                                     grad_outputs=g[0][i:i + block],
                                     allow_unused=True)
            for n, t in zip(body, gi):
                if t is not None:
                    acc[n] += t
        out.update(acc)
        out = {n: (v if v is not None else torch.zeros_like(leaves[n]))
               for n, v in out.items()}
        return {k: float(v.detach()) for k, v in losses.items()}, out


def sgd_step(params, grads, bufs, groups, lr, momentum):
    """torch.optim.SGD (dampening 0): d = g + wd * p; buf = d on the first
    step, else momentum * buf + d; p -= lr * buf. ``groups``: name ->
    (lr factor, weight decay)."""
    for n, g in grads.items():
        factor, wd = groups[n]
        d = g + wd * params[n]
        bufs[n] = d.clone() if n not in bufs else momentum * bufs[n] + d
        params[n] = params[n] - lr * factor * bufs[n]


def lr_at(step: int, base: float, steps, gamma: float, warmup_iters: int,
          warmup_factor: float, method: str) -> float:
    """WarmupMultiStepLR."""
    w = 1.0
    if warmup_iters > 0 and step < warmup_iters:
        if method == "constant":
            w = warmup_factor
        else:
            alpha = step / warmup_iters
            w = warmup_factor * (1 - alpha) + alpha
    return base * w * gamma ** sum(step >= s for s in steps)

