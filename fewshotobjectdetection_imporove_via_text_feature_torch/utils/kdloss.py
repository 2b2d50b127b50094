"""The DKD-style distillation loss decomposed into foreground/background
and class terms (ref defrcn/utils/kdloss.py:5-50, ``dandr_loss``), in
PyTorch; counterpart of the JAX package's ``utils/kdloss.py``. No model
calls it."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from ..parallel.collectives import global_normalizer


def dandr_loss(logits_student, logits_teacher, target, alpha, beta,
               temperature, detach_target=True):
    """logits (N, K) with the background last, target (N,) in [0, K)."""
    if detach_target:
        logits_teacher = logits_teacher.detach()
    t = temperature
    n, k = logits_student.shape
    target = target.long()
    fg = target != k - 1
    onehot = F.one_hot(target, k).bool()
    last = torch.zeros((n, k), dtype=torch.bool, device=target.device)
    last[:, -1] = True
    gt_mask = onehot & ~last
    other_mask = ~onehot | last

    pred_teacher = F.softmax(logits_teacher / t, dim=1)
    p_non_target_pos_teacher = (pred_teacher * other_mask).sum(dim=1)

    nt_logits_t = logits_teacher - 1000.0 * gt_mask
    nt_logits_s = logits_student - 1000.0 * gt_mask
    bg_mask, non_bg_mask = last, ~last
    nt_pred_s = F.softmax(nt_logits_s / t, dim=1)
    nt_pred_t = F.softmax(nt_logits_t / t, dim=1)

    def cat_mask(p):
        return torch.stack([(p * bg_mask).sum(1), (p * non_bg_mask).sum(1)],
                           dim=1)

    p_fbd_s = cat_mask(nt_pred_s)
    p_fbd_t = cat_mask(nt_pred_t)
    loss_fbd = (p_fbd_t * (torch.log(torch.clamp(p_fbd_t, min=1e-30))
                           - torch.log(torch.clamp(p_fbd_s, min=1e-30)))
                ).sum(dim=1) * t * t

    p_fcd_t = F.softmax(nt_logits_t / t - 1000.0 * bg_mask, dim=1)
    logp_fcd_s = F.log_softmax(nt_logits_s / t - 1000.0 * bg_mask, dim=1)
    logp_fcd_t = F.log_softmax(nt_logits_t / t - 1000.0 * bg_mask, dim=1)
    loss_fcd = p_fbd_t[:, 1] * (
        (p_fcd_t * (logp_fcd_t - logp_fcd_s)).sum(dim=1) * t * t)

    def masked_mean(v, m):  # over the global batch's count
        return torch.where(m, v, torch.zeros_like(v)).sum() \
            / global_normalizer(m.sum())

    return (alpha * masked_mean(p_non_target_pos_teacher * loss_fbd, fg)
            + beta * masked_mean(loss_fbd, ~fg)
            + masked_mean(p_non_target_pos_teacher * loss_fcd, fg)
            + masked_mean(loss_fcd, ~fg))
