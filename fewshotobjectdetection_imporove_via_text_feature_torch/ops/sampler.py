"""Fixed-shape random foreground/background subsampling.

Counterpart of the JAX package's ``ops/sampler.py`` (detectron2's
``subsample_labels``): candidates are ranked by a random priority with
``top_k`` (ties to the lower index, as ``lax.top_k``) and masked, so every
output has a static shape. Semantics: num_pos = min(#pos, int(batch_size *
positive_fraction)); num_neg = min(#neg, batch_size - num_pos); a uniform
choice without replacement within each group.

Each draw takes its priorities either from a ``torch.Generator`` (uniform
in [0, 1)) or from a tensor the caller passes in, so that a test can hand
the port the JAX package's own draw. Works on one image or a batch (leading
axes). Under a process group a generator's draw over a batch is made at the
global batch's shape and this rank keeps its rows
(``parallel.local_rand``), so N ranks sample what one process samples.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import local_rand
from .nms import top_k


def _ranked_take(eligible: torch.Tensor, k: int, generator=None,
                 priority=None):
    """k of the ``eligible`` slots (..., N) uniformly at random: (idx (...,
    k) int64, valid (..., k)), valid marking slots backed by an eligible
    entry. The draw is ``priority`` (..., N) if given, else uniform from
    ``generator``."""
    k = min(k, eligible.shape[-1])
    if priority is None:
        priority = local_rand(eligible.shape, generator, eligible.device)
    pri = torch.where(eligible, priority, torch.full_like(priority, -1.0))
    vals, idx = top_k(pri, k)
    return idx, vals >= 0.0


def subsample_labels(labels: torch.Tensor, batch_size_per_image: int,
                     positive_fraction: float, bg_label: int,
                     generator=None, priorities=None) -> torch.Tensor:
    """The RPN's label subsampling: labels (..., N) with 1 positive,
    ``bg_label`` negative, -1 ignored -> the same with every unsampled entry
    -1. ``priorities``: (positive draw, negative draw), each (..., N)."""
    pp, pn = priorities if priorities is not None else (None, None)
    pos_mask = labels == 1
    neg_mask = labels == bg_label
    max_pos = int(batch_size_per_image * positive_fraction)
    num_pos = torch.clamp(pos_mask.sum(dim=-1, keepdim=True), max=max_pos)
    num_neg = torch.minimum(neg_mask.sum(dim=-1, keepdim=True),
                            batch_size_per_image - num_pos)

    pos_idx, pos_ok = _ranked_take(pos_mask, max_pos, generator, pp)
    neg_idx, neg_ok = _ranked_take(neg_mask, batch_size_per_image,
                                   generator, pn)
    rank_p = torch.arange(pos_idx.shape[-1], device=labels.device)
    rank_n = torch.arange(neg_idx.shape[-1], device=labels.device)
    pos_keep = pos_ok & (rank_p < num_pos)
    neg_keep = neg_ok & (rank_n < num_neg)

    out = torch.full(labels.shape, -1, dtype=torch.int32,
                     device=labels.device)
    out = out.scatter(-1, pos_idx, torch.where(
        pos_keep, 1, out.gather(-1, pos_idx)).to(torch.int32))
    out = out.scatter(-1, neg_idx, torch.where(
        neg_keep, 0, out.gather(-1, neg_idx)).to(torch.int32))
    return out


def sample_proposals_fixed(gt_classes: torch.Tensor,
                           batch_size_per_image: int,
                           positive_fraction: float, num_classes: int,
                           generator=None, priorities=None):
    """The ROI heads' sampling into ``batch_size_per_image`` fixed slots.

    gt_classes (..., N) in [0, num_classes] (num_classes = background) or
    -1 (ignored or padded). Returns sampled_idx (..., S) int64 and
    sampled_valid (..., S) bool: slot i holds the i-th sampled foreground
    while i < num_fg, then the backgrounds; slots left unfilled are invalid.
    """
    pp, pn = priorities if priorities is not None else (None, None)
    fg_mask = (gt_classes >= 0) & (gt_classes != num_classes)
    bg_mask = gt_classes == num_classes
    max_pos = int(batch_size_per_image * positive_fraction)
    num_fg = torch.clamp(fg_mask.sum(dim=-1, keepdim=True), max=max_pos)
    num_bg = torch.minimum(bg_mask.sum(dim=-1, keepdim=True),
                           batch_size_per_image - num_fg)

    fg_idx, fg_ok = _ranked_take(fg_mask, max_pos, generator, pp)
    bg_idx, bg_ok = _ranked_take(bg_mask, batch_size_per_image, generator,
                                 pn)
    slot = torch.arange(batch_size_per_image, device=gt_classes.device)
    take_fg = slot < num_fg
    bg_slot = torch.clamp(slot - num_fg, 0, bg_idx.shape[-1] - 1)
    fg_slot = torch.clamp(slot, 0, fg_idx.shape[-1] - 1).expand_as(bg_slot)
    sampled_idx = torch.where(take_fg, fg_idx.gather(-1, fg_slot),
                              bg_idx.gather(-1, bg_slot))
    sampled_valid = torch.where(
        take_fg, fg_ok.gather(-1, fg_slot),
        bg_ok.gather(-1, bg_slot) & (bg_slot < num_bg),
    )
    return sampled_idx, sampled_valid
