"""Proposal/anchor <-> ground-truth matcher over padded GT.

Counterpart of the JAX package's ``ops/matcher.py`` (detectron2's
``Matcher``): padded GT rows score IoU -1 and never win; with no valid GT
every candidate gets quality 0 and index 0; ``argmax`` takes the first
maximum. Works on one image or a batch (leading axes).
"""

from __future__ import annotations

import torch


def match_proposals(iou: torch.Tensor, gt_valid: torch.Tensor, thresholds,
                    labels, allow_low_quality_matches: bool = False):
    """Match each of N candidates to one of M padded ground-truth boxes.

    Args:
        iou: (..., M, N) quality matrix (rows GT, columns candidates).
        gt_valid: (..., M) bool mask of the real GT rows.
        thresholds: increasing, e.g. (0.3, 0.7).
        labels: len(thresholds) + 1 values in {-1, 0, 1}; labels[i] goes to
            candidates whose best quality is in [thresholds[i-1],
            thresholds[i]).
        allow_low_quality_matches: the candidates tying a valid GT's best
            IoU (where that is > 0) become positive (the RPN's rule).

    Returns:
        matched_idx (..., N) int64 and match_labels (..., N) int32.
    """
    neg = torch.full((), -1.0, dtype=iou.dtype, device=iou.device)
    masked = torch.where(gt_valid[..., :, None], iou, neg)
    matched_vals = masked.amax(dim=-2)
    matched_idx = masked.argmax(dim=-2)  # the first maximum

    any_valid = gt_valid.any(dim=-1, keepdim=True)
    matched_vals = torch.where(any_valid, matched_vals,
                               torch.zeros_like(matched_vals))
    matched_idx = torch.where(any_valid, matched_idx,
                              torch.zeros_like(matched_idx))

    match_labels = torch.full(matched_vals.shape, labels[0],
                              dtype=torch.int32, device=iou.device)
    highs = list(thresholds[1:]) + [float("inf")]
    for lab, lo, hi in zip(labels[1:], thresholds, highs):
        inside = (matched_vals >= lo) & (matched_vals < hi)
        match_labels = torch.where(inside, torch.full_like(match_labels, lab),
                                   match_labels)

    if allow_low_quality_matches:
        highest = masked.amax(dim=-1, keepdim=True)  # (..., M, 1)
        best = (iou >= highest) & (highest > 0) & gt_valid[..., :, None]
        match_labels = torch.where(best.any(dim=-2),
                                   torch.ones_like(match_labels),
                                   match_labels)
    return matched_idx, match_labels
