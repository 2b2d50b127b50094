"""Checkpoint surgery for the base -> novel few-shot workflow, on state
dicts.

Counterpart of the JAX package's ``checkpoint/surgery.py`` (the
reference's tools/model_surgery.py): ``surgery_remove`` drops the box
predictor so the fine-tune initialises it; ``surgery_randinit`` widens it
from the base classes to all classes, base rows copied (VOC: the first
positions; COCO: through the base-id -> all-contiguous-id map), the
background row kept, novel rows N(0, 0.01) with zero bias;
``reset_optimizer`` drops the optimizer state and zeroes the iteration;
``surgery_reset_student`` draws a text head's student branch
(``stu_box_predictor``, ``mlp_adapter``) afresh for a cold student.

The novel rows are drawn from ``np.random.RandomState(seed)`` in the JAX
package's order and shapes (a (features, outputs) kernel, cls_score before
bbox_pred), then transposed to this package's (outputs, features) weights,
so the two packages' surgery gives the same numbers.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

COCO_NOVEL_IDS = [1, 2, 3, 4, 5, 6, 7, 9, 16, 17, 18, 19, 20, 21, 44, 62, 63,
                  64, 67, 72]
COCO_BASE_IDS = [8, 10, 11, 13, 14, 15, 22, 23, 24, 25, 27, 28, 31, 32, 33,
                 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46, 47, 48, 49, 50,
                 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 65, 70, 73, 74,
                 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90]
COCO_ALL_IDS = sorted(COCO_BASE_IDS + COCO_NOVEL_IDS)
COCO_IDMAP = {v: i for i, v in enumerate(COCO_ALL_IDS)}

PREDICTORS = ("roi_heads.box_predictor",)


def surgery_remove(state: Dict[str, torch.Tensor],
                   predictors=PREDICTORS) -> Dict[str, torch.Tensor]:
    """A copy of ``state`` without the predictors' cls_score and bbox_pred."""
    heads = tuple(f"{p}.{h}." for p in predictors
                  for h in ("cls_score", "bbox_pred"))
    return {k: v for k, v in state.items() if not k.startswith(heads)}


def surgery_randinit(state: Dict[str, torch.Tensor], num_all_classes: int,
                     dataset: str = "voc", seed: int = 0,
                     predictors=PREDICTORS) -> Dict[str, torch.Tensor]:
    """A copy of ``state`` with the predictors widened to
    ``num_all_classes``."""
    rng = np.random.RandomState(seed)
    out = dict(state)
    base_pos = ([COCO_IDMAP[c] for c in COCO_BASE_IDS]
                if dataset == "coco" else None)
    for pred in predictors:
        if f"{pred}.cls_score.weight" not in state:
            continue
        for head, tar, per in (("cls_score", num_all_classes + 1, 1),
                               ("bbox_pred", num_all_classes * 4, 4)):
            weight = state[f"{pred}.{head}.weight"].numpy()  # (out, D)
            bias = state[f"{pred}.{head}.bias"].numpy()
            prev_cls = (weight.shape[0] - 1 if head == "cls_score"
                        else weight.shape[0] // 4)
            new_w = rng.normal(0, 0.01, (weight.shape[1], tar)).astype(
                weight.dtype).T.copy()
            new_b = np.zeros((tar,), bias.dtype)
            rows = (range(prev_cls) if base_pos is None else base_pos)
            for idx, pos in enumerate(rows):
                new_w[pos * per:(pos + 1) * per] = \
                    weight[idx * per:(idx + 1) * per]
                new_b[pos * per:(pos + 1) * per] = \
                    bias[idx * per:(idx + 1) * per]
            if head == "cls_score":  # background, last
                new_w[-1] = weight[-1]
                new_b[-1] = bias[-1]
            out[f"{pred}.{head}.weight"] = torch.from_numpy(new_w)
            out[f"{pred}.{head}.bias"] = torch.from_numpy(new_b)
    return out


def reset_optimizer(checkpoint: Dict) -> Dict:
    """A copy of a training checkpoint without optimizer or scheduler state
    and with iteration 0."""
    out = {k: v for k, v in checkpoint.items()
           if k not in ("optimizer", "scheduler")}
    out["iteration"] = 0
    return out


STUDENT = ("stu_box_predictor", "mlp_adapter")


def surgery_reset_student(state: Dict[str, torch.Tensor], seed: int = 123):
    """A copy of ``state`` with the text head's student branch drawn
    afresh from a ``torch.Generator`` seeded with ``seed``: weights
    N(0, 1 / fan_in), biases zero; the teacher, backbone and RPN as they
    were. Returns (state, the number of tensors reset); raises ValueError
    below 6 (not a TextRes5ROIHeads checkpoint)."""
    gen = torch.Generator().manual_seed(seed)
    out, n = dict(state), 0
    for name, value in state.items():
        if not any(f".{s}." in f".{name}" for s in STUDENT):
            continue
        value = torch.as_tensor(value)
        if value.dim() >= 2:  # (out, in): fan_in is the product after out
            fan_in = int(np.prod(value.shape[1:]))
            out[name] = torch.randn(value.shape, generator=gen,
                                    dtype=value.dtype) / np.sqrt(
                                        max(fan_in, 1))
        else:
            out[name] = torch.zeros_like(value)
        n += 1
    if n < 6:
        raise ValueError(
            f"student branch not found (reset {n} tensors): is this a "
            "TextRes5ROIHeads checkpoint?")
    return out, n
