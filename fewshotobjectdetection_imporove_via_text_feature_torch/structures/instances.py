"""Fixed-shape batched detection structures (dataclasses of tensors).

Counterparts of the JAX package's pytrees: every field is a dense, padded
tensor with an explicit validity mask, batched on the leading axis.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch


@dataclass
class _TensorTuple:
    def to(self, *args, **kwargs):
        """Copy of the structure with every tensor field moved by
        ``Tensor.to(*args, **kwargs)``."""
        return type(self)(
            **{f.name: getattr(self, f.name).to(*args, **kwargs)
               for f in fields(self)}
        )


@dataclass
class ImageBatch(_TensorTuple):
    """Batched padded images.

    image: (B, H, W, 3) uint8 or float — raw BGR pixels, zero-padded past
        ``hw`` (normalization happens in the model).
    hw: (B, 2) int32 — valid (height, width) of each image after resize.
    orig_hw: (B, 2) int32 — original file size, for output rescaling.
    """

    image: torch.Tensor
    hw: torch.Tensor
    orig_hw: torch.Tensor


@dataclass
class GTInstances(_TensorTuple):
    """Padded ground truth: boxes (B, G, 4) XYXY in the resized image frame,
    classes (B, G) int32, valid (B, G) bool; G is ``TPU.MAX_GT``."""

    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor


@dataclass
class Proposals(_TensorTuple):
    """Padded proposals: boxes (B, P, 4), objectness (B, P), valid (B, P)."""

    boxes: torch.Tensor
    objectness: torch.Tensor
    valid: torch.Tensor


@dataclass
class Detections(_TensorTuple):
    """Padded final detections per image: boxes (B, D, 4) in the ORIGINAL
    image frame; scores (B, D); classes (B, D) int32; valid (B, D) bool."""

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
