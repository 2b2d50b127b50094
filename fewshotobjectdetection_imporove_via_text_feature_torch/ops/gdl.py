"""Gradient Decoupled Layer — DeFRCN's core trick, as an autograd Function.

Identity forward; the backward pass multiplies the incoming gradient by a
constant ``scale`` (0 before the RPN, 0.75 before the ROI heads in base
training). Counterpart of the JAX package's ``ops/gdl.py`` custom_vjp.
"""

from __future__ import annotations

import torch


class _DecoupleLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = float(scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def decouple_layer(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward; multiplies the gradient by ``scale`` on backward."""
    return _DecoupleLayer.apply(x, scale)
