"""A layer computation shared by the RPN head and the ConvFC box head."""

from __future__ import annotations


def with_bias(op, x, weight, bias, *args, **kwargs):
    """``op(x, weight) + bias`` in ``x.dtype``, ``op`` being ``F.conv2d`` or
    ``F.linear`` (``args`` and ``kwargs`` go to it). The bias is added after
    the product, as flax's ``Conv`` and ``Dense`` add it: below float32 the
    product is rounded to ``x.dtype`` before the bias is added, the JAX
    package's two roundings."""
    y = op(x, weight.to(x.dtype), None, *args, **kwargs)
    return y + bias.to(x.dtype).reshape(-1, *(1,) * (y.dim() - 2))
