"""Which version of a kernel runs: chosen by the tensor's device.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the
hand-written kernel, which launches or raises. The one exception is
explicit: inside ``with plain_ops():`` CUDA tensors take the plain versions
too, so a caller can run the same model through both and compare them on
the card. Nothing chooses the plain path on its own.
"""

from __future__ import annotations

import contextlib

import torch

_plain_depth = 0


@contextlib.contextmanager
def plain_ops():
    """Run the plain PyTorch versions of the kernels on CUDA tensors too."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def use_kernel(t: torch.Tensor) -> bool:
    """True when ``t`` goes to the CUDA kernel, False for the plain version;
    raises for a device that has neither."""
    if t.device.type == "cpu":
        return False
    if t.is_cuda:
        return _plain_depth == 0
    raise NotImplementedError(f"no kernel for device {t.device}")


def use_operator(t: torch.Tensor) -> bool:
    """True when ``t`` goes through an ``fsod::`` operator
    (``ops/custom_ops.py``: the kernel on CUDA, the plain version on the
    CPU); False inside ``plain_ops()`` on CUDA, where the caller runs the
    plain version itself."""
    return t.device.type == "cpu" or use_kernel(t)
