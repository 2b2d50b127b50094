"""On-device preprocessing (TPU.DEVICE_PREPROCESS): the loader decodes and
pads the raw pixels into a source bucket, and the resize to the shortest
edge and the horizontal flip run on the model's device.

Counterpart of the JAX package's ``data/xla_preprocess.py``. The resize is
``jax.image.scale_and_translate(method="linear", antialias=False)`` with a
scale of its own for each image: output pixel o samples the source at
``(o + 0.5) / s - 0.5`` with the triangle kernel, each output's weights
divided by their sum, and an output whose sample falls outside
[-0.5, size - 0.5] gets none. ``F.interpolate`` is not this function (one
scale for the batch, another sample formula, another border), so each
image's separable weights are built here and applied as two batched
matmuls. The JAX package's space-to-depth output is a TPU layout and has
no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..structures import ImageBatch


def _resize_weights(in_size: int, out_size: int,
                    scale: torch.Tensor) -> torch.Tensor:
    """(B, in, out) float32 linear-kernel weights of per-image ``scale``
    (B,), as ``jax.image.scale_and_translate`` builds them (translation 0,
    no antialiasing)."""
    dev = scale.device
    inv = 1.0 / scale
    sample = ((torch.arange(out_size, dtype=torch.float32, device=dev)
               + 0.5) * inv[:, None] - 0.5)  # (B, out)
    pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(sample[:, None, :] - pos[None, :, None]),
                    min=0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def device_resize_batch(raw: torch.Tensor, orig_hw: torch.Tensor,
                        flip: torch.Tensor, short, max_size: int,
                        out_hw: Tuple[int, int]):
    """ResizeShortestEdge and the horizontal flip into a fixed canvas.

    raw (B, Hs, Ws, 3) uint8 or float, the valid (h, w) of each image in
    ``orig_hw`` (B, 2); ``flip`` (B,) bool; ``short`` a number or (B,).
    Returns (images float32 (B, H, W, 3), zero past each image's resized
    extent, and that extent new_hw (B, 2) int32). detectron2's scale rule:
    short / min(h, w), shrunk so that max(h, w) * scale <= max_size, the
    sizes rounded as the host mapper rounds them.
    """
    b, hs, ws = raw.shape[:3]
    oh, ow = out_hw
    dev = raw.device
    f32 = torch.float32
    short = torch.as_tensor(short, dtype=f32, device=dev).expand(b)
    h = orig_hw[:, 0].to(f32)
    w = orig_hw[:, 1].to(f32)
    # divisions of device tensors: ``float / tensor`` would multiply by a
    # reciprocal, one rounding off the JAX package's quotient
    scale = torch.minimum(short / torch.minimum(h, w),
                          torch.full_like(h, float(max_size))
                          / torch.maximum(h, w))
    newh = torch.floor(h * scale + 0.5)
    neww = torch.floor(w * scale + 0.5)

    # one clamped-index gather flips x -> w-1-x inside the valid region and
    # replicates the last valid row and column into the pad: the linear
    # kernel's last outputs tap the first pad row/column when upscaling,
    # and the weights are not renormalised for it
    hi = orig_hw[:, 0:1].long()
    wi = orig_hw[:, 1:2].long()
    rows = torch.minimum(torch.arange(hs, device=dev)[None], hi - 1)  # (B, Hs)
    cols = torch.minimum(torch.arange(ws, device=dev)[None], wi - 1)
    cols = torch.where(flip.to(dev)[:, None], wi - 1 - cols, cols)
    bidx = torch.arange(b, device=dev)[:, None, None]
    img = raw[bidx, rows[:, :, None], cols[:, None, :]].to(f32)  # (B,Hs,Ws,3)

    wy = _resize_weights(hs, oh, newh / h)  # (B, Hs, H)
    wx = _resize_weights(ws, ow, neww / w)  # (B, Ws, W)
    x = img.permute(0, 3, 1, 2)  # (B, 3, Hs, Ws)
    x = torch.matmul(x, wx[:, None])  # (B, 3, Hs, W)
    x = torch.matmul(wy.transpose(1, 2)[:, None], x)  # (B, 3, H, W)
    out = x.permute(0, 2, 3, 1)
    yy = torch.arange(oh, dtype=f32, device=dev)
    xx = torch.arange(ow, dtype=f32, device=dev)
    mask = ((yy[None, :, None] < newh[:, None, None])
            & (xx[None, None, :] < neww[:, None, None]))
    out = out * mask[..., None]
    return out, torch.stack([newh, neww], dim=1).to(torch.int32)


def preprocess_batch(images: ImageBatch, meta) -> ImageBatch:
    """A raw batch of the device-preprocessing loader (``meta`` holds the
    draws ``short`` and ``flip`` and the batch's ``target_hw`` and
    ``max_size``) -> the batch resized on its device."""
    dev = images.image.device
    resized, _ = device_resize_batch(
        images.image, images.orig_hw,
        torch.as_tensor(meta["flip"]).to(dev),
        torch.as_tensor(meta["short"]).to(dev), meta["max_size"],
        tuple(meta["target_hw"]))
    return ImageBatch(image=resized, hw=images.hw, orig_hw=images.orig_hw)


def scale_boxes(boxes, orig_hw, new_hw, flip):
    """The GT box transform of ``device_resize_batch``, on the host: boxes
    (G, 4) in original coordinates -> flipped and resized."""
    h0, w0 = float(orig_hw[0]), float(orig_hw[1])
    h1, w1 = float(new_hw[0]), float(new_hw[1])
    sy, sx = h1 / h0, w1 / w0
    b = np.asarray(boxes, np.float32).copy()
    if flip:
        x1 = w0 - b[:, 2]
        x2 = w0 - b[:, 0]
        b[:, 0], b[:, 2] = x1, x2
    b *= np.array([sx, sy, sx, sy], np.float32)
    b[:, 0::2] = b[:, 0::2].clip(0, w1)
    b[:, 1::2] = b[:, 1::2].clip(0, h1)
    return b
