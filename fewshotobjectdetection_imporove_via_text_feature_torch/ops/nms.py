"""Fixed-shape greedy NMS: the plain PyTorch version and the device switch.

Counterpart of the JAX package's ``ops/nms.py``. ``nms_sorted_plain`` is the
plain version of the CUDA kernel in ``ops/nms_cuda.py`` and defines what
both compute: exact greedy NMS (descending score, stable ties, IoU >
threshold suppresses) over padded boxes with a validity mask, in 128-box
tiles. Within a tile the greedy result is the fixpoint of "kept iff active
and no kept earlier box overlaps"; across tiles, boxes kept earlier
suppress the tile in one pass. With ``max_keep`` the sweep stops at the
first tile boundary where at least ``max_keep`` boxes are kept, so later
keep flags stay False, exactly as in the JAX package.

Every function takes one image (N, 4) or a batch (B, N, 4).
"""

from __future__ import annotations

import torch

from .box_ops import pairwise_iou
from .dispatch import use_kernel

TILE = 128


def _batched(boxes, *rest):
    """Add a leading batch axis to one-image inputs; returns (squeeze,
    boxes, *rest)."""
    if boxes.dim() == 2:
        return True, boxes[None], *(t[None] for t in rest)
    return False, boxes, *rest


def stable_sort_desc(x: torch.Tensor, dim: int = -1):
    """Descending sort with the tie rule of ``jax.lax.top_k`` and
    ``jnp.argsort(-x, stable=True)``: of equal values, the lower index
    comes first. Returns (values, indices)."""
    return torch.sort(x, dim=dim, descending=True, stable=True)


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: (values, indices), ties to the
    lower index (``torch.topk`` does not promise that)."""
    values, idx = stable_sort_desc(x)
    return values[..., :k], idx[..., :k]


def nms_sorted_plain(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_keep: int | None = None,
) -> torch.Tensor:
    """Keep mask (B, N) for boxes (B, N, 4) already in descending score
    order. The plain version of ``nms_cuda.nms_sorted_cuda``."""
    b, n = valid.shape
    pad = (-n) % TILE
    if pad:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    np_ = n + pad
    dev = boxes.device
    thresh = torch.tensor(iou_threshold, dtype=torch.float32, device=dev)
    keep = torch.zeros((b, np_), dtype=torch.bool, device=dev)
    count = torch.zeros((b,), dtype=torch.int64, device=dev)
    earlier = torch.ones((TILE, TILE), dtype=torch.bool, device=dev)
    earlier = torch.triu(earlier, diagonal=1)  # [j, k]: j < k
    for i in range(np_ // TILE):
        s = i * TILE
        tb = boxes[:, s : s + TILE]
        active = valid[:, s : s + TILE].clone()
        if max_keep is not None:
            running = count < max_keep
            if not bool(running.any()):
                break
            active &= running[:, None]
        if s:
            cross = pairwise_iou(tb, boxes[:, :s]) > thresh  # (B, T, s)
            active &= ~(cross & keep[:, None, :s]).any(dim=2)
        sup = (pairwise_iou(tb, tb) > thresh) & earlier  # (B, T, T)
        tile_keep = active
        while True:
            suppressed = (sup & tile_keep[:, :, None]).any(dim=1)
            new_keep = active & ~suppressed
            if torch.equal(new_keep, tile_keep):
                break
            tile_keep = new_keep
        keep[:, s : s + TILE] = tile_keep
        count += tile_keep.sum(dim=1)
    return keep[:, :n]


def tiles_visited(keep: torch.Tensor, max_keep: int | None = None):
    """128-box tiles the sweep of ``nms_sorted_plain`` (and of the kernel)
    visits per image, from its keep mask (B, N): all of them without
    ``max_keep``, else those before the first tile whose start finds at
    least ``max_keep`` boxes kept. Returns a list of B ints."""
    b, n = keep.shape
    ntiles = -(-n // TILE)
    if max_keep is None:
        return [ntiles] * b
    kept = keep.long()
    kept_before = torch.cumsum(kept, dim=1) - kept
    stop = kept_before[:, ::TILE] >= max_keep  # (B, ntiles)
    first = torch.where(stop.any(dim=1), stop.long().argmax(dim=1),
                        torch.full((b,), ntiles, device=keep.device))
    return [int(t) for t in first.tolist()]


def _sorted_nms(boxes, valid, iou_threshold, max_keep):
    """Device switch (``ops.dispatch``): the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if use_kernel(boxes):
        from .nms_cuda import nms_sorted_cuda

        return nms_sorted_cuda(boxes, valid, iou_threshold, max_keep)
    return nms_sorted_plain(boxes, valid, iou_threshold, max_keep)


def _nms(boxes, scores, valid, iou_threshold, assume_sorted, max_keep,
         sorted_nms):
    squeeze, boxes, scores, valid = _batched(boxes, scores, valid)
    b, n = valid.shape
    if assume_sorted:
        keep = sorted_nms(boxes, valid, iou_threshold, max_keep)
        order = torch.arange(n, device=boxes.device).expand(b, n)
    else:
        neg_inf = torch.full_like(scores, float("-inf"))
        _, order = stable_sort_desc(torch.where(valid, scores, neg_inf))
        sboxes = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
        keep_sorted = sorted_nms(
            sboxes, torch.gather(valid, 1, order), iou_threshold, max_keep
        )
        keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    if squeeze:
        return keep[0], order[0]
    return keep, order


def nms_fixed(boxes, scores, valid, iou_threshold: float,
              assume_sorted: bool = False, max_keep: int | None = None):
    """Greedy NMS over a fixed-size padded box set, plain PyTorch.

    Args:
        boxes: (N, 4) or (B, N, 4) XYXY float32.
        scores: (N,) / (B, N) — invalid entries may hold any value.
        valid: (N,) / (B, N) bool padding mask.
        iou_threshold: IoU > threshold suppresses.
        assume_sorted: valid scores are already descending in input order
            (straight out of a top-k); skips the stable sort and scatter.
        max_keep: stop at the first 128-box tile boundary with at least
            ``max_keep`` kept boxes; the first ``max_keep`` kept boxes are
            exactly those of the full run.

    Returns:
        keep (bool, original box order) and order (int64, stable
        score-descending), shaped like ``scores``.
    """
    return _nms(boxes, scores, valid, iou_threshold, assume_sorted,
                max_keep, nms_sorted_plain)


def nms_auto(boxes, scores, valid, iou_threshold: float,
             assume_sorted: bool = False, max_keep: int | None = None):
    """``nms_fixed`` on the tensors' device: the CUDA kernel for CUDA
    tensors (it launches or raises), the plain version for CPU tensors."""
    return _nms(boxes, scores, valid, iou_threshold, assume_sorted,
                max_keep, _sorted_nms)


def batched_nms_fixed(boxes, scores, idxs, valid, iou_threshold: float,
                      assume_sorted: bool = False, max_keep=None):
    """Class-aware NMS via the coordinate-offset trick: boxes of different
    ``idxs`` never overlap. The offset unit is 1 + the largest coordinate
    of the VALID boxes of each image."""
    squeeze, boxes, scores, idxs, valid = _batched(boxes, scores, idxs, valid)
    if boxes.shape[1] == 0:
        order = torch.zeros(valid.shape, dtype=torch.int64,
                            device=boxes.device)
        return (valid[0], order[0]) if squeeze else (valid, order)
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked.amax(dim=(1, 2)) + 1.0  # (B,)
    offsets = idxs.to(boxes.dtype) * max_coord[:, None]
    shifted = boxes + offsets[..., None]
    keep, order = nms_auto(shifted, scores, valid, iou_threshold,
                           assume_sorted=assume_sorted, max_keep=max_keep)
    if squeeze:
        return keep[0], order[0]
    return keep, order
