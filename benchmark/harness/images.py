"""Images and ground truth drawn from the seed, made on the card in a few
large calls, resized and padded as the program's loaders resize and pad,
and handed over as page-locked host batches.

An image is a smooth field of colour (bilinear noise) with 1 to 3 solid
rectangles on it and some pixel noise; the rectangles are its ground-truth
objects. A traffic file fixes the sizes and how many images have each, so
every seed makes the same set of sizes in another order, with other
pixels and boxes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def resize_shortest_edge(h: int, w: int, short: int, max_size: int):
    """detectron2's ResizeShortestEdge output size (the program's rule)."""
    scale = short / min(h, w)
    if h < w:
        nh, nw = short, scale * w
    else:
        nh, nw = scale * h, short
    if max(nh, nw) > max_size:
        s = max_size / max(nh, nw)
        nh, nw = nh * s, nw * s
    return int(nh + 0.5), int(nw + 0.5)


def pick_bucket(h: int, w: int, buckets):
    """The smallest bucket by area that covers (h, w), either orientation;
    else both sides rounded up to 64 (the program's rule)."""
    cands = [(bh * bw, bh, bw) for b0, b1 in buckets
             for bh, bw in ((b0, b1), (b1, b0)) if bh >= h and bw >= w]
    if cands:
        return min(cands)[1:]
    return (int(math.ceil(h / 64) * 64), int(math.ceil(w / 64) * 64))


def draw_images(n: int, h: int, w: int, num_classes: int, gen,
                device, max_objects: int = 3):
    """n images (n, h, w, 3) uint8 with their ground truth: boxes
    (n, max_objects, 4) XYXY, classes (n, max_objects) int32 and valid
    (n, max_objects) bool; 1 to ``max_objects`` objects an image."""
    lh, lw = h // 32 + 2, w // 32 + 2
    field = torch.rand(n, 3, lh, lw, generator=gen, device=device) * 255
    img = F.interpolate(field, size=(h, w), mode="bilinear",
                        align_corners=False)
    counts = torch.randint(1, max_objects + 1, (n,), generator=gen,
                           device=device)
    valid = torch.arange(max_objects, device=device)[None] < counts[:, None]
    side = torch.tensor([w, h, w, h], device=device, dtype=torch.float32)
    u = torch.rand(n, max_objects, 4, generator=gen, device=device)
    size = 0.1 + 0.6 * u[..., 2:]                 # 10% to 70% of the side
    start = u[..., :2] * (1.0 - size)
    boxes = torch.cat([start, start + size], -1) * side
    boxes = torch.floor(boxes)
    classes = torch.randint(0, num_classes, (n, max_objects), generator=gen,
                            device=device, dtype=torch.int32)
    colour = torch.rand(n, max_objects, 3, generator=gen,
                        device=device) * 255
    ys = torch.arange(h, device=device, dtype=torch.float32)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    for k in range(max_objects):
        b = boxes[:, k]
        inside = ((ys[None, :, None] >= b[:, 1, None, None])
                  & (ys[None, :, None] < b[:, 3, None, None])
                  & (xs[None, None, :] >= b[:, 0, None, None])
                  & (xs[None, None, :] < b[:, 2, None, None])
                  & valid[:, k, None, None])
        img = torch.where(inside[:, None], colour[:, k, :, None, None], img)
    img = img + 8.0 * torch.randn(img.shape, generator=gen, device=device)
    img = img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return img.contiguous(), boxes, classes, valid


def resize_into(images, boxes, nh: int, nw: int, bucket):
    """Resize (n, h, w, 3) uint8 images to (nh, nw) bilinearly, pad them
    with zero pixels to ``bucket`` and scale their boxes."""
    n, h, w, _ = images.shape
    x = images.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
    x = x.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    out = torch.zeros((n, bucket[0], bucket[1], 3), dtype=torch.uint8,
                      device=images.device)
    out[:, :nh, :nw] = x
    scale = torch.tensor([nw / w, nh / h, nw / w, nh / h],
                         device=boxes.device)
    return out, boxes * scale


def host_batch(image, hw, orig_hw, gt_boxes, gt_classes, gt_valid, max_gt,
               ids):
    """One ``(ImageBatch, GTInstances, meta)`` of the program's structures
    (GT padded to ``max_gt``), page-locked where there is a card."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.structures \
        import GTInstances, ImageBatch

    n, g = gt_valid.shape
    boxes = torch.zeros((n, max_gt, 4), dtype=torch.float32)
    classes = torch.zeros((n, max_gt), dtype=torch.int32)
    valid = torch.zeros((n, max_gt), dtype=torch.bool)
    boxes[:, :g] = gt_boxes.cpu()
    classes[:, :g] = gt_classes.cpu()
    valid[:, :g] = gt_valid.cpu()
    boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    pinned = torch.cuda.is_available()
    pin = [t.cpu().pin_memory() if pinned else t.cpu()
           for t in (image, hw, orig_hw, boxes, classes, valid)]
    images = ImageBatch(image=pin[0], hw=pin[1], orig_hw=pin[2])
    gt = GTInstances(boxes=pin[3], classes=pin[4], valid=pin[5])
    return images, gt, {"image_ids": list(ids), "valid_count": n}
