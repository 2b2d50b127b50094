"""Test-time image geometry: the resize and bucket rules of the JAX
package's ``data/mapper.py``."""

from __future__ import annotations

import math
from typing import Sequence, Tuple


def resize_shortest_edge_size(h, w, short, max_size):
    """detectron2 ResizeShortestEdge.get_output_shape semantics."""
    scale = short / min(h, w)
    if h < w:
        newh, neww = short, scale * w
    else:
        newh, neww = scale * h, short
    if max(newh, neww) > max_size:
        scale2 = max_size / max(newh, neww)
        newh, neww = newh * scale2, neww * scale2
    return int(newh + 0.5), int(neww + 0.5)


def pick_bucket(h: int, w: int, buckets: Sequence[Tuple[int, int]]):
    """Smallest bucket (by area) covering (h, w); orientation-aware (both
    (a, b) and (b, a) are considered). Falls back to round-up-to-64."""
    cands = []
    for bh, bw in buckets:
        for ch, cw in ((bh, bw), (bw, bh)):
            if ch >= h and cw >= w:
                cands.append((ch * cw, ch, cw))
    if cands:
        _, bh, bw = min(cands)
        return bh, bw
    up = lambda v: int(math.ceil(v / 64.0) * 64)  # noqa: E731
    return up(h), up(w)
