"""Edge cases of the port's two kernels, defined once for both sides.

``tests/test_torch_kernel_edges.py`` and ``tests/test_torch_train_ops.py``
hold the port's plain versions (and the plain ROIAlign's autograd gradient)
against the JAX package on these cases (CPU), and ``tests/test_torch_cuda.py``
holds the CUDA kernels, forward and backward, against the plain versions on
them (card). This
module imports neither JAX nor the JAX package, so the card file still runs
with ``pytest --noconftest``. Its own tests check, on the CPU, that each
case has the property its name claims.

Every input is made with numpy from a fixed seed.
"""

import numpy as np
import pytest
import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.ops.nms import (
    TILE,
    nms_sorted_plain,
    tiles_visited,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align_cuda import (
    BWD_TILE_COLS,
    BWD_TILE_ROWS,
)


# ------------------------------------------------------------------ NMS
def _clustered(rng, b, n, size=600.0):
    """Score-sorted boxes in clusters of ~12, so that many overlap."""
    ncl = max(1, n // 12)
    centers = rng.uniform(0, size, (b, ncl, 2))
    which = rng.randint(0, ncl, (b, n))
    c = np.take_along_axis(centers, which[..., None], axis=1)
    c = c + rng.randn(b, n, 2) * 6.0
    wh = np.exp(rng.uniform(2.5, 5.0, (b, n, 2)))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _grid(n, step=20.0, side=10.0):
    """n disjoint boxes on a grid: greedy NMS keeps every valid one."""
    i = np.arange(n)
    x, y = (i % 64) * step, (i // 64) * step
    return np.stack([x, y, x + side, y + side], -1).astype(np.float32)


def _runs(rng, n, run):
    """Leaders, each followed by ``run`` jittered copies of itself (IoU
    above 0.9 with it): every copy is suppressed, so the sweep meets runs
    of ``run`` removed boxes that cross 64-box words and the 1024-box
    chunk boundary."""
    boxes = np.empty((n, 4), np.float32)
    for start in range(0, n, run + 1):
        lead = np.array([(start % 997) * 7.0, (start // 997) * 300.0, 0, 0])
        lead[2:] = lead[:2] + 100.0
        stop = min(n, start + run + 1)
        boxes[start:stop] = lead + rng.uniform(-1.0, 1.0, (stop - start, 4))
    return boxes


def nms_case(name):
    """(boxes (B, N, 4) float32, valid (B, N) bool, iou, max_keep)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name.startswith("n"):  # N around word and tile edges, clustered
        n = int(name[1:])
        boxes = _clustered(rng, 2, n)
        return boxes, rng.rand(2, n) < 0.9, 0.5, None
    if name == "all_invalid":
        return _clustered(rng, 2, 300), np.zeros((2, 300), bool), 0.5, None
    if name == "all_identical":
        box = np.array([10.0, 20.0, 110.0, 90.0], np.float32)
        return np.tile(box, (2, 300, 1)), np.ones((2, 300), bool), 0.5, None
    if name == "suppressed_runs":  # 8 and 7 runs, each ending at N
        boxes = np.stack([_runs(rng, 1848, 230), _runs(rng, 1848, 263)])
        return boxes, np.ones((2, 1848), bool), 0.5, None
    if name.startswith("max_keep_"):  # every valid box is kept
        mk = int(name.rsplit("_", 1)[1])
        n = 3 * mk
        boxes = np.tile(_grid(n), (2, 1, 1))
        return boxes, np.ones((2, n), bool), 0.5, mk
    if name == "train_rpn":
        boxes = _clustered(rng, 2, 12000, size=1300.0)
        valid = rng.rand(2, 12000) < 0.97
        return boxes, valid, 0.7, 2000
    raise KeyError(name)


NMS_CASES = [
    "n1", "n63", "n64", "n65", "n127", "n129", "all_invalid",
    "all_identical", "suppressed_runs",
    # kept count reaching max_keep exactly at a 128-box tile start, and one
    # box after it; the same at the 1024-box chunk start
    "max_keep_128", "max_keep_129", "max_keep_1024", "max_keep_1025",
    "train_rpn",
]


# ------------------------------------------------------------- ROIAlign
def _rois(rng, b, s, img_h, img_w):
    xy = rng.uniform(0, 1, (b, s, 2)) * [img_w, img_h]
    wh = np.exp(rng.uniform(1.5, 6.0, (b, s, 2)))
    boxes = np.concatenate([xy - wh / 4, xy + wh], -1)
    boxes[:, ::9, 2] = boxes[:, ::9, 0]  # zero width: output 0
    return boxes.astype(np.float32)


def _tile_edge_boxes(rng, s, h, w):
    """(s, 4) boxes for ``tile_edges`` (scale 1, P 2, 2 x 2 samples a bin:
    an axis of length L samples at start + L (1, 3, 5, 7) / 8, exactly in
    float32): on each axis the first sample or the last one lands on a
    tile's last pixel, on the pixel after it or half a pixel between, and
    some past the map's partial last tile."""
    def axis(tile, size):
        edges = np.arange(tile, size + 1, tile, dtype=np.float64)
        targets = np.concatenate([edges - 1.5, edges - 1.0, edges - 0.5,
                                  edges, [size - 1.0, size - 0.5, size,
                                          size + 0.5]])
        t = rng.choice(targets, s)
        length = rng.choice([2.0, 4.0, 8.0], s)
        by_last = rng.rand(s) < 0.5
        # feature start: the last sample (7/8 of L in) or the first (1/8)
        start = np.where(by_last, t - 0.875 * length, t - 0.125 * length)
        return start + 0.5, start + 0.5 + length  # image coordinates
    x1, x2 = axis(BWD_TILE_COLS, w)
    y1, y2 = axis(BWD_TILE_ROWS, h)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def roi_case(name):
    """(features (B, C, H, W) float32, boxes (B, S, 4) float32, P, scale,
    sampling_ratio, bin_stride)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    scale, p, sampling, stride, b, s = 1 / 16.0, 7, 0, 2, 2, 12
    c, h, w = 64, 14, 20
    if name.startswith("c"):  # channel widths: a tail of 4, 1024, 2048
        c = int(name[1:])
        h, w = (14, 20) if c < 1000 else (9, 13)
    elif name == "h_gt_w":
        h, w, stride = 22, 13, 1
    elif name == "w_ge_h":
        h, w, stride = 13, 22, 1
    elif name == "fixed2":  # a fixed 2 x 2 samples a bin
        h, w, stride, sampling = 13, 22, 1, 2
    elif name == "s0":
        s = 0
    elif name == "pcb":  # P 1 on res5 at 1/32 (the 800x1344 bucket)
        scale, p, stride, c, h, w, s = 1 / 32.0, 1, 1, 2048, 25, 42, 6
    elif name == "dense":  # every ROI covers most of a map of several tiles
        h, w, s = 37, 30, 16
    elif name == "tile_edges":
        scale, p, sampling, stride, h, w, s = 1.0, 2, 2, 1, 37, 27, 24
    elif name == "many":  # more ROIs than one pass of the backward's reads
        s = 300
    elif name != "outside":
        raise KeyError(name)
    feat = rng.randn(b, c, h, w).astype(np.float32)
    if name == "dense":
        lo = rng.uniform(0.0, 0.15, (b, s, 2)) * [w / scale, h / scale]
        hi = rng.uniform(0.85, 1.0, (b, s, 2)) * [w / scale, h / scale]
        return (feat, np.concatenate([lo, hi], -1).astype(np.float32), p,
                scale, sampling, stride)
    if name == "tile_edges":
        boxes = np.stack([_tile_edge_boxes(rng, s, h, w) for _ in range(b)])
        return feat, boxes, p, scale, sampling, stride
    boxes = _rois(rng, b, s, h / scale, w / scale)
    if name == "outside":  # wholly off the map, on every side
        far = np.array([[-900, -900, -300, -400], [2000, 10, 2600, 90],
                        [10, 1500, 90, 1900], [-500, 50, -40, 120]],
                       np.float32)
        boxes[:, :4] = far
    return feat, boxes, p, scale, sampling, stride


ROI_CASES = ["c60", "c1024", "c2048", "h_gt_w", "w_ge_h", "fixed2", "s0",
             "outside", "pcb", "dense", "tile_edges", "many"]


def roi_grad_out(name):
    """The gradient (B, S, C, P', P') float32 that the backward cases send
    into ROIAlign's output, for ``roi_case(name)``."""
    feat, boxes, p, _, _, stride = roi_case(name)
    p_out = len(range(0, p, stride))
    rng = np.random.RandomState(sum(map(ord, name)) + 1)
    shape = (boxes.shape[0], boxes.shape[1], feat.shape[1], p_out, p_out)
    return rng.randn(*shape).astype(np.float32)


# --------------------------------------- the cases have their properties
def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", NMS_CASES)
def test_nms_case_shapes(name):
    boxes, valid, thr, mk = nms_case(name)
    b, n = valid.shape
    assert boxes.shape == (b, n, 4) and boxes.dtype == np.float32
    assert valid.dtype == bool and 0.0 < thr < 1.0
    assert np.isfinite(boxes).all()


def test_nms_case_all_identical_keeps_the_first_box():
    boxes, valid, thr, mk = nms_case("all_identical")
    keep = nms_sorted_plain(_t(boxes), _t(valid), thr, mk).numpy()
    assert keep.sum(axis=1).tolist() == [1, 1] and keep[:, 0].all()


def test_nms_case_suppressed_runs_cross_words_and_chunks():
    boxes, valid, thr, mk = nms_case("suppressed_runs")
    keep = nms_sorted_plain(_t(boxes), _t(valid), thr, mk).numpy()
    for row in keep:
        kept = np.nonzero(row)[0]
        gaps = np.diff(np.concatenate([kept, [len(row)]])) - 1
        assert gaps.min() >= 200  # every run of removed boxes is long
        runs = [(a + 1, a + g) for a, g in zip(kept, gaps)]
        assert any(lo // 64 != hi // 64 for lo, hi in runs)
        assert any(lo < 1024 <= hi for lo, hi in runs)


@pytest.mark.parametrize("mk", [128, 129, 1024, 1025])
def test_nms_case_max_keep_reaches_the_budget_at_a_tile_edge(mk):
    boxes, valid, thr, _ = nms_case(f"max_keep_{mk}")
    keep = nms_sorted_plain(_t(boxes), _t(valid), thr, mk)
    # all boxes kept until the stop: the stop is the first tile start at or
    # beyond max_keep, so exactly max_keep rounded up to a tile are kept
    want = -(-mk // TILE) * TILE
    assert keep.sum(dim=1).tolist() == [want, want]
    assert tiles_visited(keep, mk) == [want // TILE] * 2


def test_nms_case_train_rpn_stops_early():
    boxes, valid, thr, mk = nms_case("train_rpn")
    keep = nms_sorted_plain(_t(boxes), _t(valid), thr, mk)
    visited = tiles_visited(keep, mk)
    assert all(v < -(-12000 // TILE) for v in visited)
    assert (keep.sum(dim=1) >= mk).all()
    # nothing is kept past the tiles the sweep visited
    assert all(not keep[i, v * TILE:].any() for i, v in enumerate(visited))


@pytest.mark.parametrize("name", ROI_CASES)
def test_roi_case_shapes(name):
    feat, boxes, p, scale, sampling, stride = roi_case(name)
    assert feat.ndim == 4 and boxes.shape[0] == feat.shape[0]
    assert boxes.shape[2] == 4 and np.isfinite(boxes).all()
    if name == "outside":
        h, w = feat.shape[2:]
        x1, y1, x2, y2 = (boxes[:, :4, i] * scale - 0.5 for i in range(4))
        assert ((x2 < -1) | (y2 < -1) | (x1 > w) | (y1 > h)).all()
    g = roi_grad_out(name)
    p_out = len(range(0, p, stride))
    assert g.shape == (*boxes.shape[:2], feat.shape[1], p_out, p_out)


def _footprints(name):
    """Per axis, (first, last) pixel that each ROI's taps touch, with the
    map's height and width; from the plain version's interpolation
    matrices."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align import (
        _interp_matrix,
        roi_sample_geometry,
    )

    feat, boxes, p, scale, sampling, stride = roi_case(name)
    h, w = feat.shape[2:]
    geo = roi_sample_geometry(_t(boxes).reshape(-1, 4), scale, p, sampling,
                              stride, feat_hw=(h, w))
    out = []
    for start, size_, grid, ws, size, s in (
            (geo.y1, geo.bin_h, geo.grid_y, geo.wy, h, geo.sy),
            (geo.x1, geo.bin_w, geo.grid_x, geo.wx, w, geo.sx)):
        hit = (_interp_matrix(start, size_, grid, ws, size, geo.p_out, s)
               != 0).any(dim=1).numpy()
        pix = np.arange(size)
        out.append((np.where(hit, pix, size).min(1),
                    np.where(hit, pix, -1).max(1)))
    return out, (h, w)


def test_roi_case_dense_covers_most_of_the_map():
    ((y0, y1), (x0, x1)), (h, w) = _footprints("dense")
    assert (y1 - y0 + 1 >= 0.7 * h).all() and (x1 - x0 + 1 >= 0.7 * w).all()
    assert h > BWD_TILE_ROWS and w > 2 * BWD_TILE_COLS  # several tiles


def test_roi_case_tile_edges_end_and_start_on_tile_edges():
    ((y0, y1), (x0, x1)), (h, w) = _footprints("tile_edges")
    assert h % BWD_TILE_ROWS and w % BWD_TILE_COLS
    for first, last, tile, size in ((y0, y1, BWD_TILE_ROWS, h),
                                    (x0, x1, BWD_TILE_COLS, w)):
        assert ((last + 1) % tile == 0).any()   # ends on a tile's last pixel
        assert (first % tile == 0).any()        # starts on a tile's first
        assert (last == size - 1).any()         # reaches the partial tile


def test_roi_case_many_needs_more_than_one_pass_of_box_reads():
    _, boxes, *_ = roi_case("many")
    assert boxes.shape[1] > 256


def test_bwd_tile_is_the_kernel_source_s_tile():
    """The tile the cases and chip_smoke.py's design bytes use is the one
    the backward kernel is built with."""
    import pathlib
    import re

    import fewshotobjectdetection_imporove_via_text_feature_torch.ops as ops

    src = (pathlib.Path(ops.__file__).parents[1] / "csrc"
           / "roi_align.cu").read_text()
    got = {k: int(v) for k, v in
           re.findall(r"constexpr int (kTile[HW]) = (\d+);", src)}
    assert got == {"kTileH": BWD_TILE_ROWS, "kTileW": BWD_TILE_COLS}
