"""The counts behind the shares of a peak or a roofline: the detector's
FLOPs (forward at evaluation, forward and backward in training) equal
``FlopCounterMode`` over the program's own calls at a small canvas, and
the kernels' work counts equal brute-force counts on small inputs."""

from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import port, train, work
from tiny import tiny_infer_cell, tiny_train_cell


def test_forward_flops_equal_flopcountermode():
    from fewshotobjectdetection_imporove_via_text_feature_torch.structures \
        import ImageBatch

    cell = tiny_infer_cell()
    cell["config"]["compute_dtype"] = "float32"
    cfg = port.build_cfg(cell["config"], "unused")
    model = port.build_model(cfg, "cpu").eval()
    port.load_state(model, port.seeded_state(model, cell["config"], 3,
                                             "cpu"))
    canvas = (128, 192)
    batch = ImageBatch(
        image=torch.randint(0, 255, (2, *canvas, 3), dtype=torch.uint8),
        hw=torch.tensor([[128, 170], [120, 192]], dtype=torch.int32),
        orig_hw=torch.tensor([[75, 100], [70, 110]], dtype=torch.int32))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.forward_inference(batch)
    mine = work.inference_flops(cfg, canvas)
    assert fc.get_total_flops() == 2 * (mine["low"] + mine["f32"])


def test_training_step_flops_equal_flopcountermode(tmp_path):
    from fewshotobjectdetection_imporove_via_text_feature_torch.data.loader \
        import device_batches
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine \
        import Trainer

    cell = tiny_train_cell(dtype="float32")
    cpu = torch.device("cpu")
    cfg = port.build_cfg(cell["config"], str(tmp_path), ["SEED", "3"])
    trainer = Trainer(cfg, data=[], device=cpu)
    host, canvas = train.make_batches(cell["traffic"], cfg, 5, cpu)[0]
    (images, gt, meta), = list(device_batches([host], cpu))
    with FlopCounterMode(display=False) as fc:
        trainer.train_step(images, gt, 0, meta)
    mine = work.train_flops(cfg, canvas, cfg.SOLVER.IMS_PER_BATCH)
    assert fc.get_total_flops() == mine["low"] + mine["f32"]


def _brute_taps(boxes, h, w, p, stride, scale, bins=False):
    """The (image, pixel) pairs some bin reads, or with ``bins`` the
    emitted bins that read some pixel, counted one sample at a time."""
    hit, read = set(), set()
    for b in range(boxes.shape[0]):
        for r in range(boxes.shape[1]):
            x1, y1, x2, y2 = (float(v) * scale - 0.5 for v in boxes[b, r])
            bw, bh = max(x2 - x1, 1e-6) / p, max(y2 - y1, 1e-6) / p
            gy = min(max(math.ceil((y2 - y1) / p), 0), max(1, -(-h // p)))
            gx = min(max(math.ceil((x2 - x1) / p), 0), max(1, -(-w // p)))
            for py in range(0, p, stride):
                for px in range(0, p, stride):
                    for iy in range(gy):
                        for ix in range(gx):
                            y = y1 + (py + (iy + 0.5) / gy) * bh
                            x = x1 + (px + (ix + 0.5) / gx) * bw
                            if y < -1 or y > h or x < -1 or x > w:
                                continue
                            y, x = min(max(y, 0), h - 1), min(max(x, 0),
                                                              w - 1)
                            y0, x0 = math.floor(y), math.floor(x)
                            for yy, wy in ((y0, 1 - (y - y0)),
                                           (min(y0 + 1, h - 1), y - y0)):
                                for xx, wx in ((x0, 1 - (x - x0)),
                                               (min(x0 + 1, w - 1), x - x0)):
                                    if wy > 0 and wx > 0:
                                        hit.add((b, yy, xx))
                                        read.add((b, r, py, px))
    return len(read) if bins else len(hit)


@pytest.mark.parametrize("stride", [1, 2])
def test_tapped_pixels_equal_a_brute_force_count(stride):
    g = torch.Generator().manual_seed(stride)
    h, w, scale = 12, 15, 1 / 16.0
    xy = torch.rand(2, 6, 2, generator=g) * torch.tensor([w * 16, h * 16])
    wh = torch.rand(2, 6, 2, generator=g) * 120 + 1
    boxes = torch.cat([xy - 8, xy + wh], -1)     # some reach off the map
    assert work.tapped_pixels(boxes, h, w, 7, stride, scale) == \
        _brute_taps(boxes, h, w, 7, stride, scale)


@pytest.mark.parametrize("stride", [1, 2])
def test_read_bins_equal_a_brute_force_count(stride):
    g = torch.Generator().manual_seed(10 + stride)
    h, w, scale = 12, 15, 1 / 16.0
    xy = torch.rand(2, 8, 2, generator=g) * torch.tensor([w * 16, h * 16])
    wh = torch.rand(2, 8, 2, generator=g) * 120 + 1
    boxes = torch.cat([xy - 8, xy + wh], -1)
    boxes[0, :3, 2] = boxes[0, :3, 0]            # empty boxes read nothing
    boxes[1, :2] += 400.0                        # boxes off the map
    got = work.read_bins(boxes, h, w, 7, stride, scale)
    assert got == _brute_taps(boxes, h, w, 7, stride, scale, bins=True)
    assert 0 < got < boxes.shape[0] * boxes.shape[1] * \
        len(range(0, 7, stride)) ** 2


def _brute_nms(boxes, valid, thresh, max_keep):
    from reference.detector import iou_matrix

    keep, tests = [], 0
    for i in range(boxes.shape[0]):
        if not valid[i]:
            continue
        if max_keep is not None and len(keep) >= max_keep:
            break
        tests += len(keep)
        if all(float(iou_matrix(boxes[i:i + 1], boxes[j:j + 1])) <= thresh
               for j in keep):
            keep.append(i)
    mask = torch.zeros(boxes.shape[0], dtype=torch.bool)
    mask[keep] = True
    # the greedy result past max_keep, as a kernel that finishes its tile
    for i in range(boxes.shape[0]):
        if valid[i] and i > (keep[-1] if keep else -1) and all(
                float(iou_matrix(boxes[i:i + 1], boxes[j:j + 1])) <= thresh
                for j in torch.nonzero(mask)[:, 0].tolist()):
            mask[i] = True
    return mask, tests


@pytest.mark.parametrize("max_keep", [None, 7])
def test_iou_tests_equal_a_brute_force_count(max_keep):
    g = torch.Generator().manual_seed(3)
    xy = torch.rand(60, 2, generator=g) * 50
    boxes = torch.cat([xy, xy + torch.rand(60, 2, generator=g) * 30 + 2], -1)
    valid = torch.rand(60, generator=g) > 0.2
    keep, tests = _brute_nms(boxes, valid, 0.5, max_keep)
    got = work.nms_iou_tests(keep[None], valid[None],
                             -1 if max_keep is None else max_keep)
    assert got == tests
