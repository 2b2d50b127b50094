"""The port's on-device preprocessing (``data/device_preprocess.py``,
TPU.DEVICE_PREPROCESS) against the JAX package's ``data/xla_preprocess.py``
on the CPU: the resize of uint8 raw batches (the same sizes, values within
1e-3 on the 0-255 scale), the flip, independence from the source padding,
``scale_boxes``; two SGD steps on raw batches against the JAX
``make_train_step`` with its fused preprocessing (losses within 1e-5
relative); and an evaluation with it on against the JAX evaluation."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.data.loader import (
    build_detection_test_loader as jax_test_loader,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.mapper import (
    resize_shortest_edge_size,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.xla_preprocess import (
    device_resize_batch as jax_resize,
    scale_boxes as jax_scale_boxes,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.evaluation import (
    inference_on_dataset as jax_inference_on_dataset,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    build_model as jax_build_model,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    ImageBatch as JaxImageBatch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    state_dict_from_jax_params,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
    build_detection_test_loader,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data.device_preprocess import (
    device_resize_batch,
    scale_boxes,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    make_train_step,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
    inference_on_dataset,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    build_model,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.solver import (
    build_optimizer,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
    ImageBatch,
)
from test_torch_eval_cli import (  # noqa: F401  (voc is a fixture)
    PREFIX,
    TEST_SET,
    _Recorder,
    _tiny_cfgs,
    voc,
)
from tests.test_full_network_oracle import _perturb
from tests.test_torch_model import W, match_detections

RAW = np.random.RandomState(0).randint(0, 256, (3, 256, 320, 3)).astype(
    np.uint8)
ORIG_HW = np.array([[220, 300], [256, 200], [100, 320]], np.int32)


def _both(raw, orig_hw, flip, short, max_size, out_hw):
    a, ahw = jax_resize(jnp.asarray(raw), jnp.asarray(orig_hw),
                        jnp.asarray(flip), jnp.asarray(short), max_size,
                        out_hw)
    b, bhw = device_resize_batch(torch.from_numpy(raw),
                                 torch.from_numpy(orig_hw),
                                 torch.from_numpy(np.asarray(flip)),
                                 torch.from_numpy(np.asarray(short)),
                                 max_size, out_hw)
    return (np.asarray(a), np.asarray(ahw)), (b.numpy(), bhw.numpy())


@pytest.mark.parametrize("out_hw", [(288, 416), (320, 320), (384, 384)])
def test_resize_matches_jax_on_uint8(out_hw):
    flip = np.array([False, True, True])
    short = np.array([256, 200, 300], np.float32)
    (a, ahw), (b, bhw) = _both(RAW, ORIG_HW, flip, short, 384, out_hw)
    np.testing.assert_array_equal(bhw, ahw)
    for i, (h0, w0) in enumerate(ORIG_HW):
        assert tuple(bhw[i]) == resize_shortest_edge_size(
            h0, w0, short[i], 384)
    assert b.dtype == np.float32 and b.shape == (3, *out_hw, 3)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-3)
    for i, (nh, nw) in enumerate(bhw):  # zero past the resized extent
        assert not b[i, nh:].any() and not b[i, :, nw:].any()


def test_flip_mirrors_the_valid_region():
    raw = np.zeros((1, 64, 128, 3), np.uint8)
    raw[0, :, :8] = 255  # a bright strip at the left edge of (64, 96)
    hw = np.array([[64, 96]], np.int32)
    (_, _), (plain, _) = _both(raw, hw, np.array([False]),
                               np.float32(64), 1000, (64, 96))
    (a, _), (flipped, _) = _both(raw, hw, np.array([True]),
                                 np.float32(64), 1000, (64, 96))
    np.testing.assert_allclose(flipped, a, rtol=0, atol=1e-3)
    assert plain[0, :, :4].mean() > 200 and plain[0, :, -4:].mean() < 1
    assert flipped[0, :, -4:].mean() > 200 and flipped[0, :, :4].mean() < 1
    np.testing.assert_array_equal(flipped[0], plain[0, :, ::-1])


def test_resize_independent_of_source_padding():
    """The pad past an image's valid region never reaches the output:
    zeros and noise there give the same result."""
    hw = np.array([[100, 150]], np.int32)
    base = np.zeros((1, 128, 192, 3), np.uint8)
    base[0, :100, :150] = RAW[0, :100, :150]
    noisy = base.copy()
    noisy[0, 100:] = 255
    noisy[0, :, 150:] = 77
    for flip in (False, True):
        outs = [_both(r, hw, np.array([flip]), np.float32(200), 400,
                      (224, 320))[1][0] for r in (base, noisy)]
        np.testing.assert_array_equal(outs[0], outs[1])


def test_scale_boxes_matches_jax():
    boxes = np.array([[10, 20, 60, 80], [0, 0, 300, 220]], np.float32)
    for flip in (False, True):
        np.testing.assert_array_equal(
            scale_boxes(boxes, (220, 300), (256, 349), flip),
            jax_scale_boxes(boxes, (220, 300), (256, 349), flip))


def _raw_batch():
    """Two raw images in a (112, 144) source bucket that resize into the
    tiny detector's 128x160 canvas, the second flipped, with their GT."""
    rng = np.random.RandomState(5)
    raw = np.zeros((2, 112, 144, 3), np.uint8)
    orig = np.array([[100, 130], [90, 120]], np.int32)
    short = np.array([128, 128], np.float32)
    flip = np.array([False, True])
    hw = np.array([resize_shortest_edge_size(h, w, s, W)
                   for (h, w), s in zip(orig, short)], np.int32)
    gb = np.zeros((2, 8, 4), np.float32)
    gc = np.zeros((2, 8), np.int32)
    gv = np.zeros((2, 8), bool)
    for i, (h, w) in enumerate(orig):
        raw[i, :h, :w] = rng.randint(0, 256, (h, w, 3))
        x1, y1 = rng.uniform(0, w - 40, 3), rng.uniform(0, h - 40, 3)
        b = np.stack([x1, y1, x1 + rng.uniform(12, 40, 3),
                      y1 + rng.uniform(12, 40, 3)], axis=1)
        gb[i, :3] = scale_boxes(b, (h, w), hw[i], flip[i])
        gc[i, :3] = rng.randint(0, 5, 3)
        gv[i, :3] = True
    return raw, hw, orig, short, flip, (gb, gc, gv)


def test_evaluation_with_device_preprocess_matches_the_jax_package(voc):
    cfg, jcfg = _tiny_cfgs()
    for c in (cfg, jcfg):
        c.TPU.DEVICE_PREPROCESS = True
        c.TPU.RAW_BUCKETS = ((384, 512), (512, 384))
    jmodel = jax_build_model(jcfg)
    h, w = jcfg.TPU.IMAGE_BUCKETS[0]
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0)},
        JaxImageBatch(image=np.zeros((1, h, w, 3), np.float32),
                      hw=np.array([[h, w]], np.int32),
                      orig_hw=np.array([[h, w]], np.int32)), train=False)
    params = _perturb(jax.device_get(variables["params"]))
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax_params(params))

    ours, ref = _Recorder(), _Recorder()
    loader = build_detection_test_loader(cfg, TEST_SET, batch_size=4)
    inference_on_dataset(model, loader, ours)
    jax_inference_on_dataset(jmodel, params, jax_test_loader(
        jcfg, PREFIX + TEST_SET, batch_size=4), ref)
    assert [b[0] for b in ours.batches] == [b[0] for b in ref.batches]
    total = 0
    for a, b in zip(ours.batches, ref.batches):
        for i in range(len(a[0])):
            va, vb = a[4][i], b[4][i]
            total += int(va.sum())
            match_detections((a[1][i][va], a[2][i][va], a[3][i][va]),
                             (b[1][i][vb], b[2][i][vb], b[3][i][vb]),
                             iou_min=0.99, score_tol=1e-3)
    assert total > 20
