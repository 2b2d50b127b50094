"""The port's Fast R-CNN inference and forward_inference against the JAX
package's on the same inputs; split from tests/test_torch_model.py so
that each file is a small share of one xdist worker."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.models.fast_rcnn import (
    fast_rcnn_inference as jax_fast_rcnn_inference,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    GeneralizedRCNN,
    fast_rcnn_inference,
    select_top_proposals,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
    ImageBatch,
)
from tests.test_torch_model import (  # noqa: F401
    H,
    NUM_CLASSES,
    inputs,
    jax_images,
    match_detections,
    models,
    port_images,
    W,
)


def test_fast_rcnn_inference_matches_jax_on_the_same_head_outputs():
    rng = np.random.RandomState(3)
    b, p, k = 2, 300, NUM_CLASSES
    logits = (rng.randn(b, p, k + 1) * 2).astype(np.float32)
    deltas = (rng.randn(b, p, 4 * k) * 0.3).astype(np.float32)
    xy = rng.uniform(0, [W - 40, H - 40], (b, p, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (b, p, 2))],
                           -1).astype(np.float32)
    valid = rng.rand(b, p) > 0.1
    hw = np.array([[H, W], [96, 128]], np.int32)
    kw = dict(num_classes=k, topk_per_image=50, candidate_topk=400)
    out = fast_rcnn_inference(torch.from_numpy(logits),
                              torch.from_numpy(deltas),
                              torch.from_numpy(boxes),
                              torch.from_numpy(valid), torch.from_numpy(hw),
                              **kw)
    for i in range(b):
        ref = jax_fast_rcnn_inference(
            jnp.asarray(logits[i]), jnp.asarray(deltas[i]),
            jnp.asarray(boxes[i]), jnp.asarray(valid[i]), jnp.asarray(hw[i]),
            **kw)
        np.testing.assert_array_equal(out[3][i].numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(out[2][i].numpy(), np.asarray(ref[2]))
        np.testing.assert_allclose(out[1][i].numpy(), np.asarray(ref[1]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out[0][i].numpy(), np.asarray(ref[0]),
                                   rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize(
    "depth,stride_in_1x1,padded",
    [(14, True, False), (14, True, True), (14, False, True),
     (26, True, True)],
)
def test_forward_inference_matches_jax(depth, stride_in_1x1, padded):
    jmodel, params, port = models(depth, stride_in_1x1)
    canvas, hw, orig = inputs(padded)
    det = jax.device_get(jax.jit(functools.partial(jmodel.apply, train=False))(
        {"params": params}, jax_images(canvas, hw, orig)))
    with torch.no_grad():
        tdet = port.forward_inference(port_images(canvas, hw, orig))
    assert int(np.asarray(det.valid).sum()) > 10  # the comparison has teeth
    for i in range(2):
        jv = np.asarray(det.valid[i])
        tv = tdet.valid[i].numpy()
        match_detections(
            (tdet.boxes[i].numpy()[tv], tdet.scores[i].numpy()[tv],
             tdet.classes[i].numpy()[tv]),
            (np.asarray(det.boxes[i])[jv], np.asarray(det.scores[i])[jv],
             np.asarray(det.classes[i])[jv]),
        )
