"""The port's training ops against the JAX package's, on the CPU, float32.

Seeded numpy inputs go through the JAX function and its port. Where the
JAX function draws random priorities (the samplers), the port is handed the
same draw (``jax.random.uniform`` after the same ``jax.random.split``), so
the sampled indices and masks must be equal. Tolerances: sampler outputs,
match indices and labels exactly; losses rtol 1e-5 (the same arithmetic in
another order); box deltas rtol 1e-6; the ROIAlign gradient within 1e-5 of
its largest value (the same sums of products in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.models.fast_rcnn import (
    fast_rcnn_losses as jax_fast_rcnn_losses,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models.rpn import (
    label_and_sample_anchors as jax_label_anchors,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models.rpn import (
    rpn_losses as jax_rpn_losses,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.ops.box_ops import (
    encode_deltas as jax_encode_deltas,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.ops.matcher import (
    match_proposals as jax_match,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.ops.sampler import (
    subsample_labels as jax_subsample,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    GTInstances as JaxGT,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    fast_rcnn_losses,
    label_and_sample_anchors,
    label_and_sample_proposals,
    rpn_losses,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops import (
    encode_deltas,
    match_proposals,
    sample_proposals_fixed,
    subsample_labels,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
    GTInstances,
    Proposals,
)

LOSS_TOL = dict(rtol=1e-5, atol=1e-7)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _boxes(rng, shape, size=300.0, degenerate_every=0):
    xy = rng.uniform(0, size, shape + (2,))
    wh = rng.uniform(2, size / 2, shape + (2,))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if degenerate_every:
        flat = boxes.reshape(-1, 4)
        flat[::degenerate_every, 2] = flat[::degenerate_every, 0]
        flat[1::degenerate_every, 3] = flat[1::degenerate_every, 1] - 3.0
    return boxes


def _gt(rng, b, g, counts, size=300.0, num_classes=15):
    boxes = _boxes(rng, (b, g), size)
    classes = rng.randint(0, num_classes, (b, g)).astype(np.int32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(counts):
        valid[i, :n] = True
    boxes[~valid] = 0.0  # padded rows, as the loader pads them
    return boxes, classes, valid


def _split_uniform(key, n):
    """The priorities the JAX samplers draw from ``key``."""
    kp, kn = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kp, (n,))),
            np.asarray(jax.random.uniform(kn, (n,))))


# ------------------------------------------------------------ box deltas
@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0),
                                     (10.0, 10.0, 5.0, 5.0)])
def test_encode_deltas_matches_jax_including_degenerate_boxes(weights):
    rng = np.random.RandomState(0)
    src = _boxes(rng, (3, 200), degenerate_every=7)
    tgt = _boxes(rng, (3, 200), degenerate_every=11)
    got = encode_deltas(_t(src), _t(tgt), weights).numpy()
    ref = np.asarray(jax_encode_deltas(jnp.asarray(src), jnp.asarray(tgt),
                                       weights))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- matcher
def _iou_case(name):
    """(iou (B, M, N) with ties, gt_valid (B, M))."""
    rng = np.random.RandomState(sum(map(ord, name)))
    b, m, n = 3, 8, 300
    iou = rng.randint(0, 11, (b, m, n)).astype(np.float32) / 10.0
    iou *= rng.rand(b, m, n) < 0.3  # mostly 0, ties among the rest
    valid = np.ones((b, m), bool)
    if name == "padded":
        valid[:, 5:] = False
        iou[:, 5:, :] = 1.0  # padded rows would win every column
    elif name == "no_valid_gt":
        valid[1] = False
    return iou, valid


@pytest.mark.parametrize("name", ["full", "padded", "no_valid_gt"])
@pytest.mark.parametrize("thresholds,labels,low_quality", [
    ((0.3, 0.7), (0, -1, 1), True),   # the RPN's
    ((0.5,), (0, 1), False),           # the ROI heads'
])
def test_match_proposals_matches_jax(name, thresholds, labels, low_quality):
    iou, valid = _iou_case(name)
    idx, lab = match_proposals(_t(iou), _t(valid), thresholds, labels,
                               low_quality)
    for i in range(iou.shape[0]):
        ji, jl = jax_match(jnp.asarray(iou[i]), jnp.asarray(valid[i]),
                           list(thresholds), list(labels), low_quality)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(lab[i].numpy(), np.asarray(jl))
    if name == "no_valid_gt":
        assert not idx[1].any() and (lab[1] == labels[0]).all()


# ---------------------------------------------------------------- samplers
@pytest.mark.parametrize("bs,pf,pos_share", [
    (64, 0.5, 0.3),       # positives capped at 32
    (256, 0.5, 0.02),     # few positives: negatives fill
    (100000, 0.5, 0.1),   # exhaustive
    (40, 0.25, 0.9),      # few negatives
])
def test_subsample_labels_equals_jax_with_its_draw(bs, pf, pos_share):
    rng = np.random.RandomState(bs)
    n = 1000
    u = rng.rand(2, n)
    labels = np.where(u < pos_share, 1,
                      np.where(u < pos_share + 0.1, -1, 0)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(bs), 2)
    pri = [_split_uniform(k, n) for k in keys]
    got = subsample_labels(_t(labels), bs, pf, 0, priorities=(
        _t(np.stack([p[0] for p in pri])), _t(np.stack([p[1] for p in pri]))))
    for i in range(2):
        ref = jax_subsample(keys[i], jnp.asarray(labels[i]), bs, pf, 0)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref))
    # a generator instead of a draw keeps the counts
    rand = subsample_labels(_t(labels), bs, pf, 0,
                            generator=torch.Generator().manual_seed(0))
    assert torch.equal((rand == 1).sum(1), (got == 1).sum(1))
    assert torch.equal((rand == 0).sum(1), (got == 0).sum(1))


# -------------------------------------------------------------------- RPN
def _anchor_case():
    rng = np.random.RandomState(5)
    anchors = _boxes(rng, (900,), 300.0)
    gt = _gt(rng, 3, 10, [4, 10, 0])
    gt[0][0, 1] = gt[0][0, 0]  # a GT duplicate: low-quality ties
    return anchors, gt


@pytest.mark.parametrize("bs", [256, 100000])
def test_label_and_sample_anchors_equals_jax(bs):
    anchors, (gb, gc, gv) = _anchor_case()
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    n = anchors.shape[0]
    pri = [_split_uniform(k, n) for k in keys]
    labels, matched = label_and_sample_anchors(
        _t(anchors), GTInstances(_t(gb), _t(gc), _t(gv)), bs, 0.5,
        (0.3, 0.7), priorities=(_t(np.stack([p[0] for p in pri])),
                                _t(np.stack([p[1] for p in pri]))))
    for i in range(3):
        jl, jm = jax_label_anchors(
            keys[i], jnp.asarray(anchors),
            JaxGT(jnp.asarray(gb[i]), jnp.asarray(gc[i]), jnp.asarray(gv[i])),
            bs, 0.5, (0.3, 0.7))
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(matched[i].numpy(), np.asarray(jm))
    assert (labels[0] == 1).any() and (labels[2] == 1).sum() == 0


@pytest.mark.parametrize("beta", [0.0, 0.11])
def test_rpn_losses_match_jax(beta):
    anchors, (gb, gc, gv) = _anchor_case()
    labels, matched = label_and_sample_anchors(
        _t(anchors), GTInstances(_t(gb), _t(gc), _t(gv)), 256, 0.5,
        generator=torch.Generator().manual_seed(1))
    rng = np.random.RandomState(6)
    logits = rng.randn(3, anchors.shape[0]).astype(np.float32) * 3
    deltas = rng.randn(3, anchors.shape[0], 4).astype(np.float32) * 0.3
    kw = dict(batch_size_per_image=256, smooth_l1_beta=beta,
              bbox_reg_weights=(1.0, 1.0, 1.0, 1.0), loss_weight=1.5,
              bbox_reg_loss_weight=0.7)
    got = rpn_losses(_t(logits), _t(deltas), _t(anchors), labels, matched,
                     **kw)
    ref = jax_rpn_losses(jnp.asarray(logits), jnp.asarray(deltas),
                         jnp.asarray(anchors), jnp.asarray(labels.numpy()),
                         jnp.asarray(matched.numpy()), **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert float(got[k]) > 0
        np.testing.assert_allclose(float(got[k]), float(ref[k]), **LOSS_TOL,
                                   err_msg=k)


# -------------------------------------------------------------- ROI heads


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_fast_rcnn_losses_match_jax(agnostic, beta):
    rng = np.random.RandomState(13)
    r, k = 600, 15
    logits = rng.randn(r, k + 1).astype(np.float32) * 2
    deltas = rng.randn(r, 4 if agnostic else 4 * k).astype(np.float32)
    props = _boxes(rng, (r,), 300.0, degenerate_every=50)
    gtb = props + rng.uniform(-10, 10, (r, 4)).astype(np.float32)
    cls = rng.randint(0, k + 1, r).astype(np.int32)
    valid = rng.rand(r) < 0.8
    kw = dict(num_classes=k, box_reg_weights=(10.0, 10.0, 5.0, 5.0),
              smooth_l1_beta=beta)
    got = fast_rcnn_losses(_t(logits), _t(deltas), _t(props), _t(gtb),
                           _t(cls), _t(valid), **kw)
    ref = jax_fast_rcnn_losses(*map(jnp.asarray, (logits, deltas, props, gtb,
                                                  cls, valid)), **kw)
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   **LOSS_TOL, err_msg=key)


# ------------------------------------------------------ ROIAlign gradient
