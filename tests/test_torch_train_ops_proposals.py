"""The port's proposal sampling and labelling against the JAX package's
with its draws, and the ROIAlign gradient against jax.grad of
roi_align_mxu; split from tests/test_torch_train_ops.py so that each
file is a small share of one xdist worker."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.models.roi_heads import (
    label_and_sample_proposals as jax_label_proposals,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.ops.roi_align_mxu import (
    roi_align_mxu,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.ops.sampler import (
    sample_proposals_fixed as jax_sample_fixed,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    GTInstances as JaxGT,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    Proposals as JaxProposals,
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
    roi_align,
    roi_align_plain,
    sample_proposals_fixed,
    subsample_labels,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
    GTInstances,
    Proposals,
)
from test_torch_kernel_cases import ROI_CASES, roi_case, roi_grad_out
from tests.test_torch_train_ops import (  # noqa: F401
    _boxes,
    _gt,
    _split_uniform,
    _t,
)


@pytest.mark.parametrize("bs,pf,fg_share", [
    (512, 0.25, 0.1), (64, 0.25, 0.5), (2000, 0.25, 0.05), (128, 0.5, 0.02),
])
def test_sample_proposals_fixed_equals_jax_with_its_draw(bs, pf, fg_share):
    rng = np.random.RandomState(bs)
    n, k = 1500, 15
    u = rng.rand(2, n)
    cls = np.where(u < fg_share, rng.randint(0, k, (2, n)),
                   np.where(u < fg_share + 0.05, -1, k)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(bs + 1), 2)
    pri = [_split_uniform(key, n) for key in keys]
    idx, valid = sample_proposals_fixed(
        _t(cls), bs, pf, k, priorities=(_t(np.stack([p[0] for p in pri])),
                                        _t(np.stack([p[1] for p in pri]))))
    assert idx.shape == valid.shape == (2, bs)
    for i in range(2):
        ji, jv = jax_sample_fixed(keys[i], jnp.asarray(cls[i]), bs, pf, k)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jv))


@pytest.mark.parametrize("append_gt", [True, False])
@pytest.mark.parametrize("bs", [64, 512])
def test_label_and_sample_proposals_equals_jax(append_gt, bs):
    rng = np.random.RandomState(11)
    b, p, g, k = 3, 400, 12, 15
    gb, gc, gv = _gt(rng, b, g, [5, 12, 0], num_classes=k)
    pb = _boxes(rng, (b, p), 300.0)
    # proposals near the GT, so that foregrounds exist
    near = gb[:, rng.randint(0, 5, 60)] + rng.uniform(-8, 8, (b, 60, 4))
    pb[:, :60] = near.astype(np.float32)
    pv = rng.rand(b, p) < 0.9
    pb[~pv] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(bs), b)
    n = p + g if append_gt else p
    pri = [_split_uniform(key, n) for key in keys]
    got = label_and_sample_proposals(
        Proposals(_t(pb), _t(np.zeros((b, p), np.float32)), _t(pv)),
        GTInstances(_t(gb), _t(gc), _t(gv)), bs, 0.25, k, 0.5, append_gt,
        priorities=(_t(np.stack([q[0] for q in pri])),
                    _t(np.stack([q[1] for q in pri]))))
    for i in range(b):
        ref = jax_label_proposals(
            keys[i],
            JaxProposals(jnp.asarray(pb[i]), jnp.zeros((p,)),
                         jnp.asarray(pv[i])),
            JaxGT(jnp.asarray(gb[i]), jnp.asarray(gc[i]), jnp.asarray(gv[i])),
            bs, 0.25, k, 0.5, append_gt)
        for key in ("boxes", "gt_classes", "gt_boxes", "valid"):
            np.testing.assert_array_equal(got[key][i].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
    fg = (got["gt_classes"] < k) & got["valid"]
    assert fg[0].any() and not fg[2].any()


@pytest.mark.parametrize("name", ROI_CASES)
def test_roi_align_gradient_matches_jax_grad(name):
    """Autograd of the plain ROIAlign (what the CUDA backward kernel is held
    to on the card) against ``jax.grad`` of ``roi_align_mxu``."""
    feat, boxes, p, scale, sampling, stride = roi_case(name)
    g = roi_grad_out(name)
    ft = _t(feat).requires_grad_(True)
    out = roi_align_plain(ft, _t(boxes), p, scale, sampling, stride)
    out.backward(_t(g))
    got = ft.grad.permute(0, 2, 3, 1).numpy()
    # the device switch's CPU path is the same function
    ft2 = _t(feat).requires_grad_(True)
    roi_align(ft2, _t(boxes), p, scale, sampling, stride).backward(_t(g))
    torch.testing.assert_close(ft2.grad, ft.grad, rtol=0, atol=0)
    for i in range(feat.shape[0]):
        if boxes.shape[1] == 0:
            assert not got[i].any()
            continue

        def f(x, i=i):
            return roi_align_mxu(x, jnp.asarray(boxes[i]), p, scale,
                                 sampling, 128, stride)

        _, vjp = jax.vjp(f, jnp.asarray(feat[i].transpose(1, 2, 0)))
        (ref,) = vjp(jnp.asarray(g[i].transpose(0, 2, 3, 1)))
        ref = np.asarray(ref)
        np.testing.assert_allclose(got[i], ref, rtol=0,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-30),
                                   err_msg=f"image {i}")
    if name == "outside":  # the off-map ROIs send nothing
        only = np.zeros_like(g)
        only[:, :4] = g[:, :4]
        ft3 = _t(feat).requires_grad_(True)
        roi_align_plain(ft3, _t(boxes), p, scale, sampling,
                        stride).backward(_t(only))
        assert not ft3.grad.any()
