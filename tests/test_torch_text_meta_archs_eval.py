"""The text meta-archs' inference roles against the JAX package's: the
paint roles in inference and the GT that evaluation hands to the
painting archs only; split from tests/test_torch_text_meta_archs.py so
that each file is a small share of one xdist worker."""

import functools

import numpy as np
import pytest

import jax
import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    init_weights,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
    inference_on_dataset,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    GeneralizedRCNN,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    text_heads as ttext,
)
from tests.test_torch_model import match_detections
from tests.test_torch_text_heads import (
    _detections,
    jax_batch,
    jax_model,
    port_model,
    text_kwargs,
)
from tests.test_torch_text_meta_archs import (  # noqa: F401
    DISTILL_HEAD,
)


class _Spy:
    """Records the GT each forward_inference call was handed."""

    def __init__(self, model):
        self.model, self.seen = model, []
        self.forward = model.forward_inference

    def __call__(self, images, gt=None):
        self.seen.append(gt)
        return self.forward(images, gt)


@pytest.mark.parametrize("meta,with_gt", [
    ("GeneralizedSemanticRCNN", True), ("GeneralizedSemanticRCNN", False),
    ("GeneralizedTextRCNN", True), ("GeneralizedTextRCNN", False),
    ("GeneralizedTextAttRCNN", True), ("GeneralizedTextAttRCNN", False),
    ("GeneralizedDistillatedRCNN", True)])
def test_paint_roles_in_inference_like_jax(meta, with_gt):
    """The painting archs paint test-time GT, or an all-background map
    without it; the Distillated family ignores GT."""
    kw = DISTILL_HEAD if meta.startswith("GeneralizedDistillated") else {}
    jmodel, params = jax_model(meta, **kw)
    images, gt, timages, tgt = jax_batch(True)
    det = jax.device_get(jax.jit(functools.partial(
        jmodel.apply, train=False))({"params": params}, images,
                                    gt if with_gt else None))
    port = port_model(meta, params, **kw).eval()
    with torch.no_grad():
        tdet = port.forward_inference(timages, tgt if with_gt else None)
        other = port.forward_inference(timages, None if with_gt else tgt)
    assert int(np.asarray(det.valid).sum()) > 10
    for i in range(2):
        match_detections(_detections(tdet, i), _detections(det, i))
    if meta.startswith("GeneralizedDistillated"):
        assert port.eval_gt_role == "none"
        torch.testing.assert_close(tdet.scores, other.scores, rtol=0, atol=0)
    else:
        assert port.eval_gt_role == "paint"
        assert not torch.equal(tdet.scores, other.scores)


def _eval_model(meta):
    kw = text_kwargs(**(DISTILL_HEAD if "Distill" in meta else {}))
    if meta == "GeneralizedRCNN":
        kw["roi_heads_name"] = "TextRes5ROIHeads"
        model = GeneralizedRCNN(**kw)
    else:
        cls, extra = ttext.META_ARCHS[meta]
        model = cls(**extra, **kw)
    init_weights(model, torch.Generator().manual_seed(0))
    spy = _Spy(model)
    model.forward_inference = spy
    return model, spy


@pytest.mark.parametrize("meta,role", [
    ("GeneralizedRCNN", "teacher"), ("GeneralizedSemanticRCNN", "paint"),
    ("GeneralizedDistillatedRCNN", "none"), ("GeneralizedTextRCNN", "paint"),
    ("GeneralizedTextAttRCNN", "paint")])
def test_evaluation_hands_gt_to_the_painting_archs_only(meta, role):
    """``inference_on_dataset`` hands each batch's GT to the "paint" archs
    (the reference's evaluation protocol) and to no other; ``no_gt``
    (TEST.NO_GT_EVAL) withholds it from the Text family and is refused for
    the Semantic family, whose features are solely the painted map."""
    _, _, timages, tgt = jax_batch(True)
    loader = [(timages, tgt, {"image_ids": [0, 1]})] * 2
    model, spy = _eval_model(meta)
    assert model.eval_gt_role == role
    inference_on_dataset(model, loader, None)
    if role == "paint":
        assert all(g is not None and torch.equal(g.boxes, tgt.boxes)
                   for g in spy.seen) and len(spy.seen) == 2
    else:
        assert spy.seen == [None, None]
    spy.seen.clear()
    if meta == "GeneralizedSemanticRCNN":
        with pytest.raises(ValueError, match="NO_GT_EVAL"):
            inference_on_dataset(model, loader, None, no_gt=True)
        assert not spy.seen
    else:
        inference_on_dataset(model, loader, None, no_gt=True)
        assert spy.seen == [None, None]
